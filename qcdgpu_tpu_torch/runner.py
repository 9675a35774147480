"""Chunk runner: sweeps and measurements over a packed state.

Port of qcdgpu_tpu/runner.py with the same external contract,

    run(u, base_key, sweep0, n_sweeps, measure_every) -> (u', obs)
    run.packed(state, base_key, sweep0, n_sweeps, measure_every)
        -> (state', obs)

with obs a ``[n_sweeps // measure_every, n_obs]`` float32 series on the
state's device.  With a tracked statistic (``with_acc``), each row ends
with the mean of the block's per-sweep rates, as in the reference
(runner.py:64-68, 99-104).  PyTorch runs eagerly, so where the reference
compiled bounded fori_loop programs this is a plain Python loop: each sweep
enqueues its kernels and returns, measurement rows stay on the device, and
nothing waits for the device until the caller reads the series.
"""

from __future__ import annotations

import torch

from .ops.measure import obs_names
from .utils import profile


def build_chunk_runner(cfg, sweep, measure_state, pack=None, unpack=None,
                       with_acc=False, *, device, n_obs=None):
    """sweep(state, key, sweep_idx) -> state (may update in place), or
    (state, rate) with with_acc, rate an f32 tensor on ``device`` (0-d,
    or one per chain in the ensemble); state is (links, stream state) —
    the link 8-tuple, or one per shard — or the ensemble's;
    measure_state(state) -> f32 row (without the tracked column) on
    ``device``;
    pack / unpack: canonical complex link field <-> engine state.
    n_obs: the row width (default obs_names(cfg)).  With C rates the row
    is C rows of equal width, chain-major, and each gets its chain's mean
    rate appended (the reference's append_acc, qcdgpu_tpu/runner.py:39-70);
    one rate gives the single chain's row."""
    n_obs = len(obs_names(cfg)) if n_obs is None else int(n_obs)
    pack = pack or (lambda u: u)
    unpack = unpack or (lambda s: s)

    def append_acc(row, rate):
        return torch.cat([row.reshape(rate.numel(), -1),
                          rate.reshape(-1, 1)], 1).reshape(-1)

    def step(st, base_key, sweep_idx):
        """-> (state, the sweep's rate or None)."""
        out = sweep(st, base_key, sweep_idx)
        return out if with_acc else (out, None)

    def run_packed(st, base_key, sweep0, n_sweeps, measure_every):
        me = int(measure_every or 0)
        n_blocks = n_sweeps // me if me else 0
        rows = []
        for b in range(n_blocks):
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(me):
                s = sweep0 + b * me + i
                if profile.ON:
                    profile.begin("runner.sweep", s)
                st, rate = step(st, base_key, s)
                if with_acc:
                    acc = acc + rate
                if profile.ON:
                    profile.end("runner.sweep")
            if profile.ON:
                profile.begin("runner.measure", s)
            row = measure_state(st)
            if with_acc:
                row = append_acc(row, acc / me)
            if profile.ON:
                profile.end("runner.measure")
            rows.append(row)
        for i in range(n_blocks * me, n_sweeps):
            if profile.ON:
                profile.begin("runner.sweep", sweep0 + i)
            st, _ = step(st, base_key, sweep0 + i)
            if profile.ON:
                profile.end("runner.sweep")
        obs = (torch.stack(rows) if rows
               else torch.zeros((0, n_obs), dtype=torch.float32,
                                device=device))
        return st, obs

    def run(u, base_key, sweep0, n_sweeps, measure_every):
        st, obs = run_packed(pack(u), base_key, sweep0, n_sweeps,
                             measure_every)
        return unpack(st), obs

    run.packed = run_packed
    run.pack = pack
    run.unpack = unpack
    return run
