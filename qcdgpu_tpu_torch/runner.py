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


def build_chunk_runner(cfg, sweep, measure_state, pack=None, unpack=None,
                       with_acc=False):
    """sweep(state, key, sweep_idx) -> state (may update in place), or
    (state, rate) with with_acc, rate an f32 0-d tensor; state is
    (link 8-tuple, stream state);
    measure_state(state) -> f32 row [n_obs] (without the tracked column)
    on the state's device;
    pack / unpack: canonical complex link field <-> engine state."""
    n_obs = len(obs_names(cfg))
    pack = pack or (lambda u: u)
    unpack = unpack or (lambda s: s)

    def step(st, base_key, sweep_idx):
        """-> (state, the sweep's rate or None)."""
        out = sweep(st, base_key, sweep_idx)
        return out if with_acc else (out, None)

    def run_packed(st, base_key, sweep0, n_sweeps, measure_every):
        device = st[0][0].device
        me = int(measure_every or 0)
        n_blocks = n_sweeps // me if me else 0
        rows = []
        for b in range(n_blocks):
            acc = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(me):
                st, rate = step(st, base_key, sweep0 + b * me + i)
                if with_acc:
                    acc = acc + rate
            row = measure_state(st)
            if with_acc:
                row = torch.cat([row, (acc / me).reshape(1)])
            rows.append(row)
        for i in range(n_blocks * me, n_sweeps):
            st, _ = step(st, base_key, sweep0 + i)
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
