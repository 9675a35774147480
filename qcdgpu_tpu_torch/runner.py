"""Chunk runner: sweeps and measurements over a packed state.

Port of qcdgpu_tpu/runner.py with the same external contract,

    run(u, base_key, sweep0, n_sweeps, measure_every) -> (u', obs)
    run.packed(state, base_key, sweep0, n_sweeps, measure_every)
        -> (state', obs)

with obs a ``[n_sweeps // measure_every, n_obs]`` float32 series on the
state's device.  PyTorch runs eagerly, so where the reference compiled
bounded fori_loop programs this is a plain Python loop: each sweep enqueues
its kernels and returns, measurement rows stay on the device, and nothing
waits for the device until the caller reads the series.
"""

from __future__ import annotations

import torch

from .ops.measure import obs_names


def build_chunk_runner(cfg, sweep, measure_state, pack=None, unpack=None):
    """sweep(state, key, sweep_idx) -> state (may update in place);
    measure_state(state) -> f32 row [n_obs] on the state's device;
    pack / unpack: canonical complex link field <-> engine state."""
    n_obs = len(obs_names(cfg))
    pack = pack or (lambda u: u)
    unpack = unpack or (lambda s: s)

    def run_packed(st, base_key, sweep0, n_sweeps, measure_every):
        device = st[0].device
        me = int(measure_every or 0)
        n_blocks = n_sweeps // me if me else 0
        rows = []
        for b in range(n_blocks):
            for i in range(me):
                st = sweep(st, base_key, sweep0 + b * me + i)
            rows.append(measure_state(st))
        for i in range(n_blocks * me, n_sweeps):
            st = sweep(st, base_key, sweep0 + i)
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
