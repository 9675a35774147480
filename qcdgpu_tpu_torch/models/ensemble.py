"""The beta-scan ensemble: C independent Markov chains, one per coupling,
on one lattice — port of qcdgpu_tpu/models/ensemble.py (its Pallas chain
tier, ensemble.py:120-131).

    scan = BetaScan(baseline_config(3), betas)   # on the card
    scan.warmup().thermalize(n)
    obs = scan.run(n, measure_every)   # numpy [C, n // me, len(obs_names)]
    scan.save(path); scan = BetaScan.load(path)  # exact resume

The state is chain-stacked (ops/cuda/engine.py): each of the 8 packed
arrays is ``[C, 2, N, 2, X, Y, Z*T/2]``, with the couplings (f32 [C]) and
base keys (u32 [C, 2]) beside it on the device.  A sweep launches each
stage once for all chains (K1c), each chain under its own coupling and key;
reunitarization (K2c) and measurement (K3c/K4c) batch the chains the same
way.  Chain c draws under ``rng.make_base_key(cfg.seed + 1000 c)`` and is,
bit for bit, the single-chain ``Simulation`` of seed ``cfg.seed + 1000 c``
and beta ``betas[c]``.

Supported: threefry and rng_mode "hw" (Philox), SU(2) and SU(3), every
update algorithm, the tracked statistics (one column per chain), cold and
hot starts, an unsharded lattice on one device.  PRNGCL streams (M11), a
lattice mesh or chains over several cards (chain_mesh > 1; M15) raise
NotImplementedError; chain_mesh 0 (auto) resolves to 1.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..config import SimConfig
from ..ops import rng
from ..ops.cuda import engine
from ..ops.measure import obs_names
from ..runner import build_chunk_runner


def make_ensemble_runner(cfg: SimConfig, n_chains: int, device="cuda"):
    """Runner over C = n_chains chains with per-chain beta and key, on the
    shared chunk runner: run.packed(state, None, sweep0, n, me).  State is
    (us, betas, keys): the chain-stacked 8-tuple, f32 [C] and int32 [C, 2]
    (u32 bits) on ``device``; the runner's key argument is unused (each
    chain carries its own).  Rows are the C chains' rows flattened
    chain-major, [C * n_obs], with one tracked column per chain.
    run.packed_cold_start() and run.packed_hot_start(keys) build
    chain-stacked starts."""
    engine.check_supported_chains(cfg)
    dev = engine.resolve_device(device)
    dims = tuple(cfg.dims)
    with_acc = engine.tracks(cfg)
    n_obs = len(obs_names(cfg))
    chain_sweep = engine.make_chain_sweep(cfg)

    def sweep(st, _key, sweep_idx):
        us, betas, keys = st
        out = chain_sweep(us, betas, keys, sweep_idx)
        if with_acc:
            return (out[0], betas, keys), out[1]
        return out, betas, keys

    def measure_state(st):
        return engine.measure_chains(st[0], dims).reshape(-1)

    run = build_chunk_runner(cfg, sweep, measure_state, with_acc=with_acc,
                             device=dev, n_obs=n_chains * n_obs)
    run.packed_cold_start = lambda: engine.packed_cold_start_chains(
        cfg, n_chains, dev)
    run.packed_hot_start = lambda keys: engine.packed_hot_start_chains(
        cfg, keys, dev)
    return run


def betas_tensor(betas, device):
    """Couplings as the kernels take them: f32 [C] on ``device``."""
    return torch.as_tensor(np.asarray(betas, np.float32)).to(device)


def keys_tensor(keys, device):
    """u32 base keys [C, 2] as the kernels take them: their int32 bits."""
    bits = np.ascontiguousarray(np.asarray(keys, np.uint32)).view(np.int32)
    return torch.from_numpy(bits.copy()).to(device)


class BetaScan:
    """Finite-temperature / coupling scan: one chain per beta on a shared
    lattice; the Polyakov-loop series across the grid locates the
    deconfinement transition (BASELINE config 3: 24^3 x 6).

    ``us`` is the live chain-stacked packed state (the kernels update it in
    place) and ``u`` the canonical complex fields [C, 4, N, N, X, Y, Z, T],
    as ``Simulation.us`` / ``Simulation.u``; ``betas`` (f32 [C]), ``keys``
    (u32 [C, 2], chain c's base key) and ``sweep_idx`` are the rest of the
    state.  ``device`` is 'cuda' (the default) or 'cpu'; 'cuda' without a
    card raises."""

    def __init__(self, cfg: SimConfig, betas, chain_mesh: int = 1, *,
                 device="cuda", _init=None):
        """chain_mesh: chains over this many devices; 0 (auto) and 1 run
        every chain on ``device`` (more than 1 is M15).  _init: (u, keys,
        sweep_idx) of a checkpoint (load())."""
        self.cfg = cfg
        self.chain_mesh = int(chain_mesh) or 1
        engine.check_supported_chains(cfg, self.chain_mesh)
        self.device = engine.resolve_device(device)
        self.betas = np.asarray(betas, np.float32).reshape(-1)
        c = len(self.betas)
        if c < 1:
            raise ValueError("a scan needs at least one beta")
        self._n_obs = len(obs_names(cfg))
        self._run = make_ensemble_runner(cfg, c, self.device)
        self.sweep_idx = 0
        if _init is not None:
            u, keys, self.sweep_idx = _init
            self.keys = np.asarray(keys, np.uint32).reshape(c, 2)
            us = engine.split_links_chains(
                torch.as_tensor(np.asarray(u, np.complex64)).to(self.device))
        else:
            self.keys = np.array([rng.make_base_key(cfg.seed + 1000 * i)
                                  for i in range(c)], np.uint32)
            if cfg.start == "hot":
                us = self._run.packed_hot_start(self.keys.tolist())
            elif cfg.start == "continue":
                raise ValueError(
                    "start='continue' resumes a checkpoint: use "
                    "BetaScan.load(path) (CLI: `scan --resume-state`)")
            else:
                us = self._run.packed_cold_start()
        self._st = (us, betas_tensor(self.betas, self.device),
                    keys_tensor(self.keys, self.device))

    # -- state ------------------------------------------------------------
    @property
    def us(self):
        """The chain-stacked packed 8-tuple (live; updated in place)."""
        return self._st[0]

    @property
    def u(self):
        """Canonical complex64 fields [C, 4, N, N, X, Y, Z, T] (new)."""
        return engine.join_links_chains(self.us, tuple(self.cfg.dims))

    @property
    def obs_names(self):
        return obs_names(self.cfg)

    def sync(self) -> float:
        """Wait for the device's queued work (no-op on the CPU); returns
        the seconds spent waiting."""
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    # -- simulation -------------------------------------------------------
    def warmup(self, measure_every=None):
        """Build the kernels and run one sweep, then one measured block, on
        a CLONE of the links: the kernels update in place, so the live
        chains stay exactly as they were (Simulation.warmup)."""
        me = self.cfg.meas_every if measure_every is None else measure_every
        us, betas, keys = self._st
        scratch = (tuple(a.clone() for a in us), betas, keys)
        scratch, _ = self._run.packed(scratch, None, self.sweep_idx, 1, 0)
        if me:
            self._run.packed(scratch, None, self.sweep_idx, me, me)
        self.sync()
        return self

    def thermalize(self, n=None):
        n = self.cfg.sweeps_therm if n is None else n
        if n > 0:
            self._st, _ = self._run.packed(self._st, None, self.sweep_idx,
                                           n, 0)
            self.sweep_idx += n
        return self

    def run(self, n=None, measure_every=None):
        """Production sweeps; returns numpy [C, n // me, len(obs_names)]
        (this waits for the device)."""
        n = self.cfg.sweeps if n is None else n
        me = self.cfg.meas_every if measure_every is None else measure_every
        self._st, obs = self._run.packed(self._st, None, self.sweep_idx, n,
                                         me)
        self.sweep_idx += n
        obs = obs.cpu().numpy()  # [n_meas, C * n_obs]
        c = len(self.betas)
        return obs.reshape(obs.shape[0], c, self._n_obs).transpose(1, 0, 2)

    # -- checkpoint -------------------------------------------------------
    def save(self, path: str):
        """The reference's ``betascan`` .npz (utils/checkpoint.py), which
        qcdgpu_tpu's BetaScan.load reads too.  The random source is
        counter-based, so (keys, sweep_idx) is the whole random state."""
        from ..utils.checkpoint import save_betascan

        save_betascan(path, self.cfg, self.betas, self.keys, self.u,
                      self.sweep_idx)

    @classmethod
    def load(cls, path: str, chain_mesh: int = 1, *, device="cuda"):
        """Resume a ``betascan`` checkpoint written by either package; every
        chain continues bit for bit."""
        from ..utils.checkpoint import load_betascan

        cfg, betas, keys, u, sweep_idx = load_betascan(path)
        return cls(cfg, betas, chain_mesh, device=device,
                   _init=(u, keys, sweep_idx))
