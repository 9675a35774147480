"""Simulation orchestrator — port of the library surface of qcdgpu_tpu.sim.

    sim = Simulation(cfg)                # on the card; device="cpu" opts out
    sim.warmup().thermalize(n)
    obs = sim.run(n, measure_every)      # numpy [n // me, len(obs_names)]
    sim.measure(); sim.analysis(); sim.unitarity_defect()

The state is the packed 8-tuple on ``device`` (ops/cuda/engine.py), and the
stage and reunitarization kernels update it in place.  The canonical
complex field [4, N, N, X, Y, Z, T] is built only when something asks for
it (``sim.u``, ``unitarity_defect``).  With ``rng_mode="prngcl:<gen>"`` the
Simulation also owns the packed PRNGCL stream state (``stream_state``),
which the drawing stages advance in place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .config import SimConfig, stream_mode_name
from .ops import prng_streams as streams
from .ops import rng, sun
from .ops.cuda import engine
from .ops.measure import measure_obs_names, obs_names

NDIM = 4


class Simulation:
    """Owns (packed links, base key, sweep counter) on one device, and in
    PRNGCL stream mode the packed stream state.

    ``device`` is 'cuda' (the default) or 'cpu'; 'cuda' without a card
    raises — there is no silent fallback to the CPU.  ``init_u``
    (canonical complex field) or ``init_us`` (packed 8-tuple) start from
    a given state — numpy arrays from the JAX package or tensors — with
    fresh streams from cfg.seed in stream mode; otherwise cfg.start picks a
    cold or hot start (a stream-mode hot start draws from the streams).
    """

    def __init__(self, cfg: SimConfig, init_u=None, init_us=None, *,
                 device="cuda"):
        self.cfg = cfg
        self.device = engine.resolve_device(device)
        self.base_key = rng.make_base_key(cfg.seed)
        self._run = engine.make_chunk_runner(cfg, self.device)
        self.sweep_idx = 0
        self.obs_history: list[np.ndarray] = []
        self._gen = stream_mode_name(cfg.rng_mode)
        self._rst = None  # packed stream state ({} with threefry)
        if init_u is not None:
            self._us = self._adopt_input(init_u)
        elif init_us is not None:
            self._us = self._adopt_input(tuple(init_us))
        elif cfg.start == "hot" and self._gen:
            self._us, self._rst = self._run.packed_stream_hot_start()
        elif cfg.start == "hot":
            self._us = self._run.packed_hot_start(self.base_key)
        elif cfg.start == "continue":
            raise ValueError(
                "start='continue' resumes a checkpoint: pass init_u or "
                "init_us (checkpoint loading is not ported yet, M8)"
            )
        else:
            self._us = self._run.packed_cold_start()
        if self._rst is None:
            self._rst = self._run.make_stream_state0()

    def _adopt_input(self, arrays):
        if isinstance(arrays, tuple):
            if all(isinstance(a, torch.Tensor) for a in arrays):
                return tuple(a.to(self.device, torch.float32).contiguous()
                             .clone() for a in arrays)
            return engine.from_reference(arrays, self.device)
        if isinstance(arrays, torch.Tensor):
            return engine.split_links(arrays.to(self.device,
                                                torch.complex64))
        return engine.from_reference(arrays, self.device)

    # -- state ------------------------------------------------------------
    @property
    def us(self):
        """The live packed state (updated in place by the sweeps)."""
        return self._us

    @property
    def stream_state(self):
        """The packed PRNGCL stream state as numpy in the reference's
        dtypes (words uint32 / int32 / float32; nb, ptr int32; c float32),
        or None outside stream mode."""
        if self._gen is None:
            return None
        out = {}
        for k, v in self._rst.items():
            if isinstance(v, torch.Tensor):
                out[k] = streams.words_to_numpy(self._gen, v)
            elif k.startswith("c_"):
                out[k] = np.float32(v)
            else:
                out[k] = np.int32(v)
        return out

    def _state(self):
        return self._us, self._rst

    def _adopt(self, st):
        self._us, self._rst = st

    @property
    def u(self):
        """Canonical complex64 field [4, N, N, X, Y, Z, T] (a new tensor)."""
        return self._run.unpack(self._state())

    def sync(self):
        """Wait for the queued device work (no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    # -- simulation -------------------------------------------------------
    def warmup(self):
        """Build the kernels and run the programs thermalize()/run() use —
        one sweep, then one measured block — on a CLONE of the state (links
        and stream words; the stream scalars are plain numbers).  The
        kernels update in place, so running on the live state would advance
        the chain; the clone leaves it exactly as it was."""
        me = self.cfg.meas_every
        scratch = engine.clone_state(self._state())
        scratch, _ = self._run.packed(scratch, self.base_key, self.sweep_idx,
                                      1, 0)
        if me:
            self._run.packed(scratch, self.base_key, self.sweep_idx, me, me)
        return self.sync()

    def thermalize(self, n: Optional[int] = None):
        n = self.cfg.sweeps_therm if n is None else n
        if n > 0:
            st, _ = self._run.packed(self._state(), self.base_key,
                                     self.sweep_idx, n, 0)
            self._adopt(st)
            self.sweep_idx += n
        return self

    def run(self, n: Optional[int] = None,
            measure_every: Optional[int] = None):
        """Production sweeps; returns the observable series
        [n_meas, len(obs_names)] as numpy (this waits for the device)."""
        n = self.cfg.sweeps if n is None else n
        me = self.cfg.meas_every if measure_every is None else measure_every
        st, obs = self._run.packed(self._state(), self.base_key,
                                   self.sweep_idx, n, me)
        self._adopt(st)
        self.sweep_idx += n
        obs = obs.cpu().numpy()
        if obs.size:
            self.obs_history.append(obs)
        return obs

    # -- measurement ------------------------------------------------------
    def measure(self) -> dict:
        """One measurement of the live state through the packed kernels."""
        vals = self._run.measure_packed(self._us).cpu().numpy()
        return dict(zip(measure_obs_names(self.cfg), vals.tolist()))

    @property
    def obs_names(self):
        return obs_names(self.cfg)

    def unitarity_defect(self) -> float:
        """max |U U^dag - I| over all links of the canonical field."""
        u = self.u
        return float(torch.max(torch.stack(
            [sun.unitarity_defect(u[m]) for m in range(NDIM)])))

    # -- analysis ---------------------------------------------------------
    def analysis(self):
        from .utils.stats import analyze_series

        if not self.obs_history:
            return {}
        obs = np.concatenate(self.obs_history, axis=0)
        return {name: analyze_series(obs[:, k])
                for k, name in enumerate(obs_names(self.cfg))}

    # -- checkpoint -------------------------------------------------------
    def save(self, path: str):
        raise NotImplementedError(
            "checkpoints are not ported yet (ROADMAP M8)")

    @classmethod
    def load(cls, path: str):
        raise NotImplementedError(
            "checkpoints are not ported yet (ROADMAP M8)")
