"""Simulation orchestrator — port of the library surface of qcdgpu_tpu.sim.

    sim = Simulation(cfg)                # on the card; device="cpu" opts out
    sim.warmup().thermalize(n)
    obs = sim.run(n, measure_every)      # numpy [n // me, len(obs_names)]
    sim.measure(); sim.analysis(); sim.unitarity_defect()
    sim.save(path); sim = Simulation.load(path)   # exact resume

``resolve_engine(cfg)`` (config.py, the reference's rules) picks the
engine, and ``make_chunk_runner`` builds its runner:

* the packed engine ("pallas", ops/cuda/engine.py): the state is the
  packed 8-tuple on ``device``, held as the runner's shards, and the stage
  and reunitarization kernels update it in place.  The canonical complex
  field [4, N, N, X, Y, Z, T] is built only when something asks for it
  (``sim.u``, ``unitarity_defect``).  With ``rng_mode="prngcl:<gen>"`` the
  Simulation also owns the packed PRNGCL stream state (``stream_state``),
  which the drawing stages advance in place.  With ``cfg.mesh = (mx, my,
  1, 1)`` the lattice is split over X/Y shards (ops/cuda/sharded.py), all
  on ``device`` unless ``devices`` spreads them; ``us``, ``u`` and
  ``stream_state`` then gather the shards into the global state (without
  a mesh the one shard is the whole lattice).  ``save`` writes the packed
  directory.
* the dense engine ("xla", dense.py: complex128, engine="xla", a mesh
  that splits Z or T): the state is the complex field itself, in
  cfg.dtype, and in stream mode the dense stream state; on any 4D mesh
  the field is cut into halo-padded shards and the words into their
  interiors (dense_sharded.py), all on ``device`` unless ``devices``
  spreads them.  ``us`` and ``u`` are the field (gathered on a mesh),
  ``save`` writes the reference's single .npz (links_ri and the dense
  stream state).

Checkpoints (utils/checkpoint.py) are the JAX package's: ``load`` reads
either format from either package; a stream state of the other engine's
layout is refused, as the reference refuses it.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from . import dense
from .config import SimConfig, resolve_engine, stream_mode_name
from .dense import (cold_start, hot_start, make_sweep_fn,  # noqa: F401
                    stream_hot_start)
from .ops import rng, sun
from .ops.cuda import engine
from .ops.measure import measure_obs_names, obs_names
from .utils import profile

NDIM = 4


def make_chunk_runner(cfg: SimConfig, device="cuda", devices=None):
    """The runner of the engine cfg resolves to (qcdgpu_tpu/sim.py:309-373):
    the dense engine's (dense.make_chunk_runner) or the packed engine's
    (ops/cuda/engine.make_chunk_runner), its shards on ``devices``."""
    if resolve_engine(cfg) == "xla":
        return dense.make_chunk_runner(cfg, device, devices)
    return engine.make_chunk_runner(cfg, device, devices)


class Simulation:
    """Owns (links, base key, sweep counter) on one device, and in PRNGCL
    stream mode the stream state, in the layout of the engine cfg resolves
    to (``self.engine``: "pallas" packed, "xla" dense).

    ``device`` is 'cuda' (the default) or 'cpu'; 'cuda' without a card
    raises — there is no silent fallback to the CPU.  ``init_u``
    (canonical complex field) or ``init_us`` (packed 8-tuple) start from
    a given state — numpy arrays from the JAX package or tensors — with
    fresh streams from cfg.seed in stream mode; otherwise cfg.start picks a
    cold or hot start (a stream-mode hot start draws from the streams).
    ``devices``: where the shards of cfg.mesh go (default: all on
    ``device``).  ``_stream_rst``: the stream state, as numpy in the
    reference's keys and dtypes, that goes with ``init_u`` / ``init_us``
    (``load``); a layout of the other engine is refused.
    """

    def __init__(self, cfg: SimConfig, init_u=None, init_us=None, *,
                 device="cuda", devices=None, _stream_rst=None):
        self.cfg = cfg
        self.device = engine.resolve_device(device)
        self.base_key = rng.make_base_key(cfg.seed)
        self._run = make_chunk_runner(cfg, self.device, devices)
        self.engine = self._run.engine
        self.sweep_idx = 0
        self.obs_history: list[np.ndarray] = []
        self._gen = stream_mode_name(cfg.rng_mode)
        self._rst = None  # stream state ({} with threefry)
        if init_u is not None:
            self._us = self._run.adopt(init_u)
        elif init_us is not None:
            self._us = self._run.adopt(tuple(init_us))
        elif cfg.start == "hot" and self._gen:
            self._us, self._rst = self._run.packed_stream_hot_start()
        elif cfg.start == "hot":
            self._us = self._run.packed_hot_start(self.base_key)
        elif cfg.start == "continue":
            raise ValueError(
                "start='continue' resumes a checkpoint: use "
                "Simulation.load(path) (CLI: `resume`) or pass init_u"
            )
        else:
            self._us = self._run.packed_cold_start()
        if _stream_rst is not None and self._gen:
            self._rst = self._run.adopt_streams(_stream_rst)
        if self._rst is None:
            self._rst = self._run.make_stream_state0()

    # -- state ------------------------------------------------------------
    @property
    def us(self):
        """The engine-layout links: the packed 8-tuple, or on the dense
        engine the complex field: the live state, updated in place by the
        sweeps, or on a mesh the shards gathered into a new one."""
        return self._run.gather(self._state())[0]

    @property
    def stream_state(self):
        """The stream state as numpy in the reference's keys and dtypes
        (packed: words uint32 / int32 / float32, nb, ptr int32, c float32;
        dense: the reference's dense keys), or None outside stream mode."""
        if self._gen is None:
            return None
        return self._run.stream_to_numpy(self._run.gather(self._state())[1])

    def _state(self):
        return self._us, self._rst

    def _adopt(self, st):
        self._us, self._rst = st

    @property
    def u(self):
        """Canonical complex field [4, N, N, X, Y, Z, T] (a new tensor):
        complex64 on the packed engine, cfg.dtype on the dense one."""
        return self._run.unpack(self._state())

    def sync(self) -> float:
        """Wait for the queued work of every device that holds a shard
        (no-op on the CPU); returns the seconds spent waiting."""
        t0 = time.perf_counter()
        for dev in dict.fromkeys(self._run.grid.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

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
        self.sync()
        return self

    def thermalize(self, n: Optional[int] = None):
        if profile.ON:
            profile.begin("sim.thermalize")
        n = self.cfg.sweeps_therm if n is None else n
        if n > 0:
            st, _ = self._run.packed(self._state(), self.base_key,
                                     self.sweep_idx, n, 0)
            self._adopt(st)
            self.sweep_idx += n
        if profile.ON:
            profile.end("sim.thermalize")
        return self

    def run(self, n: Optional[int] = None,
            measure_every: Optional[int] = None,
            ckpt_path: Optional[str] = None, progress_every: int = 0,
            progress=None):
        """Production sweeps; returns the observable series
        [n_meas, len(obs_names)] as numpy (this waits for the device).

        With ckpt_path and cfg.ckpt_every > 0 the full state is saved every
        ckpt_every sweeps; progress(sweeps_done, n, last_row_or_None) is
        called every progress_every sweeps.  Both cadences are rounded up
        to whole measurement blocks, so the series does not depend on
        them (the reference's chunking, qcdgpu_tpu/sim.py:589-643)."""
        if profile.ON:
            profile.begin("sim.run")
        n = self.cfg.sweeps if n is None else n
        me = self.cfg.meas_every if measure_every is None else measure_every
        every = self.cfg.ckpt_every if ckpt_path else 0
        if every and me:
            every = -(-every // me) * me
        if progress_every and me:
            progress_every = -(-progress_every // me) * me
        rows = []
        done = 0
        while done < n:
            step = n - done
            if every:
                step = min(step, every - done % every)
            if progress_every:
                step = min(step, progress_every - done % progress_every)
            st, obs = self._run.packed(self._state(), self.base_key,
                                       self.sweep_idx, step, me)
            self._adopt(st)
            self.sweep_idx += step
            done += step
            if profile.ON:
                profile.begin("sim.rows_to_host")
            obs = obs.cpu().numpy()
            if profile.ON:
                profile.end("sim.rows_to_host")
            if obs.size:
                rows.append(obs)
                self.obs_history.append(obs)
            if every and done % every == 0:
                self.save(ckpt_path)
            if progress is not None:
                progress(done, n, obs[-1] if obs.size else None)
        out = (np.concatenate(rows, axis=0) if rows
               else np.zeros((0, len(obs_names(self.cfg))), np.float32))
        if profile.ON:
            profile.end("sim.run")
        return out

    # -- measurement ------------------------------------------------------
    def measure(self) -> dict:
        """One measurement of the live state: the standard six (through
        the packed kernels, or the dense engine's measurement), then cfg's
        extended columns."""
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
        """Write the checkpoint at ``path``, readable by the JAX package's
        load_state too: the packed directory (links, and the packed stream
        state in stream mode), or on the dense engine the single .npz of
        the canonical field in cfg.dtype and the dense stream state."""
        from .utils.checkpoint import save_state

        if profile.ON:
            profile.begin("sim.save")
        if self.engine == "xla":
            save_state(path, self.cfg, self.u, self.sweep_idx,
                       self.obs_history, rng_stream=self.stream_state)
        else:
            save_state(path, self.cfg, None, self.sweep_idx,
                       self.obs_history, rng_stream=self.stream_state,
                       us=self.us)
        if profile.ON:
            profile.end("sim.save")

    @classmethod
    def load(cls, path: str, *, device="cuda", devices=None, mesh=None):
        """Resume a checkpoint of either format, written by either package;
        the chain continues bit for bit (a TPU ``hw`` run's links are
        exact, and it continues on Philox).  ``mesh`` lays the resumed run
        out on another mesh than the saved configuration's (the file holds
        the global state; the reference re-applies cfg.mesh on load).  A
        stream state of the other engine's layout (dense vs packed) is
        refused."""
        from .utils.checkpoint import load_state

        cfg, u, sweep_idx, obs_history, rng_stream = load_state(path)
        if mesh is not None:
            cfg = cfg.replace(mesh=tuple(mesh))
        if stream_mode_name(cfg.rng_mode) is not None and rng_stream is None:
            raise ValueError(
                "checkpoint has no PRNGCL stream state but the config "
                f"runs rng_mode={cfg.rng_mode!r}; cannot resume exactly"
            )
        kw = dict(device=device, devices=devices, _stream_rst=rng_stream)
        if isinstance(u, tuple):
            sim = cls(cfg, init_us=u, **kw)
        else:
            sim = cls(cfg, init_u=u, **kw)
        sim.sweep_idx = sweep_idx
        sim.obs_history = obs_history
        return sim
