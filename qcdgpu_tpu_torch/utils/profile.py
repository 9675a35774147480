"""Profiling hooks — port of qcdgpu_tpu/utils/profile.py.

``trace(dir)`` records a torch.profiler trace of the work inside it (host
calls and, on a card, every kernel launch with its device time) and
writes it as a Chrome trace, ``<dir>/trace.json`` (chrome://tracing or
Perfetto): the counterpart of the reference's jax.profiler trace behind
``--profile``.  ``PhaseTimer`` sums the host wall-clock of named phases
for a results record, as the reference's does.
"""

from __future__ import annotations

import contextlib
import os
import time


@contextlib.contextmanager
def trace(logdir: str | None):
    """Record a torch.profiler trace into ``logdir``/trace.json (no-op
    when None)."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class PhaseTimer:
    """Coarse per-phase wall-clock aggregation for the results record."""

    def __init__(self):
        self.phases: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def as_dict(self, round_to: int = 3) -> dict:
        return {k: round(v, round_to) for k, v in self.phases.items()}
