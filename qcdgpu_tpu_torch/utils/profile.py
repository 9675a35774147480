"""Profiling hooks — port of qcdgpu_tpu/utils/profile.py.

``trace(dir)`` records a torch.profiler trace of the work inside it (host
calls and, on a card, every kernel launch with its device time) and
writes it as a Chrome trace, ``<dir>/trace.json`` (chrome://tracing or
Perfetto): the counterpart of the reference's jax.profiler trace behind
``--profile``.
"""

from __future__ import annotations

import contextlib
import os


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

