"""Profiling hooks — port of qcdgpu_tpu/utils/profile.py, and the port's
span recorder.

``trace(dir)`` records a torch.profiler trace of the work inside it (host
calls and, on a card, every kernel launch with its device time) and writes
it as a Chrome trace, ``<dir>/trace.json`` (chrome://tracing or Perfetto):
the counterpart of the reference's jax.profiler trace behind
``--profile``.  The recorder is on for the trace's duration, and its spans
go into the same file, on the trace's clock, as a track of their own
("qcdgpu_tpu_torch spans"), over the kernels they launched.

The span recorder is off by default.  ``recording()`` turns it on for a
``with`` block and yields the ``Recorder`` that keeps the spans in memory.
A span site is

    if profile.ON:
        profile.begin("k1.stage")
    ...
    if profile.ON:
        profile.end("k1.stage")

so that, off, a site costs one test of the module flag ``ON`` at each end
and builds nothing.  A span holds its name, its start and end in unix-epoch
ns (``time.time_ns()``, the clock of torch.profiler's Chrome trace, whose
``baseTimeNanoseconds`` maps it to the trace's microseconds), the span it
lies in, and the index of the sweep it belongs to.  The spans:

* ``sim.run``, ``sim.thermalize``: one call of ``Simulation`` /
  ``BetaScan`` ``run`` / ``thermalize``;
* ``sim.rows_to_host``: the series' copy to the host in ``run``;
* ``sim.save``: ``Simulation.save`` / ``BetaScan.save``;
* ``runner.sweep``: one sweep in the chunk runner (its stages, their keys,
  the reunitarization decision); its sweep index is the span's;
* ``runner.measure``: one row (``measure_state`` and the tracked column),
  under the index of the block's last sweep;
* ``k1.stage``, ``k2.reunit``, ``k3.plane_sums``, ``k4.polyakov_sums``:
  one call of the wrappers of ``ops/cuda/update.py``, ``reunit.py`` and
  ``measure.py`` (argument checks, the ctypes call), whichever branch it
  takes: one span per kernel launch on a card, the plain version on the
  CPU.

Spans come from one host thread, the one that drives the chain.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import NamedTuple

ON = False  # the span sites' flag: True only inside recording()
_rec = None  # the Recorder that begin() / end() write to while ON

TRACK = "qcdgpu_tpu_torch spans"


class Span(NamedTuple):
    name: str
    start: int  # unix-epoch ns
    end: int | None
    parent: int | None  # index of the enclosing span
    sweep: int | None  # sweep index, from the enclosing runner span


class Recorder:
    """The spans of one ``recording()`` block, in the order they opened."""

    def __init__(self, clock=time.time_ns):
        self.clock = clock
        self._spans = []  # [name, start, end, parent, sweep]
        self._open = []  # indices of the open spans, innermost last

    @property
    def spans(self):
        """Every span, ``parent`` its index here; ``end`` is None while it
        is open.  A span whose code raised closes with the span around it,
        or when recording ends."""
        return [Span(*s) for s in self._spans]

    def _close_open(self):
        t = self.clock()
        for i in self._open:
            self._spans[i][2] = t
        self._open.clear()

    def totals(self):
        """{name: {"count", "total_s", "self_s"}}: the calls of each span
        name, their summed duration, and the summed duration less the time
        their child spans cover."""
        child = [0] * len(self._spans)
        for _, start, end, parent, _ in self._spans:
            if end is not None and parent is not None:
                child[parent] += end - start
        out = {}
        for i, (name, start, end, _, _) in enumerate(self._spans):
            if end is None:
                continue
            t = out.setdefault(name, {"count": 0, "total_s": 0.0,
                                      "self_s": 0.0})
            t["count"] += 1
            t["total_s"] += (end - start) / 1e9
            t["self_s"] += (end - start - child[i]) / 1e9
        return out

    def chrome_events(self, base_ns):
        """The closed spans as Chrome-trace complete events on a trace's
        clock (``ts`` and ``dur`` in microseconds after ``base_ns``, the
        trace's ``baseTimeNanoseconds``), category ``user_annotation``,
        with ``args`` span (its index), parent and sweep, on a thread track
        of this process named TRACK (tid 1, which no real thread has)."""
        pid, tid = os.getpid(), 1
        out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": TRACK}}]
        for i, s in enumerate(self._spans):
            if s[2] is None:
                continue
            out.append({"ph": "X", "cat": "user_annotation", "name": s[0],
                        "pid": pid, "tid": tid, "ts": (s[1] - base_ns) / 1e3,
                        "dur": (s[2] - s[1]) / 1e3,
                        "args": {"span": i, "parent": s[3], "sweep": s[4]}})
        return out


@contextlib.contextmanager
def recording(clock=time.time_ns):
    """Turn the recorder on for the block; yields its Recorder.  ``clock``
    (unix-epoch ns) is for tests."""
    global ON, _rec
    if ON:
        raise RuntimeError("the span recorder is already on")
    rec = Recorder(clock)
    _rec, ON = rec, True
    try:
        yield rec
    finally:
        ON, _rec = False, None
        rec._close_open()


def begin(name, sweep=None):
    """Open span ``name`` inside the innermost open one (call only while
    ``ON``); ``sweep`` defaults to the enclosing span's."""
    rec = _rec
    parent = rec._open[-1] if rec._open else None
    if sweep is None and parent is not None:
        sweep = rec._spans[parent][4]
    rec._open.append(len(rec._spans))
    rec._spans.append([name, rec.clock(), None, parent, sweep])


def end(name):
    """Close the innermost open span ``name`` and any left open inside it
    (call only while ``ON``); nothing if none is open, as when recording
    began inside its call."""
    rec = _rec
    stack = rec._open
    for depth in range(len(stack) - 1, -1, -1):
        if rec._spans[stack[depth]][0] == name:
            t = rec.clock()
            for i in stack[depth:]:
                rec._spans[i][2] = t
            del stack[depth:]
            return


@contextlib.contextmanager
def trace(logdir: str | None):
    """Record a torch.profiler trace, with the program's spans, into
    ``logdir``/trace.json (no-op when None)."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with recording() as rec:
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        doc["traceEvents"] += rec.chrome_events(doc["baseTimeNanoseconds"])
    with open(path, "w") as f:
        json.dump(doc, f)
