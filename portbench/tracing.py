"""The device trace of a traced sub-window, reduced to what the per-layer
readers and the result line take.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` and returns its
chrome-trace events and the window's bounds on the trace's clock;
``Trace`` clips the device events (kernels, copies, memsets) to the
window and gives their union, the busiest operations and the longest
idle gaps with what the host was doing meanwhile.  The idle share is 1 -
union / window: events are merged, not summed (chip_smoke.py's
``profile_window`` sums them).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function")


def profiled(fn):
    """(fn's result, chrome-trace events, window start, window end) of fn
    run under torch.profiler.  On a card only the device's activity is
    traced (CUPTI: kernels, copies, memsets and the runtime calls that
    launched them); PyTorch's own op events are left out, since recording
    them slows the host loop of a measured sweep by a third.  The window
    is fn's call, from the host clock, in the trace's microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [ProfilerActivity.CPU])
    with profile(activities=acts) as prof:
        t0 = time.time_ns()
        out = fn()
        t1 = time.time_ns()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    base = trace.get("baseTimeNanoseconds")
    if base is None:
        raise ValueError("the trace has no baseTimeNanoseconds: its clock "
                         "cannot be matched to the window")
    return out, trace["traceEvents"], (t0 - base) / 1e3, (t1 - base) / 1e3


def union(intervals):
    """Merged [start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The device events of one traced window (times in microseconds)."""

    def __init__(self, events, t0, t1):
        self.t0, self.t1 = float(t0), float(t1)
        self.device = []
        for e in events:
            if e.get("cat") not in DEVICE_CATS or "dur" not in e:
                continue
            s = max(float(e["ts"]), self.t0)
            end = min(float(e["ts"]) + float(e["dur"]), self.t1)
            if end > s:
                self.device.append({"name": e["name"], "cat": e["cat"],
                                    "ts": s, "dur": end - s})
        self.host = [e for e in events if e.get("cat") in HOST_CATS
                     and "dur" in e]
        self.busy = union((e["ts"], e["ts"] + e["dur"]) for e in self.device)

    @property
    def window_ms(self):
        return (self.t1 - self.t0) / 1e3

    @property
    def busy_ms(self):
        return sum(e - s for s, e in self.busy) / 1e3

    def device_ms(self, pattern=None):
        """Summed device ms of the events whose name matches ``pattern``
        (a compiled regex; every event when None)."""
        return sum(e["dur"] for e in self.device
                   if pattern is None or pattern.search(e["name"])) / 1e3

    def count(self, pattern=None):
        return sum(1 for e in self.device
                   if pattern is None or pattern.search(e["name"]))

    def top_ops(self, k=10):
        """[[name, seconds], ...]: the k device operations that took most
        time, summed by name."""
        by = {}
        for e in self.device:
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] / 1e6
        return [[n, s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k=10):
        """[[host activity, seconds], ...]: the device's idle time in the
        window, gap by gap, summed by what the host was doing at each
        gap's middle (the innermost host event there), the k largest."""
        edges = [self.t0] + [v for iv in self.busy for v in iv] + [self.t1]
        host = sorted(self.host, key=lambda h: float(h["ts"]))
        starts = [float(h["ts"]) for h in host]
        by = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            i = bisect.bisect_right(starts, mid)
            # the events that start before the middle; the innermost one
            # that covers it starts among the last few
            inner = [h for h in host[max(0, i - 256):i]
                     if mid <= float(h["ts"]) + h["dur"]]
            name = (min(inner, key=lambda h: h["dur"])["name"] if inner
                    else "host outside any traced call")
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return [[n, s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]
