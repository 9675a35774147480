"""The program's spans (qcdgpu_tpu_torch/utils/profile.py) on a traced
window's device trace, and the per-layer numbers of the host loop they give.

    python3 -m portbench.spans --workload su3_32.hb_hw --seed 7

runs one traced run of the cell as ``harness.run_cell`` runs it under
``--trace 1``, with ``tracing.profiled`` replaced by ``profiled`` below:
the program's recorder is on for the profiled window, and its spans,
mapped onto the trace's clock, join the trace's events as host events, so
that the line's ``breakdown.idle_gaps`` names the innermost program span
where the device waited.  It prints the result line with ``spans`` added:
the numbers below, the recorder's per-name totals (wall time, which holds
the launch queue's waits), the host's own time a sweep by span name
(``Spans.own_us``), the launch check of ``Spans.launch_check`` beside the
LAUNCHES counters' increase, and the traced window's ms a sweep (the recorder's on-cost, against the same
window of ``portbench/run.py --trace 1``).

The numbers (each None where the trace holds no program span or no device
event; times in the trace's microseconds):

* ``host_us_per_sweep``: the window's ``sim.run`` / ``sim.thermalize``
  spans, clipped to the window, less the union of the CUDA runtime and
  driver calls inside them, per sweep: the host's own Python a sweep;
* ``wrapper_us_per_launch``: the ``k1``-``k4`` wrapper spans less the
  runtime calls inside them, per span: the argument checks and ctypes path;
* ``host_loop_idle_share``: the device's idle time in the window where the
  host was inside a program span and outside every runtime or driver call,
  over the window, in %;
* ``measure_device_share``: the device time of the events whose launching
  runtime call (joined by ``correlation``) starts inside a
  ``runner.measure`` span, over the device time of every device event in
  the window, in %.

The harness does not run these yet: the benchmark's readers see only
``tracing.Trace``, and the recorder is on only here (PERF.md, Open
questions).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import sys
import tempfile
import time
from unittest import mock

from . import tracing

RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
TOP = ("sim.run", "sim.thermalize")
WRAPPERS = ("k1.stage", "k2.reunit", "k3.plane_sums", "k4.polyakov_sums")
# the kernels each wrapper launches (K3 / K4 end with the finish pass)
KERNELS = {
    "k1.stage": re.compile(r"stage(_chains)?_kernel"),
    "k2.reunit": re.compile(r"reunit_su\d_kernel"),
    "k3.plane_sums": re.compile(r"plane_sums(_tile)?_kernel|finish_sums"),
    "k4.polyakov_sums": re.compile(r"polyakov_sums_kernel|finish_sums"),
}


def profiled(fn, info):
    """``tracing.profiled(fn)`` with the program's recorder on for fn's
    call: (fn's result, the trace's events with the spans added as
    ``user_annotation`` host events, window start, window end), the spans
    mapped onto the trace's clock by its baseTimeNanoseconds as the
    window's bounds are.  The dict ``info`` receives the recorder's
    per-name totals and the LAUNCHES counters' increase over fn's call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from qcdgpu_tpu_torch.utils import profile as program

    acts = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
            else [ProfilerActivity.CPU])
    with program.recording() as rec:
        with profile(activities=acts) as prof:
            n0 = launches()
            t0 = time.time_ns()
            out = fn()
            t1 = time.time_ns()
            n1 = launches()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    base = trace.get("baseTimeNanoseconds")
    if base is None:
        raise ValueError("the trace has no baseTimeNanoseconds: its clock "
                         "cannot be matched to the window")
    info.update(totals=rec.totals(), launches=n1 - n0)
    events = trace["traceEvents"] + rec.chrome_events(base)
    return out, events, (t0 - base) / 1e3, (t1 - base) / 1e3


def launches():
    """The kernel wrappers' LAUNCHES counters, summed."""
    from qcdgpu_tpu_torch.ops.cuda import measure, reunit, update

    return sum(sum(m.LAUNCHES.values()) for m in (update, reunit, measure))


class Spans:
    """A traced window's program spans, runtime calls and device events
    (raw Chrome-trace events; times in microseconds)."""

    def __init__(self, events, t0, t1):
        self.t0, self.t1 = float(t0), float(t1)
        self.spans = [e for e in events if e.get("ph") == "X"
                      and "span" in (e.get("args") or {})]
        self.runtime = [e for e in events if e.get("cat") in RUNTIME_CATS
                        and "dur" in e]
        # the device events in the window, as tracing.Trace keeps them
        self.device = [e for e in events
                       if e.get("cat") in tracing.DEVICE_CATS and "dur" in e
                       and self.clip(e)[1] > self.clip(e)[0]]
        self.runtime_union = Union(
            (e["ts"], e["ts"] + e["dur"]) for e in self.runtime)
        self.busy = Union(self.clip(e) for e in self.device)

    def clip(self, e):
        """An event's interval clipped to the window (empty outside it)."""
        s = max(float(e["ts"]), self.t0)
        return s, max(s, min(float(e["ts"]) + float(e["dur"]), self.t1))

    def named(self, names):
        return [e for e in self.spans if e["name"] in names]

    def host_own_us(self, spans):
        """Summed span time, clipped to the window, outside the runtime
        calls."""
        total = 0.0
        for e in spans:
            s, t = self.clip(e)
            total += (t - s) - self.runtime_union.covered(s, t)
        return total

    def host_us_per_sweep(self, sweeps):
        top = self.named(TOP)
        if not top or not self.device or not sweeps:
            return None
        return self.host_own_us(top) / sweeps

    def wrapper_us_per_launch(self):
        k = self.named(WRAPPERS)
        if not k or not self.device:
            return None
        return self.host_own_us(k) / len(k)

    def host_loop_idle_share(self):
        """Idle device time inside a program span and outside every runtime
        call, over the window (%), by exact intersection of intervals."""
        if not self.spans or not self.device:
            return None
        edges = ([self.t0] + [v for iv in self.busy.iv for v in iv]
                 + [self.t1])
        idle = Union(iv for iv in zip(edges[0::2], edges[1::2])
                     if iv[1] > iv[0])
        host = Union(self.clip(e) for e in self.spans)
        inside = idle.intersect(host)
        t = sum(e - s - self.runtime_union.covered(s, e)
                for s, e in inside.iv)
        return 100.0 * t / (self.t1 - self.t0)

    def measure_device_share(self):
        """Device time launched from inside runner.measure spans over all
        the window's device time (%)."""
        meas = Union((e["ts"], e["ts"] + e["dur"])
                     for e in self.named(("runner.measure",)))
        if not meas.iv or not self.device:
            return None
        start = {e["args"]["correlation"]: float(e["ts"])
                 for e in self.runtime if "correlation" in e.get("args", {})}
        total = part = 0.0
        for e in self.device:
            s, t = self.clip(e)
            total += t - s
            ts = start.get((e.get("args") or {}).get("correlation"))
            if ts is not None and meas.contains(ts):
                part += t - s
        return 100.0 * part / total if total else None

    def own_us(self):
        """{span name: us}: each span's time, clipped to the window, less
        its child spans and the runtime calls in what is left, summed by
        name: where the host's own time goes (the top spans' sum is
        host_us_per_sweep's numerator)."""
        kids = {}
        for e in self.spans:
            kids.setdefault(e["args"]["parent"], []).append(self.clip(e))
        out = {}
        for e in self.spans:
            s, t = self.clip(e)
            edges = [s] + [v for iv in sorted(kids.get(e["args"]["span"], []))
                           for v in iv] + [t]
            out[e["name"]] = out.get(e["name"], 0.0) + sum(
                b - a - self.runtime_union.covered(a, b)
                for a, b in zip(edges[0::2], edges[1::2]) if b > a)
        return out

    def numbers(self, sweeps):
        return {"host_us_per_sweep": self.host_us_per_sweep(sweeps),
                "wrapper_us_per_launch": self.wrapper_us_per_launch(),
                "host_loop_idle_share": self.host_loop_idle_share(),
                "measure_device_share": self.measure_device_share()}

    def launch_check(self):
        """(share of the K1-K4 kernels whose launching call, joined by
        correlation, has its midpoint inside a span of the wrapper that
        launches such a kernel; the number of wrapper spans)."""
        calls = {e["args"]["correlation"]: e for e in self.runtime
                 if "correlation" in e.get("args", {})}
        by = {w: Union((e["ts"], e["ts"] + e["dur"]) for e in self.named(
            (w,))) for w in WRAPPERS}
        n = inside = 0
        for e in self.device:
            owners = [w for w, pat in KERNELS.items()
                      if pat.search(e["name"])]
            if not owners:
                continue
            n += 1
            call = calls.get((e.get("args") or {}).get("correlation"))
            if call is not None:
                mid = float(call["ts"]) + 0.5 * float(call["dur"])
                inside += any(by[w].contains(mid) for w in owners)
        return (inside / n if n else None), len(self.named(WRAPPERS))


class Union:
    """Merged, sorted [start, end) intervals, with the length of their
    overlap with any interval."""

    def __init__(self, intervals):
        self.iv = tracing.union(intervals)
        self.starts = [s for s, _ in self.iv]
        self.cum = [0.0]
        for s, e in self.iv:
            self.cum.append(self.cum[-1] + e - s)

    def covered(self, a, b):
        """The length of [a, b) that the union covers."""
        if b <= a or not self.iv:
            return 0.0
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0.0
        total = self.cum[j] - self.cum[i]
        s, e = self.iv[i]
        total -= max(0.0, min(a, e) - s)  # the first interval before a
        s, e = self.iv[j - 1]
        total -= max(0.0, e - max(b, s))  # the last interval after b
        return total

    def contains(self, x):
        i = bisect.bisect_right(self.starts, x) - 1
        return i >= 0 and x < self.iv[i][1]

    def intersect(self, other):
        out, i, j = [], 0, 0
        while i < len(self.iv) and j < len(other.iv):
            s = max(self.iv[i][0], other.iv[j][0])
            e = min(self.iv[i][1], other.iv[j][1])
            if e > s:
                out.append((s, e))
            if self.iv[i][1] < other.iv[j][1]:
                i += 1
            else:
                j += 1
        return Union(out)


def traced_run(workload, seed, **run_cell_kw):
    """One traced run of ``workload`` through harness.run_cell with the
    program's spans: the record with ``spans`` added."""
    from . import harness

    seen = {}

    def window(fn):
        out, events, t0, t1 = profiled(fn, seen)
        seen.update(events=events, t0=t0, t1=t1, sweeps=out[0])
        return out, events, t0, t1

    with mock.patch.object(tracing, "profiled", window):
        record, checks = harness.run_cell(workload, seed, 0.0, True,
                                          **run_cell_kw)
    sp = Spans(seen["events"], seen["t0"], seen["t1"])
    share, n = sp.launch_check()
    record["spans"] = {
        **sp.numbers(seen["sweeps"]), "totals": seen["totals"],
        "own_us_per_sweep": {k: v / seen["sweeps"]
                             for k, v in sp.own_us().items()},
        "launch_share_in_span": share, "wrapper_spans": n,
        "launches": seen["launches"],
        "traced_ms_per_sweep": (seen["t1"] - seen["t0"]) / 1e3
        / seen["sweeps"]}
    return record, checks


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the spans are read on the card",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    record, checks = traced_run(args.workload, args.seed)
    record["checks"] = checks
    print(json.dumps({k: v for k, v in record.items()
                      if k not in ("readings", "control")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
