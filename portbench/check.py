"""The comparison that decides ``correct``.

The reference (reference.py) replays two segments of the run and the
program's outputs there are judged against it:

- the start: the first START_SWEEPS sweeps of set-up's thermalization,
  which the reference runs from its own cold start;
- the window: ``check_sweeps`` sweeps inside one chunk of the measured
  window (the chunk drawn from the seed), which the reference runs from
  the program's state at the segment's start, through the same
  reunitarization and measurement cadence.

Numbers compared (each beside its limit, from portbench/limits/):

- ``links_off_start`` / ``links_off_window``: the share of link components
  (the f32 entries of the packed arrays) that differ from the reference's
  by more than OFF after the segment;
- ``rows_off_window``: the largest absolute difference of an observable
  row entry (plaquettes, action, Polyakov loop, tracked rate) of the
  segment's measurements, where the cell measures.
"""

from __future__ import annotations

import numpy as np
import torch

START_SWEEPS = 2
OFF = 1e-4


def off_share(prog, ref, thr=OFF):
    """Share of the components of two chain-stacked 8-tuples that differ
    by more than ``thr``."""
    bad = total = 0
    for a, b in zip(prog, ref):
        d = (a.to(b.device, torch.float32) - b).abs()
        bad += int((d > thr).sum())
        total += d.numel()
    return bad / total


def max_abs(prog, ref):
    return max(float((a.to(b.device, torch.float32) - b).abs().max())
               for a, b in zip(prog, ref))


def replay(ref, window_start, sweep0, n_sweeps, measure_every):
    """The reference's two segments: (links after the start segment,
    links after the window segment, the window segment's rows)."""
    start = ref.cold_start()
    ref.run(start, 0, START_SWEEPS, 0)
    win = ref.adopt(window_start)
    rows = ref.run(win, sweep0, n_sweeps, measure_every)
    return start, win, rows


def numbers(got, want):
    """The compared numbers of ``got`` (the program's, or the control's)
    against ``want`` (the reference's), each a replay() triple."""
    out = {"links_off_start": off_share(got[0], want[0]),
           "links_off_window": off_share(got[1], want[1])}
    if np.size(want[2]):
        out["rows_off_window"] = float(
            np.abs(np.asarray(got[2], np.float64)
                   - np.asarray(want[2], np.float64)).max())
    return out


def detail(got, want):
    """Diagnostics beside the numbers (not compared): the largest link
    difference of each segment and the share off by more than 1e-6."""
    return {"links_max_start": max_abs(got[0], want[0]),
            "links_max_window": max_abs(got[1], want[1]),
            "links_off6_start": off_share(got[0], want[0], 1e-6),
            "links_off6_window": off_share(got[1], want[1], 1e-6)}


def judge(values, limits):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit, or a limit without its number, is not
    correct."""
    checks = {k: {"value": values.get(k), "limit": limits.get(k)}
              for k in sorted(set(values) | set(limits))}
    ok = all(c["value"] is not None and c["limit"] is not None
             and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
