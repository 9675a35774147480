"""One run of one cell: set-up, the measured (or traced) window, the check.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the cell's ``Simulation`` (a ``BetaScan`` for a scan) with
cfg.seed = --seed, warms up the shapes the traffic uses (``warmup()``: one
sweep and one measured block, on a clone of the state), and thermalizes
the configuration's ``sweeps_therm`` from the cold start, so that the
window measures an equilibrium chain.  The window calls the traffic's
entry (``run(n, meas_every)`` or ``thermalize(n)``) in chunks of
``chunk_sweeps`` until ``--seconds`` have passed on the host clock, then
waits for the card; one chunk, drawn from the seed, is split to hold the
checked segment (check.py).  link_updates_per_s = 4 V C x sweeps / the
window's seconds; setup_s runs from the process's start to the window's.

With ``--trace 1`` the window is a sub-window of ``trace_sweeps`` sweeps
under torch.profiler, and the line carries the per-layer metrics, read by
portbench/metrics/<name>.py, instead of the end-to-end ones.

The result is the last line of standard output; the compared numbers,
each beside its limit, are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import random
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import check, tracing, yardstick
from .cells import load_cell
from .reference import Reference

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "qcdgpu_tpu")


def forbidden_modules(names):
    """The forbidden top-level packages among module names, compared whole:
    ``qcdgpu_tpu_torch`` is not ``qcdgpu_tpu``."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


class Program:
    """The port as the cell drives it: a Simulation, or a BetaScan over the
    configuration's couplings.  Rows come back as [n_meas, C, n_obs], the
    links as a chain-stacked 8-tuple."""

    def __init__(self, fields, betas, device):
        from qcdgpu_tpu_torch import SimConfig, Simulation
        from qcdgpu_tpu_torch.models import BetaScan

        self.cfg = SimConfig(**fields)
        self.scan = betas is not None
        if self.scan:
            self.obj = BetaScan(self.cfg, betas, device=device)
        else:
            self.obj = Simulation(self.cfg, device=device)

    @property
    def sweep_idx(self):
        return self.obj.sweep_idx

    def warmup(self):
        self.obj.warmup()

    def thermalize(self, n):
        self.obj.thermalize(n)
        return None

    def run(self, n, me):
        rows = self.obj.run(n, me)
        return rows.transpose(1, 0, 2) if self.scan else rows[:, None]

    def links(self):
        """A copy of the live links (queued on the card; no wait)."""
        us = self.obj.us
        return tuple(a.clone() if self.scan else a[None].clone()
                     for a in us)

    def copy_links(self, into):
        """The live links copied into ``into`` (an earlier links()), so
        that a copy inside the window allocates nothing."""
        for b, a in zip(into, self.obj.us):
            b.copy_(a if self.scan else a[None])
        return into

    def sync(self):
        self.obj.sync()


def seeds_of(fields, betas):
    """The chains' seeds: a scan's chain c runs cfg.seed + 1000 c."""
    if betas is None:
        return [fields["seed"]]
    return [fields["seed"] + 1000 * c for c in range(len(betas))]


def window(prog, entry, me, chunk, k, j_check, done, bufs):
    """Chunks until done(chunks, sweeps); chunk j_check ends with the
    checked segment of k sweeps, whose first and last links are copied
    into bufs.  Returns (sweeps, segment)."""
    step = ((lambda n: prog.thermalize(n)) if entry == "thermalize"
            else (lambda n: prog.run(n, me)))
    seg = None
    chunks = sweeps = 0
    while True:
        if chunks == j_check:
            step(chunk - k)
            start, sweep0 = prog.copy_links(bufs[0]), prog.sweep_idx
            rows = step(k)
            seg = {"start": start, "sweep0": sweep0, "rows": rows,
                   "end": prog.copy_links(bufs[1])}
        else:
            step(chunk)
        chunks += 1
        sweeps += chunk
        if done(chunks, sweeps):
            prog.sync()
            return sweeps, seg


def load_reader(path):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_block(chips):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                     for d in range(chips))}


def card_line():
    """The card's name and power limit, from nvidia-smi (for the log)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"


def run_cell(workload, seed, seconds, trace, *, root=ROOT, t0=None,
             device="cuda", overrides=None, control=False, log=None):
    """One run: returns (record, checks), record the result line's object
    without ``checks``.  ``device="cpu"`` and ``overrides`` (SimConfig
    fields, traffic keys under "traffic", a scan's "betas") are for the
    CPU tests; with ``control`` the record also holds the control's
    numbers."""
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    overrides = dict(overrides or {})
    cell = load_cell(root, workload)
    traffic = {**cell.traffic, **overrides.pop("traffic", {})}
    betas = overrides.pop("betas", cell.betas())
    fields = cell.sim_fields(seed, overrides)
    entry = traffic["entry"]
    me = int(fields.get("meas_every", 1)) if entry == "run" else 0
    fields["meas_every"] = me
    chunk, k = int(traffic["chunk_sweeps"]), int(traffic["check_sweeps"])
    therm = int(fields.get("sweeps_therm", 100))
    if chunk <= k or therm < check.START_SWEEPS:
        raise ValueError("chunk_sweeps must exceed check_sweeps, and "
                         "sweeps_therm cover the start segment")
    j_check = random.Random(seed).randrange(3)

    def phase(name, t):
        log(f"setup {name}: {time.perf_counter() - t:.3f} s")
        return time.perf_counter()

    t = time.perf_counter()
    import qcdgpu_tpu_torch  # noqa: F401  (timed: the port's import)
    t = phase("import", t)
    prog = Program(fields, betas, device)
    cfg = prog.cfg.to_dict()
    t = phase("start_state", t)
    prog.warmup()
    t = phase("warmup", t)
    prog.thermalize(check.START_SWEEPS)
    start_end = tuple(a.cpu() for a in prog.links())
    prog.thermalize(therm - check.START_SWEEPS)
    bufs = (prog.links(), prog.links())
    prog.sync()
    phase("thermalize", t)
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t0
    log(f"setup total: {setup_s:.3f} s ({workload}, seed {seed}, "
        f"chunk {j_check} checked)")

    record = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    n_chains = len(betas) if betas else 1
    if trace:
        trace_sweeps = int(traffic["trace_sweeps"])
        win = None
        for attempt in range(3):
            jc = j_check if attempt == 0 else -1
            t_w = time.perf_counter()
            (sweeps, seg), events, w0, w1 = tracing.profiled(
                lambda jc=jc: window(
                    prog, entry, me, chunk, k, jc,
                    lambda c, s: s >= trace_sweeps and c > jc, bufs))
            log(f"traced window {attempt}: {sweeps} sweeps, "
                f"{time.perf_counter() - t_w:.3f} s with the profiler")
            win = win or seg
            tr = tracing.Trace(events, w0, w1)
            if tr.device or device == "cpu":
                break
            log("the trace holds no device event; tracing again")
        seg = win
        every, sweep1 = cfg["reunit_every"], prog.sweep_idx
        ctx = {"trace": tr, "sweeps": sweeps, "chains": n_chains,
               "measurements": sweeps // me if me else 0,
               "reunits": sum(1 for s in range(sweep1 - sweeps, sweep1)
                              if every > 0 and s % every == every - 1),
               "cfg": cfg, "yardstick": yardstick}
        for m in cell.per_layer:
            value = load_reader(cell.metrics_dir / f"{m['name']}.py")(ctx)
            if value is not None:
                record["metrics"][m["name"]] = {"value": value,
                                                "unit": m["unit"]}
    else:
        sweeps, seg = window(
            prog, entry, me, chunk, k, j_check,
            lambda c, s: c > j_check and time.perf_counter() - t_w0
            >= seconds, bufs)
        elapsed = time.perf_counter() - t_w0
        vol = int(np.prod(fields["dims"]))
        values = {"link_updates_per_s": 4 * vol * n_chains * sweeps / elapsed,
                  "setup_s": setup_s}
        log(f"window: {sweeps} sweeps in {elapsed:.6f} s")
        for m in cell.end_to_end:
            record["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
    record["attempted"] = sweeps
    on_card = device != "cpu"
    if on_card:
        record["device"] = device_block(cell.chips)
        if trace:
            record["device"]["busy_s"] = tr.busy_ms / 1e3
            record["device"]["window_s"] = tr.window_ms / 1e3
    else:
        record["device"] = {"platform": "cpu", "kind": "cpu", "count": 0,
                            "memory_peak_bytes": 0}
    if trace and tr.device:
        record["breakdown"] = {"device_ops": tr.top_ops(),
                               "idle_gaps": tr.idle_gaps()}
    if on_card:
        log(f"card: {card_line()}")

    # the check, once the program's state is freed
    del prog
    if on_card:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    t_c = time.perf_counter()
    seeds = seeds_of(fields, betas)
    ref_betas = betas if betas else [cfg["beta"]]
    ref = Reference(cfg, ref_betas, seeds, device)
    got = (start_end, seg["end"], seg["rows"] if me else np.zeros(0))
    want = check.replay(ref, seg["start"], seg["sweep0"], k, me)
    values = check.numbers(got, want)
    log("detail " + json.dumps(check.detail(got, want)))
    if control:
        low = check.replay(Reference(cfg, ref_betas, seeds, device,
                                     lowp=True),
                           seg["start"], seg["sweep0"], k, me)
        record["control"] = check.numbers(low, want)
        log("control " + json.dumps(record["control"]))
    record["readings"] = values
    log(f"check: {time.perf_counter() - t_c:.3f} s of reference")
    ok, checks = check.judge(values, cell.limits)
    record["correct"] = ok
    record["failed"] = 0 if ok else k
    return record, checks


def main(argv=None, t0=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark measures the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    record, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t0=t0)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    emit(record, checks)
    return 0


def emit(record, checks, out=None, err=None):
    """Print the compared numbers, each beside its limit, as the last lines
    of ``err`` and the result line, ``checks`` its last key, as the last
    line of ``out``."""
    out, err = out or sys.stdout, err or sys.stderr
    line = {k: v for k, v in record.items()
            if k not in ("readings", "control")}
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(line), file=out, flush=True)
