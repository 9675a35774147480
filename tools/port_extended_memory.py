"""Device memory of the port's extended measurement (ops/measure.py
measure_extended, ops/smear.py) on one CUDA card: the peak above the
state of each piece at several lattice sizes, the live allocations at
the peak of one APE step (grouped by the line of the port that made
them), the time of each piece (CUDA events, mean of 3 after a warm-up
call), and the largest L^4 whose state and extended measurement fit on
the card.

    python3 tools/port_extended_memory.py [L ...]   # default 16 32 48

SU(3), a hot start; every extended option (the Cartan Fmunu projections,
tools/wilson_study.py's 10 Wilson loops, Q_L after 2 APE steps of weight
0.5).  Peaks from torch.cuda.max_memory_allocated; the breakdown from
torch.cuda.memory._record_memory_history on the largest L.
"""
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from qcdgpu_tpu_torch import SimConfig  # noqa: E402
from qcdgpu_tpu_torch.ops import measure, rng, smear, staples, sun  # noqa: E402
from qcdgpu_tpu_torch.ops.cuda import engine  # noqa: E402

PAIRS = tuple((r, t) for r in range(1, 5) for t in range(1, 5)
              if abs(r - t) <= 1)
GIB = 2 ** 30


def peak_above(fn):
    """(result, bytes) of fn(): the peak allocation above what was
    allocated before it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - base


def event_ms(fn, reps=3):
    """Mean ms of fn() over reps calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def pieces(u, cfg):
    x = 0.5 * u[0] + (0.5 / 6.0) * sun.dagger(staples.staple_sum(u, 0))
    return (
        ("staple_sum (one direction)", lambda: staples.staple_sum(u, 0)),
        ("project_sun_polar (one direction)",
         lambda: smear.project_sun_polar(x)),
        ("ape_smear_step", lambda: smear.ape_smear_step(u, 0.5)),
        ("fmunu_means", lambda: measure.fmunu_means(
            u, measure.cfg_fmunu_indices(cfg))),
        ("wilson_loop_means", lambda: measure.wilson_loop_means(u, PAIRS)),
        ("topological_charge", lambda: measure.topological_charge(u)),
        ("measure_extended, every option", lambda: measure.measure_extended(
            u, cfg)),
    )


def breakdown(fn, top=12):
    """The allocations live at the peak of fn(), summed by the innermost
    frame in the port's package."""
    torch.cuda.synchronize()
    torch.cuda.memory._record_memory_history(
        enabled="all", context="alloc", stacks="python", max_entries=1 << 20)
    fn()
    torch.cuda.synchronize()
    snap = torch.cuda.memory._snapshot()
    torch.cuda.memory._record_memory_history(enabled=None)
    live, cur, peak, at_peak = {}, 0, 0, {}
    for ev in snap["device_traces"][0]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = (ev["size"], ev.get("frames", []))
            cur += ev["size"]
            if cur > peak:
                peak, at_peak = cur, dict(live)
        elif ev["action"] == "free_completed" and ev["addr"] in live:
            cur -= live.pop(ev["addr"])[0]
    groups = {}
    for size, frames in at_peak.values():
        where = next((f"{os.path.basename(f['filename'])}:{f['line']} "
                      f"{f['name']}" for f in frames
                      if "qcdgpu_tpu_torch" in f["filename"]), "elsewhere")
        n, total = groups.get(where, (0, 0))
        groups[where] = (n + 1, total + size)
    print(f"  live at the peak: {peak / GIB:.3f} GiB in {len(at_peak)} "
          f"blocks")
    for where, (n, total) in sorted(groups.items(),
                                    key=lambda kv: -kv[1][1])[:top]:
        print(f"  {total / GIB:8.3f} GiB  {n:5d} blocks  {where}")


def eigh_call(dev):
    """What one torch.linalg.eigh call on EIGH_CHUNK 3x3 matrices leaves
    allocated while its results are held, beside their own size."""
    a = torch.randn(smear.EIGH_CHUNK, 3, 3, dtype=torch.complex64,
                    device=dev)
    h = a.mH @ a
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev, v = torch.linalg.eigh(h)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - base
    peak = torch.cuda.max_memory_allocated() - base
    own = ev.untyped_storage().nbytes() + v.untyped_storage().nbytes()
    print(f"one eigh call on {smear.EIGH_CHUNK} 3x3 matrices: results "
          f"{own / 2 ** 20:.3f} MiB (storages), allocated while they are "
          f"held {held / 2 ** 20:.3f} MiB, peak during the call "
          f"{peak / 2 ** 20:.3f} MiB")


def main():
    sizes = sorted(int(a) for a in sys.argv[1:]) or [16, 32, 48]
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"{total / GIB:.1f} GiB on the card")
    eigh_call(dev)
    per_site = {}
    for L in sizes:
        dims = (L,) * 4
        vol = L ** 4
        cfg = SimConfig(group=3, dims=dims, get_fmunu=True,
                        wilson_loops=PAIRS, get_qtop=True, qtop_smear=2)
        us = engine.packed_hot_start(cfg, rng.make_base_key(1), dev)
        state = sum(a.numel() * a.element_size() for a in us)
        u, join = peak_above(lambda: engine.join_links(us, dims))
        field = u.numel() * u.element_size()
        print(f"SU(3) {L}^4: packed state {state / GIB:.3f} GiB, joined "
              f"field {field / GIB:.3f} GiB (join's peak {join / GIB:.3f})")
        for name, fn in pieces(u, cfg):
            _, p = peak_above(fn)
            print(f"  {name}: peak {p / GIB:.3f} GiB above the state and "
                  f"the joined field ({p / field:.2f} joined fields), "
                  f"{event_ms(fn):.3f} ms")
        per_site[L] = (state / vol, field + p)
        if L == sizes[-1]:
            print(f"one APE step at {L}^4, by the line that allocated:")
            breakdown(lambda: smear.ape_smear_step(u, 0.5))
        del us, u
        torch.cuda.empty_cache()
    if len(sizes) < 2:
        return
    # the joined field and measure_extended's peak as a + b V: a is what
    # does not grow with the lattice (cuSOLVER's workspace), b a site's
    small, big = sizes[0], sizes[-1]
    s_site = per_site[big][0]
    b = ((per_site[big][1] - per_site[small][1])
         / (big ** 4 - small ** 4))
    a = per_site[big][1] - b * big ** 4
    print(f"joined field + measure_extended's peak = {a / GIB:.3f} GiB + "
          f"{b:.0f} B a site (fit to {small}^4 and {big}^4); the packed "
          f"state {s_site:.0f} B a site")
    for label, k in (("unsharded", 1), ("a mesh, gathered onto card 0", 2)):
        lmax = int(((total - a) / (k * s_site + b)) ** 0.25)
        print(f"largest L^4 with every extended option, {label} (state x "
              f"{k} + joined field + measure_extended's peak): L = {lmax}")


if __name__ == "__main__":
    main()
