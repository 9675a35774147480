#!/usr/bin/env python3
"""Build the port's CUDA kernels and run its main paths on one GPU.

    python3 chip_smoke.py              # one card
    python3 chip_smoke.py --cards 4    # the sharded path across 4 cards

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and nvcc.  With ``--cards N`` it builds the kernels and runs only phase 7:
the bench configuration on an XY mesh, SU(3) heat-bath + 1 OR with
track_kp_exhaust on an X mesh and prngcl:ranlux3 on an XY mesh, each with
its shards spread over N cards, against the unsharded chain on card 0
(links, series and streams bit-identical).  With no argument, phases 1-6,
each timed:

  1. device     — card name and power limit, torch / CUDA / nvcc versions;
  2. build      — nvcc builds csrc/*.cu into build/ (one process per
                  source, all at once); registers, stack frame and spills
                  of every kernel instantiation, threefry and stream,
                  unsharded and on a shard (K1a, K5a, K5b: "_shard");
  3. kernels    — every kernel instantiation against its plain PyTorch
                  version on the card (hot starts, seed 1): K1 threefry for
                  each kind x group x tracking, every (mu, parity), at
                  (4,4,2,4) and 32^4, tracked counts included; K1 streams
                  for all 11 PRNGCL generators x heat-bath/Metropolis x
                  group x tracking at (4,4,2,4), every (mu, parity) in
                  sweep order on carried streams (words bit-identical),
                  every stream instantiation again at 8^4 with the
                  generator of its own phase-5 run, and ranlux3, ranmar,
                  xor128, mrg32k3a at 32^4 (SU(3) heat-bath and tracked
                  Metropolis); K2-K4 for SU(3) and SU(2) at
                  (4,4,2,4), (8,8,8,6) (T/2 odd) and 32^4; every K1a
                  instantiation (threefry and stream) on the shards of
                  (8,8,4,4) mesh (2,2,1,1) and again at the 8^4 shape,
                  X, Y or XY mesh and generator of its own phase-5 run,
                  SU(3) heat-bath (and tracked) at 32^4 on (2,2,1,1),
                  every (mu, parity) in sweep order with the halo refresh
                  between stages, streams on carried words; K5a/K5b per
                  shard at (8,8,4,4) and 32^4 on the XY, X and Y meshes;
  4. timing     — each instantiation and its plain version at 32^4, CUDA
                  events, in the order plain, kernel, kernel (K2
                  over the 8 arrays in turn, per array), beside its bound
                  from bytes (a stream stage's state words included; on a
                  shard only the halo columns read) and f32 operations;
                  K1a, K5a and K5b on one shard of 32^4 mesh (2,2,1,1),
                  and the halo refresh of one array;
  5. main paths — first small hot starts through the library API, CUDA
                  against the CPU path (threefry slices, and ranlux3).
                  Then Simulation(cfg) with no device argument at 32^4
                  (cold start, reunit_every=10, threefry): warmup(),
                  thermalize(20), run(20, 1), with the launch counters
                  zeroed before and read after each run, for the bench's
                  SU(3) heat-bath configuration (bench.py), the three slice
                  configurations (SU(3) heat-bath + 1 overrelaxation with
                  track_kp_exhaust; SU(3) Metropolis with track_acceptance;
                  SU(2) heat-bath + 1 overrelaxation) and four more that
                  drive the remaining instantiations; for the slice
                  configurations the device idle share from torch.profiler.
                  Then the PRNGCL stream path: SU(3) heat-bath at 32^4 with
                  ranlux3 (QCDGPU's default generator; idle share too),
                  ranmar, xor128 and mrg32k3a, with the time to build the
                  stream state; and every stream instantiation through its
                  own configuration at 8^4.  Then the sharded path:
                  the bench configuration on mesh (2,2,1,1) (launch counts,
                  idle share, links bit-identical to the unsharded run),
                  meshes (4,1,1,1) and (1,4,1,1), prngcl:ranlux3 on
                  (2,1,1,1) (links and streams bit-identical), and SU(3)
                  64^4 on (1,8,1,1) against unsharded after 2 sweeps;
                  and every K1a instantiation through a configuration of
                  its own at 8^4 on an X, Y or XY mesh;
  6. physics    — SU(3) 16^4 beta=6.0 heat-bath (window 0.5937 +- 5e-4);
                  SU(3) 16^4 beta=6.0 heat-bath + 1 overrelaxation with
                  track_kp_exhaust, seed 7, and SU(2) 8^4 beta=2.4
                  heat-bath, seed 42, each with the reference's literature
                  and self-anchor gates (qcdgpu_tpu/validate.py); SU(2) 8^4
                  beta=2.4 Metropolis with track_acceptance in the
                  literature window; the stream gates: SU(3) 16^4 beta=6.0
                  heat-bath + 1 overrelaxation, track_kp_exhaust, seed 7,
                  prngcl:ranlux3, and SU(2) 8^4 beta=2.4 heat-bath, seed
                  42, prngcl:ranmar, each with both gates; SU(3) 16^4
                  heat-bath on mesh (2,2,1,1), which must reproduce the
                  unsharded chain's links and plaquette.

Any failed check raises and the script exits non-zero.  The last three
lines are the kernels' JSON record, the card's `nvidia-smi` name/power
line and {"ok": true, "device": {...}}.  Without a CUDA device, or without
the package beside it, it exits non-zero and prints no result.
"""

import itertools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

SMALL = (4, 4, 2, 4)
ODD_T2 = (8, 8, 8, 6)
BIG = (32, 32, 32, 32)
STREAM_SMALL_RUN = (8, 8, 8, 8)
SHARD_SMALL = (8, 8, 4, 4)  # K1a / K5 against their plain twins
MESH = (2, 2, 1, 1)
# the X, Y and XY meshes the K1a instantiations' own 8^4 runs cycle over
SHARD_MESHES = ((2, 2, 1, 1), (4, 1, 1, 1), (1, 4, 1, 1), (2, 1, 1, 1),
                (1, 2, 1, 1))
GROUPS = (3, 2)
BETA_HOT = {3: 5.5, 2: 2.3}  # couplings of the kernel-vs-plain comparisons
BETA_RUN = {3: 6.0, 2: 2.4}
STAGE_TOL = 2e-5
REUNIT_TOL = 1e-6
PLANE_TOL = 1e-7  # |d sum| / (N * volume)
POLY_TOL = 2e-6   # |d sum| / (N * spatial volume)
FLIP_FRACTION = 1e-5  # accept flips at a rounding boundary, per link
# CUDA vs CPU at (4,4,2,4): first series row (plaquette/action, Polyakov),
# and the tracked column, which a few accept flips may move
ROW_TOL = (5e-5, 2e-4)
RATE_TOL = 2e-3
THERM, RUN = 20, 20

# One H100 SXM, NVIDIA's data sheet: HBM bandwidth and f32 rate outside the
# tensor cores (the bound of every kernel here).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# Main-path runs of phase 5: (label, is a slice configuration, SimConfig
# fields beyond dims=32^4, cold start, reunit_every=10, seed 0, threefry).
MAIN_PATHS = (
    ("bench: SU(3) heat-bath", False, dict(group=3, beta=6.0)),
    ("slice 1: SU(3) heat-bath + 1 OR, track_kp_exhaust", True,
     dict(group=3, beta=6.0, n_or=1, track_kp_exhaust=True)),
    ("slice 2: SU(3) Metropolis, track_acceptance", True,
     dict(group=3, beta=6.0, algorithm="metropolis", n_hit=3,
          metro_delta=0.35, track_acceptance=True)),
    ("slice 3: SU(2) heat-bath + 1 OR", True,
     dict(group=2, beta=2.4, n_or=1)),
    ("SU(3) Metropolis", False,
     dict(group=3, beta=6.0, algorithm="metropolis")),
    ("SU(2) heat-bath, track_kp_exhaust", False,
     dict(group=2, beta=2.4, track_kp_exhaust=True)),
    ("SU(2) Metropolis", False,
     dict(group=2, beta=2.4, algorithm="metropolis")),
    ("SU(2) Metropolis, track_acceptance", False,
     dict(group=2, beta=2.4, algorithm="metropolis", track_acceptance=True)),
)
# The PRNGCL stream path: the bench configuration with QCDGPU's default
# generator (ranlux3, the slice) and the stream rows of the reference's
# perf matrix, SU(3) heat-bath at 32^4, cold start, reunit_every=10.
STREAM_BIG = ("ranlux3", "ranmar", "xor128", "mrg32k3a")
# the generator standing for each family where one is timed
FAMILY_GEN = {"xor128": "xor128", "xor7": "xor7", "mrg32k3a": "mrg32k3a",
              "parkmiller": "parkmiller", "constant": "constant",
              "ranlux": "ranlux3", "ranmar": "ranmar"}
# generators that drive each family's 8 instantiations at 8^4 in turn
FAMILY_RUN_GENS = {"ranlux": ("ranlux0", "ranlux1", "ranlux2", "ranlux4"),
                   "xor128": ("xor128",), "xor7": ("xor7",),
                   "mrg32k3a": ("mrg32k3a",), "parkmiller": ("parkmiller",),
                   "constant": ("constant",), "ranmar": ("ranmar",)}


def parse_instance(name):
    """(kind, group, tracked, stream family or None) of a stage
    instantiation's name (update.instance_name)."""
    parts = name.split("_")
    fam = parts[3] if parts[3] in FAMILY_RUN_GENS else None
    return parts[1], int(parts[2][2:]), "track" in parts, fam


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"== {self.name}: {time.perf_counter() - self.t0:.2f} s",
                  flush=True)
        return False


def require(cond, msg):
    if not cond:
        raise AssertionError(msg)


def nvidia_smi_lines():
    """The `name, power.limit` line of every card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()


def sync():
    torch.cuda.synchronize()


def clone(us):
    return tuple(a.clone() for a in us)


def event_ms(fn, reps):
    """Mean ms per call of fn over reps calls, after one warm-up call."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# ptxas summary
# ---------------------------------------------------------------------------


def kernel_label(mangled, kinds):
    """Readable name of a mangled qg:: kernel; stage instantiations get
    their launch-counter names (kinds: the update kinds in qg::Kind
    order)."""
    shard = "_shard" if "9ShardDims" in mangled else ""
    m = re.search(r"stage_kernelILi(\d)ELi(\d)ELb([01])ENS_"
                  r"(?:8Threefry|6StreamINS_(\d+)(\w+))", mangled)
    if m:
        n, kind, track = int(m[1]), kinds[int(m[2])], m[3] == "1"
        fam = "" if m[4] is None else "_" + m[5][:int(m[4])].lower()
        return (f"stage_{kind}_su{n}{fam}" + ("_track" if track else "")
                + shard)
    m = re.match(r"_ZN2qg(\d+)", mangled)  # qg::<length-prefixed name>
    if not m:
        return mangled
    end = m.end() + int(m[1])
    t = re.match(r"ILi(\d)E", mangled[end:])
    return mangled[m.end():end] + (f"<{t[1]}>" if t else "") + shard


def ptxas_summary(log, kinds):
    """[(kernel, 'N registers, S bytes stack frame, spills')] from nvcc's
    -Xptxas -v output."""
    rows, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, frame = kernel_label(m[1], kinds), ""
            continue
        if "stack frame" in line and name:
            frame = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, f"{m[1]} registers; {frame}"))
            name = None
    return rows


# ---------------------------------------------------------------------------
# bounds: bytes each call must move and f32 operations it must do
# ---------------------------------------------------------------------------


def mmul_ops(n):
    """f32 operations of one complex n x n product: n^2 entries of n
    complex multiplies (6 each) and n - 1 complex adds (2 each)."""
    return n * n * (8 * n - 2)


def codec_ops(n):
    """SU(3) rebuilds row 2 on every load: 3 x (2 complex multiplies + 1
    complex subtract); SU(2) stores its whole matrix."""
    return 42 if n == 3 else 0


# f32 operations per subgroup touch, counted from csrc/stage.cu: the
# heat-bath's set-up, one Kennedy-Pendleton trial and its direction +
# product; the overrelaxation flip; one Metropolis hit.  Threefry's integer
# operations are not counted: the data sheet gives no int32 rate.
HB_SETUP, HB_TRIAL, HB_FINISH = 19, 97, 89
OR_FLIP = 42
METRO_HIT = 134


def stage_ops_per_site(n, kind, k_trials, n_hit):
    staples = 13 * mmul_ops(n) + 5 * 2 * n * n + 19 * codec_ops(n)
    flip = {"heatbath": HB_SETUP + k_trials * HB_TRIAL + HB_FINISH,
            "overrelax": OR_FLIP, "metropolis": n_hit * METRO_HIT}[kind]
    n_sg = 3 if n == 3 else 1
    # per subgroup: the quaternion (8) and two left multiplications (28 n)
    return staples + n_sg * (8 + 56 * n + flip)


def stream_word_bytes(gen, v2, ndraw, scalars):
    """Bytes of state words one stream stage must move at v2 active sites:
    each word it reads before writing it, read once, and each word it
    writes, written once.  ndraw >= 24 touches every word of the
    counter-free and ranlux states; ranmar touches the slots its pointer
    and lag reach, from this call's pointer."""
    from qcdgpu_tpu_torch.ops import prng_streams as ps

    fam = ps.family(gen)
    if fam == "constant":
        return 4 * v2  # read, never written
    if fam != "ranmar":
        return 8 * ps.stream_word_count(gen) * v2
    read, written = set(), set()
    for t in range(ndraw):
        i = (scalars["ptr"] - t) % 97
        read.update(k for k in (i, (i - 64) % 97) if k not in written)
        written.add(i)
    return 4 * v2 * (len(read) + len(written))


def unit(axis):
    """(dx, dy) of one step along lattice axis 0..3 (Z, T stay in the
    column)."""
    return ((1, 0), (0, 1), (0, 0), (0, 0))[axis]


def stage_reads(mu, p):
    """The links one stage (mu, parity p) loads, as (array 2d + parity,
    dx, dy): U_mu(x), and per nu != mu the staple's U_nu(x), U_mu(x+nu),
    U_nu(x+mu), U_nu(x+mu-nu), U_mu(x-nu), U_nu(x-nu)."""
    reads = [(2 * mu + p, 0, 0)]
    m = unit(mu)
    for nu in range(4):
        if nu == mu:
            continue
        v = unit(nu)
        reads += [(2 * nu + p, 0, 0), (2 * mu + 1 - p, *v),
                  (2 * nu + 1 - p, *m),
                  (2 * nu + p, m[0] - v[0], m[1] - v[1]),
                  (2 * mu + 1 - p, -v[0], -v[1]),
                  (2 * nu + 1 - p, -v[0], -v[1])]
    return reads


def plane_reads():
    """The links the plane sums load over both parities: U_mu(x),
    U_nu(x+mu), U_nu(x), U_mu(x+nu) for each plane (mu, nu)."""
    reads = []
    for p in (0, 1):
        for mu, nu in itertools.combinations(range(4), 2):
            reads += [(2 * mu + p, 0, 0), (2 * nu + 1 - p, *unit(mu)),
                      (2 * nu + p, 0, 0), (2 * mu + 1 - p, *unit(nu))]
    return reads


def columns_read(reads, local, halo):
    """Distinct (array, X/Y column) pairs that ``reads`` touch when applied
    to every interior column of a shard: a column holds all Z*T/2 slots of
    its array, a split axis steps into the halo, an axis that is not split
    wraps."""
    lx, ly = local
    cols = set()
    for k, dx, dy in reads:
        for x in range(lx):
            for y in range(ly):
                cols.add((k, x + dx if halo[0] else (x + dx) % lx,
                          y + dy if halo[1] else (y + dy) % ly))
    return len(cols)


def work(name, dims, k_trials=4, n_hit=3, shard=None, mu=1, parity=0):
    """(bytes, f32 operations) of one call of kernel `name` at dims: each
    input read once, each output written once (a stream stage's words
    are added by the caller: stream_word_bytes).  A stage is stage (mu,
    parity).  With shard (a core.Shard: K1a, K5a, K5b) dims are its
    interior extents, and of its padded arrays only the halo columns that
    the call reads count."""
    n = int(re.search(r"_su(\d)", name)[1])
    v2 = int(np.prod(dims)) // 2
    arr = 16 * n * v2  # one packed (direction, parity) array
    col = arr // (dims[0] * dims[1])  # one X/Y column of it
    local, halo = ((dims[0], dims[1]), (0, 0)) if shard is None else (
        shard.local, shard.halo)
    if name.startswith("stage_"):
        # the links the stage loads, the target written
        kind = name.split("_")[1]
        return (columns_read(stage_reads(mu, parity), local, halo) * col
                + arr, v2 * stage_ops_per_site(n, kind, k_trials, n_hit))
    if name.startswith("reunit_"):
        return 2 * arr, v2 * (84 if n == 3 else 23)
    if name.startswith("plane_sums"):
        per_site = 6 * (2 * mmul_ops(n) + 4 * n * n + 4 * codec_ops(n))
        return (columns_read(plane_reads(), local, halo) * col + 6 * 8,
                2 * v2 * per_site)
    x, y, z, t = dims  # polyakov_sums: the temporal arrays only
    per_col = (t - 1) * mmul_ops(n) + t * codec_ops(n) + 2 * (n - 1)
    return 2 * arr + 2 * 8, x * y * z * per_col


def bound(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# device idle share
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profile_window(sim, n_sweeps):
    """thermalize(n) + run(n, 1) twice: on the host clock alone, then under
    torch.profiler.  Returns (host wall ms, host wall ms under the
    profiler, device busy ms, {kernel name: (ms, calls)}) with busy from
    the trace's device events; busy is None when the trace holds none.
    The profiler slows the host loop, not the kernels, so the idle share
    is taken against the unprofiled wall."""
    from torch.profiler import ProfilerActivity, profile

    def window():
        sim.sync()
        t0 = time.perf_counter()
        sim.thermalize(n_sweeps)
        sim.run(n_sweeps, 1)
        sim.sync()
        return (time.perf_counter() - t0) * 1e3

    wall = window()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = window()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev_events = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev_events:
        return wall, wall_prof, None, {}
    by_name = {}
    for e in dev_events:
        ms, calls = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (ms + e["dur"] / 1e3, calls + 1)
    busy = sum(ms for ms, _ in by_name.values())
    return wall, wall_prof, busy, by_name


def multicard(n_cards):
    """``--cards N``: the sharded path with its shards spread over N cards
    (Simulation(cfg, devices=[cuda:0 .. cuda:N-1]), halo copies between
    cards) against the unsharded chain on card 0: links, series and
    stream state bit-identical.  Prints each card's nvidia-smi line and
    the contract's last line with count N."""
    from qcdgpu_tpu_torch import SimConfig, Simulation
    from qcdgpu_tpu_torch.ops.cuda import build

    require(torch.cuda.device_count() >= n_cards,
            f"{n_cards} cards asked for, {torch.cuda.device_count()} present")
    cards = [f"cuda:{i}" for i in range(n_cards)]
    with Phase("1 device"):
        smi = nvidia_smi_lines()
        print("cards:", smi)
    with Phase("2 build"):
        print(f"library built in {build.build()['seconds']:.1f} s")
        build.library()
    bench = SimConfig(group=3, beta=6.0, dims=BIG, reunit_every=10,
                      start="cold", seed=0)
    x_only = (n_cards, 1, 1, 1)
    xy = (2, n_cards // 2, 1, 1) if n_cards % 2 == 0 else x_only
    runs = (("bench SU(3) heat-bath", bench, xy),
            ("SU(3) heat-bath + 1 OR, track_kp_exhaust, hot start",
             bench.replace(n_or=1, track_kp_exhaust=True, start="hot"),
             x_only),
            ("SU(3) heat-bath, prngcl:ranlux3", bench.replace(
                rng_mode="prngcl:ranlux3"), xy))
    with Phase(f"7 shards on {n_cards} cards"):
        for label, cfg, mesh in runs:
            out = []
            for m, devices in (((1, 1, 1, 1), None), (mesh, cards)):
                sim = Simulation(cfg.replace(mesh=m), device="cuda:0",
                                 devices=devices)
                sim.warmup()
                t0 = time.perf_counter()
                sim.thermalize(10)
                obs = sim.run(10, 1)
                sim.sync()
                ms = (time.perf_counter() - t0) / 20 * 1e3
                out.append((tuple(a.cpu() for a in sim.us), obs,
                            sim.stream_state, ms,
                            sorted({str(d) for d in sim._run.grid.devices})))
                del sim
            (u1, o1, s1, ms1, _), (un, on, sn, msn, used) = out
            same = (all(torch.equal(a, b) for a, b in zip(u1, un))
                    and np.array_equal(o1, on))
            if s1 is not None:
                same = same and all(np.array_equal(s1[k], sn[k]) for k in s1)
            print(f"{label}: mesh {mesh} on {used} vs unsharded on cuda:0, "
                  f"thermalize(10) + run(10, 1): links, series"
                  + (" and streams" if s1 is not None else "")
                  + f" bit-identical {same}; {msn:.3f} vs {ms1:.3f} "
                  f"ms/sweep  [{smi[0]}]")
            require(same and len(used) == n_cards,
                    f"{label}: mesh {mesh} on {n_cards} cards differs")
    print(smi[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--cards"]:
        return multicard(int(sys.argv[2]))
    from qcdgpu_tpu_torch import SimConfig, Simulation
    from qcdgpu_tpu_torch.ops import prng_streams as ps
    from qcdgpu_tpu_torch.ops import rng
    from qcdgpu_tpu_torch.ops.cuda import build, engine
    from qcdgpu_tpu_torch.ops.cuda import measure as cmeasure
    from qcdgpu_tpu_torch.ops.cuda import reunit as creunit
    from qcdgpu_tpu_torch.ops.cuda import sharded
    from qcdgpu_tpu_torch.ops.cuda import update as cupdate
    from qcdgpu_tpu_torch.parallel.mesh import ShardGrid

    dev = torch.device("cuda", 0)
    counters = (cupdate.LAUNCHES, creunit.LAUNCHES, cmeasure.LAUNCHES)
    k1_cases = [(n, kind, track) for n in GROUPS for kind in cupdate.KINDS
                for track in (False, True)
                if not (track and kind == "overrelax")]
    src = "qcdgpu_tpu_torch/csrc/"
    tpu = "qcdgpu_tpu/ops/pallas/"
    record = {}
    for n, kind, track in k1_cases:
        name = cupdate.instance_name(kind, n, track)
        record[name] = (name, "stage.cu", "update.py:460")
    for name in cupdate.STREAM_INSTANCES:
        fam = name.split("_")[3]
        # K1's stream branch: the draws of K7 (counter-free) or K8 (lag)
        record[name] = (name, f"stage_{fam}.cu", "prng_streams.py:" + (
            "767" if fam in ("ranlux", "ranmar") else "625"))
    for name in cupdate.SHARD_INSTANCES:
        # K1a: the halo-padded shard form of _stage_kernel (_stage_call with
        # local_x / local_y > 0)
        fam = name.split("_")[3]
        record[name] = (name, "stage.cu" if fam in ("track", "shard")
                        else f"stage_{fam}.cu", "update.py:602")
    for n in GROUPS:
        record[f"plane_sums_local_su{n}"] = (f"plane_sums_local_su{n}",
                                             "measure.cu", "measure.py:269")
        record[f"polyakov_sums_local_su{n}"] = (
            f"polyakov_sums_local_su{n}", "measure.cu", "measure.py:349")
        record[f"reunit_su{n}"] = (f"reunit_su{n}", "reunit.cu",
                                   "reunit.py:22")
        record[f"plane_sums_su{n}"] = (f"plane_sums_su{n}", "measure.cu",
                                       "measure.py:67")
        record[f"polyakov_sums_su{n}"] = (f"polyakov_sums_su{n}",
                                          "measure.cu", "measure.py:155")
    for key, (name, source, replaces) in record.items():
        record[key] = {
            "name": name, "route": "cuda", "source": src + source,
            "replaces": ("qcdgpu_tpu/ops/" if "prng" in replaces else tpu)
            + replaces, "launches": 0, "max_abs_err": 0.0,
            "ms": None, "plain_ms": None, "bound_ms": None, "bound_by": None,
            "library_ms": None}
    require(set(record) == {k for c in counters for k in c},
            "launch counters and kernel record disagree")

    with Phase("1 device"):
        smi = nvidia_smi_lines()[0]
        print("card:", smi)
        print("torch", torch.__version__, "cuda", torch.version.cuda,
              "device", torch.cuda.get_device_name(0),
              "count", torch.cuda.device_count())
        nvcc = subprocess.run([build.nvcc_path(), "--version"],
                              capture_output=True, text=True, check=True)
        print(nvcc.stdout.strip().splitlines()[-1])

    with Phase("2 build"):
        info = build.build()
        print(f"library {info['path'].name}: built={info['built']} "
              f"in {info['seconds']:.1f} s")
        for name, line in ptxas_summary(info["log"], cupdate.KINDS):
            print(f"  ptxas {name}: {line}")
        build.library()

    hots = {}

    def hot(dims, n):
        if (dims, n) not in hots:
            cfg = SimConfig(group=n, dims=dims, seed=1)
            hots[(dims, n)] = engine.packed_hot_start(
                cfg, rng.make_base_key(1), dev)
        return hots[(dims, n)]

    def note_err(name, err):
        record[name]["max_abs_err"] = max(record[name]["max_abs_err"], err)

    def stream_state(gen, n, dims):
        return engine.make_stream_state0(
            SimConfig(group=n, dims=dims, seed=3, rng_mode=f"prngcl:{gen}"),
            dev)

    def k1_compare(n, kind, track, dims, k_trials, gen=None):
        """The 8 stages of a sweep, in sweep order, on one hot start (and,
        with gen, one set of streams, so each parity's words, pointer and
        luxury counter carry over its 4 stages): the kernel runs on a copy
        of the inputs, the plain version on the originals, which carry on
        to the next stage.  Stream words and scalars must come out
        bit-identical.  -> (max |d| links, links beyond STAGE_TOL, links,
        kernel count, plain count)."""
        us = clone(hot(dims, n))
        rst = stream_state(gen, n, dims) if gen else {}
        names = ps.kernel_scalar_names(gen) if gen else ()
        base = rng.make_base_key(1)
        worst, bad, links, cnt_k, cnt_p = 0.0, 0, 0, 0, 0
        for p in (0, 1):
            sfx = ("_e", "_o")[p]
            for mu in range(4):
                key = None if gen else rng.stage_key(base, 0, 4 * p + mu)
                kw_p = kw_k = {}
                if gen:
                    kw_p = dict(gen=gen, words=rst["words" + sfx],
                                scalars={k: rst[k + sfx] for k in names})
                    kw_k = dict(kw_p, words=kw_p["words"].clone(),
                                scalars=dict(kw_p["scalars"]))
                ck, cp = (
                    (torch.zeros(1, dtype=torch.int64, device=dev)
                     for _ in range(2)) if track else (None, None))
                uk = clone(us)
                cupdate.stage_update(uk, mu, p, BETA_HOT[n], key, dims,
                                     k_trials, kind=kind, count=ck, **kw_k)
                cupdate.stage_update_ref(us, mu, p, BETA_HOT[n], key, dims,
                                         k_trials, kind=kind, count=cp, **kw_p)
                if gen:
                    require(torch.equal(kw_k["words"], kw_p["words"])
                            and kw_k["scalars"] == kw_p["scalars"],
                            f"K1 {gen} {kind} SU({n}) {dims} (mu={mu}, "
                            f"p={p}): stream words or scalars differ")
                    rst.update({k + sfx: v
                                for k, v in kw_p["scalars"].items()})
                d = (uk[2 * mu + p] - us[2 * mu + p]).abs().reshape(
                    4 * n, -1).amax(dim=0)
                worst = max(worst, float(d.max()))
                bad += int((d > STAGE_TOL).sum())
                links += d.numel()
                if track:
                    cnt_k += int(ck)
                    cnt_p += int(cp)
        return worst, bad, links, cnt_k, cnt_p

    def k1a_compare(n, kind, track, k_trials, gen, dims, mesh):
        """K1a against its plain twin on the shards of dims on mesh: the 8
        stages of a sweep in sweep order, each on every shard (the kernel
        on a copy of the shard, the plain twin on the shard, which carries
        on), the halo refresh after each stage, stream words and scalars
        carried and bit-identical.  -> (max |d| links, links beyond
        STAGE_TOL, links, kernel count, plain count)."""
        grid = ShardGrid(dims, mesh, [dev])
        shards = sharded.shard_links(hot(dims, n), grid)
        rst = (sharded.shard_streams(stream_state(gen, n, dims), grid)
               if gen else {})
        names = ps.kernel_scalar_names(gen) if gen else ()
        base = rng.make_base_key(1)
        worst, bad, links, cnt_k, cnt_p = 0.0, 0, 0, 0, 0
        for p in (0, 1):
            sfx = ("_e", "_o")[p]
            for mu in range(4):
                key = None if gen else rng.stage_key(base, 0, 4 * p + mu)
                scal = {k: rst[k + sfx] for k in names}
                ck, cp = (
                    (torch.zeros(1, dtype=torch.int64, device=dev)
                     for _ in range(2)) if track else (None, None))
                for i, (g, us) in enumerate(zip(grid.shards, shards)):
                    kw_p = kw_k = {}
                    if gen:
                        kw_p = dict(gen=gen, words=rst["words" + sfx][i],
                                    scalars=dict(scal))
                        kw_k = dict(kw_p, words=kw_p["words"].clone(),
                                    scalars=dict(scal))
                    uk = clone(us)
                    cupdate.stage_update(uk, mu, p, BETA_HOT[n], key, dims,
                                         k_trials, kind=kind, count=ck,
                                         shard=g, **kw_k)
                    cupdate.stage_update_ref(us, mu, p, BETA_HOT[n], key,
                                             dims, k_trials, kind=kind,
                                             count=cp, shard=g, **kw_p)
                    if gen:
                        require(torch.equal(kw_k["words"], kw_p["words"])
                                and kw_k["scalars"] == kw_p["scalars"],
                                f"K1a {gen} {kind} SU({n}) {dims} mesh "
                                f"{mesh} shard {i} (mu={mu}, p={p}): stream "
                                "words or scalars differ")
                    # the whole padded shard: the kernel must leave the
                    # halos and the other arrays alone
                    for k, (a, b) in enumerate(zip(uk, us)):
                        d = (a - b).abs().amax(dim=(0, 1, 2))
                        worst = max(worst, float(d.max()))
                        if k == 2 * mu + p:  # its interior links
                            d = sharded.interior(d, g, 0)
                            bad += int((d > STAGE_TOL).sum())
                            links += d.numel()
                if gen:
                    rst.update({k + sfx: v
                                for k, v in kw_p["scalars"].items()})
                sharded.refresh_halos(shards, grid, (2 * mu + p,))
                if track:
                    cnt_k += int(ck)
                    cnt_p += int(cp)
        return worst, bad, links, cnt_k, cnt_p

    def require_stage(msg, dims, n, kind, worst, bad, links, ck, cp):
        """Below 32^4 kernel and plain version agree within STAGE_TOL with
        equal counts; at 32^4 an accept decision at a rounding boundary may
        flip (at most FLIP_FRACTION of the links), moving the count by at
        most the decisions of those links."""
        if dims != BIG:
            require(worst < STAGE_TOL and ck == cp, msg)
        else:
            n_sg = 3 if n == 3 else 1
            per_link = 3 if kind == "metropolis" else 1  # decisions/subgroup
            require(bad <= FLIP_FRACTION * links, msg)
            require(abs(ck - cp) <= bad * n_sg * per_link, msg)

    # phase 5's stream runs at STREAM_SMALL_RUN, one per stream
    # instantiation: (index, generator, group, kind, tracking)
    small_runs = [
        (i, FAMILY_RUN_GENS[fam][i % len(FAMILY_RUN_GENS[fam])], n, kind, t)
        for i, (fam, n, kind, t) in enumerate(itertools.product(
            ps.FAMILIES, GROUPS, ("heatbath", "metropolis"), (False, True)))]
    # phase 5's K1a runs at STREAM_SMALL_RUN, one per drawing K1a
    # instantiation, over SHARD_MESHES in turn (the overrelaxation ones ride
    # on the untracked threefry heat-bath runs' OR pass): (index, name,
    # generator or None, mesh)
    k1a_runs = []
    for i, name in enumerate(n_ for n_ in cupdate.SHARD_INSTANCES
                             if not n_.startswith("stage_overrelax")):
        fam = parse_instance(name)[3]
        gen = FAMILY_RUN_GENS[fam][i % len(FAMILY_RUN_GENS[fam])] if fam \
            else None
        k1a_runs.append((i, name, gen, SHARD_MESHES[i % len(SHARD_MESHES)]))

    with Phase("3 kernels vs plain versions"):
        # K1 threefry at (4,4,2,4) and 32^4; K1 streams: every generator
        # at (4,4,2,4), every phase-5 run's at its shape, the four big
        # generators' SU(3) heat-bath and tracked Metropolis at 32^4
        cases = [(None, n, kind, track, dims) for n, kind, track in k1_cases
                 for dims in (SMALL, BIG)]
        cases += [(gen, n, kind, track, SMALL)
                  for gen in ps.STREAM_GENERATORS for n in GROUPS
                  for kind in ("heatbath", "metropolis")
                  for track in (False, True)]
        cases += [(gen, n, kind, track, STREAM_SMALL_RUN)
                  for _, gen, n, kind, track in small_runs]
        cases += [(gen, 3, kind, kind == "metropolis", BIG)
                  for gen in STREAM_BIG
                  for kind in ("heatbath", "metropolis")]
        for gen, n, kind, track, dims in cases:
            name = cupdate.instance_name(kind, n, track, gen)
            # tracked heat-bath with one KP trial, so that exhaustions occur
            k_trials = 1 if (track and kind == "heatbath") else 4
            worst, bad, links, ck, cp = k1_compare(n, kind, track, dims,
                                                   k_trials, gen)
            note_err(name, worst)
            msg = (f"K1 {name}" + (f" ({gen}; words bit-identical)"
                                   if gen else "")
                   + f" {dims}: max |d| {worst:.3e}, {bad} of {links} links "
                   f"beyond {STAGE_TOL}")
            if track:
                msg += f"; count kernel {ck} plain {cp} (K={k_trials})"
            print(msg)
            require_stage(msg, dims, n, kind, worst, bad, links, ck, cp)
        for n in GROUPS:
            for dims in (SMALL, ODD_T2, BIG):
                u_ = hot(dims, n)
                # K2 on drifted links (hot start + seeded noise)
                noise = np.random.default_rng(1)
                k2 = 0.0
                for a in u_:
                    drift = a + torch.from_numpy(
                        noise.standard_normal(a.shape).astype(np.float32)
                    ).to(dev) * 1e-3
                    got = creunit.reunitarize_dir(drift.clone(), dims)
                    ref = creunit.reunitarize_dir_ref(drift.clone(), dims)
                    k2 = max(k2, float((got - ref).abs().max()))
                note_err(f"reunit_su{n}", k2)
                d3 = float((cmeasure.plane_sums(u_, dims)
                            - cmeasure.plane_sums_ref(u_, dims)).abs().max())
                d3 /= n * np.prod(dims)
                note_err(f"plane_sums_su{n}", d3)
                d4 = float((cmeasure.polyakov_sums(u_, dims)
                            - cmeasure.polyakov_sums_ref(u_, dims)
                            ).abs().max())
                d4 /= n * np.prod(dims[:3])
                note_err(f"polyakov_sums_su{n}", d4)
                msg = (f"SU({n}) {dims}: K2 max |d| {k2:.3e} (< {REUNIT_TOL})"
                       f"; K3 max |d sum|/(N vol) {d3:.3e} (< {PLANE_TOL})"
                       f"; K4 max |d sum|/(N spatial vol) {d4:.3e} "
                       f"(< {POLY_TOL})")
                print(msg)
                require(k2 < REUNIT_TOL and d3 < PLANE_TOL and d4 < POLY_TOL,
                        msg)
        # K1a: every instantiation on the shards of SHARD_SMALL on MESH
        # (partly filled blocks), again at the shape, mesh and generator of
        # its own phase-5 run (the overrelaxation ones: of the runs whose
        # OR pass drives them), and SU(3) heat-bath at 32^4 on MESH
        cases = [(name, FAMILY_GEN.get(parse_instance(name)[3]),
                  SHARD_SMALL, MESH) for name in cupdate.SHARD_INSTANCES]
        for _, name, gen, mesh in k1a_runs:
            kind, n, track, _ = parse_instance(name)
            cases.append((name, gen, STREAM_SMALL_RUN, mesh))
            if kind == "heatbath" and not track and gen is None:
                cases.append((cupdate.instance_name("overrelax", n,
                                                    shard=True),
                              None, STREAM_SMALL_RUN, mesh))
        cases += [(cupdate.instance_name("heatbath", 3, track, shard=True),
                   None, BIG, MESH) for track in (False, True)]
        for name, gen, dims, mesh in cases:
            kind, n, track, _ = parse_instance(name)
            k_trials = 1 if (track and kind == "heatbath") else 4
            worst, bad, links, ck, cp = k1a_compare(n, kind, track, k_trials,
                                                    gen, dims, mesh)
            note_err(name, worst)
            msg = (f"K1a {name}" + (f" ({gen}; words bit-identical)"
                                    if gen else "")
                   + f" {dims} mesh {mesh}: max |d| {worst:.3e}, {bad} of "
                   f"{links} links beyond {STAGE_TOL}")
            if track:
                msg += f"; count kernel {ck} plain {cp} (K={k_trials})"
            print(msg)
            require_stage(msg, dims, n, kind, worst, bad, links, ck, cp)
        # K5a / K5b per shard, on the XY, X and Y meshes
        for n in GROUPS:
            for dims, mesh in itertools.product(
                    (SHARD_SMALL, BIG), SHARD_MESHES[:3]):
                grid = ShardGrid(dims, mesh, [dev])
                d5a = d5b = 0.0
                for g, us in zip(grid.shards,
                                 sharded.shard_links(hot(dims, n), grid)):
                    vol = n * int(np.prod(g.interior))
                    d5a = max(d5a, float(
                        (cmeasure.plane_sums_local(us, g)
                         - cmeasure.plane_sums_local_ref(us, g)).abs().max())
                        / vol)
                    d5b = max(d5b, float(
                        (cmeasure.polyakov_sums_local(us, g)
                         - cmeasure.polyakov_sums_local_ref(us, g)
                         ).abs().max()) / (vol // dims[3]))
                note_err(f"plane_sums_local_su{n}", d5a)
                note_err(f"polyakov_sums_local_su{n}", d5b)
                msg = (f"SU({n}) {dims} mesh {mesh}, per shard: K5a max "
                       f"|d sum|/(N vol) {d5a:.3e} (< {PLANE_TOL}); K5b max "
                       f"|d sum|/(N spatial vol) {d5b:.3e} (< {POLY_TOL})")
                print(msg)
                require(d5a < PLANE_TOL and d5b < POLY_TOL, msg)

    def time_pairs(pairs, dims, shard=None):
        """Time each (plain, kernel) pair: plain, kernel, kernel (the plain
        version is the correctness twin, timed once for the record);
        record ms, plain_ms and the bound of work(name, dims, shard) (the
        stages timed are stage (mu=1, parity=0), work()'s default)."""
        for name, (plain, kern, r_plain, r_kern, calls,
                   extra) in pairs.items():
            p1 = event_ms(plain, r_plain) / calls
            k1 = event_ms(kern, r_kern) / calls
            k2_ = event_ms(kern, r_kern) / calls
            rec = record[name]
            rec["ms"] = (k1 + k2_) / 2
            rec["plain_ms"] = p1
            nbytes, ops = work(name, dims, shard=shard)
            rec["bound_ms"], rec["bound_by"] = bound(nbytes + extra, ops)
            print(f"{name}: kernel {k1:.4f} / {k2_:.4f} ms, plain "
                  f"{p1:.4f} ms, bound {rec['bound_ms']:.4f} "
                  f"ms ({rec['bound_by']})  [{smi}]")

    with Phase("4 kernel timing at 32^4"):
        key = rng.stage_key(rng.make_base_key(1), 0, 0)
        v2 = int(np.prod(BIG)) // 2
        for n in GROUPS:
            w = clone(hot(BIG, n))
            cnt = torch.zeros(1, dtype=torch.int64, device=dev)
            beta = BETA_RUN[n]
            # name -> (plain, kernel, plain reps, kernel reps, calls, bytes
            # beyond work(): a stream stage's state words)
            pairs = {}
            for n_, kind, track in k1_cases:
                if n_ != n:
                    continue
                c = cnt if track else None
                pairs[cupdate.instance_name(kind, n, track)] = (
                    lambda kind=kind, c=c: cupdate.stage_update_ref(
                        w, 1, 0, beta, key, BIG, kind=kind, count=c),
                    lambda kind=kind, c=c: cupdate.stage_update(
                        w, 1, 0, beta, key, BIG, kind=kind, count=c),
                    3, 50, 1, 0)
            # K1 streams: each family through one generator, on parity 0's
            # words and scalars (advanced by every call: the cost of a stage
            # does not depend on where the streams stand)
            for fam, gen in FAMILY_GEN.items():
                rst = stream_state(gen, n, BIG)
                scal = {k: rst[k + "_e"]
                        for k in ps.kernel_scalar_names(gen)}
                for kind in ("heatbath", "metropolis"):
                    ndraw = cupdate.stream_draw_count(kind, 4, 3, n)
                    extra = stream_word_bytes(gen, v2, ndraw, scal)
                    for track in (False, True):
                        c = cnt if track else None
                        kw = dict(kind=kind, count=c, gen=gen,
                                  words=rst["words_e"], scalars=scal)
                        pairs[cupdate.instance_name(kind, n, track, gen)] = (
                            lambda kw=kw: cupdate.stage_update_ref(
                                w, 1, 0, beta, None, BIG, **kw),
                            lambda kw=kw: cupdate.stage_update(
                                w, 1, 0, beta, None, BIG, **kw),
                            1, 20, 1, extra)
            # K2 as the sweep runs it: the 8 arrays in turn (one array
            # alone would stay in the 50 MB L2 from call to call)
            pairs[f"reunit_su{n}"] = (
                lambda: [creunit.reunitarize_dir_ref(a, BIG) for a in w],
                lambda: [creunit.reunitarize_dir(a, BIG) for a in w], 2, 25,
                len(w), 0)
            pairs[f"plane_sums_su{n}"] = (
                lambda: cmeasure.plane_sums_ref(w, BIG),
                lambda: cmeasure.plane_sums(w, BIG), 3, 100, 1, 0)
            pairs[f"polyakov_sums_su{n}"] = (
                lambda: cmeasure.polyakov_sums_ref(w, BIG),
                lambda: cmeasure.polyakov_sums(w, BIG), 3, 100, 1, 0)
            time_pairs(pairs, BIG)
            # K1a, K5a and K5b on shard 0 of BIG on MESH; the halo refresh
            grid = ShardGrid(BIG, MESH, [dev])
            shards = sharded.shard_links(w, grid)
            g0, s0 = grid.shards[0], shards[0]
            v2s = int(np.prod(g0.interior)) // 2
            spairs = {}
            for n_, kind, track in k1_cases:
                if n_ != n:
                    continue
                kw = dict(kind=kind, count=cnt if track else None, shard=g0)
                spairs[cupdate.instance_name(kind, n, track, shard=True)] = (
                    lambda kw=kw: cupdate.stage_update_ref(
                        s0, 1, 0, beta, key, BIG, **kw),
                    lambda kw=kw: cupdate.stage_update(
                        s0, 1, 0, beta, key, BIG, **kw),
                    1, 20, 1, 0)
            for fam, gen in FAMILY_GEN.items():
                rst = sharded.shard_streams(stream_state(gen, n, BIG), grid)
                scal = {k: rst[k + "_e"]
                        for k in ps.kernel_scalar_names(gen)}
                for kind in ("heatbath", "metropolis"):
                    ndraw = cupdate.stream_draw_count(kind, 4, 3, n)
                    extra = stream_word_bytes(gen, v2s, ndraw, scal)
                    for track in (False, True):
                        kw = dict(kind=kind, count=cnt if track else None,
                                  gen=gen, words=rst["words_e"][0],
                                  scalars=scal, shard=g0)
                        spairs[cupdate.instance_name(kind, n, track, gen,
                                                     True)] = (
                            lambda kw=kw: cupdate.stage_update_ref(
                                s0, 1, 0, beta, None, BIG, **kw),
                            lambda kw=kw: cupdate.stage_update(
                                s0, 1, 0, beta, None, BIG, **kw),
                            1, 10, 1, extra)
            spairs[f"plane_sums_local_su{n}"] = (
                lambda: cmeasure.plane_sums_local_ref(s0, g0),
                lambda: cmeasure.plane_sums_local(s0, g0), 2, 50, 1, 0)
            spairs[f"polyakov_sums_local_su{n}"] = (
                lambda: cmeasure.polyakov_sums_local_ref(s0, g0),
                lambda: cmeasure.polyakov_sums_local(s0, g0), 2, 50, 1, 0)
            time_pairs(spairs, g0.interior, g0)
            # the halo refresh of one array (after each stage): each shard
            # copies 2 Y rows over its interior X and 2 Y-padded X slabs
            (lx, ly), (hx, hy) = g0.local, g0.halo
            row = 16 * n * BIG[2] * BIG[3] // 2  # bytes of one (x, y) column
            h_bytes = 2 * len(grid) * 2 * row * (hy * lx + hx * (ly + 2 * hy))
            plan = sharded.halo_copies(shards, grid)  # as the sweep keeps it
            h1 = event_ms(lambda: sharded.refresh_halos(shards, grid, (2,),
                                                        plan), 50)
            h2 = event_ms(lambda: sharded.refresh_halos(shards, grid, (2,),
                                                        plan), 50)
            print(f"halo refresh of one array, {BIG} mesh {MESH}, SU({n}): "
                  f"{h1:.4f} / {h2:.4f} ms for {4 * len(grid)} copies, bound "
                  f"{h_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms (bytes "
                  f"{h_bytes})  [{smi}]")
            del w, pairs, spairs, shards, s0, plan
        hots.clear()

    with Phase("5 main paths"):
        # the library API on small hot starts: CUDA kernels vs CPU plain
        for label, _, kw in MAIN_PATHS[:4] + (
                ("streams: SU(3) heat-bath, prngcl:ranlux3", True,
                 dict(group=3, beta=6.0, rng_mode="prngcl:ranlux3")),
                ("sharded: SU(3) heat-bath + 1 OR, track_kp_exhaust, mesh "
                 f"{MESH}", True, dict(group=3, beta=6.0, n_or=1,
                                       track_kp_exhaust=True, mesh=MESH)),
                ("sharded: SU(3) heat-bath, prngcl:ranlux3, mesh (2,1,1,1)",
                 True, dict(group=3, beta=6.0, rng_mode="prngcl:ranlux3",
                            mesh=(2, 1, 1, 1)))):
            small = SimConfig(**kw, dims=SMALL, seed=1, start="hot",
                              reunit_every=2)
            obs_gpu = Simulation(small, device="cuda").run(2, 1)
            obs_cpu = Simulation(small, device="cpu").run(2, 1)
            d_plq = np.abs(obs_gpu[0, :4] - obs_cpu[0, :4]).max()
            d_pol = np.abs(obs_gpu[0, 4:6] - obs_cpu[0, 4:6]).max()
            d_rate = np.abs(obs_gpu[:, 6:] - obs_cpu[:, 6:]).max(initial=0.0)
            msg = (f"{label}, {SMALL}: row 0 |d| plq/action {d_plq:.2e}, "
                   f"poly {d_pol:.2e}; tracked column |d| {d_rate:.2e}")
            print(msg)
            require(d_plq < ROW_TOL[0] and d_pol < ROW_TOL[1]
                    and d_rate <= RATE_TOL, msg)

        def zero_counters():
            for c in counters:
                for k in c:
                    c[k] = 0

        def expected(cfg, n_sweeps, n_reunit, n_meas):
            """Launches per counter; on a mesh every launch is one per
            shard, of the shard instantiations and K5a/K5b."""
            n = cfg.group
            tracked = cfg.track_acceptance or cfg.track_kp_exhaust
            gen = ps.stream_mode_name(cfg.rng_mode)
            k = int(np.prod(cfg.mesh))
            sh, loc = k > 1, "_local" if k > 1 else ""
            expect = {
                cupdate.instance_name(cfg.algorithm, n, tracked, gen, sh):
                    8 * n_sweeps * k,
                f"plane_sums{loc}_su{n}": n_meas * k,
                f"polyakov_sums{loc}_su{n}": n_meas * k,
            }
            if n_reunit:
                expect[f"reunit_su{n}"] = 8 * n_reunit * k
            if cfg.n_or:
                expect[cupdate.instance_name("overrelax", n, shard=sh)] = (
                    8 * cfg.n_or * n_sweeps * k)
            return expect

        def check_run(label, sim, obs, launches, expect):
            cfg = sim.cfg
            tracked = cfg.track_acceptance or cfg.track_kp_exhaust
            plq = float(obs[-1, 0])
            defect = sim.unitarity_defect()
            tail = ""
            if tracked:
                col = obs[:, -1]
                tail = (f"; {sim.obs_names[-1]} mean {col.mean():.6e} "
                        f"(min {col.min():.6e}, max {col.max():.6e})")
                require(np.isfinite(col).all() and (col >= 0).all()
                        and (col <= 1).all(), f"{label}: tracked column")
            print(f"  plaquette {plq:.6f}; unitarity defect {defect:.3e}; "
                  f"launches {launches}{tail}")
            require(np.isfinite(obs).all(), f"{label}: bad series")
            # the constant debug generator samples no distribution
            if cfg.rng_mode != "prngcl:constant":
                require(0.3 < plq < 1.0, f"{label}: plaquette {plq}")
            require(defect < 1e-5, f"{label}: unitarity defect {defect}")
            require(launches == expect,
                    f"{label}: launches {launches}, expected {expect}")
            for k, v in launches.items():
                record[k]["launches"] += v

        def idle_share(sim):
            wall, wall_prof, busy, by_name = profile_window(sim, 5)
            if busy is None:
                print("  idle share: not measured (the profiler saw no "
                      "device event)")
                return
            top = sorted(by_name.items(), key=lambda kv: -kv[1][0])
            print(f"  thermalize(5) + run(5, 1): wall {wall:.3f} ms "
                  f"({wall_prof:.3f} ms under the profiler), device "
                  f"busy {busy:.3f} ms, idle share "
                  f"{1 - busy / wall:.4f} "
                  f"({1 - busy / wall_prof:.4f} under the "
                  f"profiler)  [{smi}]")
            for kname, (ms, calls) in top[:6]:
                print(f"    {ms:9.3f} ms {calls:5d} calls  "
                      f"{kname[:90]}")

        def drive(label, cfg, profile, keep=False):
            """The 32^4 main path: Simulation(cfg) on the card by default,
            warmup(), thermalize(THERM), run(RUN, 1), counters zeroed
            before and read after.  -> a copy of the final links (the
            global packed 8-tuple) with keep, else None."""
            n_sweeps = 2 + THERM + RUN  # warmup() runs 1 sweep + 1 measured
            n_reunit = sum(1 for i in range(THERM + RUN) if i % 10 == 9)
            expect = expected(cfg, n_sweeps, n_reunit, 1 + RUN)
            zero_counters()
            t0 = time.perf_counter()
            sim = Simulation(cfg).sync()  # the card, by default
            t_init = time.perf_counter()
            sim.warmup()
            t1 = time.perf_counter()
            sim.thermalize(THERM).sync()
            t2 = time.perf_counter()
            obs = sim.run(RUN, 1)
            t3 = time.perf_counter()
            launches = {k: v for c in counters for k, v in c.items() if v}
            therm_ms = (t2 - t1) / THERM * 1e3
            run_ms = (t3 - t2) / RUN * 1e3
            n_links = 4 * int(np.prod(BIG))
            print(f"{label}: start state built in {t_init - t0:.3f} s; "
                  f"warmup {t1 - t_init:.2f} s; thermalize "
                  f"{therm_ms:.3f} ms/sweep "
                  f"({n_links / therm_ms * 1e3:.4e} link-updates/s); run "
                  f"with measurement {run_ms:.3f} ms/sweep "
                  f"({n_links / run_ms * 1e3:.4e} link-updates/s)  [{smi}]")
            require(obs.shape == (RUN, len(sim.obs_names)),
                    f"{label}: series shape {obs.shape}")
            check_run(label, sim, obs, launches, expect)
            final = tuple(a.clone() for a in sim.us) if keep else None
            if profile:
                idle_share(sim)
            del sim
            return final

        bench_us = None
        for label, is_slice, kw in MAIN_PATHS:
            us = drive(label, SimConfig(**kw, dims=BIG, reunit_every=10,
                                        start="cold", seed=0,
                                        rng_mode="threefry"), is_slice,
                       keep=bench_us is None)
            bench_us = bench_us or us
        for gen in STREAM_BIG:
            drive(f"streams: SU(3) heat-bath, prngcl:{gen}",
                  SimConfig(group=3, beta=6.0, dims=BIG, reunit_every=10,
                            start="cold", seed=0, rng_mode=f"prngcl:{gen}"),
                  gen == "ranlux3")

        # every stream instantiation on a path of its own at 8^4: warmup(),
        # thermalize(2), run(2, 1), reunit_every=2, alternating cold and
        # hot starts (the stream hot start; the constant generator's would
        # be degenerate), one in three with 1 OR pass
        for i, gen, n, kind, track in small_runs:
            kw = dict(group=n, beta=BETA_RUN[n], algorithm=kind,
                      dims=STREAM_SMALL_RUN, reunit_every=2,
                      start=("cold", "hot")[i % 2 and gen != "constant"],
                      seed=i, n_or=int(i % 3 == 0), rng_mode=f"prngcl:{gen}")
            if track:
                kw["track_kp_exhaust" if kind == "heatbath"
                   else "track_acceptance"] = True
            cfg = SimConfig(**kw)
            zero_counters()
            sim = Simulation(cfg)
            sim.warmup()
            sim.thermalize(2)
            obs = sim.run(2, 1)
            launches = {k: v for c in counters for k, v in c.items() if v}
            label = (f"{gen} SU({n}) {kind} track={track} n_or={cfg.n_or} "
                     f"{cfg.start} {STREAM_SMALL_RUN}")
            print(label)
            check_run(label, sim, obs, launches, expected(cfg, 6, 2, 3))

        # every K1a instantiation on a path of its own at 8^4, as the
        # stream instantiations above, over the X, Y and XY meshes in turn;
        # the untracked threefry heat-bath runs add 1 OR pass (the
        # overrelaxation instantiations)
        for i, name, gen, mesh in k1a_runs:
            kind, n, track, _ = parse_instance(name)
            kw = dict(group=n, beta=BETA_RUN[n], algorithm=kind,
                      dims=STREAM_SMALL_RUN, reunit_every=2,
                      start=("cold", "hot")[i % 2 and gen != "constant"],
                      seed=i, n_or=int(kind == "heatbath" and not track
                                       and gen is None),
                      rng_mode=f"prngcl:{gen}" if gen else "threefry",
                      mesh=mesh)
            if track:
                kw["track_kp_exhaust" if kind == "heatbath"
                   else "track_acceptance"] = True
            cfg = SimConfig(**kw)
            zero_counters()
            sim = Simulation(cfg)
            sim.warmup()
            sim.thermalize(2)
            obs = sim.run(2, 1)
            launches = {k: v for c in counters for k, v in c.items() if v}
            label = (f"K1a {name}: {cfg.rng_mode} n_or={cfg.n_or} "
                     f"{cfg.start} {STREAM_SMALL_RUN} mesh {cfg.mesh}")
            print(label)
            check_run(label, sim, obs, launches, expected(cfg, 6, 2, 3))

        # the sharded path: the bench configuration on MESH through the
        # library, then links bit-identical to the unsharded chain
        bench = SimConfig(group=3, beta=6.0, dims=BIG, reunit_every=10,
                          start="cold", seed=0)
        us = drive(f"sharded: bench SU(3) heat-bath, mesh {MESH}",
                   bench.replace(mesh=MESH), True, keep=True)
        same = all(torch.equal(a, b) for a, b in zip(us, bench_us))
        print(f"  links after {2 + THERM + RUN} sweeps bit-identical to the "
              f"unsharded run: {same}")
        require(same, f"mesh {MESH}: links differ from the unsharded chain")
        del us, bench_us

        def same_chain(label, cfg, mesh, n_sweeps):
            """Simulation(cfg) unsharded and on mesh, thermalize(n_sweeps)
            each from the same start: links (and stream state) must be
            bit-identical."""
            states = []
            for m in ((1, 1, 1, 1), mesh):
                sim = Simulation(cfg.replace(mesh=m))
                t0 = time.perf_counter()
                sim.thermalize(n_sweeps).sync()
                ms = (time.perf_counter() - t0) / n_sweeps * 1e3
                states.append((sim.us, sim.stream_state, ms))
                del sim
            (u1, s1, ms1), (un, sn, msn) = states
            same = all(torch.equal(a, b) for a, b in zip(u1, un))
            if s1 is not None:
                same = same and all(np.array_equal(s1[k], sn[k]) for k in s1)
            print(f"{label}: mesh {mesh} vs unsharded after {n_sweeps} "
                  f"sweeps: bit-identical {same} ({msn:.3f} vs {ms1:.3f} "
                  f"ms/sweep, first sweeps included)  [{smi}]")
            require(same, f"{label}: mesh {mesh} differs from unsharded")

        for mesh in ((4, 1, 1, 1), (1, 4, 1, 1)):
            same_chain("bench SU(3) heat-bath 32^4", bench, mesh, 12)
        same_chain("SU(3) heat-bath 32^4 prngcl:ranlux3",
                   bench.replace(rng_mode="prngcl:ranlux3"), (2, 1, 1, 1), 12)
        # K1b's check: SU(3) 64^4, which the TPU runs Y-tiled, on 8 Y shards
        same_chain("SU(3) heat-bath 64^4", bench.replace(dims=(64,) * 4),
                   (1, 8, 1, 1), 2)

    def chain(therm, sweeps, keep=False, **kw):
        sim = Simulation(SimConfig(**kw))
        sim.thermalize(therm)
        sim.run(sweeps, 1)
        if keep:
            return sim.analysis(), sim.us
        return sim.analysis()

    def self_gate(st, anchor, anchor_err, window):
        """|mean - anchor| and the reference's tolerance
        max(window, 3 sigma_comb) (validate.py:_self_gate)."""
        return (abs(st.mean - anchor),
                max(window, 3.0 * float(np.hypot(st.err, anchor_err))))

    with Phase("6 physics"):
        a, u1 = chain(200, 400, keep=True, group=3, dims=(16,) * 4, beta=6.0)
        st = a["plq"]
        print(f"SU(3) 16^4 beta=6.0 HB: <plq> = {st.mean:.7f} +- "
              f"{st.err:.7f} (tau_int {st.tau_int:.2f}); window 0.5937 +- "
              f"5e-4")
        require(abs(st.mean - 0.5937) < 5e-4, f"<plq> {st.mean}")
        a, un = chain(200, 400, keep=True, group=3, dims=(16,) * 4, beta=6.0,
                      mesh=MESH)
        same = all(torch.equal(x, y) for x, y in zip(u1, un))
        print(f"SU(3) 16^4 beta=6.0 HB, mesh {MESH}: <plq> = "
              f"{a['plq'].mean:.7f} +- {a['plq'].err:.7f}; |d mean| from "
              f"unsharded {abs(a['plq'].mean - st.mean):.1e}; links "
              f"bit-identical {same}")
        require(same and abs(a["plq"].mean - st.mean) < 1e-7,
                f"mesh {MESH} 16^4 chain differs from the unsharded one")
        del u1, un

        a = chain(300, 600, group=3, dims=(16,) * 4, beta=6.0, n_or=1,
                  track_kp_exhaust=True, seed=7)
        st = a["plq"]
        dev_, tol = self_gate(st, 0.5937234, 4.2e-5, 1e-4)
        print(f"SU(3) 16^4 beta=6.0 HB + 1 OR, seed 7: <plq> = "
              f"{st.mean:.7f} +- {st.err:.7f} (tau_int {st.tau_int:.2f}); "
              f"|d| from 0.5937: {abs(st.mean - 0.5937):.2e} (< 5e-4); "
              f"from anchor 0.5937234: {dev_:.2e} (< {tol:.2e}); "
              f"kp_exhaust_rate {a['kp_exhaust_rate'].mean:.3e}")
        require(abs(st.mean - 0.5937) < 5e-4 and dev_ < tol,
                f"SU(3) HB + OR <plq> {st.mean}")

        st = chain(300, 1000, group=2, dims=(8,) * 4, beta=2.4,
                   seed=42)["plq"]
        lit = max(5 * st.err, 0.002)
        dev_, tol = self_gate(st, 0.6304030, 2.7e-4, 2.5e-4)
        print(f"SU(2) 8^4 beta=2.4 HB, seed 42: <plq> = {st.mean:.7f} +- "
              f"{st.err:.7f} (tau_int {st.tau_int:.2f}); |d| from 0.6300: "
              f"{abs(st.mean - 0.63):.2e} (< {lit:.2e}); from anchor "
              f"0.6304030: {dev_:.2e} (< {tol:.2e})")
        require(abs(st.mean - 0.63) < lit and dev_ < tol,
                f"SU(2) HB <plq> {st.mean}")

        a = chain(500, 1000, group=2, dims=(8,) * 4, beta=2.4,
                  algorithm="metropolis", track_acceptance=True, seed=42)
        st = a["plq"]
        lit = max(5 * st.err, 0.002)
        acc = a["acc_rate"].mean
        print(f"SU(2) 8^4 beta=2.4 Metropolis: <plq> = {st.mean:.7f} +- "
              f"{st.err:.7f} (tau_int {st.tau_int:.2f}); |d| from 0.6300: "
              f"{abs(st.mean - 0.63):.2e} (< {lit:.2e}); acc_rate {acc:.4f}")
        require(abs(st.mean - 0.63) < lit, f"SU(2) Metropolis <plq> {st.mean}")
        require(0.0 < acc < 1.0, f"acc_rate {acc}")

        # the stream path: QCDGPU's default generator on the production
        # point, and ranmar on SU(2)
        a = chain(300, 600, group=3, dims=(16,) * 4, beta=6.0, n_or=1,
                  track_kp_exhaust=True, seed=7, rng_mode="prngcl:ranlux3")
        st = a["plq"]
        dev_, tol = self_gate(st, 0.5937234, 4.2e-5, 1e-4)
        print(f"SU(3) 16^4 beta=6.0 HB + 1 OR, seed 7, prngcl:ranlux3: "
              f"<plq> = {st.mean:.7f} +- {st.err:.7f} (tau_int "
              f"{st.tau_int:.2f}); |d| from 0.5937: "
              f"{abs(st.mean - 0.5937):.2e} (< 5e-4); from anchor "
              f"0.5937234: {dev_:.2e} (< {tol:.2e}); kp_exhaust_rate "
              f"{a['kp_exhaust_rate'].mean:.3e}")
        require(abs(st.mean - 0.5937) < 5e-4 and dev_ < tol,
                f"SU(3) HB + OR ranlux3 <plq> {st.mean}")

        st = chain(300, 1000, group=2, dims=(8,) * 4, beta=2.4, seed=42,
                   rng_mode="prngcl:ranmar")["plq"]
        lit = max(5 * st.err, 0.002)
        dev_, tol = self_gate(st, 0.6304030, 2.7e-4, 2.5e-4)
        print(f"SU(2) 8^4 beta=2.4 HB, seed 42, prngcl:ranmar: <plq> = "
              f"{st.mean:.7f} +- {st.err:.7f} (tau_int {st.tau_int:.2f}); "
              f"|d| from 0.6300: {abs(st.mean - 0.63):.2e} (< {lit:.2e}); "
              f"from anchor 0.6304030: {dev_:.2e} (< {tol:.2e})")
        require(abs(st.mean - 0.63) < lit and dev_ < tol,
                f"SU(2) HB ranmar <plq> {st.mean}")

    idle = [k for k, r in record.items() if not r["launches"]]
    require(not idle, f"kernels no main path launched: {idle}")
    print(json.dumps({"kernels": list(record.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
