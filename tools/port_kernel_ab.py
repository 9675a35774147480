#!/usr/bin/env python3
"""K1 / K1a (the Philox heat-bath stage, unsharded and on a shard), K3 /
K5a (the plane sums) and K4 / K5b / K4c (the Polyakov sums, unsharded, on
a shard and over a scan's chains) of the PyTorch port, built from two or
more CUDA source trees and timed in one process on one card, to compare
kernel versions within one chip call.

    python3 tools/port_kernel_ab.py OLD_CSRC NEW_CSRC [MORE_CSRC ...]
    python3 tools/port_kernel_ab.py --streams OLD_CSRC NEW_CSRC [...]

Each argument is a ``qcdgpu_tpu_torch/csrc`` directory of a checkout (to
compare with a parent commit, unpack it into a gitignored directory with
git archive; a variant is an edited copy).  Its ``stage_philox.cu`` and
``measure.cu`` compile with this checkout's nvcc flags (ops/cuda/build.py)
into a library of their own, all trees in parallel, and the C entry points
are called with the argument types of that tree's own ops/cuda/build.py.
The script prints each tree's ptxas lines for the kernels it times (from
chip_smoke.ptxas_summary), checks that every tree gives the first tree's
links and tracked count bit for bit (the stages) and the same sums within
1e-7 per site (the plane sums), and every tree's Polyakov sums against
this checkout's plain twin (2e-6 per spatial site, chip_smoke.py's bar),
then times the calls in rounds over the trees in order and then in
reverse (old, new, new, old for two), CUDA events over 50 calls, each
line with the card's nvidia-smi name and power limit.  The Polyakov calls
run at 256 and at 512 threads a block ("/512"), and again under
torch.profiler for their device time (kernel and finish kernel), which
CUDA events around back-to-back calls do not give below ~0.05 ms.
Stages are (mu=1, parity 0) at beta 6.0 (SU(3)) or 2.4 (SU(2)).

Inputs, 32^4, SU(3) and SU(2): a hot start, and this checkout's own
Simulation chain (cold start, reunit_every=10, rng_mode "hw"; SU(3): the
bench's configuration) after 50 sweeps, where most heat-bath trials
accept at once.  The shard is shard 0 of mesh (2,2,1,1), its halos cut
from the same links.  K4c runs on 11 hot starts at 24^3 x 6 (BASELINE
config 3's scan).  Last, the bounds chip_smoke.py records for each call
and its f32 floor at -fmad=false, and for the Polyakov calls the f32
floor of the ladder's own products (every lane of a column's group
multiplies at every level).

With --streams it builds stage.cu, stage_philox.cu and the seven
stage_<family>.cu of each tree (one nvcc per source, as many at once as
the host has cores; a tree that fails to build is reported and left
out), prints every tree's ranlux / ranmar ptxas lines and its K1
instantiations with a frame or spills, and runs K1 and K1a (shard 0)
drawing from ranlux3 and ranmar (K8), xor128, mrg32k3a, xor7 and the
constant stream (K7) and, as controls, threefry and Philox, heat-bath
and Metropolis, and K8's stages past 48 KB of shared memory (ranlux3
with 25 Metropolis hits, ranmar with 8 KP trials) and past a column's
413 draws a subgroup (ranlux3 with 110 hits), on the same inputs:
every tree must give the first tree's links, stream words, scalars and
tracked count bit for bit; then the same rounds of CUDA events, each
call's device time under torch.profiler, and the bounds with each stream
row's integer floor (chip_smoke.rng_ops_per_site).
"""

import ctypes
import importlib.util
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DIMS = (32, 32, 32, 32)
MESH = (2, 2, 1, 1)
BETA = {3: 6.0, 2: 2.4}
REPS = 50
THERM = 50
PLANE_TOL = 1e-7  # |d sum| / (N * volume), chip_smoke.py's bar
SOURCES = ("stage_philox.cu", "measure.cu")
ENTRIES = ("qg_stage_philox", "qg_stage_philox_shard", "qg_plane_sums",
           "qg_plane_sums_local", "qg_polyakov_sums", "qg_polyakov_sums_local",
           "qg_polyakov_sums_chains")
# the kernels timed, by chip_smoke.kernel_label, for the ptxas lines
TIMED = tuple(f"stage_heatbath_su{n}_philox{s}" for n in (3, 2)
              for s in ("", "_shard")) + tuple(
    f"{k}<{n}>{s}" for k in ("plane_sums_kernel", "polyakov_sums_kernel")
    for n in (3, 2) for s in ("", "_shard")
) + ("plane_sums_tile_kernel<3>", "plane_sums_tile_kernel<2>")
# --streams: every stage source, since qg_stage_stream dispatches to all
# seven families' launchers
STREAM_SOURCES = ("stage.cu", "stage_philox.cu") + tuple(
    f"stage_{fam}.cu" for fam in ("xor128", "xor7", "mrg32k3a", "parkmiller",
                                  "constant", "ranlux", "ranmar"))
STREAM_ENTRIES = ("qg_stage", "qg_stage_shard", "qg_stage_philox",
                  "qg_stage_philox_shard", "qg_stage_stream",
                  "qg_stage_stream_shard")
# K8's two generators, then K7's: the two of the perf matrix, xor7, and the
# constant stream, which draws without a generator (K1's own cost)
STREAM_GENS = ("ranlux3", "ranmar", "xor128", "mrg32k3a", "xor7", "constant")
SCAN = (24, 24, 24, 6)
CHAINS = 11
POLY_TOL = 2e-6  # |d sum| / (N * spatial volume), chip_smoke.py's bar


def build_trees(trees, out_dirs, sources, nvcc, flags):
    """Compile each tree's sources, one nvcc per (tree, source), as many at
    once as the host has cores, and link one library per tree.  Returns
    [(path or None, nvcc log)]: a tree whose build fails keeps its log and
    no library."""
    def compile_one(job):
        csrc, out_dir, src = job
        obj = out_dir / f"{Path(src).stem}.o"
        proc = subprocess.run([nvcc, *flags, "-c", "-o", str(obj),
                               str(csrc / src)], capture_output=True,
                              text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode:
            log += (f"\n{src}: nvcc exit {proc.returncode}; its last lines:"
                    f"\n{log[-1500:]}\n")
        return proc.returncode == 0, log, str(obj)

    jobs = [(t, d, s) for t, d in zip(trees, out_dirs) for s in sources]
    with ThreadPoolExecutor(os.cpu_count() or 8) as pool:
        done = list(pool.map(compile_one, jobs))
    out = []
    for i, out_dir in enumerate(out_dirs):
        mine = done[i * len(sources):(i + 1) * len(sources)]
        log = "".join(m[1] for m in mine)
        lib = out_dir / "lib.so"
        ok = all(m[0] for m in mine) and subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(lib), *(m[2] for m in mine)]).returncode == 0
        out.append((lib if ok else None, log))
    return out


def inputs(n, dev):
    """(label, packed links) at DIMS: a hot start, and this checkout's own
    hw chain (cold start, reunit_every=10) after THERM sweeps."""
    from qcdgpu_tpu_torch import SimConfig, Simulation
    from qcdgpu_tpu_torch.ops import rng
    from qcdgpu_tpu_torch.ops.cuda import engine

    chain = Simulation(SimConfig(group=n, beta=BETA[n], dims=DIMS, seed=0,
                                 start="cold", reunit_every=10,
                                 rng_mode="hw"), device=dev)
    chain.thermalize(THERM)
    yield "hot start", engine.packed_hot_start(
        SimConfig(group=n, dims=DIMS, seed=1), rng.make_base_key(1), dev)
    yield f"hw chain after {THERM} sweeps", tuple(
        a.clone() for a in chain.us)


def tree_signatures(csrc, i):
    """SIGNATURES of the ops/cuda/build.py beside csrc (its tree's own C
    interface)."""
    path = csrc.parent / "ops" / "cuda" / "build.py"
    spec = importlib.util.spec_from_file_location(f"_ab_build_{i}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES


def load_trees(trees, sources, entries, shown):
    """Build each tree's sources into a library of its own (build_trees),
    print its ptxas lines for the kernels shown(name) selects and its K1
    instantiations with a stack frame or spills, and bind entries with the
    argument types of the tree's own ops/cuda/build.py.  A tree that fails
    to build is reported and left out; the first must build.  Returns
    [(label, library, SIGNATURES)]."""
    import chip_smoke
    from qcdgpu_tpu_torch.ops.cuda import build
    from qcdgpu_tpu_torch.ops.cuda import update as cupdate

    tmp = Path(tempfile.mkdtemp(prefix="kernel_ab_", dir=ROOT / "build"))
    dirs = [tmp / f"t{i}" for i in range(len(trees))]
    for d in dirs:
        d.mkdir()
    t0 = time.perf_counter()
    built = build_trees(trees, dirs, sources, build.nvcc_path(),
                        build.NVCC_FLAGS)
    print(f"built {len(trees)} trees in {time.perf_counter() - t0:.1f} s")
    out = []
    for i, (tree, (path, log)) in enumerate(zip(trees, built)):
        label = f"[{i}] {tree}"
        rows = chip_smoke.ptxas_summary(log, cupdate.KINDS)
        for name, line, _ in rows:
            if shown(name):
                print(f"{label}: ptxas {name}: {line}")
        # device functions kept out of line (no entry of their own)
        for m in re.finditer(r"Function properties for (\w+)\n\s*(.*)", log):
            if "_kernel" not in m[1]:
                print(f"{label}: ptxas out-of-line {m[1]}: {m[2]}")
        framed = [name for name, line, _ in rows if name.startswith("stage_")
                  and any(chip_smoke.frame_and_spills(line))]
        print(f"{label}: K1 instantiations with a stack frame or spills: "
              f"{framed or 'none'}")
        if path is None:
            print(f"{label}: nvcc failed, left out:\n"
                  + log[log.index("nvcc exit") - 80:][:3000])
            if i == 0:
                raise SystemExit("the first tree must build")
            continue
        lib = ctypes.CDLL(str(path))
        sigs = tree_signatures(tree, i)
        for fn in entries:
            getattr(lib, fn).argtypes = sigs[fn]
            getattr(lib, fn).restype = ctypes.c_int
        out.append((label, lib, sigs))
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("port_kernel_ab: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    streams = sys.argv[1:2] == ["--streams"]
    trees = [Path(a).resolve() for a in sys.argv[1 + streams:]]
    sources = STREAM_SOURCES if streams else SOURCES
    if len(trees) < 2 or not all((t / s).exists() for t in trees
                                 for s in sources):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    if streams:
        return streams_main(trees)
    import chip_smoke
    from qcdgpu_tpu_torch import SimConfig
    from qcdgpu_tpu_torch.ops import rng
    from qcdgpu_tpu_torch.ops.cuda import build, engine, sharded
    from qcdgpu_tpu_torch.ops.cuda import measure as cmeasure
    from qcdgpu_tpu_torch.ops.cuda import update as cupdate
    from qcdgpu_tpu_torch.parallel.mesh import ShardGrid

    smi = chip_smoke.nvidia_smi_lines()[0]
    loaded = load_trees(trees, SOURCES, ENTRIES, lambda name: name in TIMED)
    labels = [label for label, _, _ in loaded]
    # older trees' plane sums take the block size (256) as an argument
    libs = [(lib, len(sigs["qg_plane_sums"]) == 17)
            for _, lib, sigs in loaded]

    dev = torch.device("cuda", 0)
    stream = build.stream_handle(dev)
    grid = ShardGrid(DIMS, MESH, [dev])
    shard = grid.shards[0]
    hb = cupdate.KINDS.index("heatbath")
    key = rng.stage_key(rng.make_base_key(1), 0, 0)
    v = 1
    for d in DIMS:
        v *= d
    partials = torch.empty(-(-v // 32) * 6, dtype=torch.float64,
                           device=dev)
    out = torch.empty(6, dtype=torch.float64, device=dev)
    p_out = torch.empty(CHAINS, 2, dtype=torch.float64, device=dev)

    def stage(lib, us, n, sh, count=None):
        fn, geom = ((lib.qg_stage_philox, DIMS) if sh is None else
                    (lib.qg_stage_philox_shard, sh.kernel_args()))
        err = fn(*[a.data_ptr() for a in us], n, hb, int(count is not None),
                 1, 0, *geom, key[0], key[1],
                 cupdate.two_beta_over_n(BETA[n], n), 4, 3, 0.35,
                 None if count is None else count.data_ptr(), stream)
        if err:
            raise RuntimeError(f"stage: CUDA error {err}")

    def planes(lib_block, us, n, sh):
        lib, has_block = lib_block
        fn, geom = ((lib.qg_plane_sums, DIMS) if sh is None else
                    (lib.qg_plane_sums_local, sh.kernel_args()))
        err = fn(*[a.data_ptr() for a in us], n, *geom,
                 *((256,) if has_block else ()), partials.data_ptr(),
                 out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"plane sums: CUDA error {err}")
        return out.clone()

    def poly(lib_block, us, n, sh, block=256, chains=0):
        """K4 (K5b on shard sh; K4c over the chains of chain-stacked
        arrays at SCAN when chains > 0) -> f64 [2] (or [chains, 2])"""
        lib = lib_block[0]
        u67 = (us[6].data_ptr(), us[7].data_ptr())
        if chains:
            err = lib.qg_polyakov_sums_chains(
                *u67, us[0][0].numel(), chains, n, *SCAN, block,
                partials.data_ptr(), p_out.data_ptr(), stream)
        elif sh is None:
            err = lib.qg_polyakov_sums(*u67, n, *DIMS, block,
                                       partials.data_ptr(), p_out.data_ptr(),
                                       stream)
        else:
            err = lib.qg_polyakov_sums_local(*u67, n, *sh.kernel_args(),
                                             block, partials.data_ptr(),
                                             p_out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"Polyakov sums: CUDA error {err}")
        return (p_out if chains else p_out[0]).clone()

    def device_line(fn):
        kern, total = chip_smoke.device_ms(fn, REPS, "polyakov_sums_kernel")
        return ("not measured" if kern is None
                else f"{kern:.4f} / {total:.4f} ms")

    # (call, on the shard); "/512": 512 threads a block
    calls = (("K1", False), ("K1a", True), ("K3", False), ("K5a", True),
             ("K4", False), ("K4/512", False), ("K5b", True),
             ("K5b/512", True))
    poly_calls = [c for c, _ in calls if c.startswith(("K4", "K5b"))]
    for n in (3, 2):
        for what, us_full in inputs(n, dev):
            what = f"SU({n}) {what}"
            us_shard = sharded.shard_links(us_full, grid)[0]

            def arrays(on_shard):
                return tuple(a.clone() for a in (
                    us_shard if on_shard else us_full))

            def call(name, lb, us, count=None):
                sh = shard if name[:3] in ("K1a", "K5a", "K5b") else None
                if name.startswith("K1"):
                    return stage(lb[0], us, n, sh, count)
                if name in poly_calls:
                    return poly(lb, us, n, sh, 512 if "/512" in name
                                else 256)
                return planes(lb, us, n, sh)

            # every tree against the first: links and count, then the sums
            for name, on_shard in calls[:2]:
                first = None
                for label, lb in zip(labels, libs):
                    us = arrays(on_shard)
                    cnt = torch.zeros(1, dtype=torch.int64, device=dev)
                    call(name, lb, us, cnt)
                    sums = call(("K3", "K5a")[on_shard], lb, us)
                    torch.cuda.synchronize()
                    if first is None:
                        first = (us, cnt, sums)
                        continue
                    same = (all(torch.equal(a, b)
                                for a, b in zip(us, first[0]))
                            and torch.equal(cnt, first[1]))
                    d_sum = (sums - first[2]).abs().max().item() / (n * v)
                    print(f"{what}: {name}: {label}: links and count "
                          f"bit-identical to [0]: {same} (count "
                          f"{cnt.item()}); plane sums |d| / (N V) "
                          f"{d_sum:.3e}")
                    if not same or d_sum >= PLANE_TOL:
                        raise SystemExit(f"{label} disagrees with "
                                         f"{labels[0]}")

            # every tree's Polyakov sums against this checkout's twin
            twin = {False: cmeasure.polyakov_sums_ref(us_full, DIMS),
                    True: cmeasure.polyakov_sums_local_ref(us_shard, shard)}
            for label, lb in zip(labels, libs):
                for name, on_shard in calls:
                    if name not in poly_calls:
                        continue
                    lx, ly = shard.local if on_shard else DIMS[:2]
                    d = (call(name, lb, arrays(on_shard)) - twin[on_shard]
                         ).abs().max().item() / (n * lx * ly * DIMS[2])
                    print(f"{what}: {name}: {label}: |d sum| / (N spatial "
                          f"vol) against the twin {d:.3e}")
                    if d >= POLY_TOL:
                        raise SystemExit(f"{label}: {name} disagrees with "
                                         "the twin")

            arrs = (arrays(False), arrays(True))
            order = list(range(len(libs))) + list(
                reversed(range(len(libs))))
            times = {i: {c: [] for c, _ in calls} for i in range(len(libs))}
            for i in order:
                for name, on_shard in calls:
                    times[i][name].append(chip_smoke.event_ms(
                        lambda: call(name, libs[i], arrs[on_shard]), REPS))
                print(f"{what}: {labels[i]}: " + ", ".join(
                    f"{c} {times[i][c][-1]:.4f}" for c, _ in calls)
                    + f" ms  [{smi}]", flush=True)
            for i, label in enumerate(labels):
                print(f"{what}: {label}: mean " + ", ".join(
                    f"{c} {sum(t) / len(t):.4f}"
                    for c, t in times[i].items()) + f" ms  [{smi}]")
            for i in order:
                print(f"{what}: {labels[i]}: on the device (profiler; "
                      "kernel / with the finish kernel): " + ", ".join(
                          "{} {}".format(c, device_line(
                              lambda c=c, s=on_shard: call(c, libs[i],
                                                           arrs[s])))
                          for c, on_shard in calls if c in poly_calls)
                      + f"  [{smi}]", flush=True)
            del arrs
        # K4c over CHAINS hot starts at SCAN
        us_c = tuple(torch.stack(a) for a in zip(*[
            engine.packed_hot_start(SimConfig(group=n, dims=SCAN,
                                              seed=1 + c),
                                    rng.make_base_key(1 + c), dev)
            for c in range(CHAINS)]))
        twin = cmeasure.polyakov_sums_chains_ref(us_c, SCAN)
        vol = n * SCAN[0] * SCAN[1] * SCAN[2]
        for label, lb in zip(labels, libs):
            d = (poly(lb, us_c, n, None, chains=CHAINS) - twin
                 ).abs().max().item() / vol
            print(f"SU({n}) {SCAN} x {CHAINS} chains: K4c: {label}: |d sum| "
                  f"/ (N spatial vol) against the twin {d:.3e}")
            if d >= POLY_TOL:
                raise SystemExit(f"{label}: K4c disagrees with the twin")
        for i in list(range(len(libs))) + list(reversed(range(len(libs)))):
            line = []
            for block in (256, 512):
                def fn(block=block, i=i):
                    return poly(libs[i], us_c, n, None, block, CHAINS)
                line.append(f"K4c{'/512' if block == 512 else ''} "
                            f"{chip_smoke.event_ms(fn, REPS):.4f} ms, on "
                            "the device "
                            f"{device_line(fn)}")
            print(f"SU({n}) {SCAN} x {CHAINS} chains: {labels[i]}: "
                  + "; ".join(line) + f"  [{smi}]", flush=True)
        del us_c
    # the bounds chip_smoke.py records, and the f32 floor at -fmad=false
    for n in (3, 2):
        for label, name, sh in (
                ("K1", f"stage_heatbath_su{n}_philox", None),
                ("K1a", f"stage_heatbath_su{n}_philox_shard", shard),
                ("K3", f"plane_sums_su{n}", None),
                ("K5a", f"plane_sums_local_su{n}", shard)):
            nbytes, f32_ops, int_ops, _ = chip_smoke.work(
                name, DIMS if sh is None else sh.interior, shard=sh)
            ms, by = chip_smoke.bound(nbytes, f32_ops, int_ops)
            print(f"{label} {name}: bound {ms:.4f} ms ({by}), -fmad=false "
                  f"f32 floor "
                  f"{f32_ops / chip_smoke.F32_INSTR_PER_S * 1e3:.4f} ms")
        for label, name, dims, sh, c in (
                ("K4", f"polyakov_sums_su{n}", DIMS, None, 1),
                ("K5b", f"polyakov_sums_local_su{n}", shard.interior, shard,
                 1),
                ("K4c", f"polyakov_sums_su{n}", SCAN, None, CHAINS)):
            nbytes, f32_ops, int_ops, _ = chip_smoke.work(name, dims,
                                                          shard=sh)
            ms, by = chip_smoke.bound(c * nbytes, c * f32_ops, c * int_ops)
            floor, ladder = (c * ops / chip_smoke.F32_INSTR_PER_S * 1e3
                             for ops in (f32_ops, ladder_f32_ops(n, dims)))
            print(f"{label} {name} {dims} x {c}: bound {ms:.4f} ms ({by}), "
                  f"-fmad=false f32 floor {floor:.4f} ms; the ladder's "
                  f"{ladder:.4f} ms")
    return 0


class Refused(Exception):
    """A tree's launcher refused a stage (cudaErrorInvalidValue)."""


def streams_main(trees):
    """--streams: K1 and K1a drawing from the PRNGCL streams (K8: ranlux3,
    ranmar; K7: xor128, mrg32k3a, xor7, constant) and the threefry and
    Philox stages as controls, heat-bath and Metropolis."""
    import torch

    import chip_smoke
    from qcdgpu_tpu_torch import SimConfig
    from qcdgpu_tpu_torch.ops import prng_streams as ps
    from qcdgpu_tpu_torch.ops import rng
    from qcdgpu_tpu_torch.ops.cuda import build, engine, sharded
    from qcdgpu_tpu_torch.ops.cuda import update as cupdate
    from qcdgpu_tpu_torch.parallel.mesh import ShardGrid

    smi = chip_smoke.nvidia_smi_lines()[0]
    loaded = load_trees(trees, STREAM_SOURCES, STREAM_ENTRIES,
                        lambda name: "_ranlux" in name or "_ranmar" in name)
    labels = [label for label, _, _ in loaded]
    libs = [lib for _, lib, _ in loaded]

    dev = torch.device("cuda", 0)
    stream = build.stream_handle(dev)
    grid = ShardGrid(DIMS, MESH, [dev])
    shard = grid.shards[0]
    key = rng.stage_key(rng.make_base_key(1), 0, 0)

    def call(lib, us, n, kind, src, st, sh, count=None, k_trials=4,
             n_hit=3):
        """One stage (mu=1, parity 0) of tree lib drawing from src: a
        stream generator (st: its (words, scalars), advanced as the
        wrapper does), "threefry" or "philox"."""
        geom = DIMS if sh is None else sh.kernel_args()
        head = (*[a.data_ptr() for a in us], n, cupdate.KINDS.index(kind),
                int(count is not None), 1, 0, *geom)
        tail = (cupdate.two_beta_over_n(BETA[n], n), k_trials, n_hit, 0.35,
                None if count is None else count.data_ptr(), stream)
        if src in ("threefry", "philox"):
            fn = {("threefry", False): lib.qg_stage,
                  ("threefry", True): lib.qg_stage_shard,
                  ("philox", False): lib.qg_stage_philox,
                  ("philox", True): lib.qg_stage_philox_shard}[
                      src, sh is not None]
            err = fn(*head, key[0], key[1], *tail)
        else:
            words, scal = st
            fam = ps.family(src)
            s0, ptr0 = ps.encode_kernel_scalars(src, scal)
            fn = (lib.qg_stage_stream if sh is None
                  else lib.qg_stage_stream_shard)
            err = fn(*head, ps.FAMILIES.index(fam), words.data_ptr(),
                     words[0].numel(), s0, ptr0,
                     ps.ranlux_skip_len(src) if fam == "ranlux" else 0, *tail)
            scal.update(ps.advance_kernel_scalars(
                src, scal, cupdate.stream_draw_count(kind, k_trials, n_hit,
                                                     n)))
        if err == 1:  # cudaErrorInvalidValue: the launcher refused it
            raise Refused
        if err:
            raise RuntimeError(f"stage {src} {kind}: CUDA error {err}")

    # (label, source, kind, on the shard, (k_trials, n_hit))
    calls = [(f"{g} {k[0].upper()}{'/shard' if s else ''}", g, k, s, (4, 3))
             for g in STREAM_GENS for k in ("heatbath", "metropolis")
             for s in (False, True)]
    calls += [(f"{g} H{'/shard' if s else ''}", g, "heatbath", s, (4, 3))
              for g in ("threefry", "philox") for s in (False, True)]
    # K8's stages past 48 KB of shared memory: a ranlux subgroup of 100
    # draws (25 hits), ranmar's 102 draws (8 KP trials, SU(3))
    calls += [(f"{g} {k[0].upper()}{kt[0] if k == 'heatbath' else kt[1]}"
               f"{'/shard' if s else ''}", g, k, s, kt)
              for g, k, kt in (("ranlux3", "metropolis", (4, 25)),
                               ("ranmar", "heatbath", (8, 3)))
              for s in (False, True)]
    # a ranlux subgroup past a column's 413 draws (110 hits: 440 draws, two
    # chunks)
    calls += [("ranlux3 M110", "ranlux3", "metropolis", False, (4, 110))]
    refused = set()  # (tree, call) pairs the tree's launcher refused
    for n in (3, 2):
        states = {}
        for g in STREAM_GENS:
            st = engine.make_stream_state0(SimConfig(
                group=n, dims=DIMS, seed=3, rng_mode=f"prngcl:{g}"), dev)
            scal = {k: st[k + "_e"] for k in ps.kernel_scalar_names(g)}
            states[g] = {False: (st["words_e"], scal), True: (
                sharded.shard_streams(st, grid)["words_e"][0], scal)}
            del st

        def state_copy(src, on_shard):
            if src not in states:
                return None
            words, scal = states[src][on_shard]
            return words.clone(), dict(scal)

        for what, us_full in inputs(n, dev):
            what = f"SU({n}) {what}"
            us_shard = sharded.shard_links(us_full, grid)[0]

            def arrays(on_shard):
                return tuple(a.clone() for a in (
                    us_shard if on_shard else us_full))

            # every tree against the first that runs the call: links,
            # words, scalars, count (an older tree may refuse a call: a
            # ranlux subgroup past 413 draws before they were chunked)
            for name, src, kind, on_shard, kt in calls:
                first = None
                for i, (label, lib) in enumerate(zip(labels, libs)):
                    us, st = arrays(on_shard), state_copy(src, on_shard)
                    cnt = torch.zeros(1, dtype=torch.int64, device=dev)
                    try:
                        call(lib, us, n, kind, src, st,
                             shard if on_shard else None, cnt, *kt)
                    except Refused:
                        print(f"{what}: {name}: {label}: refused")
                        refused.add((i, name))
                        continue
                    torch.cuda.synchronize()
                    got = (us, st, cnt)
                    if first is None:
                        first = got
                        continue
                    same = (all(torch.equal(a, b)
                                for a, b in zip(us, first[0]))
                            and torch.equal(cnt, first[2])
                            and (st is None or (
                                torch.equal(st[0], first[1][0])
                                and st[1] == first[1][1])))
                    print(f"{what}: {name}: {label}: links, words and count "
                          f"bit-identical to the first: {same} (count "
                          f"{cnt.item()})")
                    if not same:
                        raise SystemExit(f"{label} disagrees with the "
                                         "first tree that ran the call")

            arrs = (arrays(False), arrays(True))
            sts = [{(src, s): state_copy(src, s)
                    for _, src, _, s, _ in calls}
                   for _ in libs]
            order = list(range(len(libs))) + list(reversed(range(len(libs))))
            times = {i: {c[0]: [] for c in calls} for i in range(len(libs))}

            def fn_of(i, src, kind, on_shard, kt):
                return lambda: call(libs[i], arrs[on_shard], n, kind, src,
                                    sts[i][src, on_shard],
                                    shard if on_shard else None, None, *kt)

            for i in order:
                for name, *spec in calls:
                    if (i, name) not in refused:
                        times[i][name].append(chip_smoke.event_ms(
                            fn_of(i, *spec), REPS))
                print(f"{what}: {labels[i]}: " + ", ".join(
                    f"{c} {times[i][c][-1]:.4f}" for c, *_ in calls
                    if times[i][c]) + f" ms  [{smi}]", flush=True)
            for i, label in enumerate(labels):
                print(f"{what}: {label}: mean " + ", ".join(
                    f"{c} {sum(t) / len(t):.4f}"
                    for c, t in times[i].items() if t) + f" ms  [{smi}]")
            for i in order:
                line = []
                for name, *spec in calls:
                    if (i, name) in refused:
                        continue
                    kern, _ = chip_smoke.device_ms(
                        fn_of(i, *spec), 10, "stage_kernel")
                    line.append(f"{name} " + ("not measured" if kern is None
                                              else f"{kern:.4f}"))
                print(f"{what}: {labels[i]}: on the device (profiler): "
                      + ", ".join(line) + f" ms  [{smi}]", flush=True)
            del arrs, sts
        del states
    # the bounds chip_smoke.py records: bytes, and the integer floor of the
    # generator's steps
    v2 = 1
    for d in DIMS:
        v2 *= d
    v2 //= 2
    for n in (3, 2):
        for _, src, kind, on_shard, (k_trials, n_hit) in calls:
            if src in ("threefry", "philox"):
                continue
            sh = shard if on_shard else None
            dims = DIMS if sh is None else sh.interior
            sites = v2 if sh is None else v2 // len(grid)
            name = cupdate.instance_name(kind, n, False, src, on_shard)
            nbytes, f32_ops, int_ops, f64_ops = chip_smoke.work(
                name, dims, k_trials, n_hit, shard=sh)
            ndraw = cupdate.stream_draw_count(kind, k_trials, n_hit, n)
            nbytes += chip_smoke.stream_word_bytes(src, sites, ndraw,
                                                   {"ptr": 0})
            ms, by = chip_smoke.bound(nbytes, f32_ops, int_ops, f64_ops)
            print(f"{name} {dims} K={k_trials} hits={n_hit}: bound "
                  f"{ms:.4f} ms ({by}); its integer floor "
                  f"{int_ops / chip_smoke.INT32_OPS_PER_S * 1e3:.4f} ms, f64 "
                  f"floor {f64_ops / chip_smoke.F64_OPS_PER_S * 1e3:.4f} ms,"
                  f" -fmad=false f32 floor "
                  f"{f32_ops / chip_smoke.F32_INSTR_PER_S * 1e3:.4f} ms")
    return 0


def ladder_f32_ops(n, dims):
    """f32 operations K4's lanes execute at dims (every lane of a column's
    group: the pair and unit products, one product a ladder level, one a
    further chunk, and the two decodes of each loaded link), from
    csrc/measure.cu's association."""
    import chip_smoke
    from qcdgpu_tpu_torch.ops.cuda import measure as cmeasure

    w, m, lanes = cmeasure.poly_lanes(dims[3] // 2)
    products = 2 * w - 1 + (m.bit_length() - 1) + (bin(m).count("1") - 1)
    per_lane = (products * chip_smoke.mmul_ops(n)
                + 2 * w * chip_smoke.codec_ops(n))
    return dims[0] * dims[1] * dims[2] * lanes * per_lane


if __name__ == "__main__":
    sys.exit(main())
