#!/usr/bin/env python3
"""K1 / K1a (the Philox heat-bath stage, unsharded and on a shard), K3 /
K5a (the plane sums) and K4 / K5b / K4c (the Polyakov sums, unsharded, on
a shard and over a scan's chains) of the PyTorch port, built from two or
more CUDA source trees and timed in one process on one card, to compare
kernel versions within one chip call.

    python3 tools/port_kernel_ab.py OLD_CSRC NEW_CSRC [MORE_CSRC ...]

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
"""

import ctypes
import importlib.util
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
SCAN = (24, 24, 24, 6)
CHAINS = 11
POLY_TOL = 2e-6  # |d sum| / (N * spatial volume), chip_smoke.py's bar


def build_tree(csrc, out_dir, nvcc, flags):
    """Compile csrc's SOURCES into one library; returns (path, nvcc log)."""
    objs, log = [], ""
    for src in SOURCES:
        obj = out_dir / f"{Path(src).stem}.o"
        proc = subprocess.run([nvcc, *flags, "-c", "-o", str(obj),
                               str(csrc / src)], capture_output=True,
                              text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {csrc / src}:\n{log}")
        objs.append(str(obj))
    lib = out_dir / "lib.so"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-shared", "-o", str(lib), *objs], check=True)
    return lib, log


def tree_signatures(csrc, i):
    """SIGNATURES of the ops/cuda/build.py beside csrc (its tree's own C
    interface)."""
    path = csrc.parent / "ops" / "cuda" / "build.py"
    spec = importlib.util.spec_from_file_location(f"_ab_build_{i}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SIGNATURES


def main():
    import torch

    if not torch.cuda.is_available():
        print("port_kernel_ab: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    trees = [Path(a).resolve() for a in sys.argv[1:]]
    if len(trees) < 2 or not all((t / s).exists() for t in trees
                                 for s in SOURCES):
        print(__doc__, file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from qcdgpu_tpu_torch import SimConfig, Simulation
    from qcdgpu_tpu_torch.ops import rng
    from qcdgpu_tpu_torch.ops.cuda import build, engine, sharded
    from qcdgpu_tpu_torch.ops.cuda import measure as cmeasure
    from qcdgpu_tpu_torch.ops.cuda import update as cupdate
    from qcdgpu_tpu_torch.parallel.mesh import ShardGrid

    smi = chip_smoke.nvidia_smi_lines()[0]
    tmp = Path(tempfile.mkdtemp(prefix="kernel_ab_", dir=ROOT / "build"))
    dirs = [tmp / f"t{i}" for i in range(len(trees))]
    for d in dirs:
        d.mkdir()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(trees)) as pool:
        built = list(pool.map(
            lambda td: build_tree(td[0], td[1], build.nvcc_path(),
                                  build.NVCC_FLAGS), zip(trees, dirs)))
    print(f"built {len(trees)} trees in {time.perf_counter() - t0:.1f} s")
    labels = [f"[{i}] {t}" for i, t in enumerate(trees)]
    libs = []
    for i, (label, (path, log)) in enumerate(zip(labels, built)):
        lib = ctypes.CDLL(str(path))
        sigs = tree_signatures(trees[i], i)
        for fn in ENTRIES:
            getattr(lib, fn).argtypes = sigs[fn]
            getattr(lib, fn).restype = ctypes.c_int
        # older trees' plane sums take the block size (256) as an argument
        libs.append((lib, len(sigs["qg_plane_sums"]) == 17))
        for name, line, _ in chip_smoke.ptxas_summary(log, cupdate.KINDS):
            if name in TIMED:
                print(f"{label}: ptxas {name}: {line}")

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

    def event_ms(fn):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REPS

    def inputs(n):
        chain = Simulation(SimConfig(group=n, beta=BETA[n], dims=DIMS,
                                     seed=0, start="cold", reunit_every=10,
                                     rng_mode="hw"), device=dev)
        chain.thermalize(THERM)
        yield "hot start", engine.packed_hot_start(
            SimConfig(group=n, dims=DIMS, seed=1), rng.make_base_key(1), dev)
        yield f"hw chain after {THERM} sweeps", tuple(
            a.clone() for a in chain.us)

    # (call, on the shard); "/512": 512 threads a block
    calls = (("K1", False), ("K1a", True), ("K3", False), ("K5a", True),
             ("K4", False), ("K4/512", False), ("K5b", True),
             ("K5b/512", True))
    poly_calls = [c for c, _ in calls if c.startswith(("K4", "K5b"))]
    for n in (3, 2):
        for what, us_full in inputs(n):
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
                    times[i][name].append(event_ms(
                        lambda: call(name, libs[i], arrs[on_shard])))
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
                            f"{event_ms(fn):.4f} ms, on the device "
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
            nbytes, f32_ops, int_ops = chip_smoke.work(
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
            nbytes, f32_ops, int_ops = chip_smoke.work(name, dims, shard=sh)
            ms, by = chip_smoke.bound(c * nbytes, c * f32_ops, c * int_ops)
            floor, ladder = (c * ops / chip_smoke.F32_INSTR_PER_S * 1e3
                             for ops in (f32_ops, ladder_f32_ops(n, dims)))
            print(f"{label} {name} {dims} x {c}: bound {ms:.4f} ms ({by}), "
                  f"-fmad=false f32 floor {floor:.4f} ms; the ladder's "
                  f"{ladder:.4f} ms")
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
