#!/usr/bin/env python3
"""Build the port's CUDA kernels and run its main path on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a)
and nvcc.  Phases, each timed:

  1. device     — card name and power limit, torch / CUDA / nvcc versions;
  2. build      — nvcc builds csrc/*.cu into build/ (register and spill
                  counts printed);
  3. kernels    — each kernel against its plain PyTorch version on the card
                  (hot start, seed 1), at a small size and at 32^4;
  4. timing     — each kernel and its plain version at 32^4, CUDA events,
                  in the order plain, kernel, kernel, plain;
  5. main path  — the library API at the slice configuration (SU(3) 32^4,
                  beta=6.0, heat-bath, reunit_every=10, cold start,
                  threefry): warmup(), thermalize(20), run(20, 1), with the
                  kernels' launch counters read around it; before that, the
                  same API on a small hot start against the CPU path;
  6. physics    — SU(3) 16^4 beta=6.0: <plaquette> within 0.5937 +- 5e-4.

Any failed check raises and the script exits non-zero.  The last two lines
are the card's `nvidia-smi` name/power line and
{"ok": true, "device": {...}}; the line before them is the kernels' JSON
record.  Without a CUDA device, or without the package beside it, it exits
non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SMALL = (4, 4, 2, 4)
BIG = (32, 32, 32, 32)
STAGE_TOL = 2e-5
REUNIT_TOL = 1e-6
PLANE_TOL = 1e-7  # |d sum| / (N * volume)
POLY_TOL = 2e-6   # |d sum| / (N * spatial volume)
FLIP_FRACTION = 1e-5  # KP accept flips at a rounding boundary, per link


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


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    from qcdgpu_tpu_torch import SimConfig, Simulation
    from qcdgpu_tpu_torch.ops import rng
    from qcdgpu_tpu_torch.ops.cuda import build, engine
    from qcdgpu_tpu_torch.ops.cuda import measure as cmeasure
    from qcdgpu_tpu_torch.ops.cuda import reunit as creunit
    from qcdgpu_tpu_torch.ops.cuda import update as cupdate
    from qcdgpu_tpu_torch.utils.stats import analyze_series

    dev = torch.device("cuda", 0)
    record = {
        "stage_heatbath_su3": {
            "name": "stage_heatbath_su3", "route": "cuda",
            "source": "qcdgpu_tpu_torch/csrc/stage.cu",
            "replaces": "qcdgpu_tpu/ops/pallas/update.py:460"},
        "reunit_su3": {
            "name": "reunit_su3", "route": "cuda",
            "source": "qcdgpu_tpu_torch/csrc/reunit.cu",
            "replaces": "qcdgpu_tpu/ops/pallas/reunit.py:22"},
        "plane_sums_su3": {
            "name": "plane_sums_su3", "route": "cuda",
            "source": "qcdgpu_tpu_torch/csrc/measure.cu",
            "replaces": "qcdgpu_tpu/ops/pallas/measure.py:67"},
        "polyakov_sums_su3": {
            "name": "polyakov_sums_su3", "route": "cuda",
            "source": "qcdgpu_tpu_torch/csrc/measure.cu",
            "replaces": "qcdgpu_tpu/ops/pallas/measure.py:155"},
    }

    with Phase("1 device"):
        smi = nvidia_smi_line()
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
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                print("  ptxas:", line.strip())
        build.library()

    def hot(dims, seed=1):
        cfg = SimConfig(dims=dims, seed=seed)
        return engine.packed_hot_start(cfg, rng.make_base_key(seed), dev)

    def stage_pair(us, mu, p, key, dims):
        got = cupdate.stage_update(clone(us), mu, p, 5.5, key, dims)
        ref = cupdate.stage_update_ref(clone(us), mu, p, 5.5, key, dims)
        return got, ref

    with Phase("3 kernels vs plain versions"):
        base = rng.make_base_key(1)
        # K1 at the small size: every (mu, parity)
        us = hot(SMALL)
        worst = 0.0
        for p in (0, 1):
            for mu in range(4):
                key = rng.stage_key(base, 0, 4 * p + mu)
                got, ref = stage_pair(us, mu, p, key, SMALL)
                err = float((got - ref).abs().max())
                worst = max(worst, err)
                require(err < STAGE_TOL, f"K1 {SMALL} mu={mu} p={p}: {err}")
        record["stage_heatbath_su3"]["max_abs_err"] = worst
        print(f"K1 {SMALL}: max |d| over 8 stages {worst:.3e} (< {STAGE_TOL})")
        # K1 at 32^4: count links beyond the tolerance (KP flips)
        us = hot(BIG)
        n_links = bad = 0
        big_worst = 0.0
        for p in (0, 1):
            for mu in range(4):
                key = rng.stage_key(base, 0, 4 * p + mu)
                got, ref = stage_pair(us, mu, p, key, BIG)
                d = (got - ref).abs().reshape(12, -1).amax(dim=0)
                bad += int((d > STAGE_TOL).sum())
                n_links += d.numel()
                big_worst = max(big_worst, float(d.max()))
        print(f"K1 {BIG}: {bad} of {n_links} links beyond {STAGE_TOL} "
              f"(max |d| {big_worst:.3e})")
        require(bad <= FLIP_FRACTION * n_links,
                f"K1 {BIG}: {bad} links beyond tolerance")
        # K2 on drifted links (hot start + seeded noise)
        noise = np.random.default_rng(1)
        drift = tuple(
            a + torch.from_numpy(noise.standard_normal(a.shape)
                                 .astype(np.float32)).to(dev) * 1e-3
            for a in us)
        k2 = 0.0
        for a in drift:
            got = creunit.reunitarize_dir(a.clone(), BIG)
            ref = creunit.reunitarize_dir_ref(a.clone(), BIG)
            k2 = max(k2, float((got - ref).abs().max()))
        record["reunit_su3"]["max_abs_err"] = k2
        print(f"K2 {BIG}: max |d| {k2:.3e} (< {REUNIT_TOL})")
        require(k2 < REUNIT_TOL, f"K2: {k2}")
        # K3
        for dims, u_ in ((SMALL, hot(SMALL)), (BIG, us)):
            norm = 3 * np.prod(dims)
            d3 = float((cmeasure.plane_sums(u_, dims)
                        - cmeasure.plane_sums_ref(u_, dims)).abs().max()) / norm
            print(f"K3 {dims}: max |d sum|/(N vol) {d3:.3e} (< {PLANE_TOL})")
            require(d3 < PLANE_TOL, f"K3 {dims}: {d3}")
        record["plane_sums_su3"]["max_abs_err"] = d3
        # K4, including T/2 odd
        for dims, u_ in (((8, 8, 8, 6), hot((8, 8, 8, 6))), (BIG, us)):
            norm = 3 * np.prod(dims[:3])
            d4 = float((cmeasure.polyakov_sums(u_, dims)
                        - cmeasure.polyakov_sums_ref(u_, dims)).abs().max()) / norm
            print(f"K4 {dims}: max |d sum|/(N spatial vol) {d4:.3e} (< {POLY_TOL})")
            require(d4 < POLY_TOL, f"K4 {dims}: {d4}")
        record["polyakov_sums_su3"]["max_abs_err"] = d4

    with Phase("4 kernel timing at 32^4"):
        key = rng.stage_key(rng.make_base_key(1), 0, 0)
        work = clone(us)
        pairs = {
            "stage_heatbath_su3": (
                lambda: cupdate.stage_update_ref(work, 1, 0, 6.0, key, BIG),
                lambda: cupdate.stage_update(work, 1, 0, 6.0, key, BIG), 3, 50),
            "reunit_su3": (
                lambda: creunit.reunitarize_dir_ref(work[3], BIG),
                lambda: creunit.reunitarize_dir(work[3], BIG), 5, 200),
            "plane_sums_su3": (
                lambda: cmeasure.plane_sums_ref(work, BIG),
                lambda: cmeasure.plane_sums(work, BIG), 3, 100),
            "polyakov_sums_su3": (
                lambda: cmeasure.polyakov_sums_ref(work, BIG),
                lambda: cmeasure.polyakov_sums(work, BIG), 3, 100),
        }
        for name, (plain, kern, r_plain, r_kern) in pairs.items():
            p1 = event_ms(plain, r_plain)
            k1 = event_ms(kern, r_kern)
            k2_ = event_ms(kern, r_kern)
            p2 = event_ms(plain, r_plain)
            record[name]["ms"] = (k1 + k2_) / 2
            record[name]["plain_ms"] = (p1 + p2) / 2
            print(f"{name}: kernel {k1:.4f} / {k2_:.4f} ms, plain "
                  f"{p1:.4f} / {p2:.4f} ms  [{smi}]")
        del work

    with Phase("5 main path"):
        # the library API on a small hot start: CUDA kernels vs CPU plain
        small = SimConfig(dims=SMALL, beta=5.5, seed=1, start="hot",
                          reunit_every=2)
        obs_gpu = Simulation(small, device="cuda").run(2, 1)
        obs_cpu = Simulation(small, device="cpu").run(2, 1)
        d_plq = np.abs(obs_gpu[0, :4] - obs_cpu[0, :4]).max()
        d_pol = np.abs(obs_gpu[0, 4:] - obs_cpu[0, 4:]).max()
        print(f"small run: row 0 |d| plq/action {d_plq:.2e}, poly {d_pol:.2e}")
        require(d_plq < 5e-5 and d_pol < 2e-4, "small run: GPU != CPU")

        cfg = SimConfig(group=3, dims=BIG, beta=6.0, algorithm="heatbath",
                        n_or=0, reunit_every=10, start="cold", seed=0,
                        rng_mode="threefry")
        for counts in (cupdate.LAUNCHES, creunit.LAUNCHES, cmeasure.LAUNCHES):
            for k in counts:
                counts[k] = 0
        t0 = time.perf_counter()
        sim = Simulation(cfg, device="cuda")
        sim.warmup()
        t1 = time.perf_counter()
        sim.thermalize(20).sync()
        t2 = time.perf_counter()
        obs = sim.run(20, 1)
        t3 = time.perf_counter()
        launches = {"stage_heatbath_su3": cupdate.LAUNCHES["stage"],
                    "reunit_su3": creunit.LAUNCHES["reunit"],
                    "plane_sums_su3": cmeasure.LAUNCHES["plane_sums"],
                    "polyakov_sums_su3": cmeasure.LAUNCHES["polyakov_sums"]}
        for name, n in launches.items():
            record[name]["launches"] = n
        therm_ms = (t2 - t1) / 20 * 1e3
        run_ms = (t3 - t2) / 20 * 1e3
        n_links = 4 * int(np.prod(BIG))
        plq = float(obs[-1, 0])
        defect = sim.unitarity_defect()
        print(f"warmup {t1 - t0:.2f} s; thermalize {therm_ms:.3f} ms/sweep "
              f"({n_links / therm_ms * 1e3:.4e} link-updates/s); run with "
              f"measurement {run_ms:.3f} ms/sweep "
              f"({n_links / run_ms * 1e3:.4e} link-updates/s)  [{smi}]")
        print(f"plaquette {plq:.6f} (measure() {sim.measure()['plq']:.6f}); "
              f"unitarity defect {defect:.3e}; launches {launches}")
        require(obs.shape == (20, 6) and np.isfinite(obs).all(), "bad series")
        require(0.3 < plq < 1.0, f"plaquette {plq}")
        require(defect < 1e-5, f"unitarity defect {defect}")
        require(launches["stage_heatbath_su3"] >= 8 * 41, launches)
        require(launches["reunit_su3"] >= 32, launches)
        require(launches["plane_sums_su3"] >= 21, launches)
        require(launches["polyakov_sums_su3"] >= 21, launches)
        del sim

    with Phase("6 physics: SU(3) 16^4 beta=6.0"):
        cfg = SimConfig(group=3, dims=(16, 16, 16, 16), beta=6.0,
                        algorithm="heatbath", n_or=0, start="cold", seed=0)
        sim = Simulation(cfg, device="cuda")
        sim.thermalize(200)
        obs = sim.run(400, 1)
        st = analyze_series(obs[:, 0])
        print(f"<plq> = {st.mean:.7f} +- {st.err:.7f} (tau_int {st.tau_int:.2f}); "
              f"window 0.5937 +- 5e-4")
        require(abs(st.mean - 0.5937) < 5e-4, f"<plq> {st.mean}")

    print(json.dumps({"kernels": list(record.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
