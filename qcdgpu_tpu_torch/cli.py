"""Command line of the PyTorch / CUDA port — port of
qcdgpu_tpu/cli.py, with the same subcommands, options and defaults.

Run parameters come from an init file (TOML/JSON) with command-line
overrides; a run writes results.txt, results.json and the checkpoint
state.npz (a packed checkpoint directory, which the JAX package reads
too).  Subcommands:

  run       one Markov chain (thermalize + production + analysis + report)
  resume    continue a chain bit-exactly from a checkpoint (also one
            written by the JAX package; --mesh lays it out anew)
  info      device report
  validate  physics acceptance suite (BASELINE configs 1-5)
  rngtest   PRNG self-test (threefry, Philox, native and device streams)
  scan      beta scan: one chain per beta in one batched run (BetaScan),
            scan.json, scan_state.npz; --resume-state continues it (on any
            --mesh and --chain-mesh)

--device (default cuda) picks the card, or the CPU, where the kernels'
plain PyTorch versions run; without a card the default raises.
rng_mode "hw" is the TPU's hardware PRNG in the JAX package and Philox
here.  --mesh splits the lattice over shards: X/Y on the packed engine,
any of the four axes on the dense one (--engine xla, --dtype complex128,
a Z/T split); by default every shard sits on --device.

Examples:
  python -m qcdgpu_tpu_torch run --group 3 --dims 8,8,8,8 --beta 6.0 \
      --algorithm heatbath --n-or 1 --therm 300 --sweeps 500 --out out/
  python -m qcdgpu_tpu_torch scan --dims 24,24,24,6 --n-or 2 \
      --betas 5.6:6.1:11 --therm 200 --sweeps 400 --out scan/
  python -m qcdgpu_tpu_torch scan --dims 32 --betas 5.9,6.1 \
      --mesh 2,2,1,1 --chain-mesh 2 --therm 100 --sweeps 200 --out scan2/
  python -m qcdgpu_tpu_torch run --dims 32 --mesh 1,1,2,2 \
      --dtype complex128 --therm 100 --sweeps 200 --out dense/
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _parse_dims(s: str):
    parts = [int(x) for x in s.replace("x", ",").split(",")]
    if len(parts) == 1:
        parts = parts * 4
    if len(parts) != 4:
        raise argparse.ArgumentTypeError("dims must be L or X,Y,Z,T")
    return tuple(parts)


def _parse_betas(s: str):
    """'5.6:6.0:9' -> 9 evenly spaced; or comma list '5.6,5.8,6.0'."""
    if ":" in s:
        lo, hi, n = s.split(":")
        lo, hi, n = float(lo), float(hi), int(n)
        return [lo + (hi - lo) * i / max(n - 1, 1) for i in range(n)]
    return [float(x) for x in s.split(",")]


def _parse_mesh(s: str):
    # no single-value expansion here: "--mesh 2" must not silently mean
    # the 16-device mesh (2,2,2,2) the way "--dims 8" means 8^4
    parts = [int(x) for x in s.replace("x", ",").split(",")]
    if len(parts) != 4:
        raise argparse.ArgumentTypeError(
            "mesh must be 4 comma-separated axis sizes over X,Y,Z,T "
            "(e.g. 2,1,1,1 for a 2-way X decomposition)"
        )
    return tuple(parts)


def _parse_wloops(s):
    """'1x2,2x2' -> ((1, 2), (2, 2))."""
    pairs = []
    for part in s.split(","):
        r, _, t = part.lower().partition("x")
        pairs.append((int(r), int(t)))
    return tuple(pairs)


def _add_run_args(p: argparse.ArgumentParser):
    p.add_argument("--config", help="TOML/JSON init file with run parameters")
    p.add_argument("--group", type=int, help="gauge group N (2 or 3)")
    p.add_argument("--dims", type=_parse_dims, help="lattice size L or X,Y,Z,T")
    p.add_argument("--beta", type=float, help="coupling")
    p.add_argument("--algorithm", choices=["heatbath", "metropolis"])
    p.add_argument("--n-or", type=int, dest="n_or",
                   help="overrelaxation sweeps per update sweep")
    p.add_argument("--n-hit", type=int, dest="n_hit", help="Metropolis hits")
    p.add_argument("--kp-trials", type=int, dest="kp_trials")
    p.add_argument("--start", choices=["cold", "hot"])
    p.add_argument("--therm", type=int, dest="sweeps_therm")
    p.add_argument("--sweeps", type=int)
    p.add_argument("--meas-every", type=int, dest="meas_every")
    p.add_argument("--reunit-every", type=int, dest="reunit_every")
    p.add_argument("--ckpt-every", type=int, dest="ckpt_every",
                   help="periodic state dump every k production sweeps")
    p.add_argument("--seed", type=int)
    p.add_argument("--dtype", choices=["complex64", "complex128"])
    p.add_argument("--meas-dtype", choices=["same", "double"], dest="meas_dtype",
                   help="double = complex128 observables (mixed precision)")
    p.add_argument("--get-fmunu", action=argparse.BooleanOptionalAction,
                   dest="get_fmunu", default=None,
                   help="measure field-strength components tr(T_a P_munu)")
    p.add_argument("--fmunu-index1", type=int, dest="fmunu_index1",
                   help="first Fmunu color generator (0 = Cartan default)")
    p.add_argument("--fmunu-index2", type=int, dest="fmunu_index2",
                   help="second Fmunu color generator (0 = auto)")
    p.add_argument("--track-acceptance", action=argparse.BooleanOptionalAction,
                   dest="track_acceptance", default=None,
                   help="record the Metropolis acceptance rate per block")
    p.add_argument("--track-kp-exhaust", action=argparse.BooleanOptionalAction,
                   dest="track_kp_exhaust", default=None,
                   help="record the KP heat-bath trial-exhaustion "
                        "(identity-fallback) rate per block")
    p.add_argument("--wilson-loops", type=_parse_wloops, dest="wilson_loops",
                   metavar="RxT,RxT,...",
                   help="rectangular Wilson loop extents, e.g. 1x2,2x2 "
                        "(adds one wloop_RxT observable column per pair)")
    p.add_argument("--get-qtop", action=argparse.BooleanOptionalAction,
                   dest="get_qtop", default=None,
                   help="measure the clover topological charge Q_L "
                        "(adds a q_top observable column)")
    p.add_argument("--qtop-smear", type=int, dest="qtop_smear",
                   help="APE-smear a measurement copy this many times "
                        "before evaluating Q_L (0 = unsmeared)")
    p.add_argument("--qtop-alpha", type=float, dest="qtop_alpha",
                   help="APE mixing weight for --qtop-smear (default 0.5)")
    p.add_argument("--mesh", type=_parse_mesh,
                   help="device mesh over X,Y,Z,T (e.g. 1,1,2,4)")
    p.add_argument("--engine", choices=["auto", "xla", "pallas"],
                   help="execution engine: auto (the packed CUDA engine for "
                        "complex64, the dense engine for complex128 or a "
                        "Z/T mesh), xla (the dense engine) or pallas (the "
                        "packed engine)")
    p.add_argument("--rng-mode", dest="rng_mode",
                   help="threefry (bit-reproducible), hw (Philox here; the "
                        "TPU PRNG in the JAX package), "
                        "or prngcl:<gen> (a reference-family generator — "
                        "ranlux0..4, ranmar, xor128, xor7, mrg32k3a, "
                        "parkmiller, constant — as device-resident streams)")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a torch.profiler Chrome trace "
                        "(per-kernel timings), with the program's spans "
                        "on a track of their own, into DIR/trace.json")
    p.add_argument("--progress", type=int, default=0, metavar="N",
                   help="print a progress line every N production sweeps "
                        "(QCDGPU's per-ITER stdout; 0 = silent)")
    p.add_argument("--out", default="results", help="output directory")
    _add_device_arg(p)


def _add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="cuda[:i] (the card, default) or cpu (the kernels' "
                        "plain PyTorch versions)")


def _progress_printer(cfg):
    """Per-chunk stdout line: sweeps done, wall rate, latest observables."""
    from .ops.measure import measure_obs_names

    names = list(measure_obs_names(cfg))
    state = {"t": time.time(), "done": 0}

    def cb(done, n, row):
        now = time.time()
        dt, dn = now - state["t"], done - state["done"]
        state["t"], state["done"] = now, done
        rate = (1 + cfg.n_or) * cfg.n_links * dn / max(dt, 1e-9)
        msg = f"  sweep {done}/{n}  ({rate:.3g} lu/s)"
        if row is not None:
            plq = row[names.index("plq")]
            pre = row[names.index("poly_re")]
            msg += f"  plq={plq:.6f} poly_re={pre:+.5f}"
        print(msg, flush=True)

    return cb


def _load_config_file(path: str) -> dict:
    with open(path, "rb") as f:
        if path.endswith(".json"):
            return json.load(f)
        import tomllib

        return tomllib.load(f)


def _build_config(args) -> "SimConfig":
    from .config import SimConfig

    d = {}
    if args.config:
        d.update(_load_config_file(args.config))
    for k in ("group", "dims", "beta", "algorithm", "n_or", "n_hit",
              "kp_trials", "start", "sweeps_therm", "sweeps", "meas_every",
              "reunit_every", "ckpt_every", "seed", "dtype", "mesh", "engine",
              "y_block",
              "rng_mode", "meas_dtype", "get_fmunu", "fmunu_index1",
              "fmunu_index2", "track_acceptance", "track_kp_exhaust",
              "wilson_loops", "get_qtop", "qtop_smear", "qtop_alpha"):
        v = getattr(args, k, None)
        if v is not None:
            d[k] = v
    if "dims" in d:
        d["dims"] = tuple(d["dims"])
    if "mesh" in d:
        d["mesh"] = tuple(d["mesh"])
    if "wilson_loops" in d:  # init-file lists -> hashable tuples
        d["wilson_loops"] = tuple(tuple(p) for p in d["wilson_loops"])
    return SimConfig(**d)


def _finish_run(sim, args, timings):
    from .utils import report

    os.makedirs(args.out, exist_ok=True)
    analysis = sim.analysis()
    series = None
    if sim.obs_history:
        import numpy as np

        series = np.concatenate(sim.obs_history, axis=0)
    rec = report.build_record(sim.cfg, analysis, timings, series=series,
                              extra={"engine": sim.engine,
                                     "mesh": list(sim.cfg.mesh)},
                              device=sim.device)
    base = os.path.join(args.out, "results")
    report.write_json(base + ".json", rec)
    report.write_text(base + ".txt", rec)
    ckpt = os.path.join(args.out, "state.npz")
    sim.save(ckpt)
    print(report.format_text(rec))
    print(f"wrote {base}.txt, {base}.json, {ckpt}")


def cmd_run(args):
    from .sim import Simulation
    from .utils.profile import trace

    cfg = _build_config(args)
    # Simulation.__init__ splits the links over the cfg.mesh shards itself
    sim = Simulation(cfg, device=args.device)
    timings = {}
    with trace(getattr(args, "profile", None)):
        t0 = time.time()
        sim.warmup()
        timings["compile_s"] = round(time.time() - t0, 3)
        t0 = time.time()
        sim.thermalize()
        sim.sync()
        timings["thermalize_s"] = round(time.time() - t0, 3)
        t0 = time.time()
        os.makedirs(args.out, exist_ok=True)
        prog = getattr(args, "progress", 0)
        sim.run(
            ckpt_path=os.path.join(args.out, "state.npz"),
            progress_every=prog,
            progress=_progress_printer(cfg) if prog else None,
        )
        sim.sync()
        timings["production_s"] = round(time.time() - t0, 3)
    n_link_updates = (1 + cfg.n_or) * cfg.n_links * (cfg.sweeps + cfg.sweeps_therm)
    timings["link_updates_per_s"] = round(
        n_link_updates / max(timings["thermalize_s"] + timings["production_s"], 1e-9)
    )
    # per-phase breakdown (QCDGPU's per-kernel totals analogue; use
    # --profile for a per-kernel torch.profiler trace)
    if cfg.sweeps_therm:
        timings["ms_per_sweep"] = round(
            1e3 * timings["thermalize_s"] / cfg.sweeps_therm, 3
        )
    if cfg.sweeps:
        with_meas = 1e3 * timings["production_s"] / cfg.sweeps
        timings["ms_per_sweep_with_meas"] = round(with_meas, 3)
        # only meaningful without periodic checkpoint saves, whose host
        # I/O would otherwise be attributed to measurement
        if cfg.sweeps_therm and cfg.meas_every and not cfg.ckpt_every:
            timings["ms_per_measurement"] = round(
                (with_meas - timings["ms_per_sweep"]) * cfg.meas_every, 3
            )
    if getattr(args, "profile", None):
        timings["profile_trace"] = args.profile
    _finish_run(sim, args, timings)


def cmd_resume(args):
    from .sim import Simulation

    # device placement is not part of the checkpoint; Simulation.__init__
    # re-applies the cfg.mesh domain decomposition on load (--mesh: another
    # one; the checkpoint holds the global state)
    sim = Simulation.load(args.checkpoint, device=args.device,
                          mesh=args.mesh)
    t0 = time.time()
    sim.warmup()
    timings = {"compile_s": round(time.time() - t0, 3)}
    t0 = time.time()
    os.makedirs(args.out, exist_ok=True)
    # keep periodic checkpointing alive across resumes (cfg.ckpt_every)
    prog = getattr(args, "progress", 0)
    sim.run(args.sweeps, ckpt_path=os.path.join(args.out, "state.npz"),
            progress_every=prog,
            progress=_progress_printer(sim.cfg) if prog else None)
    sim.sync()
    timings["production_s"] = round(time.time() - t0, 3)
    _finish_run(sim, args, timings)


def cmd_scan(args):
    import numpy as np

    from .models.ensemble import BetaScan
    from .ops.measure import obs_names
    from .utils import report
    from .utils.stats import analyze_series, susceptibility

    if args.resume_state:
        # the checkpoint holds the global fields: --mesh and --chain-mesh
        # lay the resumed scan out anew
        scan = BetaScan.load(args.resume_state, chain_mesh=args.chain_mesh,
                             device=args.device, mesh=args.mesh)
        cfg = scan.cfg
        betas = [float(b) for b in scan.betas]
    else:
        cfg = _build_config(args)
        if not args.betas:
            raise SystemExit("scan requires --betas (or --resume-state)")
        betas = _parse_betas(args.betas)
        scan = BetaScan(cfg, betas, chain_mesh=args.chain_mesh,
                        device=args.device)
    t0 = time.time()
    scan.warmup()
    timings = {"compile_s": round(time.time() - t0, 3)}
    t0 = time.time()
    if args.resume_state:
        obs = scan.run(args.sweeps)
    else:
        scan.thermalize()
        obs = scan.run()  # [C, n_meas, n_obs]
    scan.sync()
    timings["total_s"] = round(time.time() - t0, 3)
    os.makedirs(args.out, exist_ok=True)
    scan.save(os.path.join(args.out, "scan_state.npz"))
    # one row per beta: mean and binned error of every series column (the
    # tracked rate included), and the deconfinement observables on the
    # Polyakov modulus: <|P|> (not |<P>|, which the Z_N phase flips average
    # away) and chi = V (<|P|^2> - <|P|>^2), whose peak locates beta_c
    names = list(obs_names(cfg))
    rows = []
    for c, b in enumerate(betas):
        row = {"beta": b}
        for k, name in enumerate(names):
            st = analyze_series(obs[c, :, k])
            row[name] = st.mean
            row[name + "_err"] = st.err
        pabs = np.hypot(obs[c, :, names.index("poly_re")],
                        obs[c, :, names.index("poly_im")])
        st = analyze_series(pabs)
        row["poly_abs"], row["poly_abs_err"] = st.mean, st.err
        row["poly_sus"], row["poly_sus_err"] = susceptibility(
            pabs, float(cfg.volume))
        rows.append(row)
    rec = {
        "config": cfg.to_dict(),
        "engine": scan.engine,
        "mesh": list(cfg.mesh),
        "chain_mesh": scan.chain_mesh,
        "device": report.device_info(args.device),
        "timings": timings,
        "scan": rows,
        # each observable's series per chain, [C][n_meas], as `run` keeps
        # its own
        "series": {name: obs[:, :, k].tolist()
                   for k, name in enumerate(names)},
    }
    path = os.path.join(args.out, "scan.json")
    report.write_json(path, rec)
    print(f"{'beta':>8} {'plq':>10} {'<|poly|>':>10} {'poly_re':>10} "
          f"{'chi_P':>10}")
    for r in rows:
        print(f"{r['beta']:8.4f} {r['plq']:10.6f} {r['poly_abs']:10.6f} "
              f"{r['poly_re']:10.6f} {r['poly_sus']:10.4f}")
    print(f"wrote {path}")


def cmd_info(args):
    from .utils import report

    print(json.dumps(report.device_info(args.device), indent=1))


def cmd_validate(args):
    from .validate import run_validation

    configs = tuple(int(x) for x in args.configs.split(","))
    ok, _ = run_validation(configs=configs, quick=args.quick,
                           out_path=args.out, device=args.device)
    return 0 if ok else 1


def cmd_rngtest(args):
    """PRNG self-test — the CLI face of the RNG parity suite.

    For the production threefry stream, Philox (rng_mode "hw") and each
    native reference generator: sample moments E[x^k] vs U(0,1) theory
    (flagged beyond 6 sigma), and a two-sample KS statistic vs threefry;
    with --streams the device streams behind rng_mode='prngcl:<gen>' too,
    each probed bit for bit against the native generator.
    """
    from .native import prngcl
    from .validate import rng_rows

    gens = args.generators.split(",") if args.generators else list(
        prngcl.GENERATORS)
    if not prngcl.available():
        print("# native prngcl library unavailable; testing threefry and "
              "Philox only")
    rows = rng_rows(args.n, args.seed, gens, streams=args.streams,
                    device=args.device)
    stream_fail = any(r.get("native_match") is False for r in rows)
    worst = 0.0
    print(f"{'generator':>22} {'E[x]':>9} {'E[x^2]':>9} {'E[x^3]':>9} "
          f"{'E[x^4]':>9} {'max|sig|':>9} {'KS p':>9} {'bit':>5}")
    for r in rows:
        m, s = r["moments"], r["moment_sigmas"]
        mx = max(abs(v) for v in s.values())
        worst = max(worst, mx)
        ks = r.get("ks_vs_threefry", {})
        ksp = f"{ks['pvalue']:9.3g}" if ks else "        -"
        match = r.get("native_match")
        bit = "-" if match is None else ("ok" if match else "DIFF")
        print(f"{r['generator']:>22} {m[1]:9.5f} {m[2]:9.5f} {m[3]:9.5f} "
              f"{m[4]:9.5f} {mx:9.2f} {ksp} {bit:>5}")
    ok = worst < 6.0 and not stream_fail
    print(f"# n={args.n} per generator; PASS criteria: all moment deviations "
          f"< 6 sigma and device streams bit-match native -> "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def main(argv=None):
    ap = argparse.ArgumentParser(prog="qcdgpu_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run one Markov chain")
    _add_run_args(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("resume", help="resume from a checkpoint")
    p.add_argument("checkpoint")
    p.add_argument("--sweeps", type=int, default=None)
    p.add_argument("--progress", type=int, default=0, metavar="N",
                   help="print a progress line every N production sweeps")
    p.add_argument("--mesh", type=_parse_mesh, default=None,
                   help="lay the resumed run out on this mesh over X,Y,Z,T "
                        "instead of the checkpoint's")
    p.add_argument("--out", default="results")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_resume)

    p = sub.add_parser("scan", help="beta scan (chain-batched ensemble)")
    _add_run_args(p)
    p.add_argument("--betas", default=None,
                   help="lo:hi:n or comma list, e.g. 5.6:6.1:11")
    p.add_argument("--resume-state", dest="resume_state", default=None,
                   help="continue a scan from its scan_state.npz")
    p.add_argument("--chain-mesh", dest="chain_mesh", type=int, default=0,
                   help="blocks the chains are cut into (must divide the "
                        "number of betas); 0 (auto): 1, as every block "
                        "sits on --device.  Blocks are there for parity "
                        "with the reference and make a scan slower (one "
                        "host thread launches them in turn).  With --mesh "
                        "every chain's lattice is also split into shards "
                        "(X/Y on the packed engine, any axis on the dense "
                        "one)")
    p.set_defaults(fn=cmd_scan)

    p = sub.add_parser("info", help="device info")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("validate", help="physics acceptance suite "
                       "(BASELINE configs vs literature)")
    p.add_argument("--configs", default="1,2,3,4,5,6",
                   help="comma list of BASELINE config numbers")
    p.add_argument("--quick", action="store_true",
                   help="reduced lattices/sweeps (minutes instead of hours)")
    p.add_argument("--out", default=None, help="JSON report path")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_validate)

    p = sub.add_parser("rngtest", help="PRNG self-test / parity report")
    p.add_argument("--n", type=int, default=1 << 20,
                   help="draws per generator")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--generators", default=None,
                   help="comma list (default: all native reference PRNGs)")
    p.add_argument("--streams", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="also test the device streams behind "
                        "rng_mode='prngcl:<gen>' (moments + bit parity "
                        "vs the native generators)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_rngtest)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
