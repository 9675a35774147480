"""Physics acceptance harness — port of qcdgpu_tpu/validate.py.

Runs the BASELINE configs through the port and checks them against the
literature and against the reference's self-regression anchors:

  1. SU(2) heat-bath, 8^4, beta=2.4            -> mean plaquette vs 0.6300
  2. SU(3) HB+OR (Cabibbo-Marinari), 16^4, 6.0 -> mean plaquette vs 0.5937
  3. SU(3) deconfinement, 24^3 x 6, beta_c +- 0.25 (a two-chain BetaScan)
     -> <|P|> above > 3 x below and > 0.05
  4. RNG parity (moments of threefry, Philox and the native reference
     generators; the device streams bit-identical to the native ones)
  5. multi-card 32^4 over an X/Y mesh with two cards or more; below two,
     the reference's fallback on the one device: a short SU(3) chain on
     the dense engine over mesh (4, 2, 1, 1), sharded == unsharded bit
     for bit (PASS or FAIL, never skipped)

  6. engine cross-validation: the dense engine (dense.py) against the
     packed CUDA engine, threefry, over 2 sweeps and one heat-bath stage

``check_su2`` / ``check_su3`` /
``check_deconfinement`` take config overrides (``rng_mode="hw"``, another generator, ...) so that the same
gates hold every random source.  Each check reports measured / expected /
deviation and PASS/FAIL; the criterion is agreement within
max(5 sigma_stat, systematic window), and at full depth the self-anchor
gate within max(window, 3 sigma_combined).
"""

from __future__ import annotations

import json
import time

import numpy as np

from .config import SimConfig
from .sim import Simulation

# literature anchors and self-regression anchors (the reference's,
# qcdgpu_tpu/validate.py:35-55)
SU2_B24_PLQ = 0.6300
SU2_WINDOW = 0.0020
SU3_B60_PLQ = 0.5937
SU3_WINDOW = 0.0005
SU3_SELF_ANCHOR = 0.5937234  # +- 4.2e-5 (600 sweeps, 16^4, seed 7)
SU3_SELF_ERR = 4.2e-5
SU3_SELF_WINDOW = 1.0e-4
SU2_SELF_ANCHOR = 0.6304030  # +- 2.7e-4 (1000 sweeps, 8^4, seed 42)
SU2_SELF_ERR = 2.7e-4
SU2_SELF_WINDOW = 2.5e-4
BETA_C_NT6 = 5.894  # SU(3) deconfinement coupling at N_t = 6


def _self_gate(mean, err, anchor, anchor_err, window, gated=True):
    """The self-regression tier: dev, tolerance, pass, and which arm bound.
    gated=False (quick mode) reports it advisorily: the anchors are
    full-depth chains, which a quick chain is not."""
    dev = abs(mean - anchor)
    stat = 3.0 * float(np.hypot(err, anchor_err))
    tol = max(window, stat)
    ok = bool(dev < tol)
    return {
        "anchor": anchor, "dev": dev, "tolerance": tol,
        "tolerance_bound": (f"window({window})" if window > stat
                            else "stat(3*sigma_comb)"),
        "gated": bool(gated),
        "pass": ok if gated else None,
        "within": ok,
    }


def _run_chain(cfg: SimConfig, device="cuda"):
    sim = Simulation(cfg, device=device)
    sim.thermalize()
    sim.run()
    return sim, sim.analysis()["plq"]


def _suffix(overrides):
    return (" [" + ", ".join(f"{k}={v}" for k, v in overrides.items()) + "]"
            if overrides else "")


def check_su2(quick=False, device="cuda", **overrides):
    cfg = SimConfig(
        group=2, dims=(8, 8, 8, 8), beta=2.4, algorithm="heatbath",
        sweeps_therm=100 if quick else 300,
        sweeps=300 if quick else 1000, seed=42,
    ).replace(**overrides)
    _, st = _run_chain(cfg, device)
    dev = abs(st.mean - SU2_B24_PLQ)
    tol = max(5 * st.err, SU2_WINDOW)
    self_gate = _self_gate(st.mean, st.err, SU2_SELF_ANCHOR, SU2_SELF_ERR,
                           SU2_SELF_WINDOW, gated=not quick)
    return {
        "name": "SU(2) 8^4 beta=2.4 plaquette" + _suffix(overrides),
        "measured": st.mean, "err": st.err, "expected": SU2_B24_PLQ,
        "tolerance": tol, "self_regression": self_gate,
        "pass": bool(dev < tol and self_gate["pass"] is not False),
    }


def check_su3(quick=False, device="cuda", **overrides):
    # track_kp_exhaust: the production point doubles as the receipt for the
    # fixed-K KP sampler's identity-fallback rate (~1e-6 at beta=6, K=4)
    cfg = SimConfig(
        group=3, dims=(16, 16, 16, 16), beta=6.0, algorithm="heatbath",
        n_or=1, sweeps_therm=100 if quick else 300,
        sweeps=200 if quick else 600, seed=7, track_kp_exhaust=True,
    ).replace(**overrides)
    sim, st = _run_chain(cfg, device)
    kp_rate = float(sim.analysis()["kp_exhaust_rate"].mean)
    dev = abs(st.mean - SU3_B60_PLQ)
    tol = max(5 * st.err, SU3_WINDOW)
    self_gate = _self_gate(st.mean, st.err, SU3_SELF_ANCHOR, SU3_SELF_ERR,
                           SU3_SELF_WINDOW, gated=not quick)
    return {
        "name": "SU(3) 16^4 beta=6.0 plaquette (HB + OR) + KP exhaustion"
                + _suffix(overrides),
        "measured": {"plq": st.mean, "kp_exhaust_rate": kp_rate},
        "err": st.err, "expected": SU3_B60_PLQ,
        "tolerance": tol,
        "tolerance_bound": ("stat(5*err)" if 5 * st.err > SU3_WINDOW
                            else f"window({SU3_WINDOW})"),
        "self_regression": self_gate,
        "pass": bool(dev < tol and kp_rate < 1e-5
                     and self_gate["pass"] is not False),
    }


def check_deconfinement(quick=False, device="cuda", chain_mesh=1,
                        **overrides):
    """|Polyakov| must be ~0 below beta_c(N_t = 6) and clearly nonzero
    above: one BetaScan of two chains (reference validate.py:141-165), in
    ``chain_mesh`` blocks (on an X/Y mesh with overrides mesh=...)."""
    from .models.ensemble import BetaScan
    from .ops.measure import measure_obs_names

    dims = (12, 12, 12, 6) if quick else (24, 24, 24, 6)
    betas = [BETA_C_NT6 - 0.25, BETA_C_NT6 + 0.25]
    cfg = SimConfig(
        group=3, dims=dims, beta=betas[0], algorithm="heatbath", n_or=1,
        sweeps_therm=100 if quick else 200,
        sweeps=150 if quick else 300, seed=5,
    ).replace(**overrides)
    scan = BetaScan(cfg, betas, chain_mesh, device=device)
    scan.thermalize()
    obs = scan.run()  # [2, n_meas, n_obs]
    names = list(measure_obs_names(cfg))
    i_re, i_im = names.index("poly_re"), names.index("poly_im")
    pabs = np.abs(obs[:, :, i_re] + 1j * obs[:, :, i_im]).mean(axis=1)
    lo, hi = float(pabs[0]), float(pabs[1])
    return {
        "name": f"deconfinement {cfg.dims[0]}^3x{cfg.dims[3]}: |P| across "
                f"beta_c={BETA_C_NT6}" + _suffix(overrides),
        "measured": {"below": lo, "above": hi},
        "expected": "|P|(above) > 3 * |P|(below) and |P|(above) > 0.05",
        "pass": bool(hi > 3 * lo and hi > 0.05),
    }


def moment_sigmas(u):
    """(E[u^k] - 1/(k+1)) / its standard error under U(0,1), k = 1..4."""
    out = {}
    for k in (1, 2, 3, 4):
        err = np.sqrt((1.0 / (2 * k + 1) - 1.0 / (k + 1) ** 2) / len(u))
        out[k] = float((np.mean(u ** k) - 1.0 / (k + 1)) / err)
    return out


def _ks_vs(a, b):
    """Two-sample KS (statistic, p); without scipy the statistic alone."""
    try:
        from scipy import stats as sps
    except ImportError:
        both = np.sort(np.concatenate([a, b]))
        ca = np.searchsorted(np.sort(a), both, "right") / len(a)
        cb = np.searchsorted(np.sort(b), both, "right") / len(b)
        return float(np.max(np.abs(ca - cb))), float("nan")
    r = sps.ks_2samp(a, b)
    return float(r.statistic), float(r.pvalue)


def rng_rows(n, seed, generators, streams=True, device="cuda",
             native_seed=None):
    """The RNG self-test behind check_rng and ``rngtest``: n uniforms of
    threefry and Philox (rng_mode "hw"), keyed by seed, and of each named
    native generator, seeded native_seed (seed + 2 by default).  Each row
    holds the generator, its moments E[x^k], their sigmas and, but for
    threefry's, a two-sample KS test against threefry.  With streams, each
    native generator's device stream (rng_mode='prngcl:<gen>') adds a row
    of its draws pooled over a 4^4 lattice, whose native_match says that
    site 0 equals the native generator bit for bit (None without the
    native library).  The constant generator is left out."""
    import torch

    from .native import prngcl
    from .ops import prng_streams as ps
    from .ops import rng
    from .ops.cuda.engine import resolve_device

    dev = resolve_device(device)
    native_seed = seed + 2 if native_seed is None else native_seed
    generators = [g for g in generators if g != "constant"]
    key = rng.make_base_key(seed)
    sidx = torch.arange((n + 15) // 16, dtype=torch.int64, device=dev)
    tf = rng.site_uniforms(key, sidx, 16).double().cpu().numpy().ravel()[:n]
    draws = [("threefry (production)", tf),
             ("philox (hw)", rng.site_uniforms_philox(key, sidx, 16)
              .double().cpu().numpy().ravel()[:n])]
    if prngcl.available():
        draws += [(g, np.clip(prngcl.fill(g, native_seed, n), 1e-12,
                              1 - 1e-12)) for g in generators]
    probes = {}
    if streams:
        dims = (4, 4, 4, 4)
        nsite = int(np.prod(dims))
        n_per = max(64, n // nsite)
        for g in generators:
            u_dev, _ = ps.stream_draw(
                g, ps.make_stream_state(g, native_seed, dims, dev), n_per)
            u_dev = u_dev.double().cpu().numpy().reshape(n_per, nsite)
            probe = None
            if prngcl.available():
                seeds = ps.site_seeds(native_seed, dims).ravel()
                k = min(n_per, 256)
                ref = prngcl.fill(g, int(seeds[0]), k)
                probe = bool(np.allclose(
                    u_dev[:k, 0].astype(np.float32),
                    ref.astype(np.float32), atol=3e-7, rtol=0,
                ))
            name = f"device:{g}"
            probes[name] = probe
            draws.append((name, np.clip(u_dev.ravel()[:n], 1e-12,
                                        1 - 1e-12)))
    rows = []
    for name, u in draws:
        row = {"generator": name,
               "moments": {k: float(np.mean(u ** k)) for k in (1, 2, 3, 4)},
               "moment_sigmas": moment_sigmas(u)}
        if u is not tf:
            stat, p = _ks_vs(tf, u)
            row["ks_vs_threefry"] = {"statistic": stat, "pvalue": p}
        if name in probes:
            row["native_match"] = probes[name]
        rows.append(row)
    return rows


def check_rng(quick=False, device="cuda"):
    rows = rng_rows(1 << (18 if quick else 20), 13,
                    ("ranlux3", "xor128", "mrg32k3a"), device=device,
                    native_seed=17)
    worst = {r["generator"]: round(max(abs(v) for v in
                                       r["moment_sigmas"].values()), 2)
             for r in rows}
    probes = [r["native_match"] for r in rows if "native_match" in r]
    # the device streams (rng_mode='prngcl:<gen>'): bit parity vs native
    streams_ok = (None if any(p is None for p in probes)
                  else all(probes))
    return {
        "name": "RNG parity (uniform moments, threefry and Philox vs "
                "reference family)",
        "measured": {**worst, "device_streams_bit_match": streams_ok},
        "expected": "max |sigma| < 6 per generator; device streams match",
        "pass": bool(max(worst.values()) < 6.0) and streams_ok is not False,
    }


def _config5_one_device(device):
    """Config 5 below two cards: the reference's fallback
    (qcdgpu_tpu/validate.py:215-250) on the dense engine, its shards all
    on ``device``: a short SU(3) chain, (8, 8, 4, 8), complex64, heat-bath
    + 1 OR, reunit_every=2, seed 3, from a hot start, 2 sweeps measured
    once, on default_mesh_shape(8, dims) = (4, 2, 1, 1) against the same
    chain unsharded.  Links bit-identical, observables within 1e-5."""
    import torch

    from . import dense
    from .ops import rng
    from .parallel.mesh import default_mesh_shape

    dims = (8, 8, 4, 8)
    shape = default_mesh_shape(8, dims)
    cfg = SimConfig(group=3, dims=dims, beta=6.0, n_or=1, reunit_every=2,
                    seed=3, engine="xla")
    key = rng.make_base_key(3)
    u0 = dense.hot_start(cfg, key, device)
    u_ref, obs_ref = dense.make_chunk_runner(cfg, device)(u0, key, 0, 2, 2)
    u_out, obs_sh = dense.make_chunk_runner(cfg.replace(mesh=shape),
                                            device)(u0, key, 0, 2, 2)
    dlinks = float(torch.max(torch.abs(u_ref - u_out)))
    dobs = float(torch.max(torch.abs(obs_ref - obs_sh)))
    return {"mesh": list(shape), "max_dlinks": dlinks, "max_dobs": dobs,
            "plq": float(obs_sh[0, 0]),
            "pass": bool(dlinks == 0.0 and dobs < 1e-5)}


def check_multichip(quick=False, device="cuda"):
    import torch

    from .ops.cuda.engine import resolve_device
    from .parallel.mesh import default_mesh_shape

    dev = resolve_device(device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n_dev < 2:
        # no second card: config 5's mechanism (domain decomposition and
        # halo exchange) on the one device, PASS or FAIL, never SKIP
        r = _config5_one_device(dev)
        return {
            "name": "multi-card SU(3) sharded == unsharded (mesh "
                    f"{tuple(r['mesh'])} on one device, {dev}; only "
                    f"{n_dev} attached)",
            "measured": {"max_dlinks": r["max_dlinks"],
                         "max_dobs": r["max_dobs"]},
            "expected": "bit-identical links, obs within 1e-5",
            "pass": r["pass"],
        }
    dims = (32, 32, 32, 32)
    k = 1 << int(np.log2(n_dev))
    shape = default_mesh_shape(k, dims)
    cfg = SimConfig(
        group=3, dims=dims, beta=6.0, n_or=1,
        mesh=shape, sweeps_therm=50 if quick else 150,
        sweeps=100 if quick else 300, seed=3,
    )
    sim = Simulation(cfg, device="cuda:0",
                     devices=[f"cuda:{i}" for i in range(k)])
    sim.thermalize()
    sim.run()
    st = sim.analysis()["plq"]
    dev = abs(st.mean - SU3_B60_PLQ)
    tol = max(5 * st.err, SU3_WINDOW)
    return {
        "name": f"multi-card SU(3) 32^4 over mesh {shape}",
        "measured": st.mean, "err": st.err, "expected": SU3_B60_PLQ,
        "tolerance": tol, "pass": bool(dev < tol),
    }


def check_engines(quick=False, device="cuda"):
    """The dense engine against the packed one, identical threefry streams
    (the reference's config 6, validate.py:321-413): SU(3) 8^4, beta 6.0,
    n_or 1, a hot start, seed 21, 2 sweeps, no reunitarization.  Both
    engines sample the same chain up to f32 rounding order; the packed
    kernels and torch's ops round differently (-fmad=false kernels, the
    two-row codec's third row), and 2 sweeps x 16 dependent stages amplify
    that, so the chain bars are |dlinks| < 1e-2 and |dobs| < 1e-4, where a
    flipped Monte Carlo decision moves a whole SU(3) matrix (O(1)).  One
    heat-bath stage (mu 1, parity 0) on identical inputs must agree to
    2e-5.  ``quick`` changes nothing (the check is one size)."""
    import torch

    from . import dense
    from .ops import rng
    from .ops.cuda import engine
    from .ops.cuda import update as cupdate
    from .ops.lattice import parity_mask, site_index
    from .ops.samplers import update_links
    from .ops.staples import staple_sum

    del quick
    dev = engine.resolve_device(device)
    cfg = SimConfig(group=3, dims=(8, 8, 8, 8), beta=6.0, n_or=1,
                    rng_mode="threefry", reunit_every=0, seed=21,
                    start="hot")
    key = rng.make_base_key(cfg.seed)
    u0 = dense.hot_start(cfg, key, dev)
    outs = {
        "xla": dense.make_chunk_runner(cfg.replace(engine="xla"), dev)(
            u0, key, 0, 2, 2),
        "pallas": engine.make_chunk_runner(cfg.replace(engine="pallas"),
                                           dev)(u0, key, 0, 2, 2),
    }
    dlinks = float(torch.max(torch.abs(outs["xla"][0] - outs["pallas"][0])))
    dobs = float(torch.max(torch.abs(outs["xla"][1] - outs["pallas"][1])))

    mu, parity = 1, 0
    key2 = rng.stage_key(key, 0, 5)
    us = engine.split_links(u0)
    cupdate.stage_update(us, mu, parity, cfg.beta, key2, cfg.dims,
                         cfg.kp_trials, kind="heatbath", n_hit=cfg.n_hit,
                         metro_delta=cfg.metro_delta)
    got = engine.join_dir((us[2 * mu], us[2 * mu + 1]), cfg.dims, cfg.group)
    ref = update_links(u0[mu], staple_sum(u0, mu), "heatbath", cfg.beta,
                       key2, site_index(cfg.dims, dev),
                       k_trials=cfg.kp_trials)
    ref = torch.where(parity_mask(cfg.dims, parity, dev), ref, u0[mu])
    dstage = float(torch.max(torch.abs(got - ref)))
    return {
        "name": "engine cross-validation (dense vs packed, threefry, "
                "2 sweeps + single stage)",
        "measured": {"max_dlinks": dlinks, "max_dobs": dobs,
                     "max_dstage": dstage},
        "expected": "chain: |dlinks| < 1e-2, |dobs| < 1e-4; "
                    "single stage: |dstage| < 2e-5",
        "pass": bool(dlinks < 1e-2 and dobs < 1e-4 and dstage < 2e-5),
    }


CHECKS = {
    1: check_su2,
    2: check_su3,
    3: check_deconfinement,
    4: check_rng,
    5: check_multichip,
    6: check_engines,
}


def run_validation(configs=(1, 2, 3, 4, 5, 6), quick=False, out_path=None,
                   device="cuda"):
    results = []
    for c in configs:
        t0 = time.time()
        r = CHECKS[c](quick=quick, device=device)
        r["config"] = c
        r["seconds"] = round(time.time() - t0, 1)
        results.append(r)
        status = ("SKIP" if r["pass"] is None
                  else "PASS" if r["pass"] else "FAIL")
        print(f"[{status}] #{c} {r['name']}  ({r['seconds']}s)")
        for k in ("measured", "err", "expected", "tolerance",
                  "tolerance_bound", "self_regression", "skipped"):
            if k in r and r[k] is not None:
                print(f"       {k}: {r[k]}")
    ok = all(r["pass"] is not False for r in results)
    print(f"=> validation {'PASSED' if ok else 'FAILED'} "
          f"({sum(1 for r in results if r['pass'] is True)} pass, "
          f"{sum(1 for r in results if r['pass'] is False)} fail, "
          f"{sum(1 for r in results if r['pass'] is None)} skip)")
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"quick": quick, "results": results}, f, indent=1,
                      default=float)
        print(f"wrote {out_path}")
    return ok, results
