"""Link-update samplers of the dense engine: heat-bath, overrelaxation,
Metropolis.

Port of qcdgpu_tpu/ops/samplers.py (its lines 39-266), as PyTorch ops on
the dense field, with the reference's order of terms and dtypes.

Every update left-multiplies the link by an SU(2)-subgroup element,
U' = embed(u; i, j) @ U, with the conditional weight
P(u) ~ exp((beta/N) Re tr(u_emb W)), W = U @ A (A the staple sum).  Only
the projected quaternion q(W; i, j) of the (i, j) block matters, so one
code path serves SU(2) (one subgroup) and SU(3) (three, Cabibbo–Marinari).

Kennedy–Pendleton runs a fixed K trials for every site, takes the first
accepted one and keeps the old link when all K fail.  That is exact: the
failure event depends only on (A, the trial uniforms), never on the
current link, so the kernel is the state-independent mixture
(1 - eps(A)) heat-bath + eps(A) identity.

Dtypes follow the reference: the uniforms and ``two_beta_over_n`` are f32
and the quaternions are in the links' real dtype, so a complex128 field
samples in f64 on f32 uniforms, and each multiplier is cast to the links'
real dtype before it is applied.  ``*sites`` is any shape: a beta scan's
chain axis sits before the lattice axes, with a coupling per chain
(``beta`` a sequence) and the tracked statistics averaged per chain over
the lattice axes.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fastmath as fm
from . import rng, sun

LATTICE_AXES = (-4, -3, -2, -1)
METRO_UNIFORMS_PER_HIT = 4


def _sqrt(x):
    """Square root, correctly rounded in f32 too.  torch's f32 sqrt on the
    CPU (MKL's vector sqrt) is not always correctly rounded, so there the
    f32 root goes through f64 (one rounding of a correctly rounded f64 root
    is exact); the card's f32 sqrt is correctly rounded (chip_smoke.py
    phase 9 (a) checks it) and runs as it is."""
    if x.dtype == torch.float32 and x.device.type == "cpu":
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def _rsqrt(x):
    """1/sqrt(x): in f32 the correctly rounded root, then a correctly
    rounded division, the same bits on the CPU and the card; in f64
    torch's rsqrt, which gives the reference's bits.  (The reference's f32
    rsqrt on XLA's CPU backend is an estimate within one ulp of this.)"""
    if x.dtype == torch.float32:
        return 1.0 / _sqrt(x)
    return torch.rsqrt(x)


def kp_uniform_terms(utr, udir):
    """The parts of a Kennedy–Pendleton draw that depend on its uniforms
    alone: (log r1 + cos^2(2 pi r2) log r3, r_acc^2 [K, *sites]; ct, st,
    sin, cos [*sites] of the S^2 direction), all f32.  A stage takes them
    for all its subgroups at once (the same elementwise operations, fewer
    launches)."""
    r1, r2, r3, r4 = utr[:, 0], utr[:, 1], utr[:, 2], utr[:, 3]
    c2 = fm.cos2_2pi(r2)  # only cos^2 enters KP: no quadrant sign
    ct = 2.0 * udir[0] - 1.0
    st = _sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    sph, cph = fm.sincos_2pi(udir[1])
    return (fm.log_u01(r1) + c2 * fm.log_u01(r3), r4 * r4,
            (ct, st, sph, cph))


def kp_trial_quat(a, utr, udir, eps=1e-10, terms=None):
    """Kennedy–Pendleton sample of w in SU(2) with P(w) ~ exp(a * w0) dw.

    a:    [*sites] > 0 coefficient (= 2*beta*k/N).
    utr:  [K, 4, *sites] uniforms in (0,1) — K trials x (r1, r2, r3, r_acc).
    udir: [2, *sites] uniforms for the uniform S^2 direction of the vector
          part.
    terms: kp_uniform_terms(utr, udir), when the caller has them.
    Returns (w [4, *sites], ok [*sites] bool)."""
    inv2a = 1.0 / (2.0 * torch.clamp(a, min=eps))
    logs, r4sq, (ct, st, sph, cph) = (kp_uniform_terms(utr, udir)
                                      if terms is None else terms)
    lam2 = -inv2a * logs  # [K, *sites]
    acc = r4sq <= (1.0 - lam2)
    # the first accepted trial (argmax of the first maximum)
    idx = torch.argmax(acc.to(torch.uint8), dim=0)
    ok = torch.any(acc, dim=0)
    lam2_sel = torch.take_along_dim(lam2, idx[None], dim=0)[0]
    x0 = torch.clamp(1.0 - 2.0 * lam2_sel, -1.0, 1.0)
    rho = _sqrt(torch.clamp(1.0 - x0 * x0, min=0.0))
    w = torch.stack([x0, rho * st * cph, rho * st * sph, rho * ct], dim=0)
    return w, ok


def kp_uniforms_per_subgroup(k_trials: int) -> int:
    return 4 * k_trials + 2


def stage_uniform_count(n_colors, kind, k_trials=4, n_hit=3) -> int:
    """Uniforms one update stage consumes per site (the rows of
    update_links' ``uniforms``); zero for overrelaxation."""
    if kind == "heatbath":
        per = kp_uniforms_per_subgroup(k_trials)
    elif kind == "metropolis":
        per = METRO_UNIFORMS_PER_HIT * n_hit
    else:
        return 0
    return 2 * ((per + 1) // 2) * len(sun.subgroups(n_colors))


def site_count(x):
    """f32 count of a boolean field over the lattice axes (per chain),
    exact below 2^24 sites."""
    return torch.sum(x.to(torch.float32), dim=LATTICE_AXES)


def tracked_rate(counts, vol, kind, n_hit, n_subgroups):
    """update_links' tracked statistic from its exact counts (return_acc:
    per subgroup, the KP exhaustions, or the acceptances of each Metropolis
    hit in turn) over ``vol`` sites: each count divided by vol (the
    reference's jnp.mean of the f32 flags), then the hits and subgroups
    averaged in the reference's order, so that the counts of a lattice's
    shards, added first, give the whole lattice's rate bit for bit."""
    total = 0.0
    it = iter(counts)
    for _ in range(n_subgroups):
        if kind == "heatbath":
            acc = next(it) / vol
        else:
            frac = 0.0
            for _ in range(n_hit):
                frac = frac + next(it) / vol
            acc = frac / n_hit
        total = total + acc
    return total / n_subgroups


def _identity_quat_like(q):
    ident = torch.zeros_like(q)
    ident[0] = 1.0
    return ident


def heatbath_flip(q_w, two_beta_over_n, u, k_trials, with_fail=False,
                  terms=None):
    """The left-multiplier of one subgroup heat-bath touch.

    q_w: projected quaternion of the W block, [4, *sites].
    u: pre-drawn uniforms [4*k_trials + 2, *sites] (unused with ``terms``,
    their kp_uniform_terms).
    Returns u [4, *sites], the identity where KP exhausted its trials; with
    with_fail also the count of the sites that exhausted them, in a
    one-element list (tracked_rate)."""
    # rsqrt form: one reciprocal square root and multiplies
    n2 = sun.quat_norm2(q_w)
    rk = _rsqrt(torch.clamp(n2, min=1e-38))
    k = n2 * rk
    v = q_w * rk
    a = two_beta_over_n * k
    if terms is None:
        utr = u[: 4 * k_trials].reshape((k_trials, 4) + tuple(u.shape[1:]))
        terms = kp_uniform_terms(utr, u[4 * k_trials:])
    w, ok = kp_trial_quat(a, None, None, terms=terms)
    unew = sun.quat_mul(w, sun.quat_conj(v))
    # a degenerate staple (k ~ 0) keeps the identity (measure zero)
    good = ok & (k > 1e-30)
    out = torch.where(good[None], unew, _identity_quat_like(unew))
    if with_fail:
        return out, [site_count(torch.logical_not(ok))]
    return out


def overrelax_flip(q_w):
    """Microcanonical overrelaxation multiplier u = (v^+)^2, v = q_w/|q_w|:
    Re tr(u_emb W) is preserved exactly; no random numbers."""
    n2 = sun.quat_norm2(q_w)
    qc = sun.quat_conj(q_w)
    # quat_mul(q^+, q^+) / |q|^2: one reciprocal, then a multiply
    inv = 1.0 / torch.clamp(n2, min=1e-38)
    u = sun.quat_mul(qc, qc) * inv
    return torch.where((n2 > 1e-38)[None], u, _identity_quat_like(u))


def metropolis_terms(uu, n_hit, delta):
    """The parts of n_hit Metropolis touches that depend on their uniforms
    alone: the proposals w [4, n_hit, *sites] (normalised, f32) and the
    log acceptance draws [n_hit, *sites], for all hits (or all subgroups'
    hits) at once.  uu: [4*n_hit, *sites]."""
    u = uu.reshape((n_hit, 4) + tuple(uu.shape[1:]))
    w1 = delta * (2.0 * u[:, 0] - 1.0)
    w2 = delta * (2.0 * u[:, 1] - 1.0)
    w3 = delta * (2.0 * u[:, 2] - 1.0)
    w0 = torch.ones_like(w1)
    rn = _rsqrt(w0 * w0 + w1 * w1 + w2 * w2 + w3 * w3)
    return torch.stack([w0, w1, w2, w3], dim=0) * rn, fm.log_u01(u[:, 3])


def metropolis_flip(q_w, two_beta_over_n, uu, n_hit, delta, with_acc=False,
                    terms=None):
    """n_hit Metropolis touches on one subgroup.

    Proposal: u = normalize(1, delta*(2r-1) x 3), symmetric under u -> u^+;
    accept with min(1, exp(dS)), dS = two_beta_over_n * ((u*q)_0 - q_0).
    uu: pre-drawn uniforms [4*n_hit, *sites] (unused with ``terms``, their
    metropolis_terms).  Returns the composed multiplier; with with_acc also
    each hit's count of accepting sites, a list (tracked_rate)."""
    ws, logs = metropolis_terms(uu, n_hit, delta) if terms is None else terms
    acc_u = _identity_quat_like(q_w)
    q_cur = q_w
    hits = []
    for h in range(n_hit):
        w = ws[:, h]
        new0 = sun.quat_mul0(w, q_cur)
        dlp = two_beta_over_n * (new0 - q_cur[0])
        accept = logs[h] < dlp
        if with_acc:
            hits.append(site_count(accept))
        w_eff = torch.where(accept[None], w.to(q_cur.dtype),
                            _identity_quat_like(q_cur))
        acc_u = sun.quat_mul(w_eff, acc_u)
        q_cur = sun.quat_mul(w_eff, q_cur)
    if with_acc:
        return acc_u, hits
    return acc_u


def two_beta_over_n(beta, n, device):
    """2 beta / N in f64, rounded to f32 (the reference's
    jnp.asarray(2.0 * beta / n, jnp.float32)): a 0-d tensor, or with one
    coupling per chain an f32 [C, 1, 1, 1, 1] that broadcasts over the
    chain axis of [C, X, Y, Z, T]."""
    b = np.asarray(beta, np.float64)
    t = torch.from_numpy(np.asarray(2.0 * b / n, np.float32)).to(device)
    return t if b.ndim == 0 else t.reshape((-1, 1, 1, 1, 1))


def update_links(u_mu, staples, kind, beta, key2, site_idx, *, k_trials=4,
                 n_hit=3, metro_delta=0.35, return_acc=False, uniforms=None,
                 two_beta=None):
    """One update of ``kind`` of every link of u_mu given its staples (the
    reference's update_links, samplers.py:183-266); the caller masks the
    parity.

    u_mu, staples: [N, N, *sites]; kind in {"heatbath", "overrelax",
    "metropolis"}; beta a number, or one per chain.  Randomness: the
    site-keyed threefry streams (key2, the stage key as two ints or two
    per-chain tensors, see rng.site_uniforms; site_idx the global
    [X, Y, Z, T] site index), or ``uniforms`` ([stage_uniform_count(...),
    *sites] in (0, 1)), the PRNGCL stream mode's pre-drawn numbers.

    With return_acc also the tracked statistic's exact counts, a list of
    f32 tensors (0-d, or one per chain): per subgroup the KP
    trial-exhaustions for heat-bath, or each Metropolis hit's acceptances;
    tracked_rate turns them into the reference's rate (a sharded lattice
    adds its shards' counts first).  two_beta: two_beta_over_n(beta, N,
    device), when the caller has it (a sweep captured for replay copies
    nothing from the host)."""
    n = u_mu.shape[0]
    tbn = (two_beta_over_n(beta, n, u_mu.device) if two_beta is None
           else two_beta)
    w = sun.mul(u_mu, staples)
    sgs = sun.subgroups(n)
    if kind == "heatbath":
        per = kp_uniforms_per_subgroup(k_trials)
    elif kind == "metropolis":
        per = METRO_UNIFORMS_PER_HIT * n_hit
    elif kind == "overrelax":
        per = 0
    else:
        raise ValueError(f"unknown update kind: {kind}")
    # the per-subgroup slot layout stays even whatever `per` is
    per_slots = (per + 1) // 2
    if per:
        if uniforms is not None:
            if uniforms.shape[0] != 2 * per_slots * len(sgs):
                raise ValueError(
                    f"uniforms must have {2 * per_slots * len(sgs)} rows "
                    f"(got {uniforms.shape[0]})")
            u_all = uniforms
        else:
            u_all = rng.site_uniforms(key2, site_idx,
                                      2 * per_slots * len(sgs))
    terms = None
    if per:
        # every subgroup's rows [per, S, *sites], subgroup s at index s of
        # the new axis: the uniform-only terms once for all of them
        rows = u_all.reshape((len(sgs), 2 * per_slots)
                             + tuple(u_all.shape[1:]))[:, :per]
        rows = rows.movedim(0, 1)
        if kind == "heatbath":
            terms = kp_uniform_terms(
                rows[: 4 * k_trials].reshape((k_trials, 4)
                                             + tuple(rows.shape[1:])),
                rows[4 * k_trials:])
        else:
            terms = metropolis_terms(rows, n_hit, metro_delta)
    real = u_mu.real.dtype
    counts = []
    for s, (i, j) in enumerate(sgs):
        q_w = sun.extract_block_quat(w, i, j)
        if kind == "heatbath":
            logs, r4sq, direction = terms
            flip = heatbath_flip(
                q_w, tbn, None, k_trials, with_fail=return_acc,
                terms=(logs[:, s], r4sq[:, s],
                       tuple(t[s] for t in direction)))
        elif kind == "overrelax":
            flip = overrelax_flip(q_w)
        else:
            flip = metropolis_flip(
                q_w, tbn, None, n_hit, metro_delta, with_acc=return_acc,
                terms=(terms[0][:, :, s], terms[1][:, s]))
        if return_acc and kind != "overrelax":
            flip, cnt = flip
            counts += cnt
        flip = flip.to(real)
        u_mu = sun.subgroup_left_mul(flip, i, j, u_mu)
        w = sun.subgroup_left_mul(flip, i, j, w)
    if return_acc:
        return u_mu, counts
    return u_mu
