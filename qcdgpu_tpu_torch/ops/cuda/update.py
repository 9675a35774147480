"""K1: the fused heat-bath stage — CUDA kernel (csrc/stage.cu) and its plain
PyTorch version.

Port of the heat-bath path of qcdgpu_tpu/ops/pallas/update.py: one
checkerboard stage (parity p, direction mu) gathers the staples of every
parity-p site, forms W = U A, runs the Kennedy–Pendleton heat-bath on the
three Cabibbo–Marinari SU(2) subgroups and stores rows 0-1 of the new link.
Randomness is threefry keyed by (host-computed stage key, global dense site
index, slot): subgroup s draws slots s*(2K+1) ... s*(2K+1) + 2K, with
trial t taking (r1, r2) from slot 2t and (r3, r4) from slot 2t+1 and the
direction from slot 2K — the reference's draw schedule.

The stage updates ``us[2*mu + parity]`` IN PLACE on both paths.  That is
safe because the stage reads that array only at the site it updates: the
staple reads of U_mu at x +- nu lie in the other parity's array
(reference ``_staple_W``, update.py:337-356).

``stage_update`` dispatches on the tensors' device: CPU tensors go to
``stage_update_ref``, CUDA tensors to the kernel, anything else raises.
There is no fallback from a failed build or launch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import fastmath as fm
from .. import rng
from . import build, core

NDIM = 4
SUBGROUPS = ((0, 1), (0, 2), (1, 2))

# kernel launches, counted where the kernel is launched (never on the CPU)
LAUNCHES = {"stage": 0}


def two_beta_over_n(beta, n):
    """beta * (2/n) rounded as the reference kernel rounds it (f32 beta
    times f32(2/n)); passed to the kernel as one f32."""
    return float(np.float32(beta) * np.float32(2.0 / n))


# ---------------------------------------------------------------------------
# quaternions as 4-tuples of f32 tensors (ops.sun conventions)
# ---------------------------------------------------------------------------


def quat_from_block(w, i, j):
    a0 = 0.5 * (w[i][i][0] + w[j][j][0])
    a1 = 0.5 * (w[i][j][1] + w[j][i][1])
    a2 = 0.5 * (w[i][j][0] - w[j][i][0])
    a3 = 0.5 * (w[i][i][1] - w[j][j][1])
    return (a0, a1, a2, a3)


def quat_mul(p, q):
    return (
        p[0] * q[0] - p[1] * q[1] - p[2] * q[2] - p[3] * q[3],
        p[0] * q[1] + q[0] * p[1] - (p[2] * q[3] - p[3] * q[2]),
        p[0] * q[2] + q[0] * p[2] - (p[3] * q[1] - p[1] * q[3]),
        p[0] * q[3] + q[0] * p[3] - (p[1] * q[2] - p[2] * q[1]),
    )


def quat_conj(q):
    return (q[0], -q[1], -q[2], -q[3])


def subgroup_left_mul(q, i, j, m):
    """m <- embed(M(q); i, j) @ m on a nested-tuple matrix."""
    u00 = (q[0], q[3])
    u01 = (q[2], q[1])
    u10 = (-q[2], q[1])
    u11 = (q[0], -q[3])
    rows = [list(r) for r in m]
    for k in range(len(m[0])):
        mi, mj = m[i][k], m[j][k]
        rows[i][k] = core.cadd(core.cmul(u00, mi), core.cmul(u01, mj))
        rows[j][k] = core.cadd(core.cmul(u10, mi), core.cmul(u11, mj))
    return tuple(tuple(r) for r in rows)


def heatbath_flip(q_w, tbn, u, k_trials):
    """KP heat-bath multiplier; u = list of 4*k_trials + 2 uniform tensors.
    Fixed-K masked trials, first accepted wins, identity on exhaustion."""
    n2 = q_w[0] * q_w[0] + q_w[1] * q_w[1] + q_w[2] * q_w[2] + q_w[3] * q_w[3]
    rk = 1.0 / torch.sqrt(torch.clamp(n2, min=fm.f32(1e-38)))
    k = n2 * rk
    v = tuple(c * rk for c in q_w)
    a = tbn * k
    inv2a = 1.0 / (2.0 * torch.clamp(a, min=fm.f32(1e-10)))
    lam2_sel = ok = None
    for t in range(k_trials):
        r1, r2, r3, r4 = u[4 * t], u[4 * t + 1], u[4 * t + 2], u[4 * t + 3]
        c2 = fm.cos2_2pi(r2)
        lam2 = -inv2a * (fm.log_u01(r1) + c2 * fm.log_u01(r3))
        acc = (r4 * r4) <= (1.0 - lam2)
        if t == 0:
            lam2_sel, ok = lam2, acc
        else:
            lam2_sel = torch.where(acc & ~ok, lam2, lam2_sel)
            ok = ok | acc
    x0 = torch.clamp(1.0 - 2.0 * lam2_sel, -1.0, 1.0)
    rho = torch.sqrt(torch.clamp(1.0 - x0 * x0, min=0.0))
    ct = 2.0 * u[4 * k_trials] - 1.0
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, min=0.0))
    sph, cph = fm.sincos_2pi(u[4 * k_trials + 1])
    w = (x0, rho * st * cph, rho * st * sph, rho * ct)
    unew = quat_mul(w, quat_conj(v))
    good = ok & (k > fm.f32(1e-30))
    ident = (1.0, 0.0, 0.0, 0.0)
    return tuple(torch.where(good, unew[c], torch.full_like(unew[c], ident[c]))
                 for c in range(4))


# ---------------------------------------------------------------------------
# the staple recipe on packed state
# ---------------------------------------------------------------------------


def staple_W(ld, mu):
    """(U_mu, W = U_mu A) with the staple sum A in the reference's order
    (ops/pallas/update.py _staple_W): nu ascending, term = fwd + bwd."""
    acc = None
    for nu in range(NDIM):
        if nu == mu:
            continue
        # forward: U_nu(x+mu) [U_nu(x) U_mu(x+nu)]^+
        inner = core.mmul(ld.U(nu), ld.U(mu, ((nu, 1),)))
        fwd = core.mmul_bdag(ld.U(nu, ((mu, 1),)), inner)
        # backward: [U_mu(x-nu) U_nu(x+mu-nu)]^+ U_nu(x-nu)
        s2 = ld.U(nu, ((mu, 1), (nu, -1)))
        bwd = core.mmul(core.mdag(core.mmul(ld.U(mu, ((nu, -1),)), s2)),
                        ld.U(nu, ((nu, -1),)))
        term = core.madd(fwd, bwd)
        acc = term if acc is None else core.madd(acc, term)
    u_mu = ld.U(mu)
    return u_mu, core.mmul(u_mu, acc)


def _check(us, mu, parity, dims, k_trials):
    if len(us) != 2 * NDIM:
        raise ValueError("us must be the 8-tuple us[2*mu + parity]")
    n = us[0].shape[1]
    if n != 3:
        raise NotImplementedError(
            "the SU(2) stage is not ported yet (ROADMAP queue 1, SU(2) "
            "instantiations of K1 and K2)"
        )
    for i, a in enumerate(us):
        core.check_packed(a, n, dims, f"us[{i}]")
    if mu not in range(NDIM) or parity not in (0, 1):
        raise ValueError(f"bad stage (mu={mu}, parity={parity})")
    if int(k_trials) < 1:
        raise ValueError("k_trials must be >= 1")
    return core.check_device(*us)


def stage_update_ref(us, mu, parity, beta, key2, dims, k_trials=4):
    """Plain PyTorch heat-bath stage; updates us[2*mu + parity] in place
    and returns it.  Any device."""
    _check(us, mu, parity, dims, k_trials)
    n = 3
    dims = tuple(dims)
    ld = core.LinkLoader(us, parity, dims, n)
    u_mu, w = staple_W(ld, mu)
    per = 4 * k_trials + 2
    sidx = core.site_index_packed(parity, dims, us[0].device).reshape(-1)
    u_all = rng.site_uniforms(key2, sidx, per * len(SUBGROUPS))
    tbn = two_beta_over_n(beta, n)
    for s, (i, j) in enumerate(SUBGROUPS):
        u_s = [u_all[per * s + c] for c in range(per)]
        flip = heatbath_flip(quat_from_block(w, i, j), tbn, u_s, k_trials)
        u_mu = subgroup_left_mul(flip, i, j, u_mu)
        w = subgroup_left_mul(flip, i, j, w)
    target = us[2 * mu + parity]
    core.store_rows(target, u_mu, n)
    return target


def stage_update(us, mu, parity, beta, key2, dims, k_trials=4):
    """One heat-bath stage on the packed 8-tuple, in place on
    us[2*mu + parity] (returned).  key2: the (k0, k1) stage key as ints
    (rng.stage_key).  CPU tensors take the plain version, CUDA tensors the
    kernel."""
    if _check(us, mu, parity, dims, k_trials) == "cpu":
        return stage_update_ref(us, mu, parity, beta, key2, dims, k_trials)
    lib = build.library()
    x, y, z, t = (int(d) for d in dims)
    with torch.cuda.device(us[0].device):
        err = lib.qg_stage_heatbath_su3(
            *[a.data_ptr() for a in us], int(mu), int(parity), x, y, z, t,
            int(key2[0]), int(key2[1]), two_beta_over_n(beta, 3),
            int(k_trials), build.stream_handle(us[0].device),
        )
    build.check(err, "stage_heatbath_su3")
    LAUNCHES["stage"] += 1
    return us[2 * mu + parity]
