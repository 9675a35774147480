"""K1: the fused checkerboard stage — CUDA kernel (csrc/stage.cuh) and its
plain PyTorch version.

Port of qcdgpu_tpu/ops/pallas/update.py (``_stage_kernel``, threefry and
PRNGCL stream RNG):
one checkerboard stage (parity p, direction mu) gathers the staples of
every parity-p site, forms W = U A, updates the Cabibbo–Marinari SU(2)
subgroups ((0,1) for SU(2); (0,1), (0,2), (1,2) for SU(3)) with one of

- ``"heatbath"``: Kennedy–Pendleton, ``k_trials`` fixed masked trials;
- ``"overrelax"``: the microcanonical flip (v^+)^2, no random numbers;
- ``"metropolis"``: ``n_hit`` accept/reject hits of spread ``metro_delta``,

and stores rows 0-1 of the new link.  Randomness is threefry keyed by
(host-computed stage key, global dense site index, slot), with the
reference's draw schedule: a subgroup consumes ``per`` uniforms (4K+2 for
heat-bath, 4 n_hit for Metropolis), rounded up to ``per_slots`` whole
threefry pairs, and subgroup s starts at slot ``per_slots * s``.
Heat-bath trial t takes (r1, r2) from slot 2t and (r3, r4) from 2t+1, the
direction from slot 2K; Metropolis hit h takes (u0, u1) from slot 2h and
(u2, u3) from 2h+1.

Tracking: given ``count`` (an int64 tensor of shape [1] on the state's
device), the stage ADDS its tracked count to it — accepted Metropolis hits,
or Kennedy–Pendleton exhaustions (sites where all K trials failed) for
heat-bath — over the active parity's sites.  On the card the count stays
on the device (one atomic add per block); nothing waits for it.

The stage updates ``us[2*mu + parity]`` IN PLACE on both paths.  That is
safe because the stage reads that array only at the site it updates: the
staple reads of U_mu at x +- nu lie in the other parity's array
(reference ``_staple_W``, update.py:337-356).

PRNGCL streams (``gen``): the randomness comes instead from the active
parity's per-site generator words ``[W, X, Y, Z*T/2]`` (ops/prng_streams.py),
which the stage advances in place: subgroup s consumes draws
``s * 2 * per_slots`` onwards in the order the threefry slots above name
them (heat-bath trial t draws 4t..4t+3, the direction 4K, 4K+1; Metropolis
hit h draws 4h..4h+3), each through ``open01``.  The lag generators' scalars
(pointer, luxury counter, carry) are host numbers in a dict the stage
advances in place, as it does the words.  The kernel has one instantiation
per generator family (csrc/stage_<family>.cu); its plain twin is
``stage_update_ref`` with the same arguments.

K1a, the stage on one shard of an X/Y-decomposed lattice (the reference's
``local_x`` / ``local_y`` > 0 form, driven by ops/pallas/sharded.py): pass
``shard`` (a ``core.Shard``).  us are then the shard's halo-padded arrays,
the stage updates its interior sites only, reading neighbours from the
halos on a split axis, and keys threefry by the GLOBAL site index, so the
sharded chain is the unsharded one; stream words are the shard's unpadded
``[W, lx, ly, Z*T/2]``.  Every instantiation has such a sharded twin
(``instance_name(..., shard=True)``).

``stage_update`` dispatches on the tensors' device: CPU tensors go to
the plain version, CUDA tensors to the kernel, anything else raises.
There is no fallback from a failed build or launch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import fastmath as fm
from .. import prng_streams as streams
from .. import rng
from . import build, core

NDIM = 4
KINDS = ("heatbath", "overrelax", "metropolis")
SUBGROUPS = {2: ((0, 1),), 3: ((0, 1), (0, 2), (1, 2))}


def instance_name(kind, n, track=False, gen=None, shard=False):
    """Name of the kernel instantiation (and its launch counter); ``gen``
    names a PRNGCL generator (its family's instantiation), ``shard`` the
    K1a twin on a halo-padded shard."""
    fam = "" if gen is None else "_" + streams.family(gen)
    return (f"stage_{kind}_su{n}{fam}" + ("_track" if track else "")
            + ("_shard" if shard else ""))


# the kernel instantiations: every kind and group, tracked where the kind
# has something to count; then the stream families' drawing kinds
INSTANCES = tuple(instance_name(k, n, t) for n in (3, 2) for k in KINDS
                  for t in (False, True) if not (t and k == "overrelax"))
STREAM_INSTANCES = tuple(
    f"stage_{k}_su{n}_{fam}" + ("_track" if t else "")
    for fam in streams.FAMILIES for n in (3, 2)
    for k in ("heatbath", "metropolis") for t in (False, True))

# K1a: the sharded twin of every instantiation
SHARD_INSTANCES = tuple(name + "_shard"
                        for name in INSTANCES + STREAM_INSTANCES)

# kernel launches, counted where the kernel is launched (never on the CPU)
LAUNCHES = {name: 0
            for name in INSTANCES + STREAM_INSTANCES + SHARD_INSTANCES}


def two_beta_over_n(beta, n):
    """beta * (2/n) rounded as the reference kernel rounds it (f32 beta
    times f32(2/n)); passed to the kernel as one f32."""
    return float(np.float32(beta) * np.float32(2.0 / n))


def uniforms_per_subgroup(kind, k_trials, n_hit):
    """Uniforms one subgroup touch consumes (reference update.py:400)."""
    if kind == "heatbath":
        return 4 * k_trials + 2
    if kind == "metropolis":
        return 4 * n_hit
    return 0


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


def _where_ident(good, q):
    """q where good, else the identity quaternion."""
    ident = (1.0, 0.0, 0.0, 0.0)
    return tuple(torch.where(good, q[c], torch.full_like(q[c], ident[c]))
                 for c in range(4))


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


def heatbath_flip(q_w, tbn, u, k_trials, with_count=False):
    """KP heat-bath multiplier; u = list of 4*k_trials + 2 uniform tensors.
    Fixed-K masked trials, first accepted wins, identity on exhaustion.
    With with_count also returns the number of exhausted sites (int64)."""
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
    out = _where_ident(ok & (k > fm.f32(1e-30)), quat_mul(w, quat_conj(v)))
    if with_count:
        return out, (~ok).sum(dtype=torch.int64)
    return out


def overrelax_flip(q_w):
    """Microcanonical overrelaxation multiplier (v^+)^2, v = q_w / |q_w|,
    as quat_mul(q_w^+, q_w^+) times the reciprocal of |q_w|^2."""
    n2 = q_w[0] * q_w[0] + q_w[1] * q_w[1] + q_w[2] * q_w[2] + q_w[3] * q_w[3]
    qc = quat_conj(q_w)
    inv = 1.0 / torch.clamp(n2, min=fm.f32(1e-38))
    u = tuple(c * inv for c in quat_mul(qc, qc))
    return _where_ident(n2 > fm.f32(1e-38), u)


def metropolis_flip(q_w, tbn, uu, n_hit, delta, with_count=False):
    """n_hit Metropolis hits on one subgroup; uu = list of 4*n_hit uniform
    tensors.  Proposal normalize(1, delta (2u - 1) x3), accepted when
    log u3 < tbn ((w q)_0 - q_0).  Returns the composed multiplier; with
    with_count also the number of accepted hits (int64)."""
    d = fm.f32(delta)
    acc_u = tuple(torch.full_like(q_w[0], c) for c in (1.0, 0.0, 0.0, 0.0))
    q_cur = q_w
    n_acc = None
    for h in range(n_hit):
        u = uu[4 * h: 4 * (h + 1)]
        w1 = d * (2.0 * u[0] - 1.0)
        w2 = d * (2.0 * u[1] - 1.0)
        w3 = d * (2.0 * u[2] - 1.0)
        w0 = torch.ones_like(w1)
        rn = 1.0 / torch.sqrt(w0 * w0 + w1 * w1 + w2 * w2 + w3 * w3)
        w = (w0 * rn, w1 * rn, w2 * rn, w3 * rn)
        new0 = quat_mul(w, q_cur)[0]
        dlp = tbn * (new0 - q_cur[0])
        accept = fm.log_u01(u[3]) < dlp
        if with_count:
            c = accept.sum(dtype=torch.int64)
            n_acc = c if n_acc is None else n_acc + c
        w_eff = _where_ident(accept, w)
        acc_u = quat_mul(w_eff, acc_u)
        q_cur = quat_mul(w_eff, q_cur)
    if with_count:
        return acc_u, n_acc
    return acc_u


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


def _check(us, mu, parity, dims, kind, k_trials, n_hit, count, shard):
    if len(us) != 2 * NDIM:
        raise ValueError("us must be the 8-tuple us[2*mu + parity]")
    n = us[0].shape[1]
    if n not in SUBGROUPS:
        raise ValueError(f"packed links are SU(2) or SU(3), got N={n}")
    if shard is not None and tuple(shard.dims) != tuple(dims):
        raise ValueError(f"shard of {shard.dims}, lattice {tuple(dims)}")
    ext = dims if shard is None else shard.padded
    for i, a in enumerate(us):
        core.check_packed(a, n, ext, f"us[{i}]")
    if mu not in range(NDIM) or parity not in (0, 1):
        raise ValueError(f"bad stage (mu={mu}, parity={parity})")
    if kind not in KINDS:
        raise ValueError(f"unknown update kind {kind!r}")
    if kind == "heatbath" and int(k_trials) < 1:
        raise ValueError("k_trials must be >= 1")
    if kind == "metropolis" and int(n_hit) < 1:
        raise ValueError("n_hit must be >= 1")
    dev = core.check_device(*us)
    if count is not None:
        if kind == "overrelax":
            raise ValueError("an overrelaxation stage has nothing to count")
        if (count.dtype != torch.int64 or tuple(count.shape) != (1,)
                or count.device != us[0].device):
            raise ValueError("count must be an int64 tensor [1] on the "
                             "state's device")
    return n, dev


def _check_stream(us, dims, kind, gen, words, scalars):
    """Validate the stream arguments of a stage (dims: the extents the
    words cover, a shard's interior); returns the family."""
    if gen is None:
        if words is not None or scalars is not None:
            raise ValueError("stream words/scalars given without gen")
        return None
    fam = streams.family(gen)
    if kind == "overrelax":
        raise ValueError("an overrelaxation stage draws nothing: no gen")
    shape = (streams.stream_word_count(gen), dims[0], dims[1],
             dims[2] * (dims[3] // 2))
    dtype = streams.stream_word_dtype(gen)
    if (not isinstance(words, torch.Tensor) or words.dtype != dtype
            or tuple(words.shape) != shape or not words.is_contiguous()):
        raise ValueError(f"{gen} words: expected contiguous {dtype} {shape}")
    if words.device != us[0].device:
        raise ValueError(f"words on {words.device}, links on {us[0].device}")
    want = set(streams.kernel_scalar_names(gen))
    if set(scalars or {}) != want:
        raise ValueError(f"{gen} scalars: expected keys {sorted(want)}")
    return fam


def _stage_plain(us, mu, parity, beta, dims, k_trials, kind, n_hit,
                 metro_delta, count, draw, shard=None):
    """The plain stage on the uniforms ``draw(m)`` returns (m tensors over
    the active sites, slot order); updates us[2*mu + parity] in place (on
    a shard: its interior)."""
    n = us[0].shape[1]
    dims = tuple(dims)
    ld = core.LinkLoader(us, parity, dims, n, shard)
    u_mu, w = staple_W(ld, mu)
    sgs = SUBGROUPS[n]
    per = uniforms_per_subgroup(kind, k_trials, n_hit)
    per_slots = (per + 1) // 2
    if per:
        u_all = draw(2 * per_slots * len(sgs))
    tbn = two_beta_over_n(beta, n)
    track = count is not None
    for s, (i, j) in enumerate(sgs):
        q_w = quat_from_block(w, i, j)
        u_s = [u_all[2 * per_slots * s + c] for c in range(per)]
        if kind == "heatbath":
            flip = heatbath_flip(q_w, tbn, u_s, k_trials, with_count=track)
        elif kind == "metropolis":
            flip = metropolis_flip(q_w, tbn, u_s, n_hit, metro_delta,
                                   with_count=track)
        else:
            flip = overrelax_flip(q_w)
        if track:
            flip, c = flip
            count += c
        u_mu = subgroup_left_mul(flip, i, j, u_mu)
        w = subgroup_left_mul(flip, i, j, w)
    target = us[2 * mu + parity]
    core.store_rows(target, u_mu, n, core.interior_slots(shard, us[0].device))
    return target


def stream_draw_count(kind, k_trials, n_hit, n):
    """Draws one stream stage consumes per site: the per-subgroup count
    rounded up to whole pairs, times the subgroups (reference
    ops/pallas/update.py stage_draw_count)."""
    per = uniforms_per_subgroup(kind, k_trials, n_hit)
    return 2 * ((per + 1) // 2) * len(SUBGROUPS[n])


def stage_update_ref(us, mu, parity, beta, key2, dims, k_trials=4,
                     kind="heatbath", n_hit=3, metro_delta=0.35, count=None, *,
                     gen=None, words=None, scalars=None, shard=None):
    """Plain PyTorch stage with stage_update's arguments: updates
    us[2*mu + parity] in place and returns it, adds the tracked count to
    ``count`` when given, and with ``gen`` advances ``words`` and the dict
    ``scalars`` in place, as the kernel does.  Any device."""
    shard = core.padded_or_none(shard)
    n, _ = _check(us, mu, parity, dims, kind, k_trials, n_hit, count, shard)
    ext = dims if shard is None else shard.interior
    if _check_stream(us, ext, kind, gen, words, scalars) is None:
        sidx = core.site_index_packed(parity, tuple(dims), us[0].device,
                                      shard).reshape(-1)
        return _stage_plain(us, mu, parity, beta, dims, k_trials, kind,
                            n_hit, metro_delta, count,
                            lambda m: rng.site_uniforms(key2, sidx, m), shard)
    flat = words.reshape(words.shape[0], -1)

    def draw(m):
        return [streams.open01(u)
                for u in streams.draw_words(gen, flat, m, scalars)]

    target = _stage_plain(us, mu, parity, beta, dims, k_trials, kind, n_hit,
                          metro_delta, count, draw, shard)
    scalars.update(streams.advance_kernel_scalars(
        gen, scalars, stream_draw_count(kind, k_trials, n_hit, n)))
    return target


def stage_update(us, mu, parity, beta, key2, dims, k_trials=4,
                 kind="heatbath", n_hit=3, metro_delta=0.35, count=None, *,
                 gen=None, words=None, scalars=None, shard=None):
    """One stage of ``kind`` on the packed 8-tuple, in place on
    us[2*mu + parity] (returned).  key2: the (k0, k1) stage key as ints
    (rng.stage_key; unused by overrelaxation and streams).  count: optional
    int64 [1] tensor the stage adds its tracked count to.

    With ``gen`` (a PRNGCL generator name) the stage draws from ``words``,
    the active parity's stream words, and advances them and the dict
    ``scalars`` in place.  With ``shard`` (a ``core.Shard``) us and words
    are that shard's (K1a; a shard without halo is the whole lattice:
    K1).  CPU tensors take the plain version, CUDA tensors the kernel."""
    shard = core.padded_or_none(shard)
    n, dev = _check(us, mu, parity, dims, kind, k_trials, n_hit, count,
                    shard)
    fam = _check_stream(us, dims if shard is None else shard.interior, kind,
                        gen, words, scalars)
    if dev == "cpu":
        return stage_update_ref(us, mu, parity, beta, key2, dims, k_trials,
                                kind, n_hit, metro_delta, count, gen=gen,
                                words=words, scalars=scalars, shard=shard)
    track = count is not None
    name = instance_name(kind, n, track, gen, shard is not None)
    lib = build.library()
    geom = (tuple(int(d) for d in dims) if shard is None
            else shard.kernel_args())
    common = (n, KINDS.index(kind), int(track), int(mu), int(parity), *geom)
    tail = (two_beta_over_n(beta, n), int(k_trials), int(n_hit),
            fm.f32(metro_delta), None if count is None else count.data_ptr(),
            build.stream_handle(us[0].device))
    with torch.cuda.device(us[0].device):
        if fam is None:
            entry = lib.qg_stage if shard is None else lib.qg_stage_shard
            err = entry(*[a.data_ptr() for a in us], *common,
                        int(key2[0]), int(key2[1]), *tail)
        else:
            s0, ptr0 = streams.encode_kernel_scalars(gen, scalars)
            skip = (streams.ranlux_skip_len(gen) if fam == "ranlux" else 0)
            entry = (lib.qg_stage_stream if shard is None
                     else lib.qg_stage_stream_shard)
            err = entry(
                *[a.data_ptr() for a in us], *common,
                streams.FAMILIES.index(fam), words.data_ptr(),
                words[0].numel(), s0, ptr0, skip, *tail)
    build.check(err, name)
    LAUNCHES[name] += 1
    if fam is not None:
        scalars.update(streams.advance_kernel_scalars(
            gen, scalars, stream_draw_count(kind, k_trials, n_hit, n)))
    return us[2 * mu + parity]
