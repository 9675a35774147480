"""The plain reference that decides ``correct``: sweeps and measurements of
the packed SU(N) link field, in plain PyTorch, over a leading chain axis.

Frozen copies of qcdgpu_tpu_torch's plain versions, which its tests hold
against the JAX package bit for bit, with a chain axis added so that a
beta scan's chains run as one batch:

- ``ops/rng.py``: threefry2x32 (int32 form), Philox-4x32-10, the keys and
  the per-site uniforms;
- ``ops/fastmath.py``: ``log_u01``, ``cos2_2pi``, ``sincos_2pi``;
- ``ops/cuda/core.py``: complex pairs, nested-tuple matrices, the packed
  addressing;
- ``ops/cuda/update.py``: the staple sum and the heat-bath,
  overrelaxation and Metropolis flips, with their tracked counts;
- ``ops/cuda/reunit.py``: the plain reunitarization;
- ``ops/cuda/measure.py``: the plane sums; ``ops/cuda/engine.py``: the
  stage schedule, the reunitarization rule and ``obs_base_from_sums``.

The Polyakov loop is the plain product U_T(t=0) ... U_T(t=T-1) of each
spatial column, not K4's association.  Nothing here imports the program.

Packed layout: one f32 array per (direction mu, parity p), ``us[2*mu +
p]`` of shape ``[C, 2, N, 2, X, Y, Z*T/2]``: chain, stored matrix row (SU(3)
row 2 = conj(row0 x row1) is rebuilt on load), column, re/im, sites.  The
array of parity p holds the links at sites with (x+y+z+t) % 2 == p, at
slot ((x*Y + y)*Z + z)*(T/2) + t//2.

``lowp=True`` is the control: every tensor the reference keeps (the links
after each stage and each reunitarization, the tracked rate, the
observable rows) is rounded to bfloat16, the arithmetic between them runs
in float32.
"""

from __future__ import annotations

import numpy as np
import torch

NDIM = 4
SUBGROUPS = {2: ((0, 1),), 3: ((0, 1), (0, 2), (1, 2))}
PLANES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))

# ---------------------------------------------------------------------------
# random numbers (ops/rng.py)
# ---------------------------------------------------------------------------

_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF
_INV_2_24 = 1.0 / (1 << 24)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """20-round Threefry-2x32 on ints (or int64 tensors) of u32 values."""
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    inject = 0
    for r in range(20):
        x0 = (x0 + x1) & _M32
        x1 = _rotl(x1, _ROT[r % 8])
        x1 = x1 ^ x0
        if (r + 1) % 4 == 0:
            inject += 1
            x0 = (x0 + ks[inject % 3]) & _M32
            x1 = (x1 + ks[(inject + 1) % 3] + inject) & _M32
    return x0, x1


def make_base_key(seed: int):
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return threefry2x32(s & _M32, s >> 32, 0x243F6A88, 0x85A308D3)


def stage_key(base_key, sweep_idx: int, stage_id: int):
    return threefry2x32(int(base_key[0]) & _M32, int(base_key[1]) & _M32,
                        int(sweep_idx) & _M32, int(stage_id) & _M32)


def _i32(v):
    """u32 values in an int64 tensor -> the same bits as int32."""
    if v.dtype == torch.int32:
        return v
    return torch.where(v > 0x7FFFFFFF, v - (1 << 32), v).to(torch.int32)


def _rotl32(x, r):
    return (x << r) | ((x >> (32 - r)) & ((1 << r) - 1))


def threefry2x32_i32(k0, k1, x0, x1):
    """threefry2x32 on int32 tensors holding u32 bits; keys int64 tensors
    of u32 values that broadcast with the counters."""
    ks = [_i32(k) for k in (k0, k1, k0 ^ k1 ^ _PARITY)]
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    inject = 0
    for r in range(20):
        x0 = x0 + x1
        x1 = _rotl32(x1, _ROT[r % 8]) ^ x0
        if (r + 1) % 4 == 0:
            inject += 1
            x0 = x0 + ks[inject % 3]
            x1 = x1 + _i32(ks[(inject + 1) % 3] + inject)
    return x0, x1


def _mulhilo(m, x):
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _M32
    hi = ((p_hi + (p_lo >> 16)) >> 16) & _M32
    return hi, lo


def philox4x32(k0, k1, c0, c1, c2, c3):
    """10-round Philox-4x32 on int64 tensors (or ints) of u32 values."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _M32
            k1 = (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def bits_to_uniform(bits):
    """u32 bits (int64, or int32) -> f32 in (0, 1) on the 24-bit grid."""
    h = bits >> 8
    if bits.dtype == torch.int32:
        h = h & 0xFFFFFF
    return (h.to(torch.float32) + 0.5) * _INV_2_24


def site_uniforms(keys, site_idx, n, rng_mode):
    """f32 [n, C, S]: n uniforms for each chain's sites.  keys: int64 [C,
    2] stage keys (u32 values); site_idx: int64 [S] global dense indices.
    threefry: pair p from counter (site, p); "hw": uniforms 4b .. 4b+3 are
    the words of philox4x32(key, (site, b, 0, 0))."""
    k0, k1 = keys[:, 0:1], keys[:, 1:2]
    sidx = site_idx[None]
    if rng_mode == "hw":
        nblk = (n + 3) // 4
        blk = torch.arange(nblk, dtype=torch.int64,
                           device=site_idx.device).reshape(nblk, 1, 1)
        words = philox4x32(k0, k1, sidx, blk, 0, 0)
        u = torch.stack([bits_to_uniform(w) for w in words], dim=1)
        return u.reshape((4 * nblk,) + tuple(u.shape[2:]))[:n]
    npairs = (n + 1) // 2
    slots = torch.arange(npairs, dtype=torch.int32,
                         device=site_idx.device).reshape(npairs, 1, 1)
    b0, b1 = threefry2x32_i32(k0, k1, sidx.to(torch.int32), slots)
    u = torch.stack([bits_to_uniform(b0), bits_to_uniform(b1)], dim=1)
    return u.reshape((2 * npairs,) + tuple(b0.shape[1:]))[:n]


# ---------------------------------------------------------------------------
# polynomial transcendentals (ops/fastmath.py)
# ---------------------------------------------------------------------------


def f32(c) -> float:
    return float(np.float32(c))


_LOG_COEF = tuple(f32(c) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
))
_COS_COEF = tuple(f32(c) for c in (
    -26.426256783374378, 60.24464137187666, -85.45681720669372,
    64.93939402266829, -19.739208802178716, 1.0,
))
_SIN_COEF = tuple(f32(c) for c in (
    3.8199525848482803, -15.094642576822984, 42.058693944897634,
    -76.70585975306136, 81.60524927607504, -41.341702240399755,
    6.283185307179586,
))
_SQRT2 = f32(1.41421356)
_LN2_LO = f32(-2.12194440e-4)
_LN2_HI = f32(0.693359375)


def log_u01(x):
    bits = x.view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    m = ((bits & 0x007FFFFF) | 0x3F800000).view(torch.float32)
    big = m > _SQRT2
    m = torch.where(big, 0.5 * m, m)
    e = torch.where(big, e + 1, e).to(torch.float32)
    t = m - 1.0
    z = t * t
    p = torch.full_like(t, _LOG_COEF[0])
    for c in _LOG_COEF[1:]:
        p = p * t + c
    y = t * z * p - 0.5 * z + e * _LN2_LO
    return t + y + e * _LN2_HI


def _poly_s(coef, s):
    p = torch.full_like(s, coef[0])
    for c in coef[1:]:
        p = p * s + c
    return p


def cos2_2pi(r):
    k = torch.round(2.0 * r)
    f = r - 0.5 * k
    p = _poly_s(_COS_COEF, f * f)
    return p * p


def sincos_2pi(r):
    k = torch.round(2.0 * r)
    f = r - 0.5 * k
    sign = 1.0 - 2.0 * (k - 2.0 * torch.floor(k * 0.5))
    s = f * f
    return sign * f * _poly_s(_SIN_COEF, s), sign * _poly_s(_COS_COEF, s)


# ---------------------------------------------------------------------------
# complex pairs and nested-tuple matrices (ops/cuda/core.py)
# ---------------------------------------------------------------------------


def cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def cmul_conj(a, b):
    return (a[0] * b[0] + a[1] * b[1], a[1] * b[0] - a[0] * b[1])


def cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def conj(a):
    return (a[0], -a[1])


def mmul(a, b):
    n, kk, m = len(a), len(b), len(b[0])
    out = []
    for i in range(n):
        row = []
        for k in range(m):
            acc = cmul(a[i][0], b[0][k])
            for j in range(1, kk):
                acc = cadd(acc, cmul(a[i][j], b[j][k]))
            row.append(acc)
        out.append(tuple(row))
    return tuple(out)


def mmul_bdag(a, b):
    n, kk, m = len(a), len(a[0]), len(b)
    out = []
    for i in range(n):
        row = []
        for k in range(m):
            acc = cmul_conj(a[i][0], b[k][0])
            for j in range(1, kk):
                acc = cadd(acc, cmul_conj(a[i][j], b[k][j]))
            row.append(acc)
        out.append(tuple(row))
    return tuple(out)


def mdag(a):
    n = len(a)
    return tuple(tuple(conj(a[j][i]) for j in range(n)) for i in range(n))


def madd(a, b):
    return tuple(tuple(cadd(a[i][j], b[i][j]) for j in range(len(a[0])))
                 for i in range(len(a)))


def codec_rows(rows, n):
    """Two stored rows -> the full N x N matrix."""
    if n == 2:
        return (tuple(rows[0]), tuple(rows[1]))
    r0, r1 = rows

    def r2k(k):
        a = cmul(r0[(k + 1) % 3], r1[(k + 2) % 3])
        b = cmul(r0[(k + 2) % 3], r1[(k + 1) % 3])
        return conj((a[0] - b[0], a[1] - b[1]))

    return (r0, r1, tuple(r2k(k) for k in range(3)))


# ---------------------------------------------------------------------------
# packed addressing
# ---------------------------------------------------------------------------


def packed_coords(parity, dims, device):
    """(x, y, z, t) int64 [X*Y*Z*T/2] of the slots of one parity."""
    x_dim, y_dim, z_dim, t_dim = dims
    t2 = t_dim // 2
    s = torch.arange(x_dim * y_dim * z_dim * t2, dtype=torch.int64,
                     device=device)
    k = s % t2
    z = (s // t2) % z_dim
    y = (s // (t2 * z_dim)) % y_dim
    x = s // (t2 * z_dim * y_dim)
    t = 2 * k + (parity + x + y + z) % 2
    return x, y, z, t


def packed_slot(x, y, z, t, dims):
    _, y_dim, z_dim, t_dim = dims
    return ((x * y_dim + y) * z_dim + z) * (t_dim // 2) + t // 2


def load_mat(arr, n, idx=None):
    """[C, 2, N, 2, X, Y, ZT2] -> N x N matrix of (re, im) [C, S] tensors
    at the slots ``idx`` (all slots when None)."""
    comps = arr.reshape(arr.shape[0], 2, n, 2, -1)
    if idx is not None:
        comps = comps.index_select(4, idx)
    rows = [tuple((comps[:, r, j, 0], comps[:, r, j, 1]) for j in range(n))
            for r in range(2)]
    return codec_rows(rows, n)


def store_rows(arr, m, n):
    """Write rows 0, 1 of matrix m into packed array arr (every slot)."""
    out = torch.stack([
        torch.stack([torch.stack([m[r][j][0], m[r][j][1]]) for j in range(n)])
        for r in range(2)
    ])  # [2, N, 2, C, S]
    arr.copy_(out.movedim(3, 0).reshape(arr.shape))


# ---------------------------------------------------------------------------
# quaternions and the flips (ops/cuda/update.py)
# ---------------------------------------------------------------------------


def uniforms_per_subgroup(kind, k_trials, n_hit):
    """Uniforms one subgroup touch consumes: 4K + 2 for the heat-bath, 4 a
    Metropolis hit, none for overrelaxation."""
    if kind == "heatbath":
        return 4 * k_trials + 2
    if kind == "metropolis":
        return 4 * n_hit
    return 0


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
    ident = (1.0, 0.0, 0.0, 0.0)
    return tuple(torch.where(good, q[c], torch.full_like(q[c], ident[c]))
                 for c in range(4))


def subgroup_left_mul(q, i, j, m):
    """m <- embed(M(q); i, j) @ m."""
    u00 = (q[0], q[3])
    u01 = (q[2], q[1])
    u10 = (-q[2], q[1])
    u11 = (q[0], -q[3])
    rows = [list(r) for r in m]
    for k in range(len(m[0])):
        mi, mj = m[i][k], m[j][k]
        rows[i][k] = cadd(cmul(u00, mi), cmul(u01, mj))
        rows[j][k] = cadd(cmul(u10, mi), cmul(u11, mj))
    return tuple(tuple(r) for r in rows)


def heatbath_flip(q_w, tbn, u, k_trials):
    """Kennedy-Pendleton multiplier, fixed k_trials masked trials, first
    accepted wins, identity on exhaustion; and the exhausted sites per
    chain (int64 [C])."""
    n2 = q_w[0] * q_w[0] + q_w[1] * q_w[1] + q_w[2] * q_w[2] + q_w[3] * q_w[3]
    rk = 1.0 / torch.sqrt(torch.clamp(n2, min=f32(1e-38)))
    k = n2 * rk
    v = tuple(c * rk for c in q_w)
    a = tbn * k
    inv2a = 1.0 / (2.0 * torch.clamp(a, min=f32(1e-10)))
    lam2_sel = ok = None
    for t in range(k_trials):
        r1, r2, r3, r4 = u[4 * t], u[4 * t + 1], u[4 * t + 2], u[4 * t + 3]
        c2 = cos2_2pi(r2)
        lam2 = -inv2a * (log_u01(r1) + c2 * log_u01(r3))
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
    sph, cph = sincos_2pi(u[4 * k_trials + 1])
    w = (x0, rho * st * cph, rho * st * sph, rho * ct)
    out = _where_ident(ok & (k > f32(1e-30)), quat_mul(w, quat_conj(v)))
    return out, (~ok).sum(dim=-1, dtype=torch.int64)


def overrelax_flip(q_w):
    n2 = q_w[0] * q_w[0] + q_w[1] * q_w[1] + q_w[2] * q_w[2] + q_w[3] * q_w[3]
    qc = quat_conj(q_w)
    inv = 1.0 / torch.clamp(n2, min=f32(1e-38))
    u = tuple(c * inv for c in quat_mul(qc, qc))
    return _where_ident(n2 > f32(1e-38), u), None


def metropolis_flip(q_w, tbn, uu, n_hit, delta):
    """n_hit Metropolis hits; the composed multiplier and the accepted hits
    per chain (int64 [C])."""
    d = f32(delta)
    acc_u = tuple(torch.full_like(q_w[0], c) for c in (1.0, 0.0, 0.0, 0.0))
    q_cur = q_w
    n_acc = 0
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
        accept = log_u01(u[3]) < dlp
        n_acc = n_acc + accept.sum(dim=-1, dtype=torch.int64)
        w_eff = _where_ident(accept, w)
        acc_u = quat_mul(w_eff, acc_u)
        q_cur = quat_mul(w_eff, q_cur)
    return acc_u, n_acc


def reunit_array(s, n):
    """Project one packed array [C, 2, N, 2, ...] onto SU(N), in place."""
    comps = s.reshape(s.shape[0], 2, n, 2, -1)

    def norm_row(r):
        acc = None
        for c in r:
            t = c[0] * c[0] + c[1] * c[1]
            acc = t if acc is None else acc + t
        inv = 1.0 / torch.sqrt(acc)
        return tuple((c[0] * inv, c[1] * inv) for c in r)

    if n == 2:
        m = comps
        a0 = 0.5 * (m[:, 0, 0, 0] + m[:, 1, 1, 0])
        a1 = 0.5 * (m[:, 0, 1, 1] + m[:, 1, 0, 1])
        a2 = 0.5 * (m[:, 0, 1, 0] - m[:, 1, 0, 0])
        a3 = 0.5 * (m[:, 0, 0, 1] - m[:, 1, 1, 1])
        inv = 1.0 / torch.sqrt(a0 * a0 + a1 * a1 + a2 * a2 + a3 * a3)
        a0, a1, a2, a3 = a0 * inv, a1 * inv, a2 * inv, a3 * inv
        store_rows(s, (((a0, a3), (a2, a1)), ((-a2, a1), (a0, -a3))), 2)
        return s
    m = [tuple((comps[:, r, j, 0], comps[:, r, j, 1]) for j in range(3))
         for r in range(2)]
    r0 = norm_row(m[0])
    ip = None
    for c0, c1 in zip(r0, m[1]):
        t = cmul_conj(c1, c0)
        ip = t if ip is None else cadd(ip, t)
    r1 = tuple(
        (c1[0] - (ip[0] * c0[0] - ip[1] * c0[1]),
         c1[1] - (ip[0] * c0[1] + ip[1] * c0[0]))
        for c0, c1 in zip(r0, m[1])
    )
    store_rows(s, (r0, norm_row(r1)), 3)
    return s


# ---------------------------------------------------------------------------
# the sweep and the measurement
# ---------------------------------------------------------------------------


class Reference:
    """Sweeps and measures chain-stacked packed states.

    params: the run's SimConfig fields (group, dims, algorithm, n_or,
    kp_trials, n_hit, metro_delta, reunit_every, rng_mode,
    track_kp_exhaust, track_acceptance).  betas: one per chain; seeds: the
    chains' seeds (a scan's chain c has cfg.seed + 1000 c)."""

    def __init__(self, params, betas, seeds, device, lowp=False):
        self.p = dict(params)
        self.n = int(self.p["group"])
        self.dims = tuple(int(d) for d in self.p["dims"])
        self.device = torch.device(device)
        self.lowp = lowp
        self.base_keys = [make_base_key(s) for s in seeds]
        self.betas = torch.tensor(np.asarray(betas, np.float32),
                                  device=self.device).reshape(-1, 1)
        self.c = len(self.base_keys)
        if self.betas.shape[0] != self.c:
            raise ValueError("one beta per chain")
        self.tbn = self.betas * f32(2.0 / self.n)
        self._slots = {}
        self._sidx = {}
        tracked = self.p.get("track_kp_exhaust") or self.p.get(
            "track_acceptance")
        self.track_kind = (None if not tracked else "heatbath"
                           if self.p.get("track_kp_exhaust") else "metropolis")

    # -- helpers ----------------------------------------------------------
    def q(self, x):
        """The stored precision: x itself, or bfloat16-rounded (control)."""
        return x.to(torch.bfloat16).to(x.dtype) if self.lowp else x

    def schedule(self):
        """(kind, parity, mu, stage_id) of one sweep, in order."""
        kinds = [self.p["algorithm"]] + ["overrelax"] * int(self.p["n_or"])
        return [(kind, parity, mu, 8 * i + 4 * parity + mu)
                for i, kind in enumerate(kinds) for parity in (0, 1)
                for mu in range(NDIM)]

    def reunit_due(self, sweep_idx):
        r = int(self.p["reunit_every"])
        return r > 0 and sweep_idx % r == r - 1

    def neighbor(self, parity, shifts):
        key = (parity, shifts)
        if key not in self._slots:
            c = list(packed_coords(parity, self.dims, self.device))
            for ax, d in shifts:
                c[ax] = (c[ax] + d) % self.dims[ax]
            self._slots[key] = packed_slot(*c, self.dims)
        return self._slots[key]

    def site_index(self, parity):
        if parity not in self._sidx:
            x, y, z, t = packed_coords(parity, self.dims, self.device)
            _, y_dim, z_dim, t_dim = self.dims
            self._sidx[parity] = ((x * y_dim + y) * z_dim + z) * t_dim + t
        return self._sidx[parity]

    def cold_start(self):
        """Unit links on every chain."""
        n, (x, y, z, t) = self.n, self.dims
        a = torch.zeros((self.c, 2, n, 2, x, y, z * (t // 2)),
                        dtype=torch.float32, device=self.device)
        for r in range(2):
            a[:, r, r, 0] = 1.0
        return tuple(a.clone() for _ in range(2 * NDIM))

    def adopt(self, us):
        """A copy of a chain-stacked 8-tuple, in the stored precision."""
        return tuple(self.q(a.to(self.device, torch.float32).clone())
                     for a in us)

    # -- one stage --------------------------------------------------------
    def stage(self, us, kind, parity, mu, keys):
        """One checkerboard stage in place; the tracked count per chain
        (int64 [C]) or None."""
        n = self.n
        cache = {}

        def U(d, shifts=()):
            if (d, shifts) not in cache:
                par = (parity + len(shifts)) % 2
                idx = self.neighbor(parity, shifts) if shifts else None
                cache[(d, shifts)] = load_mat(us[2 * d + par], n, idx)
            return cache[(d, shifts)]

        acc = None
        for nu in range(NDIM):
            if nu == mu:
                continue
            inner = mmul(U(nu), U(mu, ((nu, 1),)))
            fwd = mmul_bdag(U(nu, ((mu, 1),)), inner)
            s2 = U(nu, ((mu, 1), (nu, -1)))
            bwd = mmul(mdag(mmul(U(mu, ((nu, -1),)), s2)), U(nu, ((nu, -1),)))
            term = madd(fwd, bwd)
            acc = term if acc is None else madd(acc, term)
        u_mu = U(mu)
        w = mmul(u_mu, acc)
        sgs = SUBGROUPS[n]
        kt, nh = int(self.p["kp_trials"]), int(self.p["n_hit"])
        per = uniforms_per_subgroup(kind, kt, nh)
        per_slots = (per + 1) // 2
        if per:
            u_all = site_uniforms(keys, self.site_index(parity),
                                  2 * per_slots * len(sgs),
                                  self.p["rng_mode"])
        total = None
        for s, (i, j) in enumerate(sgs):
            q_w = quat_from_block(w, i, j)
            if kind == "heatbath":
                u_s = [u_all[2 * per_slots * s + c] for c in range(per)]
                flip, cnt = heatbath_flip(q_w, self.tbn, u_s, kt)
            elif kind == "metropolis":
                u_s = [u_all[2 * per_slots * s + c] for c in range(per)]
                flip, cnt = metropolis_flip(q_w, self.tbn, u_s, nh,
                                            self.p["metro_delta"])
            else:
                flip, cnt = overrelax_flip(q_w)
            if kind == self.track_kind:
                total = cnt if total is None else total + cnt
            u_mu = subgroup_left_mul(flip, i, j, u_mu)
            w = subgroup_left_mul(flip, i, j, w)
        target = us[2 * mu + parity]
        store_rows(target, u_mu, n)
        target.copy_(self.q(target))
        return total

    def tracked_denom(self):
        vol2 = int(np.prod(self.dims)) // 2
        n_sg = len(SUBGROUPS[self.n])
        algo = self.p["algorithm"]
        if self.p.get("track_kp_exhaust"):
            stages = 8 if algo == "heatbath" else 0
            return float(np.float32(max(stages * vol2 * n_sg, 1)))
        stages = 8 if algo == "metropolis" else 0
        return float(np.float32(max(stages * vol2 * int(self.p["n_hit"])
                                    * n_sg, 1)))

    def sweep(self, us, sweep_idx):
        """One sweep in place; the tracked rate per chain (f32 [C]) or
        None."""
        counts = None
        for kind, parity, mu, stage_id in self.schedule():
            keys = None
            if kind != "overrelax":
                keys = torch.tensor(
                    [stage_key(k, sweep_idx, stage_id)
                     for k in self.base_keys], dtype=torch.int64,
                    device=self.device)
            cnt = self.stage(us, kind, parity, mu, keys)
            if cnt is not None:
                counts = cnt if counts is None else counts + cnt
        if self.reunit_due(sweep_idx):
            for a in us:
                reunit_array(a, self.n)
                a.copy_(self.q(a))
        if self.track_kind is None:
            return None
        if counts is None:
            counts = torch.zeros(self.c, dtype=torch.int64,
                                 device=self.device)
        return self.q(counts.to(torch.float32) / self.tracked_denom())

    # -- measurement ------------------------------------------------------
    def plane_sums(self, us):
        """f64 [C, 6]: per chain, the sum over all sites of Re tr P for
        each plane."""
        n = self.n
        sums = torch.zeros((self.c, 6), dtype=torch.float64,
                           device=self.device)
        for p in (0, 1):
            def U(d, shifts=()):
                par = (p + len(shifts)) % 2
                idx = self.neighbor(p, shifts) if shifts else None
                return load_mat(us[2 * d + par], n, idx)

            for k, (mu, nu) in enumerate(PLANES):
                a = mmul(U(mu), U(nu, ((mu, 1),)))
                b = mmul(U(nu), U(mu, ((nu, 1),)))
                tr = None
                for r in range(n):
                    for c in range(n):
                        t = a[r][c][0] * b[r][c][0] + a[r][c][1] * b[r][c][1]
                        tr = t if tr is None else tr + t
                sums[:, k] += tr.to(torch.float64).sum(dim=-1)
        return sums

    def polyakov_sums(self, us):
        """f64 [C, 2]: per chain, (sum re, sum im) over spatial sites of tr
        U_T(t=0) U_T(1) ... U_T(T-1)."""
        n = self.n
        x_dim, y_dim, z_dim, t_dim = self.dims
        col = torch.arange(x_dim * y_dim * z_dim, dtype=torch.int64,
                           device=self.device)
        z = col % z_dim
        y = (col // z_dim) % y_dim
        x = col // (z_dim * y_dim)
        prod = None
        for t in range(t_dim):
            par = (x + y + z + t) % 2
            slot = packed_slot(x, y, z, torch.full_like(x, t), self.dims)
            m0 = load_mat(us[6], n, slot)
            m1 = load_mat(us[7], n, slot)
            m = tuple(tuple((torch.where(par == 0, a[0], b[0]),
                             torch.where(par == 0, a[1], b[1]))
                            for a, b in zip(r0, r1))
                      for r0, r1 in zip(m0, m1))
            prod = m if prod is None else mmul(prod, m)
        re, im = prod[0][0]
        for r in range(1, n):
            re = re + prod[r][r][0]
            im = im + prod[r][r][1]
        return torch.stack([re.to(torch.float64).sum(-1),
                            im.to(torch.float64).sum(-1)], dim=-1)

    def measure(self, us):
        """The standard observable rows, f32 [C, 6]: plq, plq_s, plq_t,
        action, poly_re, poly_im."""
        sums, poly = self.plane_sums(us), self.polyakov_sums(us)
        vol = int(np.prod(self.dims))
        s = sums / (self.n * vol)
        plq_s = (s[..., 0] + s[..., 1] + s[..., 3]) / 3.0
        plq_t = (s[..., 2] + s[..., 4] + s[..., 5]) / 3.0
        plq = 0.5 * (plq_s + plq_t)
        pl = poly / (self.n * (vol // self.dims[3]))
        rows = torch.stack([plq, plq_s, plq_t, 1.0 - plq, pl[..., 0],
                            pl[..., 1]], dim=-1).to(torch.float32)
        return self.q(rows)

    def run(self, us, sweep0, n_sweeps, measure_every):
        """n_sweeps sweeps in place from sweep index sweep0, a row every
        measure_every sweeps (the tracked block mean appended): f32
        [n_sweeps // measure_every, C, n_obs] on the host."""
        me = int(measure_every or 0)
        rows = []
        acc = None
        for i in range(n_sweeps):
            rate = self.sweep(us, sweep0 + i)
            if me and rate is not None:
                acc = rate if acc is None else acc + rate
            if me and (i + 1) % me == 0:
                row = self.measure(us)
                if rate is not None:
                    row = torch.cat([row, self.q(acc / me)[:, None]], dim=1)
                    acc = None
                rows.append(row)
        if not rows:
            return np.zeros((0, self.c, 0), np.float32)
        return torch.stack(rows).cpu().numpy()
