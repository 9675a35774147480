"""Observable names and the extended observables on the dense field.

Port of qcdgpu_tpu/ops/measure.py.  Observable vector layout:
  plq      — mean plaquette (1/N) Re tr P, averaged over all 6 planes
  plq_s    — spatial planes only (xy, xz, yz)
  plq_t    — temporal planes only (xt, yt, zt)
  action   — Wilson action density S / (beta * 6 * V) = 1 - plq
  poly_re  — Re of the volume-averaged Polyakov loop (1/N normalized)
  poly_im  — Im of the same
then, as the configuration asks for them (``measure_obs_names``):
  f{a}_{plane}_{re,im} — cfg.get_fmunu: the volume-averaged tr(T_a P_munu)
                 for each selected colour generator T_a (Pauli / Gell-Mann,
                 QCDGPU's Fmunu_index1/2; default the Cartan ones) and
                 plane, whose imaginary part is the naive field strength:
                 spatial planes QCDGPU's Fmunu, temporal ones its F0mu;
  wloop_{R}x{T} — cfg.wilson_loops: rectangular Wilson loops, R along each
                 spatial direction and T along time, plane-averaged, so
                 W(1, 1) = plq_t;
  q_top        — cfg.get_qtop: the clover topological charge Q_L, after
                 cfg.qtop_smear APE steps of weight cfg.qtop_alpha
                 (ops/smear.py).

The series row of obs_names() may end with one engine-accumulated column:
``acc_rate`` (track_acceptance) or ``kp_exhaust_rate`` (track_kp_exhaust).

On the packed engine the standard six come from its kernels (ops/cuda/
measure.py); on the dense engine (dense.py) from ``measure_all`` here,
the reference's dense measurement (measure.py:265-357), on the complex64
or complex128 field, and ``make_measure_fn`` evaluates them in complex128
when cfg.meas_dtype is "double" (the reference's measure.py:397-427).  On
a dense mesh the shards are measured without gathering the field, from
``plane_sums`` over each interior and ``polyakov_product`` of each
shard's temporal links (dense_sharded.py).  The
extended columns are what the reference computes with XLA ops on the
complex field (ops/pallas/engine.py:398-420): here PyTorch ops on the
field [4, N, N, X, Y, Z, T] (``measure_extended``), with the reference's
f32 sums, dtypes and order of terms.
"""

from __future__ import annotations

import numpy as np
import torch

from .lattice import shift, shift2
from .smear import ape_smear
from .sun import dagger, mul, retrace, trace

OBS_NAMES = ("plq", "plq_s", "plq_t", "action", "poly_re", "poly_im")
TIME_AXIS = 3  # mu index of the temporal direction

PLANES = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
PLANE_NAMES = ("xy", "xz", "xt", "yz", "yt", "zt")

# SU(2) Pauli matrices sigma_1..3 (generator index a = 1..3)
_PAULI = np.array(
    [
        [[0, 1], [1, 0]],
        [[0, -1j], [1j, 0]],
        [[1, 0], [0, -1]],
    ],
    dtype=np.complex128,
)

# SU(3) Gell-Mann matrices lambda_1..8 (generator index a = 1..8)
_S3 = 1.0 / np.sqrt(3.0)
_GELL_MANN = np.array(
    [
        [[0, 1, 0], [1, 0, 0], [0, 0, 0]],
        [[0, -1j, 0], [1j, 0, 0], [0, 0, 0]],
        [[1, 0, 0], [0, -1, 0], [0, 0, 0]],
        [[0, 0, 1], [0, 0, 0], [1, 0, 0]],
        [[0, 0, -1j], [0, 0, 0], [1j, 0, 0]],
        [[0, 0, 0], [0, 0, 1], [0, 1, 0]],
        [[0, 0, 0], [0, 0, -1j], [0, 1j, 0]],
        [[_S3, 0, 0], [0, _S3, 0], [0, 0, -2 * _S3]],
    ],
    dtype=np.complex128,
)


def generator(n: int, a: int) -> np.ndarray:
    """Hermitian group generator: Pauli sigma_a (N=2) / Gell-Mann lambda_a
    (N=3), 1-based index a in 1..N^2-1 (QCDGPU's Fmunu_index convention)."""
    table = _PAULI if n == 2 else _GELL_MANN
    if not 1 <= a <= n * n - 1:
        raise ValueError(f"generator index {a} out of range for SU({n})")
    return table[a - 1]


def default_fmunu_indices(n: int):
    """The Cartan (diagonal) generators — QCDGPU's default colour
    projection."""
    return (3, 8) if n == 3 else (3,)


def fmunu_obs_names(indices):
    return tuple(
        f"f{a}_{pl}_{c}" for a in indices for pl in PLANE_NAMES
        for c in ("re", "im")
    )


def plaquette_field(u, mu, nu):
    """Full plaquette matrix field P_{mu,nu}(x): [N, N, *site_dims]."""
    a = mul(u[mu], shift(u[nu], mu, +1))
    b = mul(u[nu], shift(u[mu], nu, +1))
    return mul(a, dagger(b))


def fmunu_means(u, indices):
    """Volume-averaged tr(T_a P_{mu,nu}) for each selected colour a and
    plane: f32 [2 * 6 * len(indices)], ordered [a-major, plane, (re, im)]
    as fmunu_obs_names(indices).  The contraction runs over the nonzero
    entries of T_a only."""
    n = u.shape[1]
    gens = [generator(n, a) for a in indices]
    out = [[] for _ in indices]
    for (mu, nu) in PLANES:
        p = plaquette_field(u, mu, nu)
        for gi, g in enumerate(gens):
            # tr(T_a P) = sum_{i,j} (T_a)_{ij} P_{ji}
            acc = 0.0
            for i in range(n):
                for j in range(n):
                    if g[i, j] != 0:
                        acc = acc + complex(g[i, j]) * p[j, i]
            tr_mean = torch.mean(acc)
            out[gi].append(torch.real(tr_mean).to(torch.float32))
            out[gi].append(torch.imag(tr_mean).to(torch.float32))
    return torch.stack([v for per_color in out for v in per_color])


# ---------------------------------------------------------------------------
# rectangular Wilson loops W(R, T)
# ---------------------------------------------------------------------------


def wilson_loop_obs_names(pairs):
    return tuple(f"wloop_{r}x{t}" for (r, t) in pairs)


def cfg_wilson_pairs(cfg):
    """The (R, T) extents requested by a SimConfig, as a tuple of tuples."""
    if cfg is None:
        return ()
    return tuple(tuple(p) for p in getattr(cfg, "wilson_loops", ()) or ())


def line_product(u_mu, mu, length):
    """Path-ordered product of ``length`` consecutive links along mu:
    L(x) = U_mu(x) U_mu(x+mu) ... U_mu(x+(length-1)mu)."""
    acc = u_mu
    for k in range(1, length):
        acc = mul(acc, shift(u_mu, mu, +k))
    return acc


def wilson_loop_means(u, pairs):
    """Volume- and plane-averaged rectangular Wilson loops, f32 [len(pairs)]:
    (1/N) Re tr of the R x T loop, averaged over sites and the three (i, t)
    planes, so W(1, 1) is the temporal mean plaquette.  Line products are
    memoized per (direction, length), each built from the next shorter."""
    n = u.shape[1]
    lines = {}

    def line(mu, length):
        if (mu, length) not in lines:
            if length == 1:
                lines[(mu, 1)] = u[mu]
            else:
                lines[(mu, length)] = mul(
                    line(mu, length - 1), shift(u[mu], mu, +(length - 1))
                )
        return lines[(mu, length)]

    out = []
    for (r, t) in pairs:
        pt = line(TIME_AXIS, t)
        acc = 0.0
        for mu in range(TIME_AXIS):
            pr = line(mu, r)
            top = shift(pt, mu, +r)          # temporal line at x + R mu
            left = shift(pr, TIME_AXIS, +t)  # spatial line at x + T t_hat
            w = retrace(mul(mul(pr, top), dagger(mul(pt, left))))
            acc = acc + torch.mean(w) / n
        out.append(acc / TIME_AXIS)
    return torch.stack([x.to(torch.float32) for x in out])


# ---------------------------------------------------------------------------
# topological charge Q_L from the clover-leaf field strength
# ---------------------------------------------------------------------------


def clover_leaf_sum(u, mu, nu):
    """Sum of the four counter-clockwise plaquette leaves through x in the
    (mu, nu) plane: [N, N, *site_dims].

      P1 = U_mu(x) U_nu(x+mu) U_mu^+(x+nu) U_nu^+(x)
      P2 = U_nu(x) U_mu^+(x-mu+nu) U_nu^+(x-mu) U_mu(x-mu)
      P3 = U_mu^+(x-mu) U_nu^+(x-mu-nu) U_mu(x-mu-nu) U_nu(x-nu)
      P4 = U_nu^+(x-nu) U_mu(x-nu) U_nu(x+mu-nu) U_mu^+(x)
    """
    um, un = u[mu], u[nu]
    um_m = shift(um, mu, -1)   # U_mu(x - mu)
    un_n = shift(un, nu, -1)   # U_nu(x - nu)
    p1 = mul(mul(um, shift(un, mu, +1)),
             dagger(mul(un, shift(um, nu, +1))))
    p2 = mul(mul(un, dagger(shift2(um, mu, -1, nu, +1))),
             mul(dagger(shift(un, mu, -1)), um_m))
    p3 = mul(mul(dagger(um_m), dagger(shift2(un, mu, -1, nu, -1))),
             mul(shift2(um, mu, -1, nu, -1), un_n))
    p4 = mul(mul(dagger(un_n), shift(um, nu, -1)),
             mul(shift2(un, mu, +1, nu, -1), dagger(um)))
    return p1 + p2 + p3 + p4


def field_strength_clover(u, mu, nu):
    """Anti-hermitian traceless clover field G_munu(x): [N, N, *site_dims],
    G = traceless[(C - C^+)/2] with C the four-leaf clover average."""
    n = u.shape[1]
    c = clover_leaf_sum(u, mu, nu)
    g = 0.125 * (c - dagger(c))
    tr = trace(g) / n
    eye = torch.eye(n, dtype=torch.complex64, device=u.device).reshape(
        (n, n) + (1,) * (g.ndim - 2))
    return g - tr[None, None] * eye


def topological_charge(u):
    """Clover topological charge Q_L, an f32 0-d tensor:

    Q_L = -(1/4 pi^2) sum_x [tr(G_01 G_23) - tr(G_02 G_13)
                             + tr(G_03 G_12)]    (G = i a^2 g F)."""
    n = u.shape[1]

    def trmul(a, b):
        # Re tr(a @ b) per site
        acc = 0.0
        for i in range(n):
            for j in range(n):
                acc = acc + torch.real(a[i, j]) * torch.real(b[j, i]) \
                    - torch.imag(a[i, j]) * torch.imag(b[j, i])
        return acc

    s = (trmul(field_strength_clover(u, 0, 1), field_strength_clover(u, 2, 3))
         - trmul(field_strength_clover(u, 0, 2), field_strength_clover(u, 1, 3))
         + trmul(field_strength_clover(u, 0, 3), field_strength_clover(u, 1, 2)))
    return -torch.sum(s) / float(np.float32(4.0 * np.pi * np.pi))


# ---------------------------------------------------------------------------
# the standard six on the dense field (the dense engine's measurement)
# ---------------------------------------------------------------------------


def plaquette_retrace(u, mu, nu):
    """Re tr P_{mu,nu}(x) field: [*site_dims]."""
    return retrace(plaquette_field(u, mu, nu))


def mean_plaquette(u):
    """(plq_total, plq_spatial, plq_temporal) as 0-d tensors in the
    field's real dtype."""
    n = u.shape[1]
    s_sum = 0.0
    t_sum = 0.0
    for mu in range(4):
        for nu in range(mu + 1, 4):
            p = torch.mean(plaquette_retrace(u, mu, nu)) / n
            if nu == TIME_AXIS:
                t_sum = t_sum + p
            else:
                s_sum = s_sum + p
    return (s_sum + t_sum) / 6.0, s_sum / 3.0, t_sum / 3.0


def polyakov_loop(u):
    """Volume-averaged Polyakov loop (re, im) of the full link field."""
    return polyakov_from_ut(u[TIME_AXIS])


def pairmul(a, b):
    """Matrix product of two matrices held as nested lists of [N][N]
    component tensors (the Polyakov recursion's form), the terms in the
    reference's order."""
    n = len(a)
    out = []
    for i in range(n):
        row = []
        for k in range(n):
            acc = a[i][0] * b[0][k]
            for j in range(1, n):
                acc = acc + a[i][j] * b[j][k]
            row.append(acc)
        out.append(row)
    return out


def polyakov_product(ut):
    """The ordered product over T of the temporal links ut [N, N, X, Y, Z,
    T] at every spatial site, as [N][N] component tensors [X, Y, Z]: a
    balanced recursion over contiguous T ranges, P(a..b) = P(a..m) @
    P(m..b) (the reference's order of products)."""
    n = ut.shape[0]
    utt = torch.movedim(ut, -1, 2)  # [N, N, T, X, Y, Z]
    comp = [[utt[i, j] for j in range(n)] for i in range(n)]

    def prod_range(lo, hi):
        if hi - lo == 1:
            return [[comp[i][j][lo] for j in range(n)] for i in range(n)]
        mid = (lo + hi) // 2
        return pairmul(prod_range(lo, mid), prod_range(mid, hi))

    return prod_range(0, utt.shape[2])


def polyakov_from_ut(ut):
    """Volume-averaged Polyakov loop (re, im), 1/N-normalized, of the
    temporal links ut [N, N, X, Y, Z, T]: L(xvec) = (1/N) tr prod_t
    U_t(xvec, t) (polyakov_product), with the matrix components kept as
    separate [X, Y, Z] tensors."""
    n = ut.shape[0]
    prod = polyakov_product(ut)
    loop = prod[0][0]
    for i in range(1, n):
        loop = loop + prod[i][i]
    loop = loop / n  # [X, Y, Z]
    return torch.mean(loop.real), torch.mean(loop.imag)


def plane_sums(u, keep=lambda f: f):
    """f64 [6]: the sums of Re tr P_{mu,nu}(x) over the sites that ``keep``
    selects (all; or a shard's interior, dense_sharded.py), plane by plane
    in PLANES order."""
    return torch.stack([torch.sum(keep(plaquette_retrace(u, mu, nu)),
                                  dtype=torch.float64)
                        for mu, nu in PLANES])


def measure_all(u):
    """The standard observable vector (OBS_NAMES) of a dense field
    [4, N, N, X, Y, Z, T], f32 [6]."""
    plq, plq_s, plq_t = mean_plaquette(u)
    pre, pim = polyakov_loop(u)
    return torch.stack([v.to(torch.float32) for v in
                        (plq, plq_s, plq_t, 1.0 - plq, pre, pim)])


def make_measure_fn(cfg):
    """u -> the observable vector of measure_obs_names(cfg), f32, on u's
    device: the standard six, then cfg's extended columns.  With
    cfg.meas_dtype "double" the field is widened to complex128 first (the
    reference's PRECISION=mixed: the updates in the run's dtype, the
    measurement sums in double)."""
    double = getattr(cfg, "meas_dtype", "same") == "double"

    def fn(u):
        if double:
            u = u.to(torch.complex128)
        ext = measure_extended(u, cfg)
        base = measure_all(u)
        return torch.cat([base, ext]) if ext.numel() else base

    return fn


# ---------------------------------------------------------------------------
# config-aware observable vector
# ---------------------------------------------------------------------------


def cfg_fmunu_indices(cfg):
    """The resolved Fmunu colour indices for a SimConfig (0 = auto/Cartan);
    one index where the two coincide, so no column name repeats."""
    if not getattr(cfg, "get_fmunu", False):
        return ()
    auto = default_fmunu_indices(cfg.group)
    i1 = cfg.fmunu_index1 or auto[0]
    i2 = cfg.fmunu_index2 or (auto[1] if len(auto) > 1 else 0)
    if i2 == i1:
        return (i1,)
    return (i1, i2) if i2 else (i1,)


def has_extended(cfg) -> bool:
    """Whether cfg asks for any extended observable."""
    return bool(cfg is not None and (cfg_fmunu_indices(cfg)
                                     or cfg_wilson_pairs(cfg)
                                     or getattr(cfg, "get_qtop", False)))


def measure_obs_names(cfg=None):
    """Names of the observables of one measurement."""
    if cfg is None:
        return OBS_NAMES
    qtop = ("q_top",) if getattr(cfg, "get_qtop", False) else ()
    return (OBS_NAMES + fmunu_obs_names(cfg_fmunu_indices(cfg))
            + wilson_loop_obs_names(cfg_wilson_pairs(cfg)) + qtop)


def obs_names(cfg=None):
    """Column names of the per-measurement series row: the measurement
    plus the tracked statistic, where the reference puts it
    (ops/measure.py:385-394)."""
    names = measure_obs_names(cfg)
    if cfg is not None and getattr(cfg, "track_acceptance", False):
        names = names + ("acc_rate",)
    if cfg is not None and getattr(cfg, "track_kp_exhaust", False):
        names = names + ("kp_exhaust_rate",)
    return names


def measure_extended(u, cfg):
    """The extended columns of cfg (Fmunu, Wilson loops, q_top, in
    measure_obs_names order) of the field u [4, N, N, X, Y, Z, T]
    (complex64, or complex128 on the dense engine):
    f32 [k] on u's device, k = 0 without extras (the reference's
    ops/pallas/engine.py:398-420)."""
    parts = []
    indices = cfg_fmunu_indices(cfg)
    pairs = cfg_wilson_pairs(cfg)
    if indices:
        parts.append(fmunu_means(u, indices))
    if pairs:
        parts.append(wilson_loop_means(u, pairs))
    if getattr(cfg, "get_qtop", False):
        n_smear = int(getattr(cfg, "qtop_smear", 0) or 0)
        if n_smear:
            u = ape_smear(u, float(getattr(cfg, "qtop_alpha", 0.5)), n_smear)
        parts.append(topological_charge(u).to(torch.float32)[None])
    if not parts:
        return torch.zeros(0, dtype=torch.float32, device=u.device)
    return torch.cat(parts)
