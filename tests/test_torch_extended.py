"""The port's extended observables (ops/measure.py, ops/staples.py,
ops/smear.py; Fmunu, Wilson loops, clover Q_L, APE smearing) against the
JAX reference's dense functions on the same fields, the packed engine's
measurement with every option against the reference's make_measure_fn,
meas_dtype="double", and the exact backgrounds of tests/test_{fmunu,
wilson,qtop,smear}.py on the port alone.

Fields are hot SU(2) / SU(3) links made from a numpy seed at 4^4 (numpy
normals, projected by the port's reunitarize), handed to both packages as
numpy arrays.  The reference's functions run eagerly, and each result is
computed once per group and shared between the tests that need it: its
measurement (make_measure_fn), its staple sums and its two APE steps,
whose first step's projection of direction 0 is also the reference for
project_sun_polar."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.ops import measure as jmeas
from qcdgpu_tpu.ops import smear as jsmear
from qcdgpu_tpu.ops import staples as jstaples
from qcdgpu_tpu_torch import SimConfig
from qcdgpu_tpu_torch import sim as tsim
from qcdgpu_tpu_torch.ops import measure as tmeas
from qcdgpu_tpu_torch.ops import smear as tsmear
from qcdgpu_tpu_torch.ops import staples as tstaples
from qcdgpu_tpu_torch.ops import sun as tsun
from qcdgpu_tpu_torch.ops.cuda import engine as teng
from qcdgpu_tpu_torch.ops.lattice import shift
from qcdgpu_tpu_torch.models import BetaScan

torch.set_num_threads(1)

L = 4
DIMS = (L, L, L, L)
GROUPS = (2, 3)
PAIRS = ((1, 1), (1, 2), (2, 1), (2, 3), (3, 3))


def _su_n(n, lead, seed):
    """Random SU(n) matrices [*lead, n, n, *DIMS] (complex64 numpy)."""
    rs = np.random.default_rng(seed)
    shape = tuple(lead) + (n, n) + DIMS
    g = rs.standard_normal(shape) + 1j * rs.standard_normal(shape)
    g = torch.from_numpy(g.astype(np.complex64)).reshape((-1, n, n) + DIMS)
    out = torch.stack([tsun.reunitarize(m) for m in g])
    return out.reshape(shape).numpy()


_FIELDS = {}


def hot(n, seed=1):
    """A hot link field [4, n, n, *DIMS] (numpy), one per (n, seed)."""
    if (n, seed) not in _FIELDS:
        _FIELDS[(n, seed)] = _su_n(n, (4,), 100 * n + seed)
    return _FIELDS[(n, seed)]


def cold(n):
    return np.broadcast_to(np.eye(n, dtype=np.complex64).reshape(
        (1, n, n) + (1,) * 4), (4, n, n) + DIMS).copy()


def abelian_two_flux(n, k1=1, k2=1):
    """tests/test_qtop.py's background in numpy: flux B1 in the xy plane
    (U_x ~ y) and B2 in the zt plane (U_z ~ t) along T_3 = diag(1, -1[,
    0]); every clover leaf there is e^{-i B T_3}."""
    b1, b2 = 2.0 * np.pi * k1 / L, 2.0 * np.pi * k2 / L
    u = cold(n).astype(np.complex128)
    ph1 = np.exp(1j * b1 * np.arange(L))
    ph2 = np.exp(1j * b2 * np.arange(L))
    for i, s in ((0, +1), (1, -1)):
        u[0, i, i] = (ph1 ** s)[None, :, None, None]
        u[2, i, i] = (ph2 ** s)[None, None, None, :]
    return u.astype(np.complex64), b1, b2


def gauge_transform(u, g):
    """U_mu(x) -> g(x) U_mu(x) g^+(x + mu), on torch fields."""
    return torch.stack([tsun.mul(tsun.mul(g, u[mu]),
                                 tsun.dagger(shift(g, mu, +1)))
                        for mu in range(4)])


def maxdiff(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


# ---------------------------------------------------------------------------
# each dense function against the reference's on the same field
# ---------------------------------------------------------------------------

ALPHA = 0.5
STAPLE_DIRS = (0, 3)
_REF = {}


def ref_once(key, make):
    """make() once per key: a reference result shared between tests."""
    if key not in _REF:
        _REF[key] = make()
    return _REF[key]


def ref_staples(n):
    """The reference's staple_sum(hot(n), mu) for mu in STAPLE_DIRS."""
    return ref_once(("staples", n), lambda: [
        np.asarray(jstaples.staple_sum(jnp.asarray(hot(n)), mu))
        for mu in STAPLE_DIRS])


def ref_smear(n):
    """The reference's ape_smear(hot(n), ALPHA, 2), step by step (its
    ape_smear is the loop over ape_smear_step): (one step, two steps)."""
    def make():
        s1 = jsmear.ape_smear_step(jnp.asarray(hot(n)), ALPHA)
        s2 = jsmear.ape_smear_step(s1, ALPHA)
        return np.array(s1), np.array(s2)
    return ref_once(("smear", n), make)


# two directions / planes each: the measurements below run all of them
FIELD_FNS = {
    "staple_sum": (lambda m, u: [m.staple_sum(u, mu) for mu in STAPLE_DIRS]),
    "plaquette_field": (lambda m, u: [m.plaquette_field(u, mu, nu)
                                      for mu, nu in ((0, 1), (1, 3))]),
    "clover_leaf_sum": (lambda m, u: [m.clover_leaf_sum(u, mu, nu)
                                      for mu, nu in ((0, 2), (2, 3))]),
    "field_strength_clover": (lambda m, u: [
        m.field_strength_clover(u, mu, nu) for mu, nu in ((0, 3), (1, 2))]),
}


@pytest.mark.parametrize("n", GROUPS)
@pytest.mark.parametrize("fn", list(FIELD_FNS))
def test_field_functions_match_reference(fn, n):
    u = hot(n)
    if fn == "staple_sum":
        ref = ref_staples(n)
        got = FIELD_FNS[fn](tstaples, torch.from_numpy(u))
    else:
        ref = FIELD_FNS[fn](jmeas, jnp.asarray(u))
        got = FIELD_FNS[fn](tmeas, torch.from_numpy(u))
    assert max(maxdiff(r, g) for r, g in zip(ref, got)) <= 2e-6


ALL_KW = dict(get_fmunu=True, wilson_loops=PAIRS, get_qtop=True)


def ref_measure(n):
    """The reference's make_measure_fn(cfg)(hot(n)) for cfg with ALL_KW:
    its columns after the standard six are fmunu_means, wilson_loop_means
    and topological_charge of the field."""
    cfg = RefConfig(group=n, dims=DIMS, **ALL_KW)
    return ref_once(("measure", n), lambda: np.asarray(
        jmeas.make_measure_fn(cfg)(jnp.asarray(hot(n)))))


@pytest.mark.parametrize("n", GROUPS)
def test_fmunu_and_wilson_means_match_reference(n):
    u = torch.from_numpy(hot(n))
    n_f = 12 * len(jmeas.default_fmunu_indices(n))
    ref = ref_measure(n)[6:6 + n_f]
    got = tmeas.fmunu_means(u, jmeas.default_fmunu_indices(n))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert maxdiff(ref, got) <= 1e-6
    # every generator, and the means of two off-diagonal ones
    for a in range(1, n * n):
        assert np.array_equal(tmeas.generator(n, a), jmeas.generator(n, a))
    ref = jmeas.fmunu_means(jnp.asarray(hot(n)), (1, 2 * n - 2))
    assert maxdiff(ref, tmeas.fmunu_means(u, (1, 2 * n - 2))) <= 1e-6
    ref = ref_measure(n)[6 + n_f:6 + n_f + len(PAIRS)]
    got = tmeas.wilson_loop_means(u, PAIRS)
    assert got.dtype == torch.float32 and got.shape == (len(PAIRS),)
    assert maxdiff(ref, got) <= 1e-6


@pytest.mark.parametrize("n", GROUPS)
def test_topological_charge_matches_reference(n):
    got = tmeas.topological_charge(torch.from_numpy(hot(n)))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - float(ref_measure(n)[-1])) <= 1e-5


@pytest.mark.parametrize("n", GROUPS)
def test_project_sun_polar_matches_reference(n):
    # a generic non-unitary field: the APE mix of direction 0, (1 - alpha)
    # U_0 + (alpha / 6) S_0^+ from the reference's staple sum, whose
    # projection is direction 0 of the reference's first APE step
    u = hot(n)
    s0 = ref_staples(n)[STAPLE_DIRS.index(0)]
    x = (1.0 - ALPHA) * u[0] + (ALPHA / 6.0) * np.conj(
        np.swapaxes(s0, 0, 1))
    assert x.dtype == np.complex64
    w = tsmear.project_sun_polar(torch.from_numpy(x))
    assert w.dtype == torch.complex64
    assert maxdiff(ref_smear(n)[0][0], w) <= 1e-5
    assert float(tsun.unitarity_defect(w)) < 1e-5
    assert float(torch.max(torch.abs(tsun.det(w) - 1.0))) < 1e-5


@pytest.mark.parametrize("n", GROUPS)
def test_ape_smear_matches_reference(n):
    ref = ref_smear(n)[1]
    got = tsmear.ape_smear(torch.from_numpy(hot(n)), ALPHA, 2)
    assert maxdiff(ref, got) <= 2e-5
    q_ref = float(jmeas.topological_charge(jnp.asarray(ref)))
    assert abs(float(tmeas.topological_charge(got)) - q_ref) <= 1e-4


# ---------------------------------------------------------------------------
# the packed engine's measurement against the reference's make_measure_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", GROUPS)
def test_packed_measurement_matches_reference(n):
    kw = dict(group=n, dims=DIMS, **ALL_KW)
    u = hot(n)
    ref = ref_measure(n)
    cfg = SimConfig(**kw)
    got = teng.measure_all_split(teng.from_reference(u, "cpu"), DIMS, cfg)
    names = tmeas.measure_obs_names(cfg)
    assert names == jmeas.measure_obs_names(RefConfig(**kw))
    assert got.dtype == torch.float32 and got.shape == (len(names),)
    got = got.numpy()
    assert maxdiff(ref[:4], got[:4]) <= 5e-5
    assert maxdiff(ref[4:6], got[4:6]) <= 2e-4
    assert maxdiff(ref[6:], got[6:]) <= 1e-5


@pytest.mark.parametrize("n", GROUPS)
def test_meas_dtype_double_is_same(n):
    kw = dict(group=n, dims=DIMS, get_fmunu=True, wilson_loops=((1, 1),),
              get_qtop=True, qtop_smear=1)
    us = teng.from_reference(hot(n), "cpu")
    a = teng.measure_all_split(us, DIMS, SimConfig(**kw, meas_dtype="double"))
    b = teng.measure_all_split(us, DIMS, SimConfig(**kw))
    assert torch.equal(a, b)


def test_meas_dtype_double_plaquette_is_complex128s():
    """K3's f64 sums: the SU(3) plaquette with meas_dtype="double" within
    1e-6 of the reference's complex128 mean_plaquette
    (tests/test_pallas.py:129-137)."""
    u = hot(3)
    cfg = SimConfig(group=3, dims=DIMS, meas_dtype="double")
    a = teng.measure_all_split(teng.from_reference(u, "cpu"), DIMS, cfg)
    plq64 = float(jmeas.mean_plaquette(
        jnp.asarray(u).astype(jnp.complex128))[0])
    assert abs(float(a[0]) - plq64) < 1e-6


# ---------------------------------------------------------------------------
# exact backgrounds and invariances, on the port alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", GROUPS)
def test_cold_start_exact(n):
    u = torch.from_numpy(cold(n))
    indices = tuple(range(1, n * n))
    assert float(torch.max(torch.abs(tmeas.fmunu_means(u, indices)))) < 1e-6
    w = tmeas.wilson_loop_means(u, PAIRS)
    assert float(torch.max(torch.abs(w - 1.0))) < 1e-6
    assert abs(float(tmeas.topological_charge(u))) < 1e-6
    assert maxdiff(tsmear.ape_smear(u, 0.5, 2), u) < 1e-5


@pytest.mark.parametrize("n,k1,k2", [(2, 1, 1), (3, 1, 1), (2, 1, 2)])
def test_abelian_two_flux_exact(n, k1, k2):
    u, b1, b2 = abelian_two_flux(n, k1, k2)
    u = torch.from_numpy(u)
    want = np.zeros((n, n), dtype=complex)
    want[0, 0], want[1, 1] = 4 * np.exp(-1j * b1), 4 * np.exp(+1j * b1)
    if n == 3:
        want[2, 2] = 4.0
    c = tmeas.clover_leaf_sum(u, 0, 1)[:, :, 0, 0, 0, 0].numpy()
    assert np.allclose(c, want, atol=1e-5)
    expect = L ** 4 * np.sin(b1) * np.sin(b2) / (2.0 * np.pi ** 2)
    q = float(tmeas.topological_charge(u))
    assert abs(q - expect) < 1e-4 * max(1.0, abs(expect)), (q, expect)
    # the background is a fixed point of smearing, so Q_L stays
    us = tsmear.ape_smear(u, 0.5, 2)
    assert maxdiff(us, u) < 2e-5
    assert abs(float(tmeas.topological_charge(us)) - q) < 1e-3


@pytest.mark.parametrize("n", GROUPS)
def test_gauge_invariance_and_covariance(n):
    u = torch.from_numpy(hot(n))
    g = torch.from_numpy(_su_n(n, (), 7 + n))
    ug = gauge_transform(u, g)
    assert maxdiff(tmeas.wilson_loop_means(u, PAIRS),
                   tmeas.wilson_loop_means(ug, PAIRS)) < 5e-6
    assert abs(float(tmeas.topological_charge(u))
               - float(tmeas.topological_charge(ug))) < 5e-4
    s, sg = tsmear.ape_smear(u, 0.5, 2), tsmear.ape_smear(ug, 0.5, 2)
    assert maxdiff(sg, gauge_transform(s, g)) < 5e-4
    assert abs(float(tmeas.topological_charge(s))
               - float(tmeas.topological_charge(sg))) < 5e-4


@pytest.mark.parametrize("n", GROUPS)
def test_w11_equals_temporal_plaquette(n):
    cfg = SimConfig(group=n, dims=DIMS, wilson_loops=((1, 1),))
    v = teng.measure_all_split(teng.from_reference(hot(n), "cpu"), DIMS, cfg)
    names = tmeas.measure_obs_names(cfg)
    assert abs(float(v[names.index("wloop_1x1")])
               - float(v[names.index("plq_t")])) < 1e-6


def test_brute_force_rectangle():
    """W(2, 3) against an explicit per-site numpy path product."""
    r, t = 2, 3
    u = hot(2).astype(np.complex128)
    total = 0.0
    for mu in range(3):
        for x in np.ndindex(DIMS):
            m = np.eye(2, dtype=complex)
            pos = list(x)
            for _ in range(r):
                m = m @ u[mu][(slice(None), slice(None)) + tuple(pos)]
                pos[mu] = (pos[mu] + 1) % L
            for _ in range(t):
                m = m @ u[3][(slice(None), slice(None)) + tuple(pos)]
                pos[3] = (pos[3] + 1) % L
            for _ in range(r):
                pos[mu] = (pos[mu] - 1) % L
                m = m @ u[mu][(slice(None), slice(None)) + tuple(pos)].conj().T
            for _ in range(t):
                pos[3] = (pos[3] - 1) % L
                m = m @ u[3][(slice(None), slice(None)) + tuple(pos)].conj().T
            total += m.trace().real / 2
    ref = total / (3 * L ** 4)
    got = float(tmeas.wilson_loop_means(
        torch.from_numpy(hot(2)), ((r, t),))[0])
    assert abs(got - ref) < 1e-5


def test_line_product_and_obs_names_match_reference():
    u = hot(3)
    ref = np.asarray(jmeas.line_product(jnp.asarray(u[1]), 1, 3))
    assert maxdiff(ref, tmeas.line_product(torch.from_numpy(u[1]), 1, 3)) \
        <= 2e-6
    for kw in (dict(group=3, get_fmunu=True, fmunu_index1=8),
               dict(group=2, get_fmunu=True, fmunu_index1=1,
                    fmunu_index2=2, track_kp_exhaust=True),
               dict(group=3, algorithm="metropolis", track_acceptance=True,
                    **ALL_KW, dims=DIMS)):
        assert (tmeas.obs_names(SimConfig(**kw))
                == jmeas.obs_names(RefConfig(**kw)))
        assert (tmeas.cfg_fmunu_indices(SimConfig(**kw))
                == jmeas.cfg_fmunu_indices(RefConfig(**kw)))


# ---------------------------------------------------------------------------
# the dense engine on a mesh, and what stays refused
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(dtype="complex128", get_qtop=True, mesh=(2, 1, 1, 1)),
    dict(dtype="complex128", meas_dtype="double", mesh=(1, 2, 1, 1)),
    dict(mesh=(1, 1, 2, 1), wilson_loops=((1, 1),)),
    dict(engine="xla", get_fmunu=True, mesh=(2, 2, 1, 1)),
])
def test_refusals_name_m11(kw):
    """The extended observables on a dense mesh (M11b): a sweep from a hot
    start, the links bit for bit the unsharded dense run's, the extended
    columns equal (measured on the gathered field), the standard six
    within 1e-5."""
    cfg = SimConfig(dims=DIMS, start="hot", seed=3, **kw)
    key = (3, 4)
    flat = tsim.make_chunk_runner(cfg.replace(mesh=(1, 1, 1, 1),
                                              engine="xla"), "cpu")
    run = tsim.make_chunk_runner(cfg, "cpu")
    assert run.engine == "xla" and len(run.grid) == np.prod(cfg.mesh)
    u0 = flat.unpack((flat.packed_hot_start(key), {}))
    u, obs = run(u0, key, 0, 1, 1)
    u_ref, obs_ref = flat(u0, key, 0, 1, 1)
    assert torch.equal(u, u_ref)
    np.testing.assert_allclose(obs[:, :6], obs_ref[:, :6], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(obs[:, 6:], obs_ref[:, 6:])


@pytest.mark.parametrize("mesh", [(2, 1, 1, 1), (2, 2, 1, 1)])
def test_mesh_scan_with_extras_raises(mesh):
    cfg = SimConfig(group=2, dims=DIMS, mesh=mesh, get_qtop=True)
    with pytest.raises(ValueError, match="chain x lattice"):
        BetaScan(cfg, [2.2, 2.4], device="cpu")
