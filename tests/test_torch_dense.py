"""The dense engine's stages (ops/sun.py's quaternion helpers,
ops/samplers.py, ops/measure.py's dense measurement, dense.py's stream
sweep) against the JAX reference's dense ops, stage by stage.

The reference runs eagerly, op by op (a jit of its sampler or sweep
compiles for tens of seconds on a CPU); each reference result is computed
once per (group, dtype) and shared.  Both sides get the same numpy fields
and draw bit-identical threefry uniforms or stream words.  Bars:
complex64 links 2e-5 with the tracked rates equal, complex128 links 1e-12;
the plaquette and action columns 5e-5, the Polyakov ones 2e-4, complex128
observables 1e-10.

XLA's CPU backend computes the f32 rsqrt as an estimate within one ulp of
1/sqrt, not the correctly rounded 1/sqrt(x) that the port computes, on
the CPU and the card alike.  The
Metropolis proposal is normalised with an f32 rsqrt whatever the links'
dtype, so the complex128 Metropolis stage is held to 1e-12 against the
reference with its rsqrt taken as 1.0 / jnp.sqrt, and to the complex64
bar against the reference as it is.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from qcdgpu_tpu import sim as jsim
from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.ops import measure as jmeas
from qcdgpu_tpu.ops import prng_streams as jps
from qcdgpu_tpu.ops import rng as jrng
from qcdgpu_tpu.ops import samplers as jsamp
from qcdgpu_tpu.ops import sun as jsun
from qcdgpu_tpu.ops.lattice import site_index as jsite
from qcdgpu_tpu.ops.staples import staple_sum as jstaple
from qcdgpu_tpu_torch import SimConfig, dense
from qcdgpu_tpu_torch.ops import measure as tmeas
from qcdgpu_tpu_torch.ops import prng_streams as tps
from qcdgpu_tpu_torch.ops import rng as trng
from qcdgpu_tpu_torch.ops import samplers as tsamp
from qcdgpu_tpu_torch.ops import sun as tsun
from qcdgpu_tpu_torch.ops.cuda import engine as teng
from qcdgpu_tpu_torch.ops.cuda import update as tupd
from qcdgpu_tpu_torch.ops.lattice import parity_mask, site_index
from qcdgpu_tpu_torch.ops.staples import staple_sum

torch.set_num_threads(1)

DIMS = (4, 4, 2, 4)
SEED = 11
BETA = {2: 2.4, 3: 6.0}
DTYPES = {"complex64": np.complex64, "complex128": np.complex128}
LINK_TOL = {"complex64": 2e-5, "complex128": 1e-12}
MU = 1
KINDS = ("heatbath", "overrelax", "metropolis", "heatbath_tracked",
         "metropolis_tracked")


@lru_cache(maxsize=None)
def hot(n, dtype):
    """A numpy hot field [4, N, N, *DIMS] in ``dtype`` (the port's Haar
    start, reunitarized in that dtype)."""
    cfg = SimConfig(group=n, dims=DIMS, dtype=dtype)
    return dense.hot_start(cfg, trng.make_base_key(SEED), "cpu").numpy()


def stage_key():
    return (jrng.stage_key(jrng.make_base_key(SEED), 0, 3),
            trng.stage_key(trng.make_base_key(SEED), 0, 3))


@lru_cache(maxsize=None)
def reference_stage(n, dtype, kind, exact_rsqrt=False):
    """The reference's update_links of direction MU on hot(n, dtype), run
    eagerly: (links, tracked rate or None).  The tracked kinds' links are
    the untracked ones'."""
    u = jnp.asarray(hot(n, dtype))
    jkey, _ = stage_key()
    rsqrt = jax.lax.rsqrt
    if exact_rsqrt:
        jax.lax.rsqrt = lambda x: 1.0 / jnp.sqrt(x)
    try:
        out = jsamp.update_links(
            u[MU], jstaple(u, MU), kind, BETA[n], jkey, jsite(DIMS),
            return_acc=kind != "overrelax")
    finally:
        jax.lax.rsqrt = rsqrt
    if kind == "overrelax":
        return np.asarray(out), None
    return np.asarray(out[0]), float(out[1])


def rate_of(counts, n, kind):
    """update_links' counts as the reference's tracked rate."""
    return tsamp.tracked_rate(counts, int(np.prod(DIMS)), kind, 3,
                              len(tsun.subgroups(n)))


def port_stage(n, dtype, kind, track):
    u = torch.from_numpy(hot(n, dtype))
    _, tkey = stage_key()
    out = tsamp.update_links(u[MU], staple_sum(u, MU), kind, BETA[n], tkey,
                             site_index(DIMS, "cpu"), return_acc=track)
    if track:
        return out[0], rate_of(out[1], n, kind)
    return out


# ---------------------------------------------------------------------------
# ops/sun.py: the quaternion and subgroup helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sun_helpers_match_reference(dtype):
    rs = np.random.default_rng(3)
    real = np.float64 if dtype == "complex128" else np.float32
    p, q = (rs.standard_normal((4, 3, 5)).astype(real) for _ in range(2))
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    for ref, got in [(jsun.quat_mul(p, q), tsun.quat_mul(tp, tq)),
                     (jsun.quat_conj(q), tsun.quat_conj(tq)),
                     (jsun.quat_norm(q), tsun.quat_norm(tq))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=0, atol=LINK_TOL[dtype])
    m = hot(3, dtype)[0]
    eye = tsun.identity(3, DIMS, getattr(torch, dtype))
    np.testing.assert_array_equal(
        eye.numpy(), np.asarray(jsun.identity(3, DIMS, DTYPES[dtype])))
    for n in (2, 3):
        assert tsun.subgroups(n) == jsun.subgroups(n)
    for i, j in jsun.subgroups(3):
        np.testing.assert_allclose(
            tsun.extract_block_quat(torch.from_numpy(m), i, j).numpy(),
            np.asarray(jsun.extract_block_quat(m, i, j)), rtol=0,
            atol=LINK_TOL[dtype])
        flip = torch.from_numpy(rs.standard_normal((4,) + DIMS).astype(real))
        ref = jsun.subgroup_left_mul(jnp.asarray(flip.numpy()), i, j,
                                     jnp.asarray(m))
        got = tsun.subgroup_left_mul(flip, i, j, torch.from_numpy(m))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=LINK_TOL[dtype])
    assert tsamp.stage_uniform_count(3, "heatbath") == \
        jsamp.stage_uniform_count(3, "heatbath")
    assert tsamp.stage_uniform_count(2, "metropolis", n_hit=5) == \
        jsamp.stage_uniform_count(2, "metropolis", n_hit=5)
    assert tsamp.METRO_UNIFORMS_PER_HIT == jsamp.METRO_UNIFORMS_PER_HIT


# ---------------------------------------------------------------------------
# ops/samplers.py: one update_links of each kind
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", (2, 3))
def test_update_links_matches_reference(n, dtype, kind):
    base, track = kind.split("_")[0], kind.endswith("tracked")
    got = port_stage(n, dtype, base, track)
    exact = base == "metropolis" and dtype == "complex128"
    ref, rate = reference_stage(n, dtype, base, exact)
    if track:
        got, got_rate = got
        assert float(got_rate) == rate
    assert got.dtype == getattr(torch, dtype)
    d = float(np.max(np.abs(got.numpy() - ref)))
    assert d <= LINK_TOL[dtype], d
    if exact:
        # the reference as it is: its f32 rsqrt rounds the proposal apart
        d = float(np.max(np.abs(got.numpy()
                                - reference_stage(n, dtype, base)[0])))
        assert d <= LINK_TOL["complex64"], d


@pytest.mark.parametrize("n", (2, 3))
def test_batched_chains_are_each_chain(n):
    """The chain axis before the lattice axes, a coupling and a key per
    chain: chain c's stage is its own single-chain stage, bit for bit."""
    betas = [BETA[n] - 0.3, BETA[n], BETA[n] + 0.4]
    keys = [trng.stage_key(trng.make_base_key(SEED + c), 0, 2)
            for c in range(3)]
    u = torch.stack([torch.from_numpy(hot(n, "complex64"))] * 3, dim=3)
    k = tuple(torch.tensor([kk[i] for kk in keys]).reshape(-1, 1, 1, 1, 1)
              for i in (0, 1))
    sidx = site_index(DIMS, "cpu")
    for kind in ("heatbath", "metropolis"):
        got, cnt = tsamp.update_links(
            u[MU], staple_sum(u, MU), kind, np.asarray(betas), k, sidx,
            return_acc=True)
        rate = rate_of(cnt, n, kind)
        for c in range(3):
            uc = u.select(3, c).contiguous()
            one, c1 = tsamp.update_links(uc[MU], staple_sum(uc, MU), kind,
                                         betas[c], keys[c], sidx,
                                         return_acc=True)
            r1 = rate_of(c1, n, kind)
            assert torch.equal(got.select(2, c), one)
            assert float(rate[c]) == float(r1)


# ---------------------------------------------------------------------------
# ops/measure.py: the dense standard six and make_measure_fn
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n", (2, 3))
def test_measure_matches_reference(n, dtype):
    u = hot(n, dtype)
    ref = np.asarray(jmeas.measure_all(jnp.asarray(u)))
    got = tmeas.measure_all(torch.from_numpy(u)).numpy()
    assert got.dtype == np.float32
    if dtype == "complex128":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-10)
    else:
        np.testing.assert_allclose(got[:4], ref[:4], rtol=0, atol=5e-5)
        np.testing.assert_allclose(got[4:], ref[4:], rtol=0, atol=2e-4)
    # meas_dtype="double" widens a complex64 field, as the reference does
    kw = dict(group=n, dims=DIMS, meas_dtype="double", wilson_loops=((1, 1),))
    ref = np.asarray(jmeas.make_measure_fn(RefConfig(**kw))(jnp.asarray(u)))
    got = tmeas.make_measure_fn(SimConfig(**kw))(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-10)
    assert tmeas.measure_obs_names(SimConfig(**kw)) == \
        jmeas.measure_obs_names(RefConfig(**kw))


# ---------------------------------------------------------------------------
# dense.py: the stream sweep and the engines against each other
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gen", ("xor128", "ranlux3"))
def test_stream_sweep_matches_reference(gen):
    """One dense stream sweep (SU(2) heat-bath, every site drawing on every
    stage): the stream state afterwards is the reference's bit for bit, the
    links within the complex64 bar."""
    kw = dict(group=2, dims=DIMS, beta=BETA[2], rng_mode=f"prngcl:{gen}",
              reunit_every=0, seed=SEED)
    u0 = hot(2, "complex64")
    rst_ref = jps.make_stream_state_host(gen, SEED, DIMS)
    rst = tps.make_stream_state(gen, SEED, DIMS, "cpu")
    assert dense.stream_to_numpy(gen, rst).keys() == rst_ref.keys()
    key = jrng.make_base_key(SEED)
    u_ref, rst_ref = jsim.make_sweep_fn(RefConfig(**kw))(
        (jnp.asarray(u0), {k: jnp.asarray(v) for k, v in rst_ref.items()}),
        key, 0)
    u, rst = dense.make_sweep_fn(SimConfig(**kw))(
        (torch.from_numpy(u0), rst), trng.make_base_key(SEED), 0)
    got = dense.stream_to_numpy(gen, rst)
    for k, v in rst_ref.items():
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)
        assert got[k].dtype == np.asarray(v).dtype, k
    d = float(np.max(np.abs(u.numpy() - np.asarray(u_ref))))
    assert d <= LINK_TOL["complex64"], d


@pytest.mark.parametrize("kind", ("heatbath", "overrelax", "metropolis"))
@pytest.mark.parametrize("n", (2, 3))
def test_dense_stage_matches_packed_stage(n, kind):
    """The port against itself on the CPU: one threefry stage of the dense
    engine and of the packed engine's plain version, within 2e-5."""
    u = torch.from_numpy(hot(n, "complex64"))
    parity = 0
    _, key2 = stage_key()
    us = teng.split_links(u)
    tupd.stage_update(us, MU, parity, BETA[n], key2, DIMS, 4, kind=kind)
    got = teng.join_dir((us[2 * MU], us[2 * MU + 1]), DIMS, n)
    new = tsamp.update_links(u[MU], staple_sum(u, MU), kind, BETA[n], key2,
                             site_index(DIMS, "cpu"))
    ref = torch.where(parity_mask(DIMS, parity, "cpu"), new, u[MU])
    d = float(torch.max(torch.abs(got - ref)))
    assert d <= 2e-5, d


def test_threefry_i32_is_threefry():
    """The int32 threefry that site_uniforms draws with gives the int64
    form's bits, for int keys and per-chain tensor keys, with counters
    that make every add overflow."""
    rs = np.random.default_rng(5)
    x0 = torch.from_numpy(rs.integers(0, 2 ** 31, 4096))
    x1 = torch.from_numpy(rs.integers(2 ** 31 - 64, 2 ** 31, 4096))
    keys = [(0, 0), (2 ** 32 - 1, 2 ** 31),
            tuple(int(k) for k in rs.integers(0, 2 ** 32, 2))]
    keys.append(tuple(torch.from_numpy(rs.integers(0, 2 ** 32, (3, 1)))
                      for _ in range(2)))
    for k0, k1 in keys:
        want = trng.threefry2x32(k0, k1, x0, x1)
        got = trng.threefry2x32_i32(k0, k1, x0.to(torch.int32),
                                    x1.to(torch.int32))
        for a, b in zip(want, got):
            assert b.dtype == torch.int32
            assert torch.equal(a, b.to(torch.int64) & 0xFFFFFFFF)
            assert torch.equal(trng.bits_to_uniform(a),
                               trng.bits_to_uniform(b))
