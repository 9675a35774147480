"""The port's PRNGCL streams (qcdgpu_tpu_torch/ops/prng_streams.py) and the
stream path of the stage (plain PyTorch version of the CUDA kernel) against
the JAX reference.

The generators must match the reference's bit for bit (inits, draws,
carried state) and the native C++ library (exactly, or to 3e-7 where the
native value is a float64 division).  The stream stage follows the
reference's Pallas provenance: a stage draws the next dense-stream values
of its ACTIVE parity's sites only, so the XLA recipe
``samplers.update_links(uniforms=...)`` is fed from two dense streams, one
per parity, each advanced only on its own parity's stages.  The dense
streams used there are the port's, held bit-equal to the reference's by
``test_init_and_draws_match_reference``.
"""

from functools import lru_cache, partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.native import prngcl as native
from qcdgpu_tpu.ops import prng_streams as ps
from qcdgpu_tpu.ops import samplers
from qcdgpu_tpu.ops import sun as jsun
from qcdgpu_tpu.ops.lattice import parity_mask
from qcdgpu_tpu.ops.measure import make_measure_fn
from qcdgpu_tpu.ops.pallas import engine as peng
from qcdgpu_tpu_torch import SimConfig, Simulation
from qcdgpu_tpu_torch.ops import prng_streams as ts
from qcdgpu_tpu_torch.ops.cuda import engine as teng
from qcdgpu_tpu_torch.ops.cuda import update as tupd
from test_torch_kinds import numpy_sun, staples_jit

torch.set_num_threads(1)

DIMS2 = (2, 2, 2, 2)
DIMS = (4, 4, 2, 4)
ROUNDED = ("parkmiller", "mrg32k3a")


def as_ref(v):
    """A port state leaf as numpy, u32 words viewed as uint32."""
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


def assert_state_equal(ref, got, what):
    assert set(ref) == set(got), what
    for k, v in ref.items():
        want = np.asarray(v)
        have = as_ref(got[k])
        if want.dtype == np.uint32:
            have = have.view(np.uint32)
        np.testing.assert_array_equal(have, want, err_msg=f"{what} {k}")


@lru_cache(maxsize=None)
def _ref_draw(name, n):
    draw = ps.stream_draw_fn(name)
    return jax.jit(lambda st: draw(st, n))


@pytest.mark.parametrize("name", ps.STREAM_GENERATORS)
def test_init_and_draws_match_reference(name):
    """Inits bit-identical to make_stream_state_host; two draw calls of 100
    (past several luxury skips, through ranmar's pointer wrap) with the
    state carried between them, bit-identical draws and states."""
    assert_state_equal(ps.make_stream_state_host(name, 5, DIMS2),
                       ts.make_stream_state(name, 5, DIMS2), "init")
    ref, _ = ps.make_stream(name, 5, DIMS2)
    got = ts.make_stream_state(name, 5, DIMS2)
    for call in range(2):
        u_ref, ref = _ref_draw(name, 100)(ref)
        u_got, got = ts.stream_draw(name, got, 100)
        np.testing.assert_array_equal(u_got.numpy(), np.asarray(u_ref))
        assert_state_equal(ref, got, f"call {call}")


@pytest.mark.skipif(not native.available(), reason="native prngcl missing")
@pytest.mark.parametrize("name", ps.STREAM_GENERATORS)
def test_draws_match_native(name):
    """200 draws at three sites against the native generator seeded with
    the same per-site seed."""
    state = ts.make_stream_state(name, 987654321, DIMS2)
    u = ts.stream_draw(name, state, 200)[0].reshape(200, -1).numpy()
    seeds = ts.site_seeds(987654321, DIMS2).ravel()
    for site in (0, 7, 15):
        ref = native.fill(name, int(seeds[site]), 200)
        if name in ROUNDED:
            np.testing.assert_allclose(u[:, site], ref, rtol=0, atol=3e-7)
        else:
            np.testing.assert_array_equal(u[:, site], ref.astype(np.float32))
    assert u.min() >= 0.0 and u.max() <= 1.0
    v = ts.open01(torch.from_numpy(u))
    assert float(v.min()) > 0.0 and float(v.max()) < 1.0


@pytest.mark.parametrize("dtype", [np.uint32, np.float32])
def test_site_field_layout(dtype):
    """split_site_field / join_site_field against the reference's."""
    v = np.arange(3 * np.prod(DIMS), dtype=dtype).reshape((3,) + DIMS)
    ref = peng.split_site_field(jnp.asarray(v), DIMS)
    tv = torch.from_numpy(v.view(np.int32) if dtype == np.uint32 else v)
    got = teng.split_site_field(tv, DIMS)
    for a, b in zip(got, ref):
        have = a.numpy().view(dtype) if dtype == np.uint32 else a.numpy()
        np.testing.assert_array_equal(have, np.asarray(b))
    np.testing.assert_array_equal(
        teng.join_site_field(got, DIMS).numpy(), tv.numpy())


@pytest.mark.parametrize("name,nb,n", [
    ("ranlux3", 0, 54), ("ranlux3", 18, 54), ("ranlux3", 24, 36),
    ("ranlux0", 7, 18), ("ranlux4", 23, 1),
    ("ranmar", None, 54), ("ranmar", None, 281), ("ranmar", None, 500),
])
def test_advance_kernel_scalars(name, nb, n):
    """The closed-form scalar advance against the reference's, and against
    the dense stream's own counters (ranmar's carry stays exact past the
    n = 281 int32 overflow the reference guards against)."""
    state = ts.make_stream_state(name, 3, DIMS2)
    if nb is not None:
        state = ts.stream_draw(name, state, nb)[1] if nb else state
    scal = ts.stream_kernel_scalars(name, state)
    got = ts.advance_kernel_scalars(name, scal, n)
    ref = ps.advance_kernel_scalars(
        name, {k: jnp.asarray(v) for k, v in scal.items()}, n)
    assert got["ptr"] == int(ref["ptr"])
    after = ts.stream_draw(name, state, n)[1]
    if name == "ranmar":
        assert np.float32(got["c"]) == np.float32(ref["c"]) == after["c"]
    else:
        assert got["nb"] == int(ref["nb"]) == after["nb"]


@lru_cache(maxsize=None)
def _sampler(kind, beta, return_acc):
    return jax.jit(partial(samplers.update_links, kind=kind, beta=beta,
                           key2=None, site_idx=None, return_acc=return_acc))


def xla_stream_stage(u, mu, parity, kind, beta, dense, gen, ndraw):
    """One stage of the reference recipe: every site draws its next ndraw
    values from ``dense`` (that parity's dense streams), the XLA sampler
    consumes them, the active parity keeps the result.  Returns (u', the
    advanced dense state)."""
    uu, dense = ts.stream_draw(gen, dense, ndraw)
    new = _sampler(kind, beta, kind == "metropolis")(
        jnp.asarray(u[mu]), staples_jit(jnp.asarray(u), mu),
        uniforms=jnp.asarray(ts.open01(uu).numpy()))
    if kind == "metropolis":
        new = new[0]
    u = u.copy()
    u[mu] = np.asarray(jnp.where(parity_mask(DIMS, parity), new, u[mu]))
    return u, dense


def canonical_words(gen, words, ptr):
    """A lag window read through its pointer: canonical slot i = absolute
    slot (i + ptr - ptr0) mod W, the carry word after it."""
    nlag, ptr0 = (24, 23) if gen.startswith("ranlux") else (97, 96)
    idx = [(i + ptr - ptr0) % nlag for i in range(nlag)]
    return words[idx + list(range(nlag, words.shape[0]))]


@pytest.mark.parametrize("gen,n,kind,stages", [
    ("xor128", 3, "heatbath", 2),
    ("ranlux3", 3, "heatbath", 3),     # luxury skips fire mid-stage
    ("ranlux3", 2, "heatbath", 2),
    ("ranmar", 3, "heatbath", 3),      # 108 draws on parity 0: a wrap
    ("ranmar", 3, "metropolis", 2),
    ("mrg32k3a", 3, "metropolis", 2),
    ("mrg32k3a", 2, "heatbath", 2),
])
def test_stream_stage_matches_xla(gen, n, kind, stages):
    """Consecutive stream stages (plain version) against the XLA recipe:
    active links within 2e-5, each parity's words exact, scalars equal to
    the dense stream's counters; Metropolis stages tracked."""
    beta = 5.5 if n == 3 else 2.3
    u = numpy_sun(n, DIMS, seed=11)
    us = teng.from_reference(u, "cpu")
    dense0 = ts.make_stream_state(gen, 7, DIMS)
    rst = teng.pack_stream_state(gen, dense0, DIMS)
    dense = [dense0, ts.make_stream_state(gen, 7, DIMS)]
    names = ts.kernel_scalar_names(gen)
    ndraw = tupd.stream_draw_count(kind, 4, 3, n)
    count = torch.zeros(1, dtype=torch.int64) if kind == "metropolis" else None
    # parity 0 draws on consecutive stages, carrying pointer and counters
    seq = [(1, 0), (2, 0), (0, 1)][:stages]
    for mu, p in seq:
        sfx = ("_e", "_o")[p]
        u, dense[p] = xla_stream_stage(u, mu, p, kind, beta, dense[p], gen,
                                       ndraw)
        scal = {k: rst[k + sfx] for k in names}
        tupd.stage_update(us, mu, p, beta, None, DIMS, kind=kind, count=count,
                          gen=gen, words=rst["words" + sfx], scalars=scal)
        rst.update({k + sfx: v for k, v in scal.items()})
        got = teng.join_dir((us[2 * mu], us[2 * mu + 1]), DIMS, n).numpy()
        mask = np.asarray(parity_mask(DIMS, p))
        d = np.abs(got[..., mask] - u[mu][..., mask]).max()
        assert d < 2e-5, (mu, p, d)
    for p in {p for _, p in seq}:
        sfx = ("_e", "_o")[p]
        words = rst["words" + sfx]
        if names:
            words = canonical_words(gen, words, rst["ptr" + sfx])
            key = "nb" if "nb" in names else "c"
            assert rst[key + sfx] == dense[p][key]
        want = teng.split_site_field(ts.state_to_words(gen, dense[p]),
                                     DIMS)[p]
        np.testing.assert_array_equal(words.numpy(), want.numpy())
    if count is not None:
        assert 0 < int(count) <= stages * 3 * 3 * np.prod(DIMS) // 2


def test_slice_matches_reference():
    """The slice's configuration (SU(3) heat-bath, ranlux3) at small dims:
    the port's Simulation against a reference series assembled from the
    XLA pieces (per-parity dense streams, the sampler, reunitarization
    every 2nd sweep, make_measure_fn)."""
    kw = dict(group=3, dims=DIMS, beta=6.0, seed=7, reunit_every=2,
              rng_mode="prngcl:ranlux3")
    u = numpy_sun(3, DIMS, seed=3)
    sim = Simulation(SimConfig(**kw), init_u=u, device="cpu")
    obs = sim.run(2, 1)
    meas = jax.jit(make_measure_fn(RefConfig(**kw)))
    dense = [ts.make_stream_state("ranlux3", 7, DIMS) for _ in range(2)]
    ndraw = tupd.stream_draw_count("heatbath", 4, 3, 3)
    rows = []
    for sweep in range(2):
        for p in (0, 1):
            for mu in range(4):
                u, dense[p] = xla_stream_stage(u, mu, p, "heatbath", 6.0,
                                               dense[p], "ranlux3", ndraw)
        if sweep == 1:
            u = np.asarray(jax.jit(jax.vmap(jsun.reunitarize))(u))
        rows.append(np.asarray(meas(jnp.asarray(u))))
    ref = np.stack(rows)
    assert obs.shape == ref.shape == (2, 6)
    np.testing.assert_allclose(obs[0, :4], ref[0, :4], atol=5e-5)
    np.testing.assert_allclose(obs[0, 4:6], ref[0, 4:6], atol=2e-4)
    np.testing.assert_allclose(obs, ref, atol=1e-2)
    st = sim.stream_state
    assert st["words_e"].dtype == np.int32 and st["nb_e"].dtype == np.int32
    assert int(st["nb_e"]) == dense[0]["nb"]


@pytest.mark.parametrize("gen", ["xor128", "ranmar"])
def test_stream_hot_start_matches_reference(gen):
    """The stream hot start against the reference's packed stream hot start
    (dense draws, Box–Muller, reunitarize, pack): links to the ulps of
    Box–Muller's log/cos, words and scalars exact."""
    kw = dict(group=3, dims=DIMS, seed=9, rng_mode=f"prngcl:{gen}")
    run = peng.make_pallas_chunk_runner(RefConfig(**kw), interpret=True)
    us_ref, rst_ref = run.packed_stream_hot_start()
    us, rst = teng.packed_stream_hot_start(SimConfig(**kw), "cpu")
    for a, b in zip(us, us_ref):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-6
    sim = Simulation(SimConfig(**kw, start="hot"), device="cpu")
    assert_state_equal({k: np.asarray(v) for k, v in rst_ref.items()},
                       sim.stream_state, "hot start")
    assert set(rst) == run.stream_state_keys


def test_chunking_and_warmup():
    """run(4) == run(2) + run(2) bit for bit (links, words, scalars), and
    warmup() leaves the chain where it was."""
    cfg = SimConfig(group=2, dims=DIMS, beta=2.4, seed=5, n_or=1,
                    reunit_every=3, rng_mode="prngcl:ranlux3")
    a = Simulation(cfg, device="cpu")
    b = Simulation(cfg, device="cpu")
    b.warmup()
    obs_a = a.run(4, 2)
    obs_b = np.concatenate([b.run(2, 2), b.run(2, 2)])
    np.testing.assert_array_equal(obs_a, obs_b)
    for x, y in zip(a.us, b.us):
        assert torch.equal(x, y)
    sa, sb = a.stream_state, b.stream_state
    assert set(sa) == set(sb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])
    assert 0.4 < obs_a[-1, 0] < 0.95


def test_stream_stage_refuses_bad_input():
    us = teng.packed_cold_start(SimConfig(dims=DIMS), "cpu")
    rst = teng.make_stream_state0(
        SimConfig(dims=DIMS, rng_mode="prngcl:ranmar"), "cpu")
    scal = {"c": rst["c_e"], "ptr": rst["ptr_e"]}
    good = dict(gen="ranmar", words=rst["words_e"], scalars=scal)
    tupd.stage_update(us, 0, 0, 6.0, None, DIMS, **good)
    for bad in (dict(good, words=rst["words_e"].double()),
                dict(good, words=rst["words_e"][:, :2]),
                dict(good, scalars={"ptr": 0}),
                dict(good, gen="xor128")):
        with pytest.raises(ValueError):
            tupd.stage_update(us, 0, 0, 6.0, None, DIMS, **bad)
    with pytest.raises(ValueError):  # overrelaxation draws nothing
        tupd.stage_update(us, 0, 0, 6.0, None, DIMS, kind="overrelax",
                          **good)
