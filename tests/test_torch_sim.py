"""The slice as a whole: the port's Simulation on the CPU (plain PyTorch
versions of the kernels) against the JAX reference's XLA engine, from the
same hot-start links."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import qcdgpu_tpu
from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.ops import rng as jrng
from qcdgpu_tpu.sim import hot_start
from qcdgpu_tpu_torch import SimConfig, Simulation
from qcdgpu_tpu_torch.ops import rng as trng
from qcdgpu_tpu_torch.ops.cuda import engine as teng
from qcdgpu_tpu_torch.ops.cuda import measure as tmeas
from qcdgpu_tpu_torch.ops.cuda import reunit as treunit
from qcdgpu_tpu_torch.ops.cuda import update as tupd

torch.set_num_threads(1)

DIMS = (4, 4, 2, 4)
KW = dict(group=3, dims=DIMS, beta=5.5, seed=1, reunit_every=2)


@pytest.fixture(scope="module")
def u0():
    cfg = RefConfig(**KW)
    return np.array(hot_start(cfg, jrng.make_base_key(1))
                    .astype(jnp.complex64))


def test_slice_matches_reference(u0):
    ref = qcdgpu_tpu.Simulation(RefConfig(**KW, engine="xla"),
                                init_u=jnp.asarray(u0))
    obs_ref = np.asarray(ref.run(2, 1))
    sim = Simulation(SimConfig(**KW), init_u=u0, device="cpu")
    obs = sim.run(2, 1)
    assert obs.shape == obs_ref.shape == (2, 6)
    assert sim.obs_names == tuple(ref.obs_names)
    # first block: rounding-order lockstep (tests/test_pallas.py:160-172)
    np.testing.assert_allclose(obs[0, :4], obs_ref[0, :4], atol=5e-5)
    np.testing.assert_allclose(obs[0, 4:], obs_ref[0, 4:], atol=2e-4)
    # later blocks: a KP accept flip at a rounding boundary may diverge
    # the chains pointwise; bound it to a few links' worth
    np.testing.assert_allclose(obs, obs_ref, atol=1e-2)
    assert sim.unitarity_defect() < 1e-5
    assert sim.sweep_idx == 2


def test_warmup_leaves_state_unchanged(u0):
    sim = Simulation(SimConfig(**KW), init_u=u0, device="cpu")
    before = [a.clone() for a in sim.us]
    sim.warmup()
    assert sim.sweep_idx == 0
    for a, b in zip(sim.us, before):
        assert torch.equal(a, b)


def test_chunking_invariance():
    """Sweeps are keyed by the global sweep index, so run(1)+run(2) draws
    exactly what run(3) draws."""
    cfg = SimConfig(**{**KW, "start": "hot"})
    a = Simulation(cfg, device="cpu")
    obs_a = np.concatenate([a.run(1, 1), a.run(2, 1)])
    b = Simulation(cfg, device="cpu")
    obs_b = b.run(3, 1)
    np.testing.assert_array_equal(obs_a, obs_b)
    for x, y in zip(a.us, b.us):
        assert torch.equal(x, y)


def test_cold_start_thermalize_measure_analysis():
    sim = Simulation(SimConfig(dims=DIMS, beta=5.5), device="cpu")
    m = sim.measure()
    assert m["plq"] == 1.0 and m["action"] == 0.0 and m["poly_re"] == 1.0
    sim.thermalize(1)
    obs = sim.run(4, 2)
    assert obs.shape == (2, 6) and np.isfinite(obs).all()
    assert 0.0 < obs[-1, 0] < 1.0
    assert sim.sweep_idx == 5
    stats = sim.analysis()
    assert set(stats) == set(sim.obs_names) and stats["plq"].n == 2


def test_cpu_run_launches_no_kernel():
    """On CPU tensors every wrapper takes its plain version."""
    counters = (tupd.LAUNCHES, treunit.LAUNCHES, tmeas.LAUNCHES)
    before = [dict(c) for c in counters]
    Simulation(SimConfig(**{**KW, "start": "hot"}), device="cpu").run(2, 1)
    assert [dict(c) for c in counters] == before


def test_runner_canonical_field_contract(u0):
    """run(u, key, sweep0, n, me) on the canonical field equals the
    Simulation driving the packed state."""
    cfg = SimConfig(**KW)
    run = teng.make_chunk_runner(cfg, "cpu")
    u1, obs = run(torch.from_numpy(u0), trng.make_base_key(cfg.seed), 0, 3, 2)
    sim = Simulation(cfg, init_u=u0, device="cpu")
    obs_sim = sim.run(3, 2)
    assert obs.shape == (1, 6) and u1.shape == u0.shape
    np.testing.assert_array_equal(obs.numpy(), obs_sim)
    assert torch.equal(u1, sim.u)


EXT = dict(group=3, dims=(4, 4, 4, 4), beta=5.5, seed=2, start="hot",
           reunit_every=2, get_fmunu=True,
           wilson_loops=((1, 1), (1, 2), (2, 1), (2, 2)), get_qtop=True,
           qtop_smear=1)


@pytest.fixture(scope="module")
def ext_run():
    """The unsharded Simulation with every extended option after run(2,
    1), and its series; shared by the mesh cases."""
    sim = Simulation(SimConfig(**EXT), device="cpu")
    return sim, sim.run(2, 1)


@pytest.mark.parametrize("mesh", [(2, 2, 1, 1), (2, 1, 1, 1)])
def test_extended_observables_through_simulation(mesh, ext_run):
    """Every extended option through Simulation: the row is
    measure_obs_names(cfg) wide (the reference's names), W(1,1) = plq_t in
    every row, measure() is the last row and measure_all_split of the
    state (tests/test_torch_extended.py holds that to the reference), and
    a mesh gives the same series bit for bit."""
    from qcdgpu_tpu.ops.measure import obs_names

    cfg = SimConfig(**EXT)
    sim, obs = ext_run
    names = list(sim.obs_names)
    assert tuple(names) == obs_names(RefConfig(**EXT))
    assert obs.shape == (2, len(names)) and np.isfinite(obs).all()
    np.testing.assert_allclose(obs[:, names.index("wloop_1x1")],
                               obs[:, names.index("plq_t")], atol=1e-5)
    m = sim.measure()
    np.testing.assert_array_equal(np.array(list(m.values()), np.float32),
                                  obs[-1])
    np.testing.assert_array_equal(
        teng.measure_all_split(sim.us, cfg.dims, cfg).numpy(), obs[-1])
    sharded = Simulation(cfg.replace(mesh=mesh), device="cpu")
    np.testing.assert_array_equal(sharded.run(2, 1), obs)


def test_meas_dtype_double_series_is_same():
    """meas_dtype="double" runs and its series is "same"'s, bit for bit
    (the f64 sums are always on), with the extras too."""
    cfg = SimConfig(**{**KW, "start": "hot", "wilson_loops": ((1, 1),),
                       "get_qtop": True})
    a = Simulation(cfg.replace(meas_dtype="double"), device="cpu").run(2, 1)
    b = Simulation(cfg, device="cpu").run(2, 1)
    assert a.shape == (2, 8)
    np.testing.assert_array_equal(a, b)
