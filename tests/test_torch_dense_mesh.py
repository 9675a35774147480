"""The dense engine on a 4D mesh (dense_sharded.py, parallel/mesh.py
DenseGrid) on the CPU: a mesh sweep against the JAX reference's, the
sharded chain against the unsharded one bit for bit (links, stream words,
tracked rates) for every random source, group, update kind and mesh, the
halo refresh against the wrapped window of the global field, the
measurement without gathering, dense scans on a mesh and in chain blocks,
checkpoints across layouts, config 5 on one device, and what stays
refused."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qcdgpu_tpu import sim as jsim
from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.ops import measure as jmeas
from qcdgpu_tpu.ops import rng as jrng
from qcdgpu_tpu_torch import SimConfig, Simulation, validate
from qcdgpu_tpu_torch import dense_sharded as dsh
from qcdgpu_tpu_torch.models import BetaScan
from qcdgpu_tpu_torch.parallel.mesh import DenseGrid

torch.set_num_threads(1)

D4 = (4, 4, 4, 4)
MESHES = [(1, 1, 1, 2), (1, 1, 2, 2), (2, 1, 1, 2), (2, 2, 2, 2)]
SOURCES = ["threefry", "prngcl:xor128", "prngcl:xor7", "prngcl:mrg32k3a",
           "prngcl:parkmiller", "prngcl:constant", "prngcl:ranlux3",
           "prngcl:ranmar"]
BASE = dict(group=2, dims=D4, beta=2.3, start="hot", reunit_every=1,
            engine="xla", seed=5)

_UNSHARDED = {}


def unsharded(cfg, n):
    """(links, series, stream state) of cfg's unsharded run of n sweeps,
    made once per configuration."""
    key = (repr(cfg.replace(mesh=(1, 1, 1, 1))), n)
    if key not in _UNSHARDED:
        sim = Simulation(cfg.replace(mesh=(1, 1, 1, 1)), device="cpu")
        obs = sim.run(n, 1)
        _UNSHARDED[key] = (sim.u, obs, sim.stream_state)
    return _UNSHARDED[key]


def assert_mesh_run_is_unsharded(cfg, n=1, **kw):
    """cfg's run of n sweeps on its mesh: links and stream state bit for
    bit the unsharded run's, the series within 1e-5 (the tracked column
    equal)."""
    sim = Simulation(cfg, device="cpu", **kw)
    assert sim.engine == "xla" and len(sim._run.grid) == np.prod(cfg.mesh)
    obs = sim.run(n, 1)
    u, obs_ref, rst = unsharded(cfg, n)
    assert torch.equal(sim.u, u)
    np.testing.assert_allclose(obs, obs_ref, rtol=0, atol=1e-5)
    if engine_tracks(cfg):
        np.testing.assert_array_equal(obs[:, -1], obs_ref[:, -1])
    if rst is not None:
        got = sim.stream_state
        assert set(got) == set(rst)
        for k, v in rst.items():
            np.testing.assert_array_equal(got[k], v)
    return sim


def engine_tracks(cfg):
    return cfg.track_acceptance or cfg.track_kp_exhaust


def test_mesh_sweep_matches_reference():
    """One complex128 SU(2) sweep (heat-bath + 1 overrelaxation, KP
    exhaustion tracked) on mesh (1,1,2,2) from the reference's hot start,
    against the reference's make_sweep_fn / make_measure_fn run eagerly
    unsharded (its own tests/test_sharding.py holds its sharded sweep to
    its unsharded one bit for bit): links 1e-12, observables 1e-10, the
    tracked rate equal."""
    kw = dict(group=2, dims=D4, beta=2.4, n_or=1, track_kp_exhaust=True,
              dtype="complex128", reunit_every=0, seed=4)
    u0 = np.asarray(jsim.hot_start(RefConfig(**kw), jrng.make_base_key(4)))
    ref_u, ref_rate = jsim.make_sweep_fn(RefConfig(**kw), with_acc=True)(
        jnp.asarray(u0), jrng.make_base_key(4), 0)
    sim = Simulation(SimConfig(**kw, mesh=(1, 1, 2, 2)), init_u=u0,
                     device="cpu")
    assert sim.engine == "xla" and len(sim._run.grid) == 4
    obs = sim.run(1, 1)[0]
    np.testing.assert_allclose(sim.u.numpy(), np.asarray(ref_u), rtol=0,
                               atol=1e-12)
    ref_obs = np.asarray(jmeas.make_measure_fn(RefConfig(**kw))(ref_u))
    np.testing.assert_allclose(obs[:6], ref_obs, rtol=0, atol=1e-10)
    assert obs[6] == float(ref_rate)


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
@pytest.mark.parametrize("source", SOURCES)
def test_every_source_on_every_mesh(source, mesh, dtype):
    """Each random source on each mesh in each dtype, one sweep with a
    reunitarization from a hot start: links and stream words bit for bit
    the unsharded run's."""
    cfg = SimConfig(**BASE, rng_mode=source, dtype=dtype, mesh=mesh)
    assert_mesh_run_is_unsharded(cfg)


@pytest.mark.parametrize("kw", [
    dict(group=3, beta=5.7),
    dict(group=3, beta=5.7, n_or=1, track_kp_exhaust=True,
         dtype="complex128"),
    dict(group=3, beta=5.7, algorithm="metropolis", track_acceptance=True),
    dict(algorithm="metropolis", track_acceptance=True, n_or=2,
         dtype="complex128", rng_mode="prngcl:ranlux3"),
    dict(n_or=1, track_kp_exhaust=True, rng_mode="prngcl:ranmar"),
], ids=["su3-hb", "su3-hb-or-kp-c128", "su3-metro-acc", "su2-metro-or2-lux",
        "su2-hb-or-kp-ranmar"])
def test_each_group_and_kind(kw):
    """SU(2) and SU(3), heat-bath, overrelaxation and Metropolis with their
    tracked rates on mesh (1,1,2,2): bit for bit the unsharded run."""
    cfg = SimConfig(**{**BASE, **kw}, mesh=(1, 1, 2, 2))
    assert_mesh_run_is_unsharded(cfg)


def test_shards_spread_over_devices():
    """devices=[...] puts shard k on devices[k % len]: the chain is the
    same."""
    cfg = SimConfig(**BASE, mesh=(1, 1, 2, 2))
    sim = assert_mesh_run_is_unsharded(cfg, devices=["cpu", "cpu"])
    assert len(sim._run.grid.devices) == 4


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_halo_refresh_is_the_wrapped_window(mesh):
    """After the interiors of one direction change, refreshing its halos
    makes every shard's padded array the wrapped window of the global
    field (what scatter cuts), corners included, and leaves the other
    directions alone."""
    grid = DenseGrid(D4, mesh, ["cpu"])
    gen = torch.Generator().manual_seed(3)
    u = torch.randn((4, 2, 2) + D4, generator=gen, dtype=torch.float64)
    shards = dsh.scatter(u, grid)
    plan = dsh.halo_plan(shards, grid)
    assert sum(len(dsts) for dsts, _ in plan[0]) == \
        dsh.halo_copies_per_stage(grid)
    for mu in (2, 0):
        for g, s in zip(grid.shards, shards):
            inner = g.interior(s[mu])
            inner.copy_(torch.randn(inner.shape, generator=gen,
                                    dtype=torch.float64))
        stale = [s.clone() for s in shards]
        dsh.refresh(plan, mu)
        want = dsh.scatter(dsh.gather(shards, grid), grid)
        for s, w, old in zip(shards, want, stale):
            assert torch.equal(s[mu], w[mu])
            others = [m for m in range(4) if m != mu]
            assert torch.equal(s[others], old[others])
        for s, w in zip(shards, want):
            s.copy_(w)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m)))
def test_measurement_on_a_mesh(mesh):
    """The standard six from the shards within 1e-5 of the unsharded
    measurement; the extended columns (Fmunu, Wilson loops, smeared Q_L,
    measured on the gathered field) and meas_dtype "double" equal it."""
    cfg = SimConfig(group=3, dims=D4, dtype="complex128", seed=2,
                    start="hot", get_fmunu=True, wilson_loops=((1, 1),
                                                               (2, 1)),
                    get_qtop=True, qtop_smear=1)
    flat = Simulation(cfg, device="cpu")
    meshed = Simulation(cfg.replace(mesh=mesh), init_u=flat.u, device="cpu")
    a = np.array(list(flat.measure().values()))
    b = np.array(list(meshed.measure().values()))
    np.testing.assert_allclose(b[:6], a[:6], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b[6:], a[6:])
    c64 = cfg.replace(dtype="complex64", meas_dtype="double", engine="xla")
    flat = Simulation(c64, init_u=flat.u, device="cpu")
    meshed = Simulation(c64.replace(mesh=mesh), init_u=flat.u, device="cpu")
    a = np.array(list(flat.measure().values()))
    b = np.array(list(meshed.measure().values()))
    np.testing.assert_allclose(b[:6], a[:6], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b[6:], a[6:])


@pytest.mark.parametrize("chain_mesh", [1, 3])
@pytest.mark.parametrize("kw", [dict(dtype="complex128"),
                                dict(rng_mode="prngcl:ranlux3",
                                     track_kp_exhaust=True)],
                         ids=["threefry-c128", "ranlux3"])
def test_scan_chains_are_their_mesh_simulations(kw, chain_mesh):
    """A 3-chain dense scan on (1,1,2,1), in one block or in 3: chain c's
    links, series and stream words are its own dense Simulation's on the
    same mesh (seed + 1000 c, betas[c]), bit for bit."""
    cfg = SimConfig(**{**BASE, **kw}, mesh=(1, 1, 2, 1))
    betas = [2.1, 2.3, 2.5]
    scan = BetaScan(cfg, betas, chain_mesh, device="cpu")
    assert scan.engine == "xla" and len(scan._run.grid) == chain_mesh
    obs = scan.run(2, 1)
    u, rst = scan.u, scan.stream_state
    for c, b in enumerate(betas):
        sim = Simulation(cfg.replace(seed=cfg.seed + 1000 * c,
                                     beta=float(np.float32(b))),
                         device="cpu")
        np.testing.assert_array_equal(sim.run(2, 1), obs[c])
        assert torch.equal(sim.u, u[c]), c
        if rst is not None:
            for k, v in sim.stream_state.items():
                np.testing.assert_array_equal(
                    rst[k][c] if np.ndim(v) >= 4 else rst[k], v)


@pytest.mark.parametrize("source", ["threefry", "prngcl:ranlux3"])
def test_checkpoint_across_layouts(source, tmp_path):
    """A run on (1,1,2,2) saved after one sweep and resumed on (2,1,1,1)
    (the file holds the global field and stream state) is the
    uninterrupted unsharded run: links and streams bit for bit."""
    cfg = SimConfig(**BASE, rng_mode=source, dtype="complex128",
                    mesh=(1, 1, 2, 2))
    a = Simulation(cfg, device="cpu")
    a.run(1, 1)
    path = str(tmp_path / "state.npz")
    a.save(path)
    b = Simulation.load(path, device="cpu", mesh=(2, 1, 1, 1))
    assert b.cfg.mesh == (2, 1, 1, 1) and len(b._run.grid) == 2
    obs = b.run(1, 1)
    u, obs_ref, rst = unsharded(cfg, 2)
    assert torch.equal(b.u, u)
    np.testing.assert_allclose(np.concatenate(b.obs_history), obs_ref,
                               rtol=0, atol=1e-5)
    assert obs.shape == (1, 6)
    if rst is not None:
        for k, v in rst.items():
            np.testing.assert_array_equal(b.stream_state[k], v)


def test_scan_checkpoint_across_layouts(tmp_path):
    """A stream scan on (1,1,2,1) in 3 blocks saved and resumed unsharded
    in one block equals its uninterrupted run."""
    cfg = SimConfig(**BASE, rng_mode="prngcl:xor128", mesh=(1, 1, 2, 1))
    betas = [2.1, 2.3, 2.5]
    a = BetaScan(cfg, betas, 3, device="cpu")
    a.run(1, 1)
    path = str(tmp_path / "scan_state.npz")
    a.save(path)
    b = BetaScan.load(path, 1, device="cpu", mesh=(1, 1, 1, 1))
    whole = BetaScan(cfg.replace(mesh=(1, 1, 1, 1)), betas, device="cpu")
    whole.run(1, 1)
    np.testing.assert_allclose(b.run(1, 1), whole.run(1, 1), rtol=0,
                               atol=1e-5)
    assert torch.equal(b.u, whole.u)
    for k, v in whole.stream_state.items():
        np.testing.assert_array_equal(b.stream_state[k], v)


def test_config5_passes_on_one_device():
    """validate config 5 below two cards: the reference's fallback, a
    short SU(3) chain on mesh (4,2,1,1) of the one device against the
    unsharded chain, PASS with bit-identical links (never skipped)."""
    r = validate.check_multichip(device="cpu")
    assert r["pass"] is True and "skipped" not in r
    assert r["measured"]["max_dlinks"] == 0.0
    assert r["measured"]["max_dobs"] < 1e-5
    assert "(4, 2, 1, 1)" in r["name"]


def test_odd_shard_extent_raises():
    """A mesh that leaves a shard an odd extent breaks the checkerboard:
    refused by the configuration (the reference's words) and the grid."""
    with pytest.raises(ValueError, match="even per mesh shard"):
        SimConfig(dims=D4, mesh=(1, 1, 1, 4))
    with pytest.raises(ValueError, match="even shards"):
        DenseGrid((4, 4, 6, 4), (1, 1, 2, 1), ["cpu"])


def test_other_engines_stream_state_refused_on_a_mesh():
    """A packed engine's stream state does not resume on the dense mesh."""
    gen = "prngcl:xor128"
    packed = Simulation(SimConfig(group=2, dims=D4, rng_mode=gen),
                        device="cpu")
    assert packed.engine == "pallas"
    cfg = SimConfig(group=2, dims=D4, rng_mode=gen, mesh=(1, 1, 2, 2))
    with pytest.raises(ValueError, match="layout mismatch"):
        Simulation(cfg, init_u=packed.u, device="cpu",
                   _stream_rst=packed.stream_state)


def test_mesh_without_a_card_raises():
    """The default device is the card: no silent move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(SimConfig(dims=D4, mesh=(1, 1, 2, 2)))
