"""The beta-scan ensemble on the CPU (plain twins of K1c-K4c): the port's
BetaScan against the JAX reference's, each chain against its own
single-chain Simulation bit for bit, the chain twins against the
single-chain twins, the device key derivation, warmup and chunking,
checkpoints in both directions, the presets, dense scans on a mesh and in
chain blocks, and the refusals."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.models import baseline_config as ref_baseline_config
from qcdgpu_tpu.models.ensemble import BetaScan as RefBetaScan
from qcdgpu_tpu_torch import SimConfig, Simulation
from qcdgpu_tpu_torch.models import (BetaScan, SU2PureGauge, SU3PureGauge,
                                     baseline_config)
from qcdgpu_tpu_torch.models.ensemble import keys_tensor
from qcdgpu_tpu_torch.ops import rng
from qcdgpu_tpu_torch.ops.cuda import core, engine
from qcdgpu_tpu_torch.ops.cuda import measure as cmeasure
from qcdgpu_tpu_torch.ops.cuda import reunit as creunit
from qcdgpu_tpu_torch.ops.cuda import update as cupdate

torch.set_num_threads(1)

SU3 = dict(group=3, dims=(4, 4, 2, 4), reunit_every=2)
SU2 = dict(group=2, dims=(4, 4, 4, 4), reunit_every=2)
BETAS = {3: (5.5, 6.0, 6.5), 2: (2.1, 2.4)}


def test_scan_matches_reference():
    """From the same cold start and seeds, the port's scan and the
    reference's (its XLA engine on the CPU) agree to tests/test_torch_sim's
    bars: rounding-order lockstep in the first block, a few links' worth
    after."""
    kw = dict(SU2, beta=2.3, seed=3)
    ref = RefBetaScan(RefConfig(**kw, engine="xla"), BETAS[2])
    obs_ref = np.asarray(ref.run(2, 1))
    obs = BetaScan(SimConfig(**kw), BETAS[2], device="cpu").run(2, 1)
    assert obs.shape == obs_ref.shape == (2, 2, 6)
    np.testing.assert_allclose(obs[:, 0, :4], obs_ref[:, 0, :4], atol=5e-5)
    np.testing.assert_allclose(obs[:, 0, 4:], obs_ref[:, 0, 4:], atol=2e-4)
    np.testing.assert_allclose(obs, obs_ref, atol=1e-2)


@pytest.mark.parametrize("kw", [
    dict(SU3, n_or=1, start="hot", seed=1),
    dict(SU3, rng_mode="hw", track_kp_exhaust=True, seed=2),
    dict(SU2, algorithm="metropolis", track_acceptance=True, rng_mode="hw",
         start="hot", seed=4),
    dict(SU2, algorithm="metropolis", track_acceptance=True, seed=5),
], ids=["su3-hb-or-hot", "su3-hb-kp-hw", "su2-metro-acc-hw-hot",
        "su2-metro-acc"])
def test_each_chain_is_its_own_simulation(kw):
    """Chain c is Simulation(seed + 1000 c, betas[c]), bit for bit: links
    and series, one tracked column per chain."""
    cfg = SimConfig(**kw)
    betas = BETAS[cfg.group][:2]
    scan = BetaScan(cfg, betas, device="cpu")
    scan.warmup().thermalize(1)
    obs = scan.run(2, 1)
    assert obs.shape == (len(betas), 2, len(scan.obs_names))
    assert scan.sweep_idx == 3
    for c, beta in enumerate(scan.betas):
        sim = Simulation(cfg.replace(seed=cfg.seed + 1000 * c,
                                     beta=float(beta)), device="cpu")
        sim.thermalize(1)
        np.testing.assert_array_equal(obs[c], sim.run(2, 1))
        for a, b in zip(scan.us, sim.us):
            assert torch.equal(a[c], b)
    if cfg.track_acceptance or cfg.track_kp_exhaust:
        assert ((obs[..., -1] >= 0) & (obs[..., -1] <= 1)).all()


@pytest.mark.parametrize("kind,track,mode", [
    ("heatbath", True, "threefry"), ("overrelax", False, "threefry"),
    ("metropolis", True, "hw"), ("heatbath", False, "hw"),
])
def test_chain_twins_are_the_single_chain_twins(kind, track, mode):
    """K1c-K4c's plain twins (what the CPU wrappers run) equal the
    single-chain twins on each chain's view, counts included."""
    n, dims = 3, SU3["dims"]
    keys = [rng.make_base_key(9 + 1000 * c) for c in range(3)]
    us = engine.packed_hot_start_chains(SimConfig(**SU3), keys, "cpu")
    betas = torch.tensor(BETAS[3], dtype=torch.float32)
    chains = tuple(a.clone() for a in us)
    count = torch.zeros(3, dtype=torch.int64) if track else None
    cupdate.stage_update_chains(chains, 2, 1, betas, keys_tensor(keys, "cpu"),
                                7, 6, dims, 1, kind=kind, count=count,
                                rng_mode=mode)
    for c in range(3):
        one = tuple(a[c].clone() for a in us)
        cnt = torch.zeros(1, dtype=torch.int64) if track else None
        key = rng.stage_key(keys[c], 7, 6) if kind != "overrelax" else (0, 0)
        cupdate.stage_update_ref(one, 2, 1, float(betas[c]), key, dims, 1,
                                 kind=kind, count=cnt, rng_mode=mode)
        for a, b in zip(chains, one):
            assert torch.equal(a[c], b)
        if track:
            assert int(count[c]) == int(cnt)
    sums = cmeasure.plane_sums_chains(chains, dims)
    poly = cmeasure.polyakov_sums_chains(chains, dims)
    row = engine.measure_chains((chains,), (core.whole(dims),))
    for c in range(3):
        view = tuple(a[c] for a in chains)
        assert torch.equal(sums[c], cmeasure.plane_sums_ref(view, dims))
        assert torch.equal(poly[c], cmeasure.polyakov_sums_ref(view, dims))
        assert torch.equal(row[c], engine.measure_all_split(view, dims))
    drift = chains[5] * 1.001
    single = drift.clone()
    creunit.reunitarize_chains(drift, dims)
    for c in range(3):
        creunit.reunitarize_dir_ref(single[c], dims)
    assert torch.equal(drift, single)


def test_device_key_derivation_is_stage_key():
    """K1c derives each chain's stage key on the device; its plain form
    (int32 bits in, u32 out) is rng.stage_key, high bits included."""
    keys = [rng.make_base_key(s) for s in (0, 1, 1000, 2 ** 40 + 7)]
    kt = keys_tensor(keys, "cpu")
    assert kt.dtype == torch.int32 and (kt < 0).any()
    for sweep, sid in ((0, 0), (5, 17), (2 ** 31 + 3, 0xF1)):
        got = cupdate.chain_stage_keys(kt, sweep, sid).tolist()
        assert got == [list(rng.stage_key(k, sweep, sid)) for k in keys]


def test_warmup_and_chunking():
    """warmup() leaves the chains as they were (it runs on a clone), and
    run(1) + run(2) is run(3): every sweep is keyed by its index."""
    cfg = SimConfig(**SU2, start="hot", seed=6)
    a = BetaScan(cfg, BETAS[2], device="cpu")
    before = [x.clone() for x in a.us]
    a.warmup()
    assert a.sweep_idx == 0
    assert all(torch.equal(x, y) for x, y in zip(a.us, before))
    obs_a = np.concatenate([a.run(1, 1), a.run(2, 1)], axis=1)
    b = BetaScan(cfg, BETAS[2], device="cpu")
    np.testing.assert_array_equal(obs_a, b.run(3, 1))
    assert all(torch.equal(x, y) for x, y in zip(a.us, b.us))


def test_checkpoints_cross_packages(tmp_path):
    """A port-written betascan .npz resumes in the port bit for bit and
    loads in the reference's BetaScan.load with equal links, keys, betas
    and sweep index; a reference-written one loads in the port the same
    (no reference run)."""
    cfg = SimConfig(**SU3, start="hot", seed=8, n_or=1)
    scan = BetaScan(cfg, BETAS[3], device="cpu")
    scan.thermalize(1)
    path = str(tmp_path / "scan_state.npz")
    scan.save(path)
    u = scan.u.numpy()
    back = BetaScan.load(path, device="cpu")
    assert back.sweep_idx == 1 and back.cfg == cfg
    np.testing.assert_array_equal(back.keys, scan.keys)
    np.testing.assert_array_equal(back.betas, scan.betas)
    assert all(torch.equal(x, y) for x, y in zip(back.us, scan.us))
    np.testing.assert_array_equal(back.run(1, 1), scan.run(1, 1))

    ref = RefBetaScan.load(path)
    assert ref.sweep_idx == 1
    np.testing.assert_array_equal(np.asarray(ref.keys), scan.keys)
    np.testing.assert_array_equal(np.asarray(ref.betas), scan.betas)
    np.testing.assert_array_equal(np.asarray(ref.us), u)

    w = RefBetaScan(RefConfig(**SU3, start="hot", seed=8, n_or=1),
                    BETAS[3], _defer_start=True)
    w.keys = jnp.asarray(scan.keys)
    w.us = jnp.asarray(u)
    w.sweep_idx = 2
    ref_path = str(tmp_path / "ref_state.npz")
    w.save(ref_path)
    port = BetaScan.load(ref_path, device="cpu")
    assert port.sweep_idx == 2
    np.testing.assert_array_equal(port.keys, scan.keys)
    np.testing.assert_array_equal(port.u.numpy(), u)
    with pytest.raises(ValueError, match="resume"):
        BetaScan.load(str(_simulation_ckpt(tmp_path)), device="cpu")


def _simulation_ckpt(tmp_path):
    from qcdgpu_tpu_torch.utils.checkpoint import load_state, save_state

    cfg = SimConfig(**SU2)
    path = tmp_path / "sim.npz"
    save_state(str(path), cfg, Simulation(cfg, device="cpu").u, 0)
    with pytest.raises(ValueError, match="scan --resume-state"):
        load_state(str(tmp_path / "scan_state.npz"))
    return path


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_baseline_configs_are_the_reference(n):
    assert baseline_config(n).to_dict() == ref_baseline_config(n).to_dict()


def test_presets():
    su2, su3 = SU2PureGauge(device="cpu"), SU3PureGauge(device="cpu")
    assert su2.cfg.to_dict() == RefConfig(group=2, dims=(8,) * 4,
                                          beta=2.4).to_dict()
    assert su3.cfg.to_dict() == RefConfig(group=3, dims=(16,) * 4,
                                          beta=6.0).to_dict()
    with pytest.raises(ValueError, match="group=3"):
        SU3PureGauge(SimConfig(group=2), device="cpu")
    with pytest.raises(ValueError):
        baseline_config(4)


@pytest.mark.parametrize("kw,chain_mesh,item", [
    (dict(rng_mode="prngcl:ranlux3", mesh=(1, 2, 1, 1)), 1, "M11b"),
    (dict(mesh=(1, 1, 2, 1)), 1, "M11b"),
    (dict(rng_mode="prngcl:ranlux3", mesh=(2, 1, 1, 1)), 2, "M11b"),
    (dict(get_qtop=True, dtype="complex128"), 2, "M11b"),
])
def test_refusals_name_their_item(kw, chain_mesh, item):
    """Dense scans on a mesh and in chain blocks (``item``: their ROADMAP
    item): each chain's links bit for bit the unsharded one-block dense
    scan's, the series within 1e-5 (the extended columns equal)."""
    assert item == "M11b"
    cfg = SimConfig(**{**SU2, **kw}, start="hot", seed=7)
    scan = BetaScan(cfg, BETAS[2], chain_mesh, device="cpu")
    assert scan.engine == "xla" and scan.chain_mesh == chain_mesh
    obs = scan.run(2, 1)
    flat = BetaScan(cfg.replace(mesh=(1, 1, 1, 1), engine="xla"), BETAS[2],
                    device="cpu")
    obs_ref = flat.run(2, 1)
    assert torch.equal(scan.u, flat.u)
    np.testing.assert_allclose(obs[..., :6], obs_ref[..., :6], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(obs[..., 6:], obs_ref[..., 6:])


def test_chain_mesh_auto_is_one_card():
    assert BetaScan(SimConfig(**SU2), BETAS[2], 0, device="cpu").chain_mesh == 1


def test_chain_wrappers_refuse_malformed_input():
    """The chain wrappers check what the kernels index: one chain count
    across the arrays, betas and keys, contiguous chain-stacked arrays."""
    keys = [rng.make_base_key(c) for c in range(2)]
    us = engine.packed_cold_start_chains(SimConfig(**SU2), 2, "cpu")
    kt = keys_tensor(keys, "cpu")
    dims = SU2["dims"]
    with pytest.raises(ValueError, match="betas"):
        cupdate.stage_update_chains(us, 0, 0, torch.ones(3), kt, 0, 0, dims)
    with pytest.raises(ValueError, match="contiguous chains"):
        cmeasure.plane_sums_chains((us[0][:1],) + us[1:], dims)
    with pytest.raises(ValueError, match="chain-stacked"):
        creunit.reunitarize_chains(us[0][0], dims)


@pytest.mark.parametrize("chain_mesh", [1, 2])
def test_scan_extended_rows_are_simulations(chain_mesh):
    """An unsharded scan (one chain block or two) with Wilson loops and
    Q_L: each chain's rows are its Simulation's, bit for bit, each
    chain's extras measured on its own joined field."""
    cfg = SimConfig(**SU2, seed=6, start="hot", wilson_loops=((1, 1), (2, 1)),
                    get_qtop=True, get_fmunu=True)
    scan = BetaScan(cfg, BETAS[2], chain_mesh, device="cpu")
    obs = scan.run(2, 1)
    assert obs.shape == (2, 2, len(scan.obs_names)) == (2, 2, 21)
    for c, beta in enumerate(scan.betas):
        sim = Simulation(cfg.replace(seed=cfg.seed + 1000 * c,
                                     beta=float(beta)), device="cpu")
        np.testing.assert_array_equal(obs[c], sim.run(2, 1))


def test_mesh_scan_with_extras_refused_as_the_reference():
    """The chain x lattice scan has no extended observables: the port
    raises the reference's ValueError (qcdgpu_tpu/models/ensemble.py:
    106-112), word for word."""
    from qcdgpu_tpu_torch.ops.cuda.engine import check_supported_chains

    want = ("extended observables (fmunu/wilson/qtop) are not supported "
            "on the chain x lattice Pallas path; use engine='xla' for such "
            "scans")
    for kw in (dict(get_fmunu=True), dict(wilson_loops=((1, 1),)),
               dict(get_qtop=True, qtop_smear=1)):
        cfg = SimConfig(**SU2, mesh=(2, 2, 1, 1), **kw)
        with pytest.raises(ValueError) as err:
            BetaScan(cfg, BETAS[2], 2, device="cpu")
        assert str(err.value) == want
        check_supported_chains(cfg.replace(mesh=(1, 1, 1, 1)))
