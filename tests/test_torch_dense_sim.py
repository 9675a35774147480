"""The dense engine through the library and the CLI: a whole sweep and its
measurement against the JAX reference's (eager), resolve_engine's rules,
exact resume and dense stream checkpoints across the packages, the dense
tier of BetaScan (each chain its own Simulation, bit for bit) and the
dense engine on a mesh (its unsharded run bit for bit)."""

import json
import os
import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import qcdgpu_tpu
from qcdgpu_tpu import sim as jsim
from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.models.ensemble import BetaScan as RefBetaScan
from qcdgpu_tpu.ops import measure as jmeas
from qcdgpu_tpu.ops import prng_streams as jps
from qcdgpu_tpu.ops import rng as jrng
from qcdgpu_tpu.utils.checkpoint import load_state as ref_load_state
from qcdgpu_tpu.utils.checkpoint import save_state as ref_save_state
from qcdgpu_tpu_torch import SimConfig, Simulation, cli, dense
from qcdgpu_tpu_torch.config import resolve_engine
from qcdgpu_tpu_torch.models import BetaScan
from qcdgpu_tpu_torch.ops import prng_streams as tps
from qcdgpu_tpu_torch.ops import rng as trng

torch.set_num_threads(1)

DIMS = (4, 4, 2, 4)


def test_sweep_matches_reference():
    """One complex128 SU(2) sweep (heat-bath + 1 overrelaxation, KP
    exhaustion tracked, threefry) and its measurement against the
    reference's make_sweep_fn / make_measure_fn run eagerly: links 1e-12,
    observables 1e-10, the tracked rate equal."""
    kw = dict(group=2, dims=DIMS, beta=2.4, n_or=1, track_kp_exhaust=True,
              dtype="complex128", reunit_every=0, seed=4)
    u0 = dense.hot_start(SimConfig(**kw), trng.make_base_key(4), "cpu")
    ref_u, ref_rate = jsim.make_sweep_fn(RefConfig(**kw), with_acc=True)(
        jnp.asarray(u0.numpy()), jrng.make_base_key(4), 0)
    sim = Simulation(SimConfig(**kw), init_u=u0.numpy(), device="cpu")
    assert sim.engine == "xla" and sim.u.dtype == torch.complex128
    obs = sim.run(1, 1)[0]
    np.testing.assert_allclose(sim.u.numpy(), np.asarray(ref_u), rtol=0,
                               atol=1e-12)
    ref_obs = np.asarray(jmeas.make_measure_fn(RefConfig(**kw))(ref_u))
    np.testing.assert_allclose(obs[:6], ref_obs, rtol=0, atol=1e-10)
    assert obs[6] == float(ref_rate)
    assert sim.unitarity_defect() < 1e-5


@pytest.mark.parametrize("kw,want", [
    (dict(engine="xla"), "xla"),
    (dict(dtype="complex128"), "xla"),
    (dict(dtype="complex128", engine="xla", rng_mode="prngcl:ranmar"),
     "xla"),
    (dict(meas_dtype="double"), "pallas"),
    (dict(), "pallas"),
    (dict(engine="pallas"), "pallas"),
])
def test_resolve_engine(kw, want):
    cfg = SimConfig(dims=DIMS, **kw)
    assert resolve_engine(cfg) == want
    assert jsim.resolve_engine(RefConfig(dims=DIMS, **kw)) in (want, "xla")
    assert Simulation(cfg, device="cpu").engine == want


def test_hw_on_the_dense_engine_draws_threefry():
    """rng_mode "hw" with "auto" and complex128 resolves to the dense
    engine, which warns in the reference's words and draws threefry."""
    cfg = SimConfig(group=2, dims=DIMS, dtype="complex128", start="hot")
    with pytest.warns(UserWarning, match="always draws threefry"):
        hw = Simulation(cfg.replace(rng_mode="hw"), device="cpu")
    tf = Simulation(cfg, device="cpu")
    np.testing.assert_array_equal(hw.run(1, 1), tf.run(1, 1))
    assert torch.equal(hw.u, tf.u)


def stream_field(n, dtype):
    """A hand-made Haar field (numpy) for the checkpoint tests."""
    cfg = SimConfig(group=n, dims=DIMS, dtype=dtype)
    return dense.hot_start(cfg, trng.make_base_key(8), "cpu").numpy()


@pytest.mark.parametrize("gen,dtype", [("ranlux3", "complex64"),
                                       ("xor128", "complex128")])
def test_stream_checkpoint_from_reference(gen, dtype, tmp_path):
    """The reference's save_state of a hand-made dense stream state loads
    here exactly, and the resumed chain equals the uninterrupted one."""
    kw = dict(group=3, dims=DIMS, rng_mode=f"prngcl:{gen}", engine="xla",
              dtype=dtype, seed=9, ckpt_every=2)
    u = stream_field(3, dtype)
    rst = tps.make_stream_state(gen, 9, DIMS, "cpu")
    _, rst = tps.stream_draw(gen, rst, 7)  # a state mid-stream
    rst_np = dense.stream_to_numpy(gen, rst)
    path = str(tmp_path / "ref.npz")
    ref_save_state(path, RefConfig(**kw), jnp.asarray(u), 3, [],
                   rng_stream=rst_np)
    sim = Simulation.load(path, device="cpu")
    assert sim.engine == "xla" and sim.sweep_idx == 3
    np.testing.assert_array_equal(sim.u.numpy(), u)
    for k, v in rst_np.items():
        np.testing.assert_array_equal(sim.stream_state[k], v, err_msg=k)
    # resumed == uninterrupted, bit for bit
    sim.run(2, 1, ckpt_path=str(tmp_path / "mid.npz"))
    back = Simulation.load(str(tmp_path / "mid.npz"), device="cpu")
    a, b = sim.run(2, 1), back.run(2, 1)
    np.testing.assert_array_equal(a, b)
    assert torch.equal(sim.u, back.u)
    for k, v in sim.stream_state.items():
        np.testing.assert_array_equal(back.stream_state[k], v, err_msg=k)


def test_stream_checkpoint_to_reference(tmp_path):
    """The port's dense stream checkpoint is the reference's: its
    load_state reads the field and the stream state, and its Simulation
    adopts them on its dense engine."""
    cfg = SimConfig(group=2, dims=DIMS, rng_mode="prngcl:ranmar",
                    engine="xla", start="hot", seed=2)
    sim = Simulation(cfg, device="cpu")
    sim.run(1, 1)
    path = str(tmp_path / "state.npz")
    sim.save(path)
    _, u, idx, hist, rst = ref_load_state(path)
    assert idx == 1 and len(hist) == 1
    np.testing.assert_array_equal(np.asarray(u), sim.u.numpy())
    ref = qcdgpu_tpu.Simulation.load(path)
    assert set(ref._rst) == set(jps.make_stream_state_host("ranmar", 0,
                                                            (2, 2, 2, 2)))
    for k, v in sim.stream_state.items():
        np.testing.assert_array_equal(np.asarray(ref._rst[k]), v, err_msg=k)
        np.testing.assert_array_equal(np.asarray(rst[k]), v, err_msg=k)


def test_stream_layouts_are_refused_across_engines():
    """A packed stream state on the dense engine is refused, and the
    reverse, in the reference's words."""
    cfg = SimConfig(group=2, dims=DIMS, rng_mode="prngcl:xor128", seed=1)
    packed = Simulation(cfg, device="cpu")
    dense_sim = Simulation(cfg.replace(engine="xla"), device="cpu")
    u = dense_sim.u.numpy()
    with pytest.raises(ValueError, match="layout mismatch"):
        Simulation(cfg.replace(engine="xla"), init_u=u, device="cpu",
                   _stream_rst=packed.stream_state)
    with pytest.raises(ValueError, match="layout mismatch"):
        Simulation(cfg, init_u=u, device="cpu",
                   _stream_rst=dense_sim.stream_state)


def test_stream_scan_chains_are_their_simulations(tmp_path):
    """A 3-chain dense prngcl:xor128 scan at 4^4: chain c's links are its
    own dense Simulation's (seed + 1000 c, betas[c]) bit for bit, and its
    series too; the scan resumes exactly, and the reference's BetaScan
    reads its checkpoint."""
    cfg = SimConfig(group=3, dims=(4, 4, 4, 4), rng_mode="prngcl:xor128",
                    start="hot", seed=6, track_kp_exhaust=True)
    betas = [5.6, 5.9, 6.2]
    scan = BetaScan(cfg, betas, device="cpu")
    assert scan.engine == "xla"
    obs = scan.thermalize(1).run(2, 1)
    u = scan.u
    for c, b in enumerate(betas):
        sim = Simulation(cfg.replace(seed=6 + 1000 * c,
                                     beta=float(np.float32(b)),
                                     engine="xla"), device="cpu")
        sim.thermalize(1)
        np.testing.assert_array_equal(sim.run(2, 1), obs[c])
        assert torch.equal(sim.u, u[c]), c
    path = str(tmp_path / "scan_state.npz")
    scan.save(path)
    saved = scan.stream_state
    back = BetaScan.load(path, device="cpu")
    np.testing.assert_array_equal(back.run(1, 1), scan.run(1, 1))
    assert torch.equal(back.u, scan.u)
    ref = RefBetaScan.load(path)
    assert set(ref._rsts) == {"x", "y", "z", "w"}
    for k, v in saved.items():
        assert v.shape == (3, 4, 4, 4, 4) and v.dtype == np.uint32
        np.testing.assert_array_equal(np.asarray(ref._rsts[k]), v)


@pytest.mark.parametrize("kw", [
    dict(mesh=(1, 1, 2, 1)),
    dict(dtype="complex128", mesh=(2, 1, 1, 1)),
    dict(engine="xla", rng_mode="prngcl:ranlux3", mesh=(1, 2, 1, 1)),
])
def test_dense_mesh_raises_m11b(kw):
    """The dense engine on a mesh (M11b): 2 sweeps from a hot start, links
    and stream state bit for bit the unsharded dense run's, the series
    within 1e-5."""
    cfg = SimConfig(dims=(4, 4, 4, 4), start="hot", seed=8, **kw)
    sim = Simulation(cfg, device="cpu")
    assert sim.engine == "xla" and len(sim._run.grid) == 2
    obs = sim.run(2, 1)
    flat = Simulation(cfg.replace(mesh=(1, 1, 1, 1), engine="xla"),
                      device="cpu")
    np.testing.assert_allclose(obs, flat.run(2, 1), rtol=0, atol=1e-5)
    assert torch.equal(sim.u, flat.u)
    if flat.stream_state is not None:
        for k, v in flat.stream_state.items():
            np.testing.assert_array_equal(sim.stream_state[k], v)


def test_cli_run_and_resume_dense(tmp_path, capsys):
    """`run --engine xla --dtype complex128` and `resume` on the CPU: the
    record names the dense engine, the resumed series continues exactly."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    args = ["--dims", "4,4,2,4", "--group", "2", "--therm", "1", "--sweeps",
            "4", "--ckpt-every", "2", "--device", "cpu"]
    warnings.simplefilter("ignore")
    assert cli.main(["run", "--engine", "xla", "--dtype", "complex128",
                     *args, "--out", a]) in (0, None)
    with open(os.path.join(a, "results.json")) as f:
        rec = json.load(f)
    assert rec["engine"] == "xla" and rec["config"]["dtype"] == "complex128"
    assert os.path.isfile(os.path.join(a, "state.npz"))
    assert cli.main(["resume", os.path.join(a, "state.npz"), "--sweeps", "2",
                     "--device", "cpu", "--out", b]) in (0, None)
    with open(os.path.join(b, "results.json")) as f:
        rec_b = json.load(f)
    assert rec_b["engine"] == "xla"
    assert len(rec_b["series"]["plq"]) == 6
    assert rec_b["series"]["plq"][:4] == rec["series"]["plq"]
    capsys.readouterr()


@pytest.mark.parametrize("chains", (1, 3))
def test_chain_sweep_is_each_chains_sweep(chains):
    """A scan's batched sweep (the chain axis before the lattice axes, a
    key and a coupling per chain) gives each chain's own sweep's links and
    tracked rate bit for bit, with a reunitarization on the second."""
    cfg = SimConfig(group=3, dims=(4, 4, 4, 4), n_or=1, reunit_every=2,
                    track_kp_exhaust=True, engine="xla")
    sweep = dense.make_sweep_fn(cfg, with_acc=True)
    keys = [trng.make_base_key(3 + c) for c in range(chains)]
    betas = np.array([5.7, 6.0, 6.3][:chains], np.float32)
    u = torch.stack([dense.hot_start(cfg, k, "cpu") for k in keys], dim=3)
    singles = [u.select(3, c).clone() for c in range(chains)]
    for idx in (0, 1):
        _, rates = sweep(u, keys, idx, beta=betas)
        for c in range(chains):
            _, rate = sweep(singles[c], keys[c], idx,
                            beta=np.float64(betas[c]))
            assert torch.equal(u.select(3, c), singles[c])
            assert torch.equal(rates.reshape(-1)[c], rate.reshape(-1)[0])
