"""Checkpoints of the port (utils/checkpoint.py, Simulation.save / load)
against the JAX package's (qcdgpu_tpu/utils/checkpoint.py): both formats
(single .npz with the canonical field, packed directory) read and written
in both directions for threefry, hw and two PRNGCL generators; exact
resume; a reference chain continued in the port (ROADMAP M8); and the
port's native generator library against the reference's."""

import os
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qcdgpu_tpu
from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.native import prngcl as ref_prngcl
from qcdgpu_tpu.utils import checkpoint as ref_ckpt
from qcdgpu_tpu_torch import SimConfig, Simulation
from qcdgpu_tpu_torch.native import prngcl
from qcdgpu_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

DIMS = (4, 4, 2, 4)
MODES = ("threefry", "hw", "prngcl:xor128", "prngcl:ranlux3")
FORMATS = ("npz", "dir")


@pytest.fixture(params=MODES)
def state(request):
    """A port chain one sweep past a hot start: (sim, canonical field)."""
    cfg = SimConfig(group=2, dims=DIMS, beta=2.3, seed=4, start="hot",
                    rng_mode=request.param)
    sim = Simulation(cfg, device="cpu")
    sim.run(1, 1)
    return sim, sim.u.numpy()


def _path(tmp_path, fmt):
    return str(tmp_path / ("ck.npz" if fmt == "npz" else "ckdir"))


def _check_loaded(sim, cfg_d, u, sweep_idx, history, rng_stream):
    assert cfg_d == sim.cfg.to_dict()
    assert sweep_idx == sim.sweep_idx == 1
    np.testing.assert_array_equal(np.concatenate(history),
                                  np.concatenate(sim.obs_history))
    if isinstance(u, tuple):
        for a, b in zip(u, sim.us):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    else:
        np.testing.assert_array_equal(np.asarray(u), sim.u.numpy())
    want = sim.stream_state
    if want is None:
        assert rng_stream is None
    else:
        assert set(rng_stream) == set(want)
        for k, v in want.items():
            got = np.asarray(rng_stream[k])
            assert got.dtype == np.asarray(v).dtype, k
            np.testing.assert_array_equal(got, v)


@pytest.mark.parametrize("fmt", FORMATS)
def test_port_save_reference_load(state, fmt, tmp_path):
    sim, u = state
    path = _path(tmp_path, fmt)
    if fmt == "dir":
        sim.save(path)
        assert os.path.exists(os.path.join(path, "meta.npz"))
    else:
        ckpt.save_state(path, sim.cfg, sim.u, sim.sweep_idx,
                        sim.obs_history, rng_stream=sim.stream_state)
    cfg, got, sweep_idx, history, rng_stream = ref_ckpt.load_state(path)
    _check_loaded(sim, cfg.to_dict(), got, sweep_idx, history, rng_stream)


@pytest.mark.parametrize("fmt", FORMATS)
def test_reference_save_port_load(state, fmt, tmp_path):
    sim, u = state
    path = _path(tmp_path, fmt)
    ref_cfg = RefConfig(**sim.cfg.to_dict())
    if fmt == "dir":
        ref_ckpt.save_state(path, ref_cfg, None, sim.sweep_idx,
                            sim.obs_history, rng_stream=sim.stream_state,
                            us=tuple(a.numpy() for a in sim.us))
    else:
        ref_ckpt.save_state(path, ref_cfg, jnp.asarray(u), sim.sweep_idx,
                            sim.obs_history, rng_stream=sim.stream_state)
    cfg, got, sweep_idx, history, rng_stream = ckpt.load_state(path)
    _check_loaded(sim, cfg.to_dict(), got, sweep_idx, history, rng_stream)
    # and the loaded Simulation carries on as the saved one does
    loaded = Simulation.load(path, device="cpu")
    np.testing.assert_array_equal(loaded.run(1, 1), sim.run(1, 1))
    assert all(torch.equal(a, b) for a, b in zip(loaded.us, sim.us))


@pytest.mark.parametrize("rng_mode", ["hw", "prngcl:ranlux3"])
def test_resume_is_exact(rng_mode, tmp_path):
    cfg = SimConfig(group=2, dims=DIMS, beta=2.3, seed=9, start="hot",
                    rng_mode=rng_mode, reunit_every=2, ckpt_every=2)
    path = str(tmp_path / "state.npz")
    a = Simulation(cfg, device="cpu")
    a.run(2, ckpt_path=path)  # saves at sweep 2
    tail = a.run(2, 1)
    b = Simulation.load(path, device="cpu")
    assert b.sweep_idx == 2
    np.testing.assert_array_equal(b.run(2, 1), tail)
    assert all(torch.equal(x, y) for x, y in zip(a.us, b.us))
    np.testing.assert_array_equal(np.concatenate(b.obs_history),
                                  np.concatenate(a.obs_history))


def test_load_refuses_what_it_cannot_resume(tmp_path):
    cfg = SimConfig(group=2, dims=DIMS, rng_mode="prngcl:xor128")
    sim = Simulation(cfg, device="cpu")
    path = str(tmp_path / "a")
    ckpt.save_state(path, cfg, None, 0, us=sim.us)  # no stream state
    with pytest.raises(ValueError, match="no PRNGCL stream state"):
        Simulation.load(path, device="cpu")
    # a dense (XLA-layout) stream state is another provenance
    ckpt.save_state(path, cfg, None, 0, us=sim.us,
                    rng_stream={"x": np.zeros(DIMS, np.uint32)})
    with pytest.raises(ValueError, match="layout mismatch"):
        Simulation.load(path, device="cpu")
    os.remove(os.path.join(path, "meta.npz"))  # an interrupted save
    with pytest.raises(ValueError, match="meta.npz"):
        Simulation.load(path, device="cpu")


def test_reference_chain_resumes_in_the_port(tmp_path):
    """ROADMAP M8: a reference CPU chain (threefry) saved at sweep 2 and
    resumed in the port for 2 sweeps agrees with the reference's own 4
    sweeps (the bars of tests/test_pallas.py:160-172 and the stage's)."""
    kw = dict(group=3, dims=DIMS, beta=5.5, seed=1, reunit_every=2)
    # the hot start (the reference's, bit for bit in the packed rows) from
    # the port, so that the reference compiles one program only
    u0 = Simulation(SimConfig(**kw, start="hot"), device="cpu").u.numpy()
    ref = qcdgpu_tpu.Simulation(RefConfig(**kw), init_u=jnp.asarray(u0))
    ref.run(2, 1)
    path = str(tmp_path / "ref.npz")
    ref.save(path)
    obs_ref = np.asarray(ref.run(2, 1))
    sim = Simulation.load(path, device="cpu")
    assert sim.sweep_idx == 2
    obs = sim.run(2, 1)
    np.testing.assert_allclose(obs[:, :4], obs_ref[:, :4], atol=5e-5)
    np.testing.assert_allclose(obs[:, 4:], obs_ref[:, 4:], atol=2e-4)
    np.testing.assert_allclose(sim.u.numpy(), np.asarray(ref.u), atol=2e-5)


def _ref_prngcl_available(deadline_s=60.0):
    """Whether the reference's native PRNG library loads, waiting for it on
    a cold checkout: there several test workers build it at once into the
    same file, not atomically, and a worker that opens the half-written file
    caches None (qcdgpu_tpu/native/build.py, prngcl.py).  Clear that cache
    and try again until the writer has finished."""
    end = time.monotonic() + deadline_s
    while not ref_prngcl.available() and time.monotonic() < end:
        ref_prngcl._lib.cache_clear()
        time.sleep(0.5)
    return ref_prngcl.available()


@pytest.mark.parametrize("gen", ["ranlux3", "xor128", "mrg32k3a"])
def test_native_prngcl_matches_reference(gen):
    assert prngcl.available() and _ref_prngcl_available()
    np.testing.assert_array_equal(prngcl.fill(gen, 17, 4096),
                                  ref_prngcl.fill(gen, 17, 4096))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_extended_config_checkpoints_cross_packages(writer, tmp_path):
    """A checkpoint whose config sets every extended option (obs_history
    as wide as obs_names) written by either package loads in the other
    with equal config, history and links; the port resumes the reference's
    and its series keeps the width."""
    from qcdgpu_tpu.ops.measure import obs_names as ref_obs_names

    kw = dict(group=2, dims=(4, 4, 4, 4), beta=2.3, seed=4, start="hot",
              rng_mode="hw", get_fmunu=True, wilson_loops=((1, 1), (1, 2)),
              get_qtop=True, qtop_smear=1, meas_dtype="double")
    sim = Simulation(SimConfig(**kw), device="cpu")
    sim.run(1, 1)
    width = len(ref_obs_names(RefConfig(**kw)))
    assert np.concatenate(sim.obs_history).shape == (1, width) == (1, 21)
    path = str(tmp_path / "ckdir")
    if writer == "port":
        sim.save(path)
        cfg, got, idx, hist, _ = ref_ckpt.load_state(path)
    else:
        ref_ckpt.save_state(path, RefConfig(**kw), None, sim.sweep_idx,
                            sim.obs_history,
                            us=tuple(a.numpy() for a in sim.us))
        cfg, got, idx, hist, _ = ckpt.load_state(path)
    _check_loaded(sim, cfg.to_dict(), got, idx, hist, None)
    loaded = Simulation.load(path, device="cpu")
    tail = loaded.run(1, 1)
    assert tail.shape == (1, width)
    np.testing.assert_array_equal(tail, sim.run(1, 1))
