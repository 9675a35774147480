"""qcdgpu_tpu_torch.config mirrors qcdgpu_tpu.config; features outside the
ported slices are refused; the package never imports jax."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu_torch import SimConfig, Simulation
from qcdgpu_tpu_torch.ops.cuda import engine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(dims=(4, 4, 2, 4))


def test_fields_and_defaults_match_reference():
    ref = {f.name: f.default for f in dataclasses.fields(RefConfig)}
    got = {f.name: f.default for f in dataclasses.fields(SimConfig)}
    assert list(got) == list(ref)
    assert got == ref


@pytest.mark.parametrize("kw", [
    {},
    dict(group=2, dims=(8, 8, 8, 4), beta=2.4, n_or=2, start="hot"),
    dict(algorithm="metropolis", track_acceptance=True, rng_mode="hw",
         engine="pallas", y_block=4),
    dict(wilson_loops=((1, 1), (2, 1)), get_qtop=True, qtop_smear=3,
         mesh=(2, 2, 1, 1), rng_mode="prngcl:ranlux3", meas_dtype="double"),
])
def test_reference_dict_round_trips(kw):
    d = RefConfig(**kw).to_dict()
    cfg = SimConfig.from_dict(d)
    assert cfg.to_dict() == d
    assert cfg.replace(seed=9).seed == 9


@pytest.mark.parametrize("kw", [
    dict(group=3, algorithm="bogus"),
    dict(rng_mode="prngcl:nope"),
    dict(y_block=3, dims=(4, 8, 4, 4)),
    dict(n_or=8),
    dict(dims=(4, 4, 3, 4)),
])
def test_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        RefConfig(**kw)
    with pytest.raises(ValueError):
        SimConfig(**kw)


# each ported feature paired with an unported one: the pair is still refused
@pytest.mark.parametrize("kw", [
    dict(group=2, rng_mode="hw"),
    dict(algorithm="metropolis", rng_mode="prngcl:ranmar", get_qtop=True),
    dict(algorithm="metropolis", track_acceptance=True, get_qtop=True),
    dict(track_kp_exhaust=True, meas_dtype="double"),
    dict(get_fmunu=True),
    dict(wilson_loops=((1, 1),)),
    dict(get_qtop=True),
    dict(rng_mode="hw"),
    dict(mesh=(2, 2, 1, 1), get_qtop=True),
    dict(dtype="complex128"),
    dict(meas_dtype="double"),
    dict(engine="xla"),
])
def test_unported_features_raise(kw):
    cfg = SimConfig(**{**TINY, **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.make_chunk_runner(cfg, "cpu")


# Z/T splits run on the reference's XLA engine, which is not ported
@pytest.mark.parametrize("mesh", [(1, 1, 2, 1), (2, 1, 1, 2), (1, 1, 1, 2)])
def test_zt_meshes_raise(mesh):
    cfg = SimConfig(dims=(4, 4, 4, 4), mesh=mesh)
    with pytest.raises(NotImplementedError, match="M11"):
        Simulation(cfg, device="cpu")


@pytest.mark.parametrize("kw", [
    dict(group=2, beta=2.4),
    dict(n_or=7),
    dict(algorithm="metropolis", n_hit=2, metro_delta=0.5),
    dict(algorithm="metropolis", track_acceptance=True),
    dict(track_kp_exhaust=True, n_or=1),
    dict(rng_mode="prngcl:ranlux3"),
    dict(rng_mode="prngcl:ranmar", algorithm="metropolis",
         track_acceptance=True),
    dict(rng_mode="prngcl:xor128", group=2, n_or=1),
    dict(rng_mode="prngcl:mrg32k3a", track_kp_exhaust=True),
    dict(n_or=1, mesh=(1, 2, 1, 1)),
    dict(rng_mode="prngcl:xor128", mesh=(2, 1, 1, 1)),
    dict(mesh=(2, 1, 1, 1)),
])
def test_ported_features_accepted(kw):
    cfg = SimConfig(**{**TINY, **kw})
    engine.check_supported(cfg)
    run = engine.make_chunk_runner(cfg, "cpu")
    u = run.unpack((run.packed_cold_start(), run.make_stream_state0()))
    assert u.shape == (4, cfg.group, cfg.group) + TINY["dims"]


def test_checkpoints_raise():
    sim = Simulation(SimConfig(**TINY), device="cpu")
    with pytest.raises(NotImplementedError, match="M8"):
        sim.save("unused")
    with pytest.raises(NotImplementedError, match="M8"):
        Simulation.load("unused")


def test_device_is_explicit():
    """The CPU is an explicit opt-in; any other device is refused."""
    cfg = SimConfig(**TINY)
    assert Simulation(cfg, device="cpu").device.type == "cpu"
    with pytest.raises(ValueError):
        Simulation(cfg, device="meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(cfg, device="cuda")


def test_default_device_is_the_card():
    """With no device argument every entry point asks for the card, so on
    a host without one it raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is moot")
    cfg = SimConfig(**TINY)
    for call in (lambda: Simulation(SimConfig()),
                 lambda: engine.make_chunk_runner(cfg),
                 lambda: engine.packed_cold_start(cfg),
                 lambda: engine.packed_hot_start(cfg, (1, 2)),
                 lambda: engine.from_reference(
                     np.zeros((4, 3, 3) + TINY["dims"], np.complex64))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_import_leaves_jax_out():
    code = ("import sys, qcdgpu_tpu_torch, qcdgpu_tpu_torch.sim, "
            "qcdgpu_tpu_torch.ops.cuda.engine, "
            "qcdgpu_tpu_torch.ops.cuda.sharded, "
            "qcdgpu_tpu_torch.parallel.mesh, "
            "qcdgpu_tpu_torch.ops.prng_streams; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'qcdgpu_tpu' or "
            "m.startswith('qcdgpu_tpu.')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
