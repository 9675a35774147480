"""qcdgpu_tpu_torch.config mirrors qcdgpu_tpu.config; features outside the
ported slice are refused; the package never imports jax."""

import dataclasses
import subprocess
import sys
from pathlib import Path

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


@pytest.mark.parametrize("kw", [
    dict(group=2),
    dict(n_or=1),
    dict(algorithm="metropolis"),
    dict(algorithm="metropolis", track_acceptance=True),
    dict(track_kp_exhaust=True),
    dict(get_fmunu=True),
    dict(wilson_loops=((1, 1),)),
    dict(get_qtop=True),
    dict(rng_mode="hw"),
    dict(rng_mode="prngcl:xor128"),
    dict(mesh=(2, 1, 1, 1)),
    dict(dtype="complex128"),
    dict(meas_dtype="double"),
    dict(engine="xla"),
])
def test_unported_features_raise(kw):
    cfg = SimConfig(**{**TINY, **kw})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        engine.make_chunk_runner(cfg, "cpu")


def test_checkpoints_raise():
    sim = Simulation(SimConfig(**TINY), device="cpu")
    with pytest.raises(NotImplementedError, match="M8"):
        sim.save("unused")
    with pytest.raises(NotImplementedError, match="M8"):
        Simulation.load("unused")


def test_device_is_explicit():
    cfg = SimConfig(**TINY)
    with pytest.raises(TypeError):
        Simulation(cfg)  # no default device
    with pytest.raises(ValueError):
        Simulation(cfg, device="meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(cfg, device="cuda")


def test_import_leaves_jax_out():
    code = ("import sys, qcdgpu_tpu_torch, qcdgpu_tpu_torch.sim, "
            "qcdgpu_tpu_torch.ops.cuda.engine; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'qcdgpu_tpu' or "
            "m.startswith('qcdgpu_tpu.')]; print(bad); sys.exit(bool(bad))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
