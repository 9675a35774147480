"""SU(2) in the port: the packed layout, the stage of every kind, the
reunitarization and the measurement sums (plain PyTorch versions of the
CUDA kernels) against the JAX reference, and the SU(2) slice configuration
as a whole.  The reference helpers are shared with test_torch_kinds.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.ops import rng as jrng
from qcdgpu_tpu.ops import sun as jsun
from qcdgpu_tpu.ops.measure import (mean_plaquette, measure_all,
                                     polyakov_from_ut)
from qcdgpu_tpu.ops.pallas import engine as peng
from qcdgpu_tpu_torch import SimConfig
from qcdgpu_tpu_torch.ops import rng as trng
from qcdgpu_tpu_torch.ops import sun as tsun
from qcdgpu_tpu_torch.ops.cuda import engine as teng
from qcdgpu_tpu_torch.ops.cuda import measure as tmeas
from qcdgpu_tpu_torch.ops.cuda.reunit import reunitarize_dir
from test_torch_kinds import check_slice, numpy_sun, port_stage, xla_stage

torch.set_num_threads(1)

DIMS = (4, 4, 4, 4)
BETA = 2.4


@pytest.fixture(scope="module")
def u0():
    return numpy_sun(2, DIMS, seed=4)


def noisy(u, seed):
    rs = np.random.default_rng(seed)
    noise = rs.standard_normal(u.shape) + 1j * rs.standard_normal(u.shape)
    return (u + 1e-3 * noise).astype(np.complex64)


def test_layout_round_trip_and_cold_start(u0):
    """split_links equals the reference's bit for bit; SU(2) stores the
    whole matrix, so join_links returns it unchanged."""
    us = teng.split_links(torch.from_numpy(u0))
    for a, b in zip(us, peng.split_links(jnp.asarray(u0))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(teng.join_links(us, DIMS).numpy(), u0)
    cold = teng.packed_cold_start(SimConfig(group=2, dims=DIMS), "cpu")
    for a, b in zip(cold, peng.packed_cold_start(RefConfig(group=2,
                                                           dims=DIMS))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_packed_hot_start_matches():
    dims = (2, 2, 2, 2)
    ref = peng.packed_hot_start(RefConfig(group=2, dims=dims, seed=3),
                                jrng.make_base_key(3))
    got = teng.packed_hot_start(SimConfig(group=2, dims=dims, seed=3),
                                trng.make_base_key(3), "cpu")
    for a, b in zip(got, ref):
        assert a.shape == (2, 2, 2) + dims[:2] + (dims[2] * dims[3] // 2,)
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-6


@pytest.mark.parametrize("kind,parity,mu", [
    ("heatbath", 0, 0), ("overrelax", 1, 3), ("metropolis", 1, 2),
])
def test_stage_matches_xla(u0, kind, parity, mu):
    key = trng.stage_key(trng.make_base_key(1), 0, 5)
    ref = xla_stage(u0, key, parity, mu, kind, BETA, DIMS)
    got = port_stage(u0, key, parity, mu, kind, BETA, DIMS)
    assert np.abs(got - ref).max() < 2e-5
    assert np.abs(got - u0[mu]).max() > 1e-3


def test_reunitarize_matches_reference(u0):
    bad = noisy(u0, 2)
    ref = np.asarray(jsun.reunitarize(jnp.asarray(bad[1])))
    got = tsun.reunitarize(torch.from_numpy(bad[1])).numpy()
    assert np.abs(got - ref).max() < 1e-6
    us = teng.from_reference(bad, "cpu")
    for mu in (0, 3):
        pair = (reunitarize_dir(us[2 * mu], DIMS),
                reunitarize_dir(us[2 * mu + 1], DIMS))
        got = teng.join_dir(pair, DIMS, 2).numpy()
        ref = np.asarray(jsun.reunitarize(jnp.asarray(bad[mu])))
        assert np.abs(got - ref).max() < 1e-6


def test_plane_sums_and_measure(u0):
    us = teng.from_reference(u0, "cpu")
    sums = tmeas.plane_sums(us, DIMS)
    plq = float(sums.sum()) / (6 * 2 * np.prod(DIMS))
    ref = float(mean_plaquette(jnp.asarray(u0).astype(jnp.complex128))[0])
    assert abs(plq - ref) < 1e-6
    np.testing.assert_allclose(teng.measure_all_split(us, DIMS).numpy(),
                               np.asarray(measure_all(jnp.asarray(u0))),
                               atol=2e-5)


@pytest.mark.parametrize("t_ext", [2, 6])
def test_polyakov_any_t(t_ext):
    dims = (4, 2, 2, t_ext)
    u = numpy_sun(2, dims, seed=t_ext)
    sre, sim_ = tmeas.polyakov_sums(teng.from_reference(u, "cpu"),
                                    dims).tolist()
    ref_re, ref_im = polyakov_from_ut(jnp.asarray(u[3]))
    n_spatial = 2 * dims[0] * dims[1] * dims[2]
    assert abs(sre / n_spatial - float(ref_re)) < 2e-6
    assert abs(sim_ / n_spatial - float(ref_im)) < 2e-6


def test_slice_su2_hb_or(monkeypatch, u0):
    """Slice configuration 3 at small dims: SU(2) heat-bath + 1
    overrelaxation."""
    kw = dict(group=2, dims=DIMS, beta=BETA, n_or=1, seed=7,
              reunit_every=2)
    check_slice(monkeypatch, kw, u0, rate_atol=None)
