"""The port's measurement and reunitarization (plain PyTorch versions of the
K2-K4 CUDA kernels) against the JAX reference's dense-field observables."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.ops import rng as jrng
from qcdgpu_tpu.ops import sun as jsun
from qcdgpu_tpu.ops.measure import mean_plaquette, measure_all, polyakov_from_ut
from qcdgpu_tpu.sim import hot_start
from qcdgpu_tpu_torch.ops import sun as tsun
from qcdgpu_tpu_torch.ops.cuda import engine as teng
from qcdgpu_tpu_torch.ops.cuda import measure as tmeas
from qcdgpu_tpu_torch.ops.cuda.reunit import reunitarize_dir

torch.set_num_threads(1)

DIMS = (4, 4, 2, 4)


@pytest.fixture(scope="module")
def u0():
    cfg = RefConfig(group=3, dims=DIMS, beta=5.5, seed=1)
    return np.array(hot_start(cfg, jrng.make_base_key(1))
                    .astype(jnp.complex64))


def _numpy_su3(dims, seed):
    """Random SU(3) field [4, 3, 3, *dims] from numpy normals (Ginibre,
    projected by Gram–Schmidt)."""
    rs = np.random.default_rng(seed)
    shape = (4, 3, 3) + tuple(dims)
    g = rs.standard_normal(shape) + 1j * rs.standard_normal(shape)
    g = torch.from_numpy(g.astype(np.complex64))
    return torch.stack([tsun.reunitarize(g[m]) for m in range(4)]).numpy()


def test_plaquette_from_plane_sums(u0):
    us = teng.from_reference(u0, "cpu")
    sums = tmeas.plane_sums(us, DIMS)
    assert sums.dtype == torch.float64 and sums.shape == (6,)
    plq = float(sums.sum()) / (6 * 3 * np.prod(DIMS))
    ref = float(mean_plaquette(jnp.asarray(u0).astype(jnp.complex128))[0])
    assert abs(plq - ref) < 1e-6


def test_measure_all_split(u0):
    us = teng.from_reference(u0, "cpu")
    got = teng.measure_all_split(us, DIMS)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(measure_all(jnp.asarray(u0))),
                               atol=2e-5)


@pytest.mark.parametrize("t_ext", [2, 6, 8])
def test_polyakov_any_t(t_ext):
    dims = (4, 4, 2, t_ext)
    u = _numpy_su3(dims, seed=t_ext)
    us = teng.from_reference(u, "cpu")
    sre, sim_ = tmeas.polyakov_sums(us, dims).tolist()
    ref_re, ref_im = polyakov_from_ut(jnp.asarray(u[3]))
    n_spatial = 3 * dims[0] * dims[1] * dims[2]
    assert abs(sre / n_spatial - float(ref_re)) < 2e-6
    assert abs(sim_ / n_spatial - float(ref_im)) < 2e-6


def test_reunitarize_dir(u0):
    rs = np.random.default_rng(2)
    noisy = (u0 + 1e-3 * (rs.standard_normal(u0.shape)
                          + 1j * rs.standard_normal(u0.shape))
             ).astype(np.complex64)
    us = teng.from_reference(noisy, "cpu")
    for mu in (0, 3):
        pair = (reunitarize_dir(us[2 * mu], DIMS),
                reunitarize_dir(us[2 * mu + 1], DIMS))
        got = teng.join_dir(pair, DIMS, 3).numpy()
        ref = np.asarray(jsun.reunitarize(jnp.asarray(noisy[mu])))
        assert np.abs(got - ref).max() < 2e-5
