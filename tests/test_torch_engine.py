"""Packed layout, start states and neighbour addressing of the port against
the JAX reference (qcdgpu_tpu/ops/pallas/engine.py, core.py)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.ops import lattice as jlat
from qcdgpu_tpu.ops import rng as jrng
from qcdgpu_tpu.ops.pallas import core as pcore
from qcdgpu_tpu.ops.pallas import engine as peng
from qcdgpu_tpu.sim import hot_start
from qcdgpu_tpu_torch import SimConfig
from qcdgpu_tpu_torch.ops import lattice as tlat
from qcdgpu_tpu_torch.ops import rng as trng
from qcdgpu_tpu_torch.ops.cuda import core as tcore
from qcdgpu_tpu_torch.ops.cuda import engine as teng

torch.set_num_threads(1)

DIMS = (4, 4, 2, 4)  # X, Y, Z, T — deliberately anisotropic


@pytest.fixture(scope="module")
def u0():
    cfg = RefConfig(group=3, dims=DIMS, beta=5.5, seed=1)
    return np.array(hot_start(cfg, jrng.make_base_key(1))
                    .astype(jnp.complex64))


def test_split_links_exact(u0):
    ref = peng.split_links(jnp.asarray(u0))
    got = teng.split_links(torch.from_numpy(u0))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_join_round_trip(u0):
    us = teng.split_links(torch.from_numpy(u0))
    back = teng.join_links(us, DIMS)
    # the stored rows come back exactly
    np.testing.assert_array_equal(back[:, :2].numpy(), u0[:, :2])
    # row 2 is rebuilt by the kernels' real-pair codec; the reference's
    # row 2 came from XLA's complex product, which rounds differently by
    # a few ulps (measured 1.2e-7 here)
    assert np.abs(back.numpy() - u0).max() < 2.5e-7
    # the port's own round trip is < 1e-7 (idempotent)
    again = teng.join_links(teng.split_links(back), DIMS)
    assert float((again - back).abs().max()) < 1e-7


def test_from_reference_both_forms(u0):
    us = teng.from_reference(u0, "cpu")
    packed = [np.asarray(a) for a in peng.split_links(jnp.asarray(u0))]
    adopted = teng.from_reference(tuple(packed), "cpu")
    for a, b, c in zip(us, adopted, packed):
        np.testing.assert_array_equal(a.numpy(), c)
        np.testing.assert_array_equal(b.numpy(), c)
        assert b.is_contiguous() and b.dtype == torch.float32


def test_packed_cold_start_exact():
    cfg = SimConfig(dims=DIMS)
    ref = peng.packed_cold_start(RefConfig(dims=DIMS))
    got = teng.packed_cold_start(cfg, "cpu")
    assert len(got) == 8
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # separate storage: the stages update arrays in place
    assert len({a.data_ptr() for a in got}) == 8


def test_packed_hot_start_matches():
    key = trng.make_base_key(1)
    ref = peng.packed_hot_start(RefConfig(dims=DIMS, seed=1),
                                jrng.make_base_key(1))
    got = teng.packed_hot_start(SimConfig(dims=DIMS, seed=1), key, "cpu")
    # Box–Muller log/cos may differ from XLA's by ulps
    for a, b in zip(got, ref):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-6


@pytest.mark.parametrize("parity", [0, 1])
def test_site_index_packed(parity):
    ref = np.asarray(pcore.site_index_packed(parity, DIMS))
    got = tcore.site_index_packed(parity, DIMS, torch.device("cpu"))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("axis,d", [(a, d) for a in range(4) for d in (1, -1)])
def test_neighbor_slots_match_dense_shift(u0, axis, d):
    """Gathering the direct neighbour slots from the packed field equals
    packing the dense field shifted by (axis, d)."""
    us = teng.split_links(torch.from_numpy(u0))
    shifted = teng.split_links(
        torch.from_numpy(np.roll(u0, -d, axis=3 + axis).copy()))
    for p in (0, 1):
        idx = tcore.neighbor_slots(p, DIMS, ((axis, d),), torch.device("cpu"))
        for mu in range(4):
            src = us[2 * mu + 1 - p].reshape(12, -1)
            want = shifted[2 * mu + p].reshape(12, -1)
            np.testing.assert_array_equal(src[:, idx].numpy(), want.numpy())


@pytest.mark.parametrize("parity", [0, 1])
def test_lattice_parity_and_site_index(parity):
    cpu = torch.device("cpu")
    np.testing.assert_array_equal(tlat.parity_mask(DIMS, parity, cpu).numpy(),
                                  np.asarray(jlat.parity_mask(DIMS, parity)))
    np.testing.assert_array_equal(tlat.site_index(DIMS, cpu).numpy(),
                                  np.asarray(jlat.site_index(DIMS), np.int64))
