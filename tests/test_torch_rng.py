"""qcdgpu_tpu_torch.ops.rng / fastmath against the JAX reference.

Threefry, the host key derivation and the site uniforms must be
bit-identical.  The fastmath polynomials are held to BIT equality with the
reference's eager (op-by-op) evaluation on every 97th point of the 2**24
uniform grid: both evaluate the same f32 operations in the same order.
(A jitted XLA:CPU evaluation may contract multiply-adds and then differs
by a few ulps of the result's magnitude; the port's CUDA kernels are built
with -fmad=false to keep the uncontracted order.)
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from qcdgpu_tpu.ops import fastmath as jfm
from qcdgpu_tpu.ops import rng as jrng
from qcdgpu_tpu_torch.ops import fastmath as tfm
from qcdgpu_tpu_torch.ops import rng as trng

torch.set_num_threads(1)


def _u32(rs, n):
    return rs.integers(0, 1 << 32, size=n, dtype=np.uint64).astype(np.uint32)


def test_threefry_bit_identical():
    rs = np.random.default_rng(0)
    k0, k1, x0, x1 = (_u32(rs, 100_000) for _ in range(4))
    r0, r1 = jrng.threefry2x32(k0, k1, x0, x1)
    t = [torch.from_numpy(a.astype(np.int64)) for a in (k0, k1, x0, x1)]
    g0, g1 = trng.threefry2x32(*t)
    np.testing.assert_array_equal(g0.numpy(), np.asarray(r0, np.int64))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(r1, np.int64))


@pytest.mark.parametrize("seed", [0, 1, 7, 2**40 + 5])
def test_host_keys_bit_identical(seed):
    ref = np.asarray(jrng.make_base_key(seed))
    got = trng.make_base_key(seed)
    assert got == tuple(int(v) for v in ref)
    for sweep, stage in ((0, 0), (3, 7), (123456, 0xF1)):
        ref_s = np.asarray(jrng.stage_key(jnp.asarray(ref), sweep, stage))
        assert trng.stage_key(got, sweep, stage) == tuple(int(v) for v in ref_s)


def test_site_uniforms_bit_identical():
    key = trng.stage_key(trng.make_base_key(3), 5, 2)
    sidx = np.arange(4096, dtype=np.uint32).reshape(16, 256)
    ref = jrng.site_uniforms(jnp.asarray(np.array(key, np.uint32)),
                             jnp.asarray(sidx), 18, slot0=3)
    got = trng.site_uniforms(key, torch.from_numpy(sidx.astype(np.int64)),
                             18, slot0=3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _grid():
    h = np.arange(0, 1 << 24, 97).astype(np.float32)
    return ((h + np.float32(0.5)) * np.float32(1.0 / (1 << 24))).astype(
        np.float32)


@pytest.mark.parametrize("name", ["log_u01", "cos2_2pi", "sin", "cos"])
def test_fastmath_bit_identical(name):
    u = _grid()
    ut, uj = torch.from_numpy(u), jnp.asarray(u)
    if name in ("sin", "cos"):
        i = 0 if name == "sin" else 1
        got, ref = tfm.sincos_2pi(ut)[i], jfm.sincos_2pi(uj)[i]
    else:
        got, ref = getattr(tfm, name)(ut), getattr(jfm, name)(uj)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref, np.float32))
