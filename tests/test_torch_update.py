"""The port's heat-bath stage (plain PyTorch version of the CUDA kernel)
against the JAX reference's XLA recipe (staple_sum + update_links +
parity_mask, as tests/test_pallas.py checks the Pallas stage).

Both draw bit-identical threefry uniforms for every site, so any
disagreement beyond f32 rounding order (< 2e-5 max |d link|) is a stencil,
addressing or draw-schedule bug.  On the CPU ``stage_update`` takes the
plain version; the kernel is held to the plain version on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.ops import rng as jrng
from qcdgpu_tpu.ops import samplers
from qcdgpu_tpu.ops.lattice import parity_mask, site_index
from qcdgpu_tpu.ops.samplers import update_links
from qcdgpu_tpu.ops.staples import staple_sum
from qcdgpu_tpu.sim import hot_start
from qcdgpu_tpu_torch.ops import fastmath as tfm
from qcdgpu_tpu_torch.ops import rng as trng
from qcdgpu_tpu_torch.ops.cuda import engine as teng
from qcdgpu_tpu_torch.ops.cuda import update as tupd

torch.set_num_threads(1)

DIMS = (4, 4, 2, 4)
BETA = 5.5


@pytest.fixture(scope="module")
def u0():
    cfg = RefConfig(group=3, dims=DIMS, beta=BETA, seed=1)
    return hot_start(cfg, jrng.make_base_key(1)).astype(jnp.complex64)


def _xla_stage(u, key2, parity, mu):
    new = update_links(u[mu], staple_sum(u, mu), "heatbath", BETA, key2,
                       site_index(DIMS), k_trials=4)
    return jnp.where(parity_mask(DIMS, parity), new, u[mu])


@pytest.mark.parametrize("parity,mu", [(0, 0), (1, 3), (0, 2)])
def test_stage_matches_xla(u0, parity, mu):
    key = trng.stage_key(trng.make_base_key(1), 0, 7)
    ref = _xla_stage(u0, jnp.asarray(np.array(key, np.uint32)), parity, mu)
    us = teng.from_reference(np.asarray(u0), "cpu")
    out = tupd.stage_update(us, mu, parity, BETA, key, DIMS)
    assert out is us[2 * mu + parity]  # in place
    got = teng.join_dir((us[2 * mu], us[2 * mu + 1]), DIMS, 3).numpy()
    assert np.abs(got - np.asarray(ref)).max() < 2e-5


def test_stage_touches_only_its_array(u0):
    us = teng.from_reference(np.asarray(u0), "cpu")
    before = [a.clone() for a in us]
    tupd.stage_update(us, 1, 1, BETA, (5, 6), DIMS)
    for k, (a, b) in enumerate(zip(us, before)):
        assert torch.equal(a, b) == (k != 3)


def test_heatbath_flip_matches_samplers():
    """The sampler alone, on the same quaternions and uniforms."""
    rs = np.random.default_rng(4)
    q = rs.standard_normal((4, 512)).astype(np.float32) * 2.0
    u = rs.uniform(1e-6, 1.0, (18, 512)).astype(np.float32)
    tbn = tupd.two_beta_over_n(BETA, 3)
    flip = jax.jit(samplers.heatbath_flip, static_argnums=3)
    ref = flip(jnp.asarray(q), jnp.float32(tbn), jnp.asarray(u), 4)
    got = tupd.heatbath_flip(tuple(torch.from_numpy(q)), tbn,
                             list(torch.from_numpy(u)), 4)
    np.testing.assert_allclose(torch.stack(got).numpy(), np.asarray(ref),
                               atol=2e-6)


def _kp_accepts(q, tbn, r):
    """Whether one Kennedy-Pendleton trial with uniforms r = (r1, r2, r3,
    r4) accepts at each site (the acceptance test of heatbath_flip)."""
    n2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]
    k = n2 * (1.0 / torch.sqrt(torch.clamp(n2, min=tfm.f32(1e-38))))
    inv2a = 1.0 / (2.0 * torch.clamp(tbn * k, min=tfm.f32(1e-10)))
    lam2 = -inv2a * (tfm.log_u01(r[0])
                     + tfm.cos2_2pi(r[1]) * tfm.log_u01(r[2]))
    return (r[3] * r[3]) <= (1.0 - lam2)


@pytest.mark.parametrize("scale,seed", [(0.05, 0), (0.3, 1), (2.0, 2)])
def test_heatbath_flip_ignores_trials_after_first_accept(scale, seed):
    """The kernels stop a site's trials at its first accepted one (and do
    not draw the rest from a counter-based source): heatbath_flip's
    multiplier and exhausted count must not change when every later
    trial's uniforms are replaced by fresh ones."""
    rs = np.random.default_rng(seed)
    sites, k_trials = 4096, 4
    q = tuple(torch.from_numpy(
        rs.standard_normal((4, sites)).astype(np.float32) * scale))
    u = list(torch.from_numpy(
        rs.uniform(1e-6, 1.0, (4 * k_trials + 2, sites)).astype(np.float32)))
    tbn = tupd.two_beta_over_n(BETA, 3)
    first = torch.full((sites,), k_trials)  # k_trials: none accepted
    for t in reversed(range(k_trials)):
        first = torch.where(_kp_accepts(q, tbn, u[4 * t: 4 * t + 4]), t,
                            first)
    # later trials decide some sites, and some sites have trials after
    # their deciding one
    assert ((first > 0) & (first < k_trials)).any()
    assert (first < k_trials - 1).any()
    fresh = torch.from_numpy(
        rs.uniform(1e-6, 1.0, (4 * k_trials, sites)).astype(np.float32))
    later = [torch.where(first < i // 4, fresh[i], u[i])
             for i in range(4 * k_trials)] + u[4 * k_trials:]
    ref, n_ref = tupd.heatbath_flip(q, tbn, u, k_trials, with_count=True)
    got, n_got = tupd.heatbath_flip(q, tbn, later, k_trials,
                                    with_count=True)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert int(n_got) == int(n_ref) == int((first == k_trials).sum())
    # the deciding trial itself does matter
    moved = [torch.where(first == i // 4, fresh[i], u[i])
             for i in range(4 * k_trials)] + u[4 * k_trials:]
    other = tupd.heatbath_flip(q, tbn, moved, k_trials)
    assert not all(torch.equal(a, b) for a, b in zip(other, ref))


def test_stage_refuses_bad_input(u0):
    us = teng.from_reference(np.asarray(u0), "cpu")
    with pytest.raises(ValueError):
        tupd.stage_update(us[:7], 0, 0, BETA, (1, 2), DIMS)
    with pytest.raises(ValueError):
        tupd.stage_update(tuple(a.double() for a in us), 0, 0, BETA, (1, 2),
                          DIMS)
    with pytest.raises(ValueError):
        tupd.stage_update(tuple(a.to("meta") for a in us), 0, 0, BETA,
                          (1, 2), DIMS)
    with pytest.raises(ValueError):  # SU(2) and SU(3) arrays mixed
        tupd.stage_update(us[:7] + (us[7][:, :2].contiguous(),), 0, 0,
                          BETA, (1, 2), DIMS)
    with pytest.raises(ValueError):  # an overrelaxation stage counts nothing
        tupd.stage_update(us, 0, 0, BETA, (1, 2), DIMS, kind="overrelax",
                          count=torch.zeros(1, dtype=torch.int64))
