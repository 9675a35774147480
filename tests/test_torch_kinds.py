"""Overrelaxation, Metropolis and the tracked counts of the port's SU(3)
stage (plain PyTorch version of the CUDA kernel) against the JAX
reference's XLA recipe, and the SU(3) slice configurations as a whole.

The reference's sampler ``samplers.update_links`` is compiled once per
(kind, tracking) and its staple sum once per direction; the XLA engine's
own sweep (``sim.make_sweep_fn``) and measurement (``make_measure_fn``) then
run op by op on top of them.  Compiling the engine's fused chunk instead
costs 15-45 s per configuration on a CPU.  Both sides draw bit-identical
threefry uniforms, so any disagreement beyond f32 rounding order is a
stencil, addressing, draw-schedule or sampler bug.
"""

from functools import lru_cache, partial

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import qcdgpu_tpu.sim as jsim
from qcdgpu_tpu.config import SimConfig as RefConfig
from qcdgpu_tpu.ops import rng as jrng
from qcdgpu_tpu.ops import samplers
from qcdgpu_tpu.ops.lattice import parity_mask, site_index
from qcdgpu_tpu.ops.measure import make_measure_fn
from qcdgpu_tpu.ops.measure import obs_names as ref_obs_names
from qcdgpu_tpu.ops.staples import staple_sum
from qcdgpu_tpu_torch import SimConfig, Simulation
from qcdgpu_tpu_torch.ops import rng as trng
from qcdgpu_tpu_torch.ops import sun as tsun
from qcdgpu_tpu_torch.ops.cuda import core as tcore
from qcdgpu_tpu_torch.ops.cuda import engine as teng
from qcdgpu_tpu_torch.ops.cuda import update as tupd

torch.set_num_threads(1)

DIMS = (4, 4, 2, 4)
BETA = 6.0
CPU = torch.device("cpu")


@lru_cache(maxsize=None)
def _sampler(kind, beta, k_trials, n_hit, metro_delta, return_acc):
    return jax.jit(partial(samplers.update_links, kind=kind, beta=beta,
                           k_trials=k_trials, n_hit=n_hit,
                           metro_delta=metro_delta, return_acc=return_acc))


def update_links(u_mu, staples, kind, beta, key2, site_idx, *, k_trials=4,
                 n_hit=3, metro_delta=0.35, return_acc=False):
    """samplers.update_links, compiled once per static argument set."""
    return _sampler(kind, beta, k_trials, n_hit, metro_delta, return_acc)(
        u_mu, staples, key2=key2, site_idx=site_idx)


staples_jit = jax.jit(staple_sum, static_argnums=1)


def numpy_sun(n, dims, seed):
    """Random SU(N) field [4, N, N, *dims] (complex64) from numpy normals,
    projected by the port's reunitarize."""
    rs = np.random.default_rng(seed)
    shape = (4, n, n) + tuple(dims)
    g = rs.standard_normal(shape) + 1j * rs.standard_normal(shape)
    g = torch.from_numpy(g.astype(np.complex64))
    return torch.stack([tsun.reunitarize(g[m]) for m in range(4)]).numpy()


def xla_stage(u, key, parity, mu, kind, beta, dims, return_acc=False):
    new = update_links(u[mu], staples_jit(u, mu), kind, beta,
                       jnp.asarray(np.array(key, np.uint32)),
                       site_index(dims), return_acc=return_acc)
    if return_acc:
        new = new[0]
    return np.asarray(jnp.where(parity_mask(dims, parity), new, u[mu]))


def port_stage(u0, key, parity, mu, kind, beta, dims):
    n = u0.shape[1]
    us = teng.from_reference(u0, "cpu")
    out = tupd.stage_update(us, mu, parity, beta, key, dims, kind=kind)
    assert out is us[2 * mu + parity]  # in place
    return teng.join_dir((us[2 * mu], us[2 * mu + 1]), dims, n).numpy()


def reference_rows(monkeypatch, kw, u0, n_sweeps):
    """The XLA engine's series rows for run(n_sweeps, 1) from u0: its sweep
    and measurement, the tracked rate appended as the reference runner
    does."""
    monkeypatch.setattr(jsim, "update_links", update_links)
    monkeypatch.setattr(jsim, "staple_sum", staples_jit)
    cfg = RefConfig(**kw, engine="xla")
    with_acc = cfg.track_acceptance or cfg.track_kp_exhaust
    sweep = jsim.make_sweep_fn(cfg, with_acc=with_acc)
    meas = make_measure_fn(cfg)
    key = jrng.make_base_key(cfg.seed)
    u, rows = jnp.asarray(u0), []
    for i in range(n_sweeps):
        u = sweep(u, key, i)
        if with_acc:
            u, rate = u
        row = np.asarray(meas(u))
        rows.append(np.append(row, np.float32(rate)) if with_acc else row)
    return np.stack(rows)


def check_slice(monkeypatch, kw, u0, rate_atol):
    """The port's Simulation (CPU) against the reference for 2 sweeps."""
    ref = reference_rows(monkeypatch, kw, u0, 2)
    sim = Simulation(SimConfig(**kw), init_u=u0, device="cpu")
    obs = sim.run(2, 1)
    assert sim.obs_names == tuple(ref_obs_names(RefConfig(**kw)))
    assert obs.shape == ref.shape == (2, len(sim.obs_names))
    # first block: rounding-order lockstep (tests/test_pallas.py:160-172)
    np.testing.assert_allclose(obs[0, :4], ref[0, :4], atol=5e-5)
    np.testing.assert_allclose(obs[0, 4:6], ref[0, 4:6], atol=2e-4)
    # later blocks: an accept flip at a rounding boundary may diverge the
    # chains pointwise; bound it to a few links' worth
    np.testing.assert_allclose(obs[:, :6], ref[:, :6], atol=1e-2)
    if obs.shape[1] > 6:
        # the port counts the active parity's sites (as the Pallas engine
        # does), the XLA engine all sites: equal in distribution only
        assert np.all((obs[:, 6] >= 0) & (obs[:, 6] <= 1))
        np.testing.assert_allclose(obs[:, 6], ref[:, 6], atol=rate_atol)
    assert sim.unitarity_defect() < 1e-5


@pytest.fixture(scope="module")
def u0():
    return numpy_sun(3, DIMS, seed=3)


@pytest.mark.parametrize("kind,parity,mu", [
    ("overrelax", 0, 1), ("overrelax", 1, 3),
    ("metropolis", 0, 0), ("metropolis", 1, 2),
])
def test_stage_matches_xla(u0, kind, parity, mu):
    key = trng.stage_key(trng.make_base_key(1), 0, 9)
    ref = xla_stage(u0, key, parity, mu, kind, BETA, DIMS,
                    return_acc=kind == "metropolis")
    got = port_stage(u0, key, parity, mu, kind, BETA, DIMS)
    assert np.abs(got - ref).max() < 2e-5
    # the stage really moved the active links
    assert np.abs(got - u0[mu]).max() > 1e-3


def test_overrelax_flip_matches_samplers():
    rs = np.random.default_rng(5)
    q = rs.standard_normal((4, 512)).astype(np.float32) * 2.0
    q[:, :3] = 0.0  # the degenerate-staple branch (identity)
    ref = jax.jit(samplers.overrelax_flip)(jnp.asarray(q))
    got = tupd.overrelax_flip(tuple(torch.from_numpy(q)))
    np.testing.assert_allclose(torch.stack(got).numpy(), np.asarray(ref),
                               atol=2e-6)


@pytest.mark.parametrize("n", [2, 3])
def test_metropolis_flip_matches_samplers(n):
    """The sampler alone, with its accepted-hit count against the
    reference's accepted fraction."""
    rs = np.random.default_rng(6)
    q = rs.standard_normal((4, 512)).astype(np.float32) * 2.0
    u = rs.uniform(1e-6, 1.0, (12, 512)).astype(np.float32)
    tbn = tupd.two_beta_over_n(BETA, n)
    flip = jax.jit(partial(samplers.metropolis_flip, n_hit=3, delta=0.35,
                           with_acc=True))
    ref, frac = flip(jnp.asarray(q), jnp.float32(tbn), jnp.asarray(u))
    got, cnt = tupd.metropolis_flip(tuple(torch.from_numpy(q)), tbn,
                                    list(torch.from_numpy(u)), 3, 0.35,
                                    with_count=True)
    np.testing.assert_allclose(torch.stack(got).numpy(), np.asarray(ref),
                               atol=2e-6)
    assert abs(int(cnt) - float(frac) * 512 * 3) <= 1


def reference_count(us, mu, parity, kind, key, k_trials):
    """The stage's tracked count from the reference's samplers, fed the
    active parity's quaternions (the port's staple recipe, held to the XLA
    one above) and the stage's threefry uniforms (bit-identical to the
    reference's, tests/test_torch_rng.py)."""
    n = us[0].shape[1]
    ld = tcore.LinkLoader(us, parity, DIMS, n)
    _, w = tupd.staple_W(ld, mu)
    sidx = tcore.site_index_packed(parity, DIMS, CPU).reshape(-1)
    per = tupd.uniforms_per_subgroup(kind, k_trials, 3)
    per_slots = (per + 1) // 2
    sgs = tupd.SUBGROUPS[n]
    u_all = trng.site_uniforms(key, sidx, 2 * per_slots * len(sgs)).numpy()
    tbn = jnp.float32(tupd.two_beta_over_n(BETA, n))
    total = 0.0
    for s, (i, j) in enumerate(sgs):
        q = jnp.asarray(torch.stack(tupd.quat_from_block(w, i, j)).numpy())
        uu = jnp.asarray(u_all[2 * per_slots * s: 2 * per_slots * s + per])
        if kind == "metropolis":
            flip, frac = samplers.metropolis_flip(q, tbn, uu, 3, 0.35,
                                                  with_acc=True)
            total += float(frac) * sidx.numel() * 3
        else:
            flip, frac = samplers.heatbath_flip(q, tbn, uu, k_trials,
                                                with_fail=True)
            total += float(frac) * sidx.numel()
        flip = tuple(torch.from_numpy(np.array(flip[c])) for c in range(4))
        w = tupd.subgroup_left_mul(flip, i, j, w)
    return total


@pytest.mark.parametrize("kind,k_trials,n", [
    ("metropolis", 4, 3), ("heatbath", 1, 3),
    ("metropolis", 4, 2), ("heatbath", 1, 2),
])
def test_tracked_count_matches_samplers(u0, kind, k_trials, n):
    """Accepted hits / KP exhaustions of one stage (K=1, so that the
    heat-bath exhausts at a visible rate), within +-1 of the reference
    samplers' fraction times the trial count."""
    key = trng.stage_key(trng.make_base_key(2), 3, 4)
    us = teng.from_reference(u0 if n == 3 else numpy_sun(2, DIMS, 8), "cpu")
    want = reference_count(us, 2, 1, kind, key, k_trials)
    count = torch.zeros(1, dtype=torch.int64)
    tupd.stage_update(us, 2, 1, BETA, key, DIMS, k_trials, kind=kind,
                      count=count)
    assert int(count) > 0
    assert abs(int(count) - want) <= 1
    # a second stage adds to the same counter
    before = int(count)
    tupd.stage_update(us, 0, 0, BETA, key, DIMS, k_trials, kind=kind,
                      count=count)
    assert int(count) > before


def test_tracked_stat_denom():
    """The per-sweep denominators of reference ops/pallas/update.py."""
    vol2 = int(np.prod(DIMS)) // 2
    kp = SimConfig(dims=DIMS, track_kp_exhaust=True)
    acc = SimConfig(dims=DIMS, algorithm="metropolis", n_hit=2,
                    track_acceptance=True)
    su2 = SimConfig(group=2, dims=DIMS, algorithm="metropolis",
                    track_acceptance=True)
    assert teng.tracked_stat_denom(kp, DIMS) == 8 * vol2 * 3
    assert teng.tracked_stat_denom(acc, DIMS) == 8 * vol2 * 2 * 3
    assert teng.tracked_stat_denom(su2, DIMS) == 8 * vol2 * 3 * 1
    assert teng.tracked_stat_denom(SimConfig(dims=DIMS), DIMS) == 1.0


def test_slice_hb_or_kp_exhaust(monkeypatch, u0):
    """Slice configuration 1 at small dims: SU(3) heat-bath + 1
    overrelaxation, track_kp_exhaust."""
    kw = dict(group=3, dims=DIMS, beta=BETA, n_or=1, track_kp_exhaust=True,
              seed=7, reunit_every=2)
    check_slice(monkeypatch, kw, u0, rate_atol=5e-3)


def test_slice_metropolis_acceptance(monkeypatch, u0):
    """Slice configuration 2 at small dims: SU(3) Metropolis, n_hit=3,
    metro_delta=0.35, track_acceptance."""
    kw = dict(group=3, dims=DIMS, beta=BETA, algorithm="metropolis",
              n_hit=3, metro_delta=0.35, track_acceptance=True, seed=7,
              reunit_every=2)
    check_slice(monkeypatch, kw, u0, rate_atol=0.05)
