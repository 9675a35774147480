"""rng_mode "hw" in the port: Philox-4x32-10 in place of the TPU's hardware
PRNG (ops/rng.py philox4x32, the plain twin of csrc/common.cuh and
csrc/stage_philox.cu).

The TPU's bits cannot be reproduced off a TPU (the reference calls its hw
stream "statistically equivalent, NOT bit-compatible"), so Philox is held
to Random123's known answers and, after tests/test_rng_parity.py, to
U(0,1) moments, a two-sample KS test against threefry and the
Kennedy-Pendleton w0 marginal it feeds.  The chains it drives keep the
port's invariants: chunking-, resume- and mesh-invariant, bit for bit.
"""

import warnings

import numpy as np
import pytest
import torch
from scipy import stats as sps

from qcdgpu_tpu_torch import SimConfig, Simulation
from qcdgpu_tpu_torch.ops import rng
from qcdgpu_tpu_torch.ops.cuda import engine
from qcdgpu_tpu_torch.ops.cuda import update as tupd

torch.set_num_threads(1)

M = 0xFFFFFFFF
# Random123's kat_vectors for philox4x32, 10 rounds: (key, counter, output)
KAT = [
    ((0, 0), (0, 0, 0, 0),
     (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M, M), (M, M, M, M),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0xA4093822, 0x299F31D0), (0x243F6A88, 0x85A308D3, 0x13198A2E,
                                0x03707344),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]
N_DRAWS = 1 << 18


@pytest.mark.parametrize("key,ctr,out", KAT)
def test_philox_known_answers(key, ctr, out):
    assert rng.philox4x32_host(*key, *ctr) == out
    # the tensor form, the counter words broadcast against a site axis
    c = [torch.tensor([v, v], dtype=torch.int64) for v in ctr]
    got = rng.philox4x32(*key, *c)
    assert [w.tolist() for w in got] == [[v, v] for v in out]


def test_slots_are_half_blocks():
    """Uniforms 2s, 2s+1 of a site are words 2(s&1), 2(s&1)+1 of block
    s >> 1 at counter (site, s >> 1, 0, 0)."""
    key, sites = (0x1234, 0xABCDEF), torch.tensor([0, 7, 4095])
    u = rng.site_uniforms_philox(key, sites, 10)
    for s in range(5):
        for i, site in enumerate(sites.tolist()):
            w = rng.philox4x32_host(*key, site, s >> 1, 0, 0)
            lo = 2 * (s & 1)
            want = rng.bits_to_uniform(torch.tensor(w[lo:lo + 2]))
            assert torch.equal(u[2 * s: 2 * s + 2, i], want)


def _uniforms(fn, n, seed):
    sidx = torch.arange((n + 15) // 16, dtype=torch.int64)
    return fn(rng.make_base_key(seed), sidx, 16).double().numpy().ravel()[:n]


def test_philox_moments_vs_theory():
    u = _uniforms(rng.site_uniforms_philox, N_DRAWS, 7)
    for k in (1, 2, 3, 4):
        err = np.sqrt((1.0 / (2 * k + 1) - 1.0 / (k + 1) ** 2) / len(u))
        assert abs(np.mean(u ** k) - 1.0 / (k + 1)) < 6.0 * err, k


def test_philox_ks_two_sample_vs_threefry():
    a = _uniforms(rng.site_uniforms, N_DRAWS, 11)
    b = _uniforms(rng.site_uniforms_philox, N_DRAWS, 13)
    assert sps.ks_2samp(a, b).pvalue > 1e-3


def _kp_w0(u, a_coef=2.9, k_trials=8):
    """Accepted w0 of the port's KP sampler (update.heatbath_flip) fed a
    flat uniform stream at a = 2.9 (SU(2) beta=2.4 equilibrium)."""
    per = 4 * k_trials + 2
    m = len(u) // per
    uu = torch.from_numpy(u[: m * per].astype(np.float32).reshape(per, m))
    q_w = (torch.full((m,), a_coef),) + (torch.zeros(m),) * 3
    flip, exhausted = tupd.heatbath_flip(q_w, 1.0, list(uu), k_trials,
                                         with_count=True)
    w0 = flip[0].numpy()
    return w0[w0 != 1.0], int(exhausted)


def test_kp_consumption_parity_vs_threefry():
    """The sampler's w0 marginal does not depend on the generator."""
    wa, _ = _kp_w0(_uniforms(rng.site_uniforms, 1 << 19, 17))
    wb, _ = _kp_w0(_uniforms(rng.site_uniforms_philox, 1 << 19, 19))
    assert len(wa) > 1000 and len(wb) > 1000
    assert sps.ks_2samp(wa, wb).pvalue > 1e-3


# --- chains -----------------------------------------------------------------

CHAINS = {
    "su3_heatbath": dict(group=3, beta=5.5),
    "su2_metropolis_acc": dict(group=2, beta=2.3, algorithm="metropolis",
                               track_acceptance=True),
}


def _cfg(name, **kw):
    return SimConfig(dims=(4, 4, 2, 4), seed=5, start="hot", reunit_every=2,
                     **{"rng_mode": "hw", **CHAINS[name], **kw})


@pytest.fixture(scope="module", params=sorted(CHAINS))
def hw_chain(request):
    """(name, series, links) of run(4) with rng_mode='hw'."""
    sim = Simulation(_cfg(request.param), device="cpu")
    obs = sim.run(4, 1)
    assert sim.unitarity_defect() < 1e-6
    return request.param, obs, tuple(a.clone() for a in sim.us)


def _same(us_a, us_b):
    return all(torch.equal(a, b) for a, b in zip(us_a, us_b))


def test_hw_chain_is_chunking_invariant(hw_chain):
    name, obs, us = hw_chain
    sim = Simulation(_cfg(name), device="cpu")
    obs2 = np.concatenate([sim.run(2, 1), sim.run(2, 1)])
    np.testing.assert_array_equal(obs2, obs)
    assert _same(sim.us, us)


def test_hw_sharded_chain_is_the_unsharded_chain(hw_chain):
    name, obs, us = hw_chain
    sim = Simulation(_cfg(name, mesh=(2, 1, 1, 1)), device="cpu")
    np.testing.assert_array_equal(sim.run(4, 1), obs)
    assert _same(sim.us, us)


def test_hw_differs_from_threefry(hw_chain):
    name, obs, us = hw_chain
    sim = Simulation(_cfg(name, rng_mode="threefry"), device="cpu")
    sim.run(4, 1)
    assert not _same(sim.us, us)


def test_hw_stage_refuses_a_stream_gen():
    cfg = SimConfig(dims=(4, 4, 2, 4))
    us = engine.packed_cold_start(cfg, "cpu")
    with pytest.raises(ValueError, match="Philox"):
        tupd.stage_update(us, 0, 0, 6.0, (1, 2), cfg.dims, gen="xor128",
                          rng_mode="hw")
    with pytest.raises(ValueError, match="rng_mode"):
        tupd.stage_update(us, 0, 0, 6.0, (1, 2), cfg.dims, rng_mode="bogus")


def test_philox_instances_are_counted():
    names = set(tupd.PHILOX_INSTANCES)
    assert len(names) == 8 and len(
        {n + "_shard" for n in names} & set(tupd.SHARD_INSTANCES)) == 8
    assert tupd.instance_name("metropolis", 2, True, philox=True,
                              shard=True) in tupd.LAUNCHES


# --- config: hw is accepted and refused as the reference does
# (tests/test_config.py:41-66) ------------------------------------------------


def test_hw_config_behaviour():
    with pytest.raises(ValueError, match="X/Y"):
        SimConfig(engine="pallas", dims=(8, 8, 8, 8), mesh=(1, 1, 2, 1),
                  rng_mode="hw")
    with pytest.raises(ValueError, match="rng_mode"):
        SimConfig(engine="xla", rng_mode="hw")
    # engine 'auto' runs the kernels (their plain versions on the CPU):
    # hw is Philox there, nothing to warn about
    for eng in ("auto", "pallas"):
        cfg = SimConfig(dims=(4, 4, 2, 4), rng_mode="hw", engine=eng)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            engine.make_chunk_runner(cfg, "cpu")
