"""The frozen reference against the port's plain path, and the frozen
yardstick against chip_smoke.py's, on the CPU."""

import numpy as np
import pytest
import torch

from portbench import yardstick
from portbench.reference import Reference
from qcdgpu_tpu_torch import SimConfig, Simulation
from qcdgpu_tpu_torch.models import BetaScan

SEED = 2 ** 31 + 77  # past 32 signed bits: seeds may be that large

CASES = {
    "threefry HB": dict(),
    "hw HB": dict(rng_mode="hw"),
    "HB + OR, kp tracked": dict(n_or=1, track_kp_exhaust=True),
    "Metropolis, acceptance tracked": dict(algorithm="metropolis",
                                           track_acceptance=True),
    "SU(2) HB + OR": dict(group=2, beta=2.4, n_or=1),
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", sorted(CASES))
def test_single_chain_matches_port(case):
    """Links bit for bit and rows within the Polyakov loop's association
    (the reference multiplies a column's links in t order, K4 and its
    plain twin by a ladder) after sweeps that reunitarize and measure."""
    cfg = SimConfig(**{**dict(group=3, dims=(4, 4, 4, 4), beta=6.0,
                              seed=SEED, reunit_every=2), **CASES[case]})
    sim = Simulation(cfg, device="cpu")
    ref = Reference(cfg.to_dict(), [cfg.beta], [cfg.seed], "cpu")
    us = ref.cold_start()
    sim.thermalize(2)
    ref.run(us, 0, 2, 0)
    assert all(torch.equal(a[0], b) for a, b in zip(us, sim.us))
    rows = sim.run(4, 2)
    want = ref.run(us, 2, 4, 2)
    assert all(torch.equal(a[0], b) for a, b in zip(us, sim.us))
    assert want.shape == (2, 1, rows.shape[1])
    np.testing.assert_allclose(want[:, 0], rows, rtol=0, atol=1e-7)


def test_scan_matches_port():
    cfg = SimConfig(group=3, dims=(4, 4, 4, 2), beta=5.9, n_or=2,
                    seed=SEED, reunit_every=2)
    betas = [5.6, 6.1]
    scan = BetaScan(cfg, betas, device="cpu")
    scan.thermalize(2)
    rows = scan.run(2, 1)
    ref = Reference(cfg.to_dict(), betas,
                    [cfg.seed + 1000 * c for c in range(2)], "cpu")
    us = ref.cold_start()
    ref.run(us, 0, 2, 0)
    want = ref.run(us, 2, 2, 1)
    assert all(torch.equal(a, b) for a, b in zip(us, scan.us))
    np.testing.assert_allclose(want.transpose(1, 0, 2), rows, rtol=0,
                               atol=1e-7)


def test_lowp_is_bfloat16_storage():
    cfg = SimConfig(group=3, dims=(4, 4, 4, 4), seed=SEED)
    ref = Reference(cfg.to_dict(), [6.0], [SEED], "cpu", lowp=True)
    us = ref.cold_start()
    ref.run(us, 0, 1, 0)
    for a in us:
        assert torch.equal(a, a.to(torch.bfloat16).to(torch.float32))


@pytest.mark.parametrize("dims", [(32, 32, 32, 32), (24, 24, 24, 6)])
def test_yardstick_is_chip_smokes(dims):
    """The frozen counts equal chip_smoke.work() for every stage kind and
    source, K2, K3 and K4, and the bound arithmetic equals its bound()."""
    import chip_smoke as cs

    for n in (3, 2):
        for kind, philox in (("heatbath", False), ("heatbath", True),
                             ("overrelax", False), ("metropolis", False),
                             ("metropolis", True)):
            name = f"stage_{kind}_su{n}" + ("_philox" if philox else "")
            for mu, parity in ((0, 0), (1, 0), (3, 1)):
                want = cs.work(name, dims, mu=mu, parity=parity)
                got = yardstick.stage_work(n, dims, kind,
                                           "hw" if philox else "threefry",
                                           mu=mu, parity=parity)
                assert got == tuple(want), name
                assert yardstick.bound(*got) == cs.bound(*want)
        assert yardstick.reunit_work(n, dims) == tuple(
            cs.work(f"reunit_su{n}", dims))
        plane, poly = yardstick.measure_work(n, dims)
        assert plane == tuple(cs.work(f"plane_sums_su{n}", dims))
        assert poly == tuple(cs.work(f"polyakov_sums_su{n}", dims))


def test_chains_multiply_work():
    one = yardstick.stage_work(3, (24, 24, 24, 6), "overrelax")
    eleven = yardstick.stage_work(3, (24, 24, 24, 6), "overrelax",
                                  chains=11)
    assert eleven == tuple(11 * v for v in one)
    # the bench's stage: every array read once, the target written once
    assert yardstick.bound_ms(yardstick.stage_work(
        3, (32,) * 4, "heatbath", "hw")) == pytest.approx(0.0676, abs=1e-4)
