"""The N_t = 8 scan cell (scan_32x8.hb2or_meas1): the port against the
reference from seeded hot links at T = 8, the readers the cell lists on a
chain trace, and, on the card, K3c's tile form over chains and K4c at
T/2 = 4 against the single-chain kernels.  The parametrised tests of
test_portbench_cells.py and test_portbench_control.py run the cell through
the harness, sound and with each fault."""

import numpy as np
import pytest
import torch

from portbench import harness, tracing, yardstick
from portbench.cells import load_cell
from portbench.reference import Reference
from portbench.tests.test_portbench_cells import ROOT, SEED0
from qcdgpu_tpu_torch import SimConfig
from qcdgpu_tpu_torch.models import BetaScan
from qcdgpu_tpu_torch.ops import rng
from qcdgpu_tpu_torch.ops.cuda import engine
from qcdgpu_tpu_torch.ops.cuda import measure as cmeasure

CELL = "scan_32x8.hb2or_meas1"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_hot_links_match_reference():
    """From seeded hot links at T = 8, the scan's links after two measured
    sweeps (a reunitarization among them) are the reference's bit for
    bit, and its rows within the Polyakov loop's association."""
    seed = 2 ** 31 + 303
    cfg = SimConfig(group=3, dims=(4, 4, 4, 8), beta=6.06, n_or=2,
                    start="hot", seed=seed, reunit_every=2)
    betas = [5.96, 6.16]
    scan = BetaScan(cfg, betas, device="cpu")
    ref = Reference(cfg.to_dict(), betas,
                    [seed + 1000 * c for c in range(len(betas))], "cpu")
    us = ref.adopt(scan.us)
    assert not all(torch.equal(a, b) for a, b in zip(us, ref.cold_start()))
    rows = scan.run(2, 1)
    want = ref.run(us, 0, 2, 1)
    assert all(torch.equal(a, b) for a, b in zip(us, scan.us))
    np.testing.assert_allclose(want.transpose(1, 0, 2), rows, rtol=0,
                               atol=1e-7)


def test_readers_on_a_synthetic_chain_trace():
    """The accepted readers the cell lists read the scan's chain kernels:
    stage_roofline the K1c launches, measure_roofline K3c, K4c and the
    finish pass, each bound times the chain count; the others the whole
    window."""
    cell = load_cell(ROOT, CELL)
    cfg = SimConfig(**cell.sim_fields(SEED0)).to_dict()

    def ev(name, ts, dur, cat="kernel"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [ev("void qg::stage_chains_kernel<3, 0, false>", 0, 4000),
              ev("qg::reunit_su3_kernel(float*, int, long)", 4000, 300),
              ev("void qg::plane_sums_tile_kernel<3, false>", 4300, 500),
              ev("qg::finish_sums_kernel(double const*, ...)", 4800, 20),
              ev("void qg::polyakov_sums_kernel<3, qg::Dims>", 4820, 100),
              ev("void at::native::vectorized_elementwise_kernel", 4920, 80),
              ev("Memcpy DtoH (Device -> Pageable)", 5000, 500,
                 "gpu_memcpy")]
    ctx = {"trace": tracing.Trace(events, 0, 6000), "sweeps": 1,
           "chains": 11, "measurements": 1, "reunits": 1, "cfg": cfg,
           "yardstick": yardstick}
    read = {m["name"]: harness.load_reader(cell.metrics_dir
                                           / f"{m['name']}.py")
            for m in cell.per_layer}
    assert set(read) == {"stage_roofline", "measure_roofline",
                         "sweep_roofline", "launches_per_sweep",
                         "device_idle_share"}
    stages = yardstick.sweep_stages_ms(cfg, 11)
    meas = yardstick.measure_ms(cfg, 11)
    assert read["stage_roofline"](ctx) == pytest.approx(100 * stages / 4.0)
    assert read["measure_roofline"](ctx) == pytest.approx(
        100 * meas / 0.62)
    assert read["sweep_roofline"](ctx) == pytest.approx(
        100 * (stages + yardstick.reunit_ms(cfg, 11) + meas) / 6.0)
    assert read["launches_per_sweep"](ctx) == 7
    assert read["device_idle_share"](ctx) == pytest.approx(
        100 * (1 - 5.5 / 6.0))


@pytest.mark.card
def test_tile_over_chains_is_single_chain_tile():
    """At 8 x 8 x 32 x 8 (Z T/2 = 128: the tile kernel) K3c over 3 chains
    gives each chain's K3 plane sums bit for bit, and launches
    plane_sums_tile_kernel; K4c at T/2 = 4 each chain's K4 sums."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    from torch.profiler import ProfilerActivity, profile

    dims = (8, 8, 32, 8)
    assert cmeasure.tile_fits(dims)
    cfg = SimConfig(group=3, dims=dims, beta=6.0, start="hot")
    keys = [rng.make_base_key(2 ** 31 + 11 + 1000 * c) for c in range(3)]
    us = engine.packed_hot_start_chains(cfg, keys, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sums = cmeasure.plane_sums_chains(us, dims)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()}
    assert any("plane_sums_tile_kernel" in n for n in names), sorted(names)
    poly = cmeasure.polyakov_sums_chains(us, dims)
    for c in range(3):
        one = tuple(a[c] for a in us)
        assert torch.equal(sums[c], cmeasure.plane_sums(one, dims))
        assert torch.equal(poly[c], cmeasure.polyakov_sums(one, dims))
