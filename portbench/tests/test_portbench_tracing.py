"""The trace reduction and the per-layer readers on a synthetic trace."""

import re

import pytest

from portbench import tracing, yardstick
from portbench.harness import load_reader
from portbench.tests.test_portbench_cells import ROOT


def synthetic():
    """A 100 us window: a stage kernel 10-40, a copy 35-50 (overlapping),
    a measurement kernel 60-70; the host in a launch call 50-60."""
    return [
        {"name": "void qg::stage_kernel<3, 0, false>(...)", "cat": "kernel",
         "ts": 10, "dur": 30},
        {"name": "Memcpy DtoH", "cat": "gpu_memcpy", "ts": 35, "dur": 15},
        {"name": "void plane_sums_tile_kernel(...)", "cat": "kernel",
         "ts": 60, "dur": 10},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 50,
         "dur": 10},
        {"name": "aten::copy_", "cat": "cpu_op", "ts": 0, "dur": 10},
        {"name": "outside", "cat": "kernel", "ts": 150, "dur": 10},
    ]


def test_union_idle_and_breakdown():
    tr = tracing.Trace(synthetic(), 0, 100)
    assert tr.window_ms == pytest.approx(0.1)
    assert tr.busy_ms == pytest.approx(0.05)  # [10, 50) and [60, 70)
    assert tr.device_ms() == pytest.approx(0.055)  # summed, not merged
    assert tr.count() == 3
    assert tr.top_ops(2)[0] == ["void qg::stage_kernel<3, 0, false>(...)",
                                pytest.approx(30e-6)]
    gaps = dict(tr.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(10e-6)
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["host outside any traced call"] == pytest.approx(30e-6)


def test_readers():
    cfg = {"group": 3, "dims": (32, 32, 32, 32), "algorithm": "heatbath",
           "n_or": 0, "rng_mode": "hw", "kp_trials": 4, "n_hit": 3}
    ctx = {"trace": tracing.Trace(synthetic(), 0, 100), "sweeps": 1, "chains": 1,
           "measurements": 1, "reunits": 0, "cfg": cfg,
           "yardstick": yardstick}
    read = {name: load_reader(ROOT / "portbench" / "metrics" / f"{name}.py")
            for name in ("stage_roofline", "measure_roofline",
                         "sweep_roofline", "launches_per_sweep",
                         "device_idle_share")}
    stage = 8 * 0.0676
    assert read["stage_roofline"](ctx) == pytest.approx(
        100 * stage / 0.030, rel=1e-3)
    meas = yardstick.measure_ms(cfg)
    assert read["measure_roofline"](ctx) == pytest.approx(
        100 * meas / 0.010)
    assert read["sweep_roofline"](ctx) == pytest.approx(
        100 * (yardstick.sweep_stages_ms(cfg) + meas) / 0.1)
    assert read["launches_per_sweep"](ctx) == 3
    assert read["device_idle_share"](ctx) == pytest.approx(50.0)
    # a trace with no device event reads nothing, never 0
    empty = dict(ctx, trace=tracing.Trace(synthetic()[4:6], 0, 100))
    assert all(r(empty) is None for r in read.values())
    assert re.search("stage", "void qg::stage_chains_kernel<3>")
