"""The program's spans on a traced window (portbench/spans.py): the four
numbers on a synthetic trace, the existing readers unchanged by the merged
spans, the idle gaps named by them, a CPU run through the harness, and on
the card the spans holding the launches of their wrappers."""

import pytest
import torch

from portbench import spans, tracing, yardstick
from portbench.harness import load_reader
from portbench.tests.test_portbench_cells import ROOT, SEED0, WORKLOADS

READERS = ("stage_roofline", "measure_roofline", "sweep_roofline",
           "launches_per_sweep", "device_idle_share")


def span(name, ts, end, i, parent=None, sweep=None):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": end - ts, "pid": 1, "tid": 1,
            "args": {"span": i, "parent": parent, "sweep": sweep}}


def call(name, ts, end, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts,
            "dur": end - ts, "args": {"correlation": corr}}


def device(name, ts, end, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "args": {"correlation": corr}}


def cuda_events():
    """A 100 us window of one measured sweep: a stage kernel 18-40, the
    plane kernel 62-75 and its finish pass 75-80, a row copy 93-95, and a
    kernel after the window."""
    return [
        call("cudaLaunchKernel", 15, 18, 1),
        device("void qg::stage_kernel<3, 0>(...)", 18, 40, 1),
        call("cudaLaunchKernel", 60, 62, 2),
        device("void plane_sums_tile_kernel(...)", 62, 75, 2),
        call("cudaLaunchKernel", 64, 66, 3),
        device("void finish_sums_kernel(...)", 75, 80, 3),
        call("cudaMemcpyAsync", 92, 96, 4),
        device("Memcpy DtoH", 93, 95, 4, cat="gpu_memcpy"),
        device("void qg::stage_kernel<3, 0>(...)", 150, 160, 5),
    ]


def program_spans():
    return [
        span("sim.run", 0, 100, 0),
        span("runner.sweep", 2, 50, 1, 0, 5),
        span("k1.stage", 5, 20, 2, 1, 5),
        span("runner.measure", 50, 90, 3, 0, 5),
        span("k3.plane_sums", 55, 70, 4, 3, 5),
    ]


def test_the_four_numbers_on_a_synthetic_trace():
    sp = spans.Spans(cuda_events() + program_spans(), 0, 100)
    # sim.run 100 us less the runtime calls 3 + 2 + 2 + 4
    assert sp.host_us_per_sweep(1) == pytest.approx(89.0)
    assert sp.host_us_per_sweep(2) == pytest.approx(44.5)
    # k1 15 - 3, k3 15 - (2 + 2)
    assert sp.wrapper_us_per_launch() == pytest.approx(11.5)
    # idle 18 + 22 + 13 + 5 = 58 us, all inside sim.run; less the idle
    # time in runtime calls: 15-18, 60-62, 92-93, 95-96
    assert sp.host_loop_idle_share() == pytest.approx(51.0)
    # plane 13 + finish 5 of 22 + 13 + 5 + 2 device us
    assert sp.measure_device_share() == pytest.approx(100 * 18 / 42)
    assert sp.launch_check() == (1.0, 2)
    # each span less its children and the runtime calls left: they add up
    # to host_us_per_sweep's 89
    assert sp.own_us() == pytest.approx({
        "sim.run": 8.0, "runner.sweep": 33.0, "k1.stage": 12.0,
        "runner.measure": 25.0, "k3.plane_sums": 11.0})


def test_idle_outside_spans_and_in_runtime_calls_is_not_the_host_loop():
    ev = cuda_events() + [span("sim.run", 10, 60, 0)]
    # idle in sim.run: 10-18 (less 15-18) and 40-60 (less none)
    assert spans.Spans(ev, 0, 100).host_loop_idle_share() == pytest.approx(
        25.0)


def test_numbers_are_none_without_spans_or_device_events():
    assert all(v is None for v in
               spans.Spans(cuda_events(), 0, 100).numbers(1).values())
    host_only = [e for e in cuda_events() if e["cat"] == "cuda_runtime"]
    assert all(v is None for v in spans.Spans(
        host_only + program_spans(), 0, 100).numbers(1).values())


def test_union_covered_and_contains():
    u = spans.Union([(0, 10), (5, 12), (20, 30), (40, 41)])
    assert u.iv == [[0, 12], [20, 30], [40, 41]]
    assert u.covered(-5, 100) == 23
    assert u.covered(2, 25) == 15
    assert u.covered(12, 20) == 0
    assert u.covered(25, 40.5) == 5.5
    assert u.covered(3, 3) == 0
    assert u.contains(0) and not u.contains(12) and u.contains(29.9)
    assert not u.contains(-1) and not u.contains(50)
    assert u.intersect(spans.Union([(8, 22), (35, 45)])).iv == [
        [8, 12], [20, 22], [40, 41]]


def test_merged_spans_leave_the_readers_and_name_the_gaps():
    cfg = {"group": 3, "dims": (32, 32, 32, 32), "algorithm": "heatbath",
           "n_or": 0, "rng_mode": "threefry", "kp_trials": 4, "n_hit": 3}

    def ctx(events):
        return {"trace": tracing.Trace(events, 0, 100), "sweeps": 1,
                "chains": 1, "measurements": 1, "reunits": 0, "cfg": cfg,
                "yardstick": yardstick}

    plain, merged = ctx(cuda_events()), ctx(cuda_events() + program_spans())
    for name in READERS:
        read = load_reader(ROOT / "portbench" / "metrics" / f"{name}.py")
        assert read(merged) == read(plain) is not None, name
    assert merged["trace"].top_ops() == plain["trace"].top_ops()
    gaps = dict(merged["trace"].idle_gaps())
    # gap middles 9, 51, 86.5, 97.5: the innermost span or call there
    assert gaps == {"k1.stage": pytest.approx(18e-6),
                    "runner.measure": pytest.approx(35e-6),
                    "sim.run": pytest.approx(5e-6)}
    assert "host outside any traced call" in dict(plain["trace"].idle_gaps())


def test_traced_run_on_the_cpu():
    """The harness's traced branch with the recorder on, at 4^4 on the
    CPU: the spans reach the result, the numbers read nothing (no device
    event), and the recorder is off again."""
    from qcdgpu_tpu_torch.utils import profile

    over = {"sweeps_therm": 2, "dims": (4, 4, 4, 4),
            "traffic": {"chunk_sweeps": 3, "trace_sweeps": 3}}
    rec, _ = spans.traced_run("su3_32.hb_threefry_meas1", SEED0,
                              device="cpu", overrides=over,
                              log=lambda *a: None)
    assert rec["correct"] and not profile.ON
    out = rec["spans"]
    t = out["totals"]
    # the checked chunk, split into run(1, 1) and run(2, 1)
    assert t["sim.run"]["count"] == 2 and t["sim.rows_to_host"]["count"] == 2
    assert t["runner.sweep"]["count"] == t["runner.measure"]["count"] == 3
    assert t["k1.stage"]["count"] == 24
    assert t["k3.plane_sums"]["count"] == t["k4.polyakov_sums"]["count"] == 3
    assert out["wrapper_spans"] == sum(t[k]["count"] for k in spans.WRAPPERS
                                       if k in t)
    assert out["launches"] == 0  # the plain versions on the CPU
    assert out["host_us_per_sweep"] is None


@pytest.mark.card
@pytest.mark.parametrize("workload", WORKLOADS)
def test_wrapper_spans_hold_their_launches_on_the_card(workload):
    """At 16^4: at least 99 % of the K1-K4 kernels were launched, by the
    midpoint of their runtime call, inside a span of their wrapper, and
    the window holds one wrapper span per LAUNCHES count."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    over = {"sweeps_therm": 20, "dims": (16, 16, 16, 16)}
    rec, checks = spans.traced_run(workload, SEED0, overrides=over,
                                   log=lambda *a: None)
    assert rec["correct"], checks
    out = rec["spans"]
    assert out["launch_share_in_span"] >= 0.99, out
    assert out["wrapper_spans"] == out["launches"] > 0, out
    assert out["host_us_per_sweep"] > 0 and out["wrapper_us_per_launch"] > 0
    assert out["host_loop_idle_share"] is not None
