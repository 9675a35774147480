"""The span recorder (utils/profile.py) on the CPU: off by default and
without effect on the chain, the span tree of a Simulation and of a
BetaScan, per-name totals, and the shared clock with torch.profiler's
Chrome trace."""

import json
import time

import numpy as np
import pytest
import torch

from qcdgpu_tpu_torch import SimConfig, Simulation
from qcdgpu_tpu_torch.models import BetaScan
from qcdgpu_tpu_torch.utils import profile

torch.set_num_threads(1)

# 4^4 SU(2) (the spans do not depend on N; its plain stages are cheaper),
# heat-bath + 1 OR, reunitarized on odd sweeps
CFG = SimConfig(group=2, dims=(4, 4, 4, 4), beta=2.4, seed=3, start="hot",
                reunit_every=2, n_or=1)
K = ("k1.stage", "k2.reunit", "k3.plane_sums", "k4.polyakov_sums")


def drive(sim):
    """Sweep 0 by thermalize, sweeps 1-2 by run(2, 1): two rows."""
    sim.thermalize(1)
    return sim.run(2, 1)


@pytest.fixture(scope="module")
def runs():
    """(links, rows) of a run with the recorder off, in which no span site
    calls the recorder, and (links, rows, recorder) of one with it on."""
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(profile, "begin", lambda *a: calls.append(a))
        mp.setattr(profile, "end", lambda *a: calls.append(a))
        off = Simulation(CFG, device="cpu")
        rows_off = drive(off)
    assert not profile.ON and calls == []
    on = Simulation(CFG, device="cpu")
    with profile.recording() as rec:
        assert profile.ON
        rows_on = drive(on)
    assert not profile.ON
    return (off.us, rows_off), (on.us, rows_on, rec)


def test_recorder_off_changes_no_bit(runs):
    (us_off, rows_off), (us_on, rows_on, _) = runs
    np.testing.assert_array_equal(rows_off, rows_on)
    for a, b in zip(us_off, us_on):
        assert torch.equal(a, b)


def children(spans, i, name=None):
    return [j for j, s in enumerate(spans)
            if s.parent == i and (name is None or s.name == name)]


def test_span_tree_of_a_simulation(runs):
    spans = runs[1][2].spans
    assert all(s.end is not None and s.start <= s.end for s in spans)
    top = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in top] == ["sim.thermalize", "sim.run"]
    therm, run = top
    assert [spans[j].sweep for j in children(spans, therm)] == [0]
    sweeps = children(spans, run, "runner.sweep")
    meas = children(spans, run, "runner.measure")
    assert [spans[j].sweep for j in sweeps] == [1, 2]
    assert [spans[j].sweep for j in meas] == [1, 2]
    assert len(children(spans, run, "sim.rows_to_host")) == 1
    assert len(children(spans, run)) == 5
    for j in children(spans, therm) + sweeps:
        names = [spans[c].name for c in children(spans, j)]
        reunit = spans[j].sweep % 2 == 1
        assert names == ["k1.stage"] * 16 + ["k2.reunit"] * (8 * reunit)
        assert all(spans[c].sweep == spans[j].sweep
                   for c in children(spans, j))
    for j in meas:
        assert [spans[c].name for c in children(spans, j)] == [
            "k3.plane_sums", "k4.polyakov_sums"]
    # a span lies inside its parent, and siblings follow one another
    for s in spans:
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end
    k = [s for s in spans if s.name in K]
    assert all(a.end <= b.start for a, b in zip(k, k[1:]))


def test_span_tree_of_a_beta_scan():
    scan = BetaScan(CFG.replace(n_or=0), [2.3, 2.5], device="cpu")
    with profile.recording() as rec:
        rows = scan.run(2, 1)
    assert rows.shape[:2] == (2, 2)
    spans = rec.spans
    (run,) = [i for i, s in enumerate(spans) if s.parent is None]
    assert spans[run].name == "sim.run"
    assert [spans[j].name for j in children(spans, run)] == [
        "runner.sweep", "runner.measure", "runner.sweep", "runner.measure",
        "sim.rows_to_host"]
    for j in children(spans, run, "runner.sweep"):
        # one K1c call a stage for both chains; sweep 1 reunitarizes
        names = [spans[c].name for c in children(spans, j)]
        assert names == ["k1.stage"] * 8 + ["k2.reunit"] * (
            8 * (spans[j].sweep == 1))
    for j in children(spans, run, "runner.measure"):
        assert [spans[c].name for c in children(spans, j)] == [
            "k3.plane_sums", "k4.polyakov_sums"]


def test_totals_and_self_time_with_a_fake_clock():
    clock = iter([0, 10, 15, 40, 100, 103, 200, 250, 260, 300, 320])
    with profile.recording(clock=lambda: next(clock)) as rec:
        profile.begin("runner.sweep", 7)   # 0
        profile.begin("k1.stage")          # 10
        profile.end("k1.stage")            # 15
        profile.end("runner.sweep")        # 40
        profile.begin("runner.sweep", 8)   # 100
        profile.begin("k1.stage")          # 103: raises, left open
        profile.end("runner.sweep")        # 200 closes both
        profile.end("k2.reunit")           # none open: nothing
        profile.begin("sim.save")          # 250
        profile.end("sim.save")            # 260
        profile.begin("sim.run")           # 300: open when recording ends
        with pytest.raises(RuntimeError, match="already on"):
            with profile.recording():
                pass
    # recording's end closed sim.run at 320
    spans = rec.spans
    assert [(s.name, s.start, s.end, s.parent, s.sweep) for s in spans] == [
        ("runner.sweep", 0, 40, None, 7), ("k1.stage", 10, 15, 0, 7),
        ("runner.sweep", 100, 200, None, 8), ("k1.stage", 103, 200, 2, 8),
        ("sim.save", 250, 260, None, None), ("sim.run", 300, 320, None,
                                             None)]
    tot = rec.totals()
    assert tot["runner.sweep"] == {"count": 2,
                                   "total_s": pytest.approx(140e-9),
                                   "self_s": pytest.approx(38e-9)}
    assert tot["k1.stage"] == {"count": 2, "total_s": pytest.approx(102e-9),
                               "self_s": pytest.approx(102e-9)}
    assert tot["sim.save"]["total_s"] == pytest.approx(10e-9)
    assert set(tot) == {"runner.sweep", "k1.stage", "sim.save", "sim.run"}
    assert not profile.ON


def test_trace_shares_the_profilers_clock(tmp_path):
    """Under trace(dir) the spans are in trace.json on the trace's clock:
    every aten op recorded during a call of run() lies inside its sim.run
    span, and each k1.stage span holds an op of the plain stage."""
    sim = Simulation(CFG.replace(n_or=0, reunit_every=0), device="cpu")
    with profile.trace(str(tmp_path)):
        assert profile.ON
        t0 = time.time_ns()
        sim.run(1, 1)
        t1 = time.time_ns()
    assert not profile.ON
    doc = json.loads((tmp_path / "trace.json").read_text())
    base = doc["baseTimeNanoseconds"]
    lo, hi = (t0 - base) / 1e3, (t1 - base) / 1e3
    ev = doc["traceEvents"]
    spans = [e for e in ev if "span" in e.get("args", {})]
    assert {e["name"] for e in spans} == {
        "sim.run", "runner.sweep", "runner.measure", "sim.rows_to_host",
        "k1.stage", "k3.plane_sums", "k4.polyakov_sums"}
    assert {e["tid"] for e in spans} == {1}
    assert any(e.get("ph") == "M" and e["args"].get("name") == profile.TRACK
               for e in ev)
    (run,) = [e for e in spans if e["name"] == "sim.run"]
    ops = [e for e in ev if e.get("cat") == "cpu_op"
           and e["name"].startswith("aten::") and lo <= e["ts"]
           and e["ts"] + e["dur"] <= hi]
    assert len(ops) > 100
    assert all(run["ts"] <= e["ts"] and e["ts"] + e["dur"]
               <= run["ts"] + run["dur"] for e in ops)
    stages = [e for e in spans if e["name"] == "k1.stage"]
    assert len(stages) == 8
    for s in stages:
        assert any(s["ts"] <= e["ts"] and e["ts"] + e["dur"]
                   <= s["ts"] + s["dur"] for e in ops)
