"""BENCHMARK.json and the files of every cell: they parse, keep to the
contract's shapes, and a cell is added from files alone."""

import io
import json
import re
import shutil
from pathlib import Path

import pytest
import torch

from portbench import harness
from portbench.cells import load_cell
from qcdgpu_tpu_torch import SimConfig

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED0 = 2147483650  # its checked chunk is the first (random.Random)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in names
            names.add(e["name"])
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"] for m in BENCH["end_to_end"]} == {
        "link_updates_per_s", "setup_s"}
    for m in BENCH["per_layer"]:
        assert m["moves"] == "link_updates_per_s"
        assert set(m["workloads"]) <= set(WORKLOADS)
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(WORKLOADS) // 4)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_cell_parses(workload):
    cell = load_cell(ROOT, workload)
    fields = cell.sim_fields(SEED0)
    SimConfig(**fields)
    conf = {c["name"]: c for c in BENCH["configs"]}[workload.split(".")[0]]
    assert cell.config["source"] == conf["source"]
    assert sorted(cell.config["reduced"]) == sorted(conf["reduced"])
    assert cell.traffic["entry"] in ("run", "thermalize")
    assert cell.traffic["chunk_sweeps"] > cell.traffic["check_sweeps"]
    assert cell.traffic["chunk_sweeps"] % 10 == 0  # chunks keep reunit
    me = fields.get("meas_every", 0) if cell.traffic["entry"] == "run" else 0
    if me:
        assert cell.traffic["chunk_sweeps"] % me == 0
        assert cell.traffic["check_sweeps"] % me == 0
    want = {"links_off_start", "links_off_window"} | (
        {"rows_off_window"} if me else set())
    assert set(cell.limits) == want
    assert all(v >= 0 for v in cell.limits.values())


def tiny(workload):
    """Overrides that run a cell's path at 4^4 on the CPU in seconds."""
    cell = load_cell(ROOT, workload)
    over = {"sweeps_therm": 4,
            "traffic": {"chunk_sweeps": 4, "check_sweeps": 2,
                        "trace_sweeps": 4}}
    if cell.betas():
        over.update(dims=(4, 4, 4, 2), betas=[5.6, 6.1])
    else:
        over["dims"] = (4, 4, 4, 4)
    if cell.traffic["entry"] == "run":
        over["meas_every"] = 2
    return over


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cpu_run_prints_the_result_line(workload):
    rec, checks = harness.run_cell(workload, SEED0, 0.05, False,
                                   device="cpu", overrides=tiny(workload),
                                   log=lambda *a: None)
    out, err = io.StringIO(), io.StringIO()
    harness.emit(rec, checks, out, err)
    line = json.loads(out.getvalue().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 4
    assert set(line["metrics"]) == {"link_updates_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and UNIT.match(m["unit"])
    last = err.getvalue().splitlines()[-len(checks):]
    assert all(s.startswith("check ") and " limit " in s for s in last)


def with_cells(tmp_path, configs=(), workloads=(), per_layer=()):
    """A checkout in tmp_path: portbench/ and BENCHMARK.json with the given
    entries added."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"] += list(configs)
    bench["workloads"] += list(workloads)
    bench["per_layer"] += list(per_layer)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


SCAN = ({"name": "scan_24x6", "source": "BASELINE config 3",
         "file": "portbench/configs/scan_24x6.json", "reduced": [],
         "why": "test"},
        {"name": "scan_24x6.hb2or_meas1", "config": "scan_24x6",
         "traffic": "hb2or_meas1", "chips": 1, "why": "test"})


def test_scan_cell_from_its_files(tmp_path):
    """The scan's files (kept for when its host loop is steady enough to
    bound, PERF.md) run through the harness's BetaScan path: sound, the
    scan's limits hold; a sweep that leaves its state unchanged fails."""
    from qcdgpu_tpu_torch.ops.cuda import update as cupdate

    root = with_cells(tmp_path, [SCAN[0]], [SCAN[1]])
    over = {"dims": (4, 4, 4, 2), "betas": [5.6, 6.1], "sweeps_therm": 4,
            "meas_every": 2, "traffic": {"chunk_sweeps": 4,
                                         "check_sweeps": 2}}
    rec, checks = harness.run_cell("scan_24x6.hb2or_meas1", SEED0, 0.05,
                                   False, root=root, device="cpu",
                                   overrides=dict(over), log=lambda *a: None)
    assert rec["correct"] and set(checks) == {
        "links_off_start", "links_off_window", "rows_off_window"}
    orig = cupdate.stage_update_chains
    cupdate.stage_update_chains = lambda us, mu, parity, *a, **k: us[
        2 * mu + parity]
    try:
        rec, _ = harness.run_cell("scan_24x6.hb2or_meas1", SEED0, 0.05,
                                  False, root=root, device="cpu",
                                  overrides=dict(over), log=lambda *a: None)
    finally:
        cupdate.stage_update_chains = orig
    assert rec["correct"] is False


def test_a_cell_from_files_alone(tmp_path):
    """A configuration, a traffic mix, its limits and a per-layer metric
    added as new files plus a workloads entry: the harness runs the cell
    and reads the metric, with no file of the harness edited."""
    root = with_cells(
        tmp_path,
        [{"name": "su3_4", "source": "test",
          "file": "portbench/configs/su3_4.json", "reduced": [],
          "why": "test"}],
        [{"name": "su3_4.tiny_or", "config": "su3_4", "traffic": "tiny_or",
          "chips": 1, "why": "test"}],
        [{"name": "sweeps_traced", "unit": "sweeps", "better": "higher",
          "source": "program_counter", "layer": "host loop",
          "moves": "link_updates_per_s", "workloads": ["su3_4.tiny_or"]}])
    (tmp_path / "portbench/configs/su3_4.json").write_text(json.dumps({
        "name": "su3_4", "source": "a 4^4 SU(3) lattice for this test",
        "sim": {"group": 3, "dims": [4, 4, 4, 4], "beta": 5.7,
                "start": "cold", "sweeps_therm": 4, "reunit_every": 10},
        "reduced": {}, "assumed": {}}))
    (tmp_path / "portbench/traffic/tiny_or.json").write_text(json.dumps({
        "entry": "run", "sim": {"n_or": 1, "meas_every": 1},
        "chunk_sweeps": 3, "check_sweeps": 2, "trace_sweeps": 3,
        "why": "heat-bath + 1 OR measured every sweep"}))
    (tmp_path / "portbench/limits/su3_4.tiny_or.json").write_text(
        json.dumps({"limits": {"links_off_start": 1e-4,
                               "links_off_window": 1e-4,
                               "rows_off_window": 1e-5}}))
    (tmp_path / "portbench/metrics/sweeps_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['sweeps'])\n")
    rec, _ = harness.run_cell("su3_4.tiny_or", SEED0, 0.05, False,
                              root=root, device="cpu",
                              log=lambda *a: None)
    assert rec["correct"] and rec["attempted"] >= 3
    rec, _ = harness.run_cell("su3_4.tiny_or", SEED0, 0.05, True,
                              root=root, device="cpu",
                              log=lambda *a: None)
    assert rec["correct"]
    assert rec["metrics"]["sweeps_traced"] == {"value": 3.0,
                                               "unit": "sweeps"}
