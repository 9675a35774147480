"""A cell of BENCHMARK.json and the files it names.

A cell (``workloads`` entry) names a configuration (``configs`` entry,
whose ``file`` holds the SimConfig fields under ``sim`` and, for a beta
scan, the grid under ``betas``) and a traffic mix, the file
``portbench/traffic/<traffic>.json``: the entry it drives ("run" or
"thermalize"), its SimConfig overrides, the sweeps of a chunk, of the
checked segment and of the traced sub-window.  The limits of the numbers
that decide ``correct`` are in ``portbench/limits/<workload>.json``, and
each per-layer metric is read by ``portbench/metrics/<name>.py``.  A new
cell is new files and a ``workloads`` entry: nothing here names one.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Cell:
    name: str
    chips: int
    config: dict      # the configuration file's contents
    traffic: dict     # the traffic file's contents
    limits: dict      # {number: limit}
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list
    metrics_dir: Path

    def sim_fields(self, seed, overrides=None):
        """The SimConfig fields of this cell's run: the configuration's,
        then the traffic's, then ``overrides``; cfg.seed is ``seed``."""
        fields = dict(self.config["sim"])
        fields.update(self.traffic.get("sim", {}))
        fields.update(overrides or {})
        fields["seed"] = int(seed)
        for k in ("dims", "mesh"):
            if k in fields:
                fields[k] = tuple(int(v) for v in fields[k])
        return fields

    def betas(self):
        """The scan's couplings (the CLI's lo:hi:n grid), or None for a
        single chain."""
        g = self.config.get("betas")
        if g is None:
            return None
        lo, hi, n = float(g["lo"]), float(g["hi"]), int(g["n"])
        return [lo + (hi - lo) * i / max(n - 1, 1) for i in range(n)]


def _reports(metric, workload, end_to_end_names):
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves", metric["name"]) in end_to_end_names


def load_cell(root, workload) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json; raises KeyError
    for a name the file does not hold."""
    root = Path(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    bench_dir = root / "portbench"
    config = json.loads((root / conf["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = bench_dir / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text())["limits"]
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, workload, names)]
    return Cell(workload, int(w["chips"]), config, traffic, limits, e2e,
                per_layer, bench_dir / "metrics")
