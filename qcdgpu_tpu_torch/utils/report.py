"""Self-describing run record: text + JSON results files — port of
qcdgpu_tpu/utils/report.py.

Capability parity with QCDGPU's plain-text results file (full parameter
header, measurement time series, final averages +/- errors, per-phase
timings, device info), plus a machine-readable JSON twin.  The device
block names the card (torch.cuda) with its power limit from nvidia-smi,
since a time means little without them.
"""

from __future__ import annotations

import json
import platform
import shutil
import subprocess
import time

import numpy as np

from ..config import SimConfig
from ..ops.measure import obs_names


def _nvidia_smi() -> list | None:
    """`name, power.limit` of every card, as nvidia-smi prints them, or
    None where nvidia-smi is missing or fails."""
    if shutil.which("nvidia-smi") is None:
        return None
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    return proc.stdout.strip().splitlines() if proc.returncode == 0 else None


def device_info(device="cuda") -> dict:
    """The device a run uses: for a CUDA device every card's name and
    compute capability and the nvidia-smi name/power-limit lines; for the
    CPU the host only.  A CUDA device without a card raises."""
    import torch

    from ..ops.cuda.engine import resolve_device

    dev = resolve_device(device)
    info = {"backend": dev.type, "torch_version": torch.__version__,
            "host": platform.platform()}
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        info.update(
            device_count=n,
            devices=[torch.cuda.get_device_name(i) for i in range(n)],
            capability=["%d.%d" % torch.cuda.get_device_capability(i)
                        for i in range(n)],
            cuda_version=torch.version.cuda,
            nvidia_smi=_nvidia_smi(),
        )
    else:
        info["device_count"] = 1
    return info


def build_record(cfg: SimConfig, analysis: dict, timings: dict | None = None,
                 series: np.ndarray | None = None, extra: dict | None = None,
                 device="cuda") -> dict:
    rec = {
        "created": time.strftime("%Y-%m-%d %H:%M:%S"),
        "config": cfg.to_dict(),
        "device": device_info(device),
        "results": {
            name: (st.to_dict() if hasattr(st, "to_dict") else st)
            for name, st in analysis.items()
        },
        "timings": timings or {},
    }
    if extra:
        rec.update(extra)
    if series is not None:
        names = obs_names(cfg)
        rec["series"] = {
            name: np.asarray(series)[:, k].tolist()
            for k, name in enumerate(names[: np.asarray(series).shape[1]])
        }
    derived = _creutz_ratios(rec["results"])
    if derived:
        rec["derived"] = derived
    return rec


def _creutz_ratios(results: dict) -> dict:
    """chi(r, t) for every extent whose four Wilson loops were measured
    (wilson_loops config) — the string-tension estimators, derived once
    here so both the text and JSON records carry them."""
    from .stats import creutz_ratio

    loops = {
        name: (st["mean"], st.get("err", float("nan")))
        for name, st in results.items()
        if name.startswith("wloop_") and isinstance(st, dict) and "mean" in st
    }

    def have(rr, tt):
        return rr == 0 or tt == 0 or f"wloop_{rr}x{tt}" in loops

    out = {}
    for name in loops:
        r, t = (int(v) for v in name[len("wloop_"):].split("x"))
        if have(r - 1, t - 1) and have(r, t - 1) and have(r - 1, t):
            chi, err = creutz_ratio(loops, r, t)
            out[f"chi_{r}x{t}"] = {"mean": chi, "err": err}
    return out


def write_json(path: str, record: dict):
    with open(path, "w") as f:
        json.dump(record, f, indent=1)


def format_text(record: dict) -> str:
    lines = ["# qcdgpu_tpu_torch results", f"# created {record['created']}", ""]
    lines.append("[parameters]")
    for k, v in record["config"].items():
        lines.append(f"  {k} = {v}")
    lines.append("")
    if "engine" in record:
        lines.append(f"[engine]  {record['engine']}")
        lines.append("")
    lines.append("[device]")
    for k, v in record["device"].items():
        lines.append(f"  {k} = {v}")
    lines.append("")
    lines.append("[results]  (mean +/- err ; tau_int)")
    for name, st in record["results"].items():
        if isinstance(st, dict) and "mean" in st:
            lines.append(
                f"  {name:8s} = {st['mean']:+.8f} +/- {st.get('err', float('nan')):.2e}"
                f"   (naive {st.get('err_naive', float('nan')):.2e},"
                f" tau_int {st.get('tau_int', float('nan')):.2f}, n {st.get('n', 0)})"
            )
    if record.get("derived"):
        lines.append("")
        lines.append("[derived]  (Creutz ratios chi(R,T) from the Wilson loops)")
        for name, st in record["derived"].items():
            lines.append(
                f"  {name:8s} = {st['mean']:+.6f} +/- {st.get('err', float('nan')):.2e}"
            )
    if record.get("timings"):
        lines.append("")
        lines.append("[timings]")
        for k, v in record["timings"].items():
            lines.append(f"  {k} = {v}")
    lines.append("")
    return "\n".join(lines)


def write_text(path: str, record: dict):
    with open(path, "w") as f:
        f.write(format_text(record))
