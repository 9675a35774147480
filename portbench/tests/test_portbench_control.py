"""The comparison fails what it should: the control (the reference in
bfloat16 in the program's place) and the program with its timed path
broken underneath, on each cell's path at a CPU size."""

import numpy as np
import pytest
import torch

from portbench import check, harness
from portbench.cells import load_cell
from portbench.reference import Reference
from portbench.tests.test_portbench_cells import ROOT, SEED0, WORKLOADS, tiny
from qcdgpu_tpu_torch.ops.cuda import engine
from qcdgpu_tpu_torch.ops.cuda import update as cupdate


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_fails(workload):
    """Every cell's limits refuse the control on at least one number (on
    the link shares, at any size: bfloat16 storage moves most components
    by more than check.OFF)."""
    cell = load_cell(ROOT, workload)
    over = tiny(workload)
    betas = over.pop("betas", cell.betas())
    over.pop("traffic")
    fields = cell.sim_fields(SEED0, over)
    me = fields["meas_every"] if cell.traffic["entry"] == "run" else 0
    fields = {**fields, "meas_every": me}
    seeds = harness.seeds_of(fields, betas)
    from qcdgpu_tpu_torch import SimConfig

    cfg = SimConfig(**fields).to_dict()
    bs = betas or [cfg["beta"]]
    ref = Reference(cfg, bs, seeds, "cpu")
    start = ref.cold_start()
    ref.run(start, 0, 6, 0)
    want = check.replay(ref, start, 6, 2, me)
    low = check.replay(Reference(cfg, bs, seeds, "cpu", lowp=True), start,
                       6, 2, me)
    ok, checks = check.judge(check.numbers(low, want), cell.limits)
    assert not ok
    assert checks["links_off_window"]["value"] > 0.5
    if me:
        assert checks["rows_off_window"]["value"] > \
            checks["rows_off_window"]["limit"]


def _unchanged(mp):
    mp.setattr(cupdate, "stage_update",
               lambda us, mu, parity, *a, **k: us[2 * mu + parity])
    mp.setattr(cupdate, "stage_update_chains",
               lambda us, mu, parity, *a, **k: us[2 * mu + parity])


def _half(mp):
    """Half of the batch left out: the stage updates half of its sites
    (of its chains, in a scan)."""
    for name in ("stage_update", "stage_update_chains"):
        orig = getattr(cupdate, name)

        def part(us, mu, parity, *a, _orig=orig, _chains=name.endswith(
                "chains"), **k):
            t = us[2 * mu + parity]
            keep = t.clone()
            _orig(us, mu, parity, *a, **k)
            if _chains:
                t[t.shape[0] // 2:] = keep[t.shape[0] // 2:]
            else:
                flat, old = t.view(2, t.shape[1], 2, -1), keep.view(
                    2, t.shape[1], 2, -1)
                flat[..., flat.shape[-1] // 2:] = old[..., old.shape[-1] // 2:]
            return t

        mp.setattr(cupdate, name, part)


def _altered_links(mp):
    """A stage's answer altered where it is produced: the (mu 0, parity 0)
    stage's links scaled by 1 + 1e-3."""
    for name in ("stage_update", "stage_update_chains"):
        orig = getattr(cupdate, name)

        def bent(us, mu, parity, *a, _orig=orig, **k):
            t = _orig(us, mu, parity, *a, **k)
            if (mu, parity) == (0, 0):
                t.mul_(1.0 + 1e-3)
            return t

        mp.setattr(cupdate, name, bent)


def _altered_rows(mp):
    """A measurement's answer altered where it is produced: every plaquette
    column moved by 1e-4."""
    orig = engine.obs_base_from_sums

    def bent(*a, **k):
        out = orig(*a, **k).clone()
        out[..., :3] += 1e-4
        return out

    mp.setattr(engine, "obs_base_from_sums", bent)


FAULTS = {"unchanged": _unchanged, "half": _half,
          "altered_links": _altered_links, "altered_rows": _altered_rows}


def _cases():
    """Each cell with each fault it can have: a cell that measures nothing
    has no row to alter."""
    for w in WORKLOADS:
        measured = load_cell(ROOT, w).traffic["entry"] == "run"
        for f in sorted(FAULTS):
            if measured or f != "altered_rows":
                yield w, f


@pytest.mark.parametrize("workload, fault", list(_cases()))
def test_fault_fails(workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    rec, checks = harness.run_cell(workload, SEED0, 0.05, False,
                                   device="cpu", overrides=tiny(workload),
                                   log=lambda *a: None)
    assert rec["correct"] is False, checks
    assert rec["failed"] > 0
    assert np.isfinite([c["value"] for c in checks.values()]).all()
