"""The port's command line (qcdgpu_tpu_torch/cli.py) on the CPU: run with
periodic checkpoints, resume bit for bit, a beta scan and its resume,
info, validate, and the dense engine on a mesh (bit for bit its unsharded
run, its record naming the engine and the mesh)."""

import json
import os

import numpy as np
import pytest
import torch

from qcdgpu_tpu_torch import cli
from qcdgpu_tpu_torch.utils.checkpoint import load_state

torch.set_num_threads(1)

RUN = ["--group", "2", "--beta", "2.3", "--dims", "4,4,2,4", "--rng-mode",
       "hw", "--start", "hot", "--seed", "3", "--reunit-every", "2",
       "--ckpt-every", "2", "--device", "cpu"]


def _run(tmp_path, name, *args):
    out = str(tmp_path / name)
    assert cli.main([*args, "--out", out]) in (None, 0)
    return out


def _series_and_links(out):
    with open(os.path.join(out, "results.json")) as f:
        rec = json.load(f)
    _, us, sweep_idx, _, _ = load_state(os.path.join(out, "state.npz"))
    return rec, us, sweep_idx


def test_run_then_resume_is_one_run(tmp_path):
    a = _run(tmp_path, "a", "run", *RUN, "--therm", "1", "--sweeps", "4")
    rec_a, _, idx_a = _series_and_links(a)
    assert os.path.exists(os.path.join(a, "results.txt"))
    assert os.path.exists(os.path.join(a, "state.npz", "meta.npz"))
    assert idx_a == 5 and len(rec_a["series"]["plq"]) == 4
    assert rec_a["device"]["backend"] == "cpu"
    for k in ("compile_s", "thermalize_s", "production_s",
              "link_updates_per_s", "ms_per_sweep", "ms_per_sweep_with_meas"):
        assert k in rec_a["timings"], k
    b = _run(tmp_path, "b", "resume", os.path.join(a, "state.npz"),
             "--sweeps", "4", "--device", "cpu")
    c = _run(tmp_path, "c", "run", *RUN, "--therm", "1", "--sweeps", "8")
    rec_b, us_b, idx_b = _series_and_links(b)
    rec_c, us_c, idx_c = _series_and_links(c)
    assert idx_b == idx_c == 9
    assert rec_b["series"] == rec_c["series"]
    for x, y in zip(us_b, us_c):
        np.testing.assert_array_equal(x, y)


def test_info_prints_the_device(capsys):
    cli.main(["info", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out)["backend"] == "cpu"


SCAN = ["--group", "2", "--dims", "4", "--betas", "1.0:4.0:3",
        "--reunit-every", "2", "--seed", "2", "--device", "cpu"]


def test_scan_then_resume_is_one_scan(tmp_path):
    """scan 3 + 3 sweeps, then --resume-state for 3 more: the resumed
    series and links equal an uninterrupted 3 + 6 scan's, bit for bit;
    scan.json carries the reference's row keys; the plaquette rises with
    beta."""
    from qcdgpu_tpu_torch.utils.checkpoint import load_betascan

    a = _run(tmp_path, "a", "scan", *SCAN, "--therm", "3", "--sweeps", "3")
    b = _run(tmp_path, "b", "scan", "--resume-state",
             os.path.join(a, "scan_state.npz"), "--sweeps", "3",
             "--device", "cpu")
    c = _run(tmp_path, "c", "scan", *SCAN, "--therm", "3", "--sweeps", "6")
    recs = []
    for out in (a, b, c):
        with open(os.path.join(out, "scan.json")) as f:
            recs.append(json.load(f))
    rows = recs[0]["scan"]
    assert [r["beta"] for r in rows] == [1.0, 2.5, 4.0]
    keys = {"beta", "poly_abs", "poly_abs_err", "poly_sus", "poly_sus_err"}
    for name in ("plq", "plq_s", "plq_t", "action", "poly_re", "poly_im"):
        keys |= {name, name + "_err"}
    assert all(set(r) == keys for rec in recs for r in rec["scan"])
    plq = [r["plq"] for r in rows]
    assert plq[0] < plq[1] < plq[2]
    for name, series in recs[2]["series"].items():
        assert recs[1]["series"][name] == [s[3:] for s in series]
    _, betas, keys_b, u_b, idx_b = load_betascan(
        os.path.join(b, "scan_state.npz"))
    _, _, keys_c, u_c, idx_c = load_betascan(
        os.path.join(c, "scan_state.npz"))
    assert idx_b == idx_c == 9 and betas.tolist() == [1.0, 2.5, 4.0]
    np.testing.assert_array_equal(keys_b, keys_c)
    np.testing.assert_array_equal(u_b, u_c)


def _mesh_args(args, mesh):
    """args with its --mesh replaced by ``mesh`` and the engine pinned to
    the dense one (an unsharded complex64 run would resolve to the packed
    engine)."""
    i = args.index("--mesh")
    return args[:i] + ["--mesh", mesh] + args[i + 2:] + ["--engine", "xla"]


@pytest.mark.parametrize("args,item", [
    (["scan", "--betas", "5.6,6.0", "--rng-mode", "prngcl:ranlux3",
      "--mesh", "2,1,1,1"], "M11b"),
    (["scan", "--betas", "5.6,6.0", "--mesh", "1,1,1,2"], "M11b"),
    (["scan", "--betas", "5.6,6.0", "--engine", "xla", "--mesh",
      "2,1,1,1"], "M11b"),
    (["run", "--get-qtop", "--dtype", "complex128", "--mesh", "2,1,1,1"],
     "M11b"),
    (["run", "--wilson-loops", "1x1", "--mesh", "1,1,1,2"], "M11b"),
    (["run", "--meas-dtype", "double", "--dtype", "complex128", "--mesh",
      "2,2,1,1"], "M11b"),
    (["run", "--engine", "xla", "--mesh", "1,2,1,1"], "M11b"),
])
def test_unported_features_name_their_item(args, item, tmp_path):
    """Runs and scans on the dense engine on a mesh (``item``: its ROADMAP
    item), 1 + 1 sweeps: the record names the engine and the mesh, the
    links (every chain's) are bit for bit the unsharded dense run's, the
    series within 1e-5."""
    assert item == "M11b"
    common = ["--dims", "4,4,2,4", "--therm", "1", "--sweeps", "1",
              "--seed", "2", "--device", "cpu"]
    out = {}
    for tag, argv in (("mesh", args), ("flat", _mesh_args(args,
                                                          "1,1,1,1"))):
        out[tag] = _run(tmp_path, tag, *argv, *common)
    mesh = [int(m) for m in args[args.index("--mesh") + 1].split(",")]
    if args[0] == "scan":
        from qcdgpu_tpu_torch.utils.checkpoint import load_betascan

        recs = []
        for tag in ("mesh", "flat"):
            with open(os.path.join(out[tag], "scan.json")) as f:
                recs.append(json.load(f))
        links = [load_betascan(os.path.join(out[t], "scan_state.npz"))[3]
                 for t in ("mesh", "flat")]
    else:
        recs, links = [], []
        for tag in ("mesh", "flat"):
            rec, u, _ = _series_and_links(out[tag])
            recs.append(rec)
            links.append(u)
    assert recs[0]["engine"] == recs[1]["engine"] == "xla"
    assert recs[0]["mesh"] == mesh and recs[1]["mesh"] == [1, 1, 1, 1]
    np.testing.assert_array_equal(links[0], links[1])
    for name, series in recs[1]["series"].items():
        np.testing.assert_allclose(recs[0]["series"][name], series, rtol=0,
                                   atol=1e-5)


def test_dense_resume_on_another_mesh(tmp_path):
    """run --mesh 1,1,2,2 --dtype complex128 with checkpoints, then resume
    --mesh 2,1,1,1: the links equal an uninterrupted unsharded run's, the
    series within 1e-5; the records name each run's mesh."""
    args = ["--group", "2", "--dims", "4", "--dtype", "complex128",
            "--start", "hot", "--seed", "3", "--ckpt-every", "1",
            "--therm", "1", "--device", "cpu"]
    a = _run(tmp_path, "a", "run", *args, "--mesh", "1,1,2,2", "--sweeps",
             "1")
    b = _run(tmp_path, "b", "resume", os.path.join(a, "state.npz"),
             "--mesh", "2,1,1,1", "--sweeps", "1", "--device", "cpu")
    c = _run(tmp_path, "c", "run", *args, "--sweeps", "2")
    rec_b, u_b, idx_b = _series_and_links(b)
    rec_c, u_c, idx_c = _series_and_links(c)
    assert idx_b == idx_c == 3 and rec_b["mesh"] == [2, 1, 1, 1]
    assert rec_b["engine"] == rec_c["engine"] == "xla"
    np.testing.assert_array_equal(u_b, u_c)
    np.testing.assert_allclose(rec_b["series"]["plq"],
                               rec_c["series"]["plq"], rtol=0, atol=1e-5)


def test_validate_skips_multicard_without_cards(capsys):
    """Below two cards config 5 runs the reference's fallback (sharded ==
    unsharded on one device) and PASSes; it is never skipped."""
    assert cli.main(["validate", "--configs", "5", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[PASS] #5" in out and "SKIP" not in out


def test_rngtest_passes(capsys):
    assert cli.main(["rngtest", "--n", "4096", "--generators", "xor128",
                     "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "philox (hw)" in out and "device:xor128" in out and "PASS" in out


EXTRAS = ["--dims", "4", "--wilson-loops", "1x1,1x2,2x1,2x2", "--get-qtop",
          "--qtop-smear", "1", "--get-fmunu"]


def test_run_resume_with_extended_observables(tmp_path):
    """run with Wilson loops, Fmunu and smeared Q_L, then resume: the
    series is an uninterrupted run's bit for bit, every extended column is
    there, and the results record has the Creutz ratios."""
    a = _run(tmp_path, "a", "run", *RUN, *EXTRAS, "--therm", "1",
             "--sweeps", "2")
    b = _run(tmp_path, "b", "resume", os.path.join(a, "state.npz"),
             "--sweeps", "2", "--device", "cpu")
    c = _run(tmp_path, "c", "run", *RUN, *EXTRAS, "--therm", "1",
             "--sweeps", "4")
    rec_b, us_b, idx_b = _series_and_links(b)
    rec_c, us_c, idx_c = _series_and_links(c)
    assert idx_b == idx_c == 5
    assert rec_b["series"] == rec_c["series"]
    assert {"wloop_2x2", "q_top", "f3_zt_im"} <= set(rec_b["series"])
    assert set(rec_b["derived"]) == {"chi_1x1", "chi_1x2", "chi_2x1",
                                     "chi_2x2"}
    with open(os.path.join(b, "results.txt")) as f:
        assert "chi_2x2" in f.read()


def test_scan_with_extended_observables(tmp_path):
    out = _run(tmp_path, "s", "scan", *SCAN, "--wilson-loops", "1x1,2x2",
               "--get-qtop", "--therm", "1", "--sweeps", "2")
    with open(os.path.join(out, "scan.json")) as f:
        rec = json.load(f)
    assert [len(s) for s in rec["series"]["wloop_2x2"]] == [2, 2, 2]
    assert all(np.isfinite(r["q_top"]) for r in rec["scan"])
    assert all(abs(r["wloop_1x1"] - r["plq_t"]) < 1e-5 for r in rec["scan"])
