"""The port's native analysis library (qcdgpu_tpu_torch/native/analysis.py
and its copy of analysis.cpp) against the reference's
(qcdgpu_tpu/native/analysis.py): every estimator bit for bit, the guards,
and analyze_series on the native and on the numpy path, alone and through
the command line's results record; the port's native threefry against
ops/rng.py and the reference's."""

import json
import os
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from qcdgpu_tpu.native import analysis as ref_nat
from qcdgpu_tpu.native import prngcl as ref_prngcl
from qcdgpu_tpu.utils import stats as ref_stats
from qcdgpu_tpu_torch import cli
from qcdgpu_tpu_torch.native import analysis as nat
from qcdgpu_tpu_torch.native import prngcl
from qcdgpu_tpu_torch.ops import rng
from qcdgpu_tpu_torch.utils import stats

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the native libraries")

ROOT = Path(__file__).resolve().parents[1]
# AR(1) lengths: two values, fewer than 2 * min_bins (no binning step), the
# first with a binning step, and longer series
LENGTHS = (2, 3, 15, 16, 100, 2048, 100_001)


def _ref_available(mod, deadline_s=60.0):
    """Whether one of the reference's native libraries loads, waiting for it
    on a cold checkout: there several test workers build it at once into the
    same file, not atomically, and a worker that opens the half-written file
    caches None (qcdgpu_tpu/native/build.py).  Clear that cache and try
    again until the writer has finished."""
    end = time.monotonic() + deadline_s
    while not mod.available() and time.monotonic() < end:
        mod._lib.cache_clear()
        time.sleep(0.5)
    return mod.available()


@pytest.fixture(scope="module")
def both_native():
    assert nat.available(), "the port's analysis library did not build"
    assert _ref_available(ref_nat), "the reference's analysis library"


def ar1(n, seed=5, rho=0.8):
    """0.6 + 0.01 x with x an AR(1) chain: autocorrelated like a
    Markov-chain observable."""
    eps = np.random.default_rng(seed).normal(size=n)
    x = np.empty(n)
    x[0] = 0.0
    for i in range(1, n):
        x[i] = rho * x[i - 1] + eps[i]
    return 0.6 + 0.01 * x


def assert_same_bits(a, b):
    """Equal floats (NaN equal to NaN), element by element."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.array_equal(a.view(np.uint64), b.view(np.uint64)), (a, b)


def assert_same_record(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert_same_bits(got[k], want[k])


@pytest.mark.parametrize("n", LENGTHS)
def test_estimators_match_reference(n, both_native):
    x = ar1(n)
    assert_same_bits(nat.series_moments(x), ref_nat.series_moments(x))
    for bs in (1, 2, 3, 16, 100):
        assert_same_bits(nat.binned_error(x, bs), ref_nat.binned_error(x, bs))
    for min_bins in (1, 2, 8):
        e, bs = nat.plateau_error(x, min_bins)
        e_ref, bs_ref = ref_nat.plateau_error(x, min_bins)
        assert_same_bits(e, e_ref)
        assert bs == bs_ref
    for bs in (1, 8):
        assert_same_bits(nat.jackknife_mean(x, bs),
                         ref_nat.jackknife_mean(x, bs))
    assert_same_bits(nat.autocorr(x, 20), ref_nat.autocorr(x, 20))


@pytest.mark.parametrize("n", LENGTHS)
def test_analyze_series_native_matches_reference(n, both_native):
    x = ar1(n)
    assert_same_record(stats.analyze_series(x).to_dict(),
                       ref_stats.analyze_series(x).to_dict())


@pytest.mark.parametrize("n", LENGTHS)
def test_analyze_series_numpy_matches_reference(n, monkeypatch):
    monkeypatch.setattr(nat, "available", lambda: False)
    monkeypatch.setattr(ref_nat, "available", lambda: False)
    x = ar1(n)
    assert_same_record(stats.analyze_series(x).to_dict(),
                       ref_stats.analyze_series(x).to_dict())


def test_native_and_numpy_paths_agree(monkeypatch, both_native):
    """The two paths of the port's analyze_series: the same bin size and
    bin count, the values within rounding (rel 1e-12)."""
    x = ar1(2048)
    native = stats.analyze_series(x).to_dict()
    monkeypatch.setattr(nat, "available", lambda: False)
    plain = stats.analyze_series(x).to_dict()
    assert native["n"] == plain["n"]
    assert native["bins_used"] == plain["bins_used"]
    for k in ("mean", "var", "err_naive", "err", "tau_int"):
        assert native[k] == pytest.approx(plain[k], rel=1e-12), k


def test_run_record_analysis_is_the_references(tmp_path, both_native):
    """The command line's results record (Simulation.analysis() of the
    run's series) equals the reference's analyze_series of that series."""
    out = str(tmp_path / "o")
    cli.main(["run", "--group", "2", "--beta", "2.3", "--dims", "4,4,2,4",
              "--start", "hot", "--seed", "3", "--therm", "1", "--sweeps",
              "20", "--device", "cpu", "--out", out])
    with open(os.path.join(out, "results.json")) as f:
        rec = json.load(f)
    assert rec["series"].keys() == rec["results"].keys()
    for name, series in rec["series"].items():
        assert len(series) == 20
        want = ref_stats.analyze_series(np.asarray(series)).to_dict()
        assert_same_record(rec["results"][name], want)


@pytest.mark.parametrize("call", [
    lambda: nat.binned_error(np.ones(16), 0),
    lambda: nat.plateau_error(np.ones(16), 0),
    lambda: nat.jackknife_mean(np.ones(16), 0),
    lambda: nat.autocorr(np.ones(16), -1),
], ids=["binned_error", "plateau_error", "jackknife_mean", "autocorr"])
def test_native_guards(call, both_native):
    with pytest.raises(ValueError, match="bin_size|min_bins|maxlag"):
        call()


def test_analysis_cpp_is_the_references():
    port = ROOT / "qcdgpu_tpu_torch" / "native" / "analysis" / "analysis.cpp"
    ref = ROOT / "qcdgpu_tpu" / "native" / "analysis" / "analysis.cpp"
    assert port.read_bytes() == ref.read_bytes()


def test_threefry_native_matches_rng_and_reference():
    assert prngcl.available() and _ref_available(ref_prngcl)
    r = np.random.default_rng(3)
    x0 = r.integers(0, 2**32, size=512, dtype=np.uint32)
    x1 = r.integers(0, 2**32, size=512, dtype=np.uint32)
    t0 = torch.from_numpy(x0.astype(np.int64))
    t1 = torch.from_numpy(x1.astype(np.int64))
    for k0, k1 in [(0, 0), (1, 0xDEADBEEF), (0x243F6A88, 0x85A308D3),
                   (0xFFFFFFFF, 0xFFFFFFFF)]:
        y0, y1 = prngcl.threefry2x32(k0, k1, x0, x1)
        assert y0.dtype == y1.dtype == np.uint32
        r0, r1 = ref_prngcl.threefry2x32(k0, k1, x0, x1)
        np.testing.assert_array_equal(y0, r0)
        np.testing.assert_array_equal(y1, r1)
        z0, z1 = rng.threefry2x32(k0, k1, t0, t1)
        np.testing.assert_array_equal(y0, z0.numpy().astype(np.uint32))
        np.testing.assert_array_equal(y1, z1.numpy().astype(np.uint32))
        w0, w1 = rng.threefry2x32_i32(k0, k1, t0.to(torch.int32),
                                      t1.to(torch.int32))
        np.testing.assert_array_equal(y0, w0.numpy().view(np.uint32))
        np.testing.assert_array_equal(y1, w1.numpy().view(np.uint32))
    with pytest.raises(ValueError, match="differ in size"):
        prngcl.threefry2x32(0, 0, x0, x1[:16])
