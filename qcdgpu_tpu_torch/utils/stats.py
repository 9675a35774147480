"""Markov-chain time-series statistics: binned/jackknife errors.

QCDGPU's data_analysis module reports mean / dispersion / naive error of the
measurement series (SURVEY.md §2 "Data analysis").  Monte Carlo series are
autocorrelated, so the acceptance gates ("within MC error") need
autocorrelation-aware errors — we add log-binning and jackknife on top of the
reference capabilities (SURVEY.md §7 "Hard parts" #5).

A copy of qcdgpu_tpu/utils/stats.py (which cannot be imported without jax,
through qcdgpu_tpu/__init__.py).  Host-side like the reference's: the C++
implementation of the same estimators in qcdgpu_tpu_torch/native/analysis
(a copy of the reference's, built with g++ at first use) gives
analyze_series its moments and binning plateau whenever the library
builds, as in the reference, so both packages report the same bits; the
numpy implementation below is the fallback and the parity oracle
(tests/test_torch_native_analysis.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SeriesStats:
    n: int
    mean: float
    var: float  # population variance of the raw series
    err_naive: float  # sqrt(var / n) — uncorrelated assumption
    err: float  # binning-plateau error (autocorrelation-aware)
    tau_int: float  # integrated autocorrelation estimate from binning
    bins_used: int

    def to_dict(self):
        return self.__dict__.copy()


def binned_error(x: np.ndarray, bin_size: int) -> float:
    """Standard error of the mean computed on non-overlapping bin means."""
    nb = len(x) // bin_size
    if nb < 2:
        return float("nan")
    b = x[: nb * bin_size].reshape(nb, bin_size).mean(axis=1)
    return float(np.sqrt(b.var(ddof=1) / nb))


def analyze_series(x, min_bins: int = 8) -> SeriesStats:
    """Mean +/- autocorrelation-aware error via the binning plateau.

    Doubles the bin size while at least ``min_bins`` bins remain and takes
    the largest (plateau) error estimate.
    """
    x = np.asarray(x, dtype=np.float64).ravel()
    n = len(x)
    mean = float(x.mean()) if n else float("nan")
    var = float(x.var()) if n else float("nan")
    if n < 2:
        return SeriesStats(n, mean, var, float("nan"), float("nan"), float("nan"), 1)
    from ..native import analysis as native_analysis

    if native_analysis.available():
        mean, var, err_naive = native_analysis.series_moments(x)
        best, bin_size = native_analysis.plateau_error(x, min_bins)
    else:
        err_naive = float(np.sqrt(x.var(ddof=1) / n))
        best = err_naive
        bin_size = 1
        bs = 2
        while n // bs >= min_bins:
            e = binned_error(x, bs)
            if np.isfinite(e) and e > best:
                best = e
                bin_size = bs
            bs *= 2
    tau = 0.5 * (best / err_naive) ** 2 if err_naive > 0 else float("nan")
    return SeriesStats(n, mean, var, err_naive, best, float(tau), n // max(bin_size, 1))


def susceptibility(x, volume: float = 1.0, min_bins: int = 8):
    """(chi, err): chi = volume * (<x^2> - <x>^2) over the series.

    The standard finite-T observable on the Polyakov-loop modulus |P|:
    chi_P peaks at the deconfinement coupling (BASELINE config 3's beta
    grid locates beta_c this way).  The error is a delete-one-bin
    jackknife of the variance estimator, taken at the binning plateau
    (doubling bin sizes, largest finite error) so autocorrelation is
    accounted for like analyze_series does for the mean.
    """
    x = np.asarray(x, dtype=np.float64).ravel()
    n = len(x)
    if n < 2:
        return float("nan"), float("nan")
    est = float(volume * x.var())

    def chi(y):
        return volume * np.var(y)

    best = float("nan")
    bs = 1
    while n // bs >= min_bins:
        _, e = jackknife(x, chi, bs)
        if np.isfinite(e) and not (e <= best):  # max; best starts as nan
            best = e
        bs *= 2
    return est, best


def jackknife(x: np.ndarray, estimator=np.mean, bin_size: int = 1):
    """Delete-one-bin jackknife: (estimate, error)."""
    x = np.asarray(x, dtype=np.float64).ravel()
    nb = len(x) // bin_size
    if nb < 2:
        return float(estimator(x)), float("nan")
    b = x[: nb * bin_size].reshape(nb, bin_size)
    full = float(estimator(b.reshape(-1)))
    reps = np.array(
        [estimator(np.delete(b, i, axis=0).reshape(-1)) for i in range(nb)]
    )
    err = np.sqrt((nb - 1) / nb * np.sum((reps - reps.mean()) ** 2))
    return full, float(err)


def creutz_ratio(wloops: dict, r: int, t: int):
    """Creutz ratio chi(r, t) from rectangular Wilson-loop means.

    chi(r, t) = -ln( W(r,t) W(r-1,t-1) / (W(r,t-1) W(r-1,t)) ) — the
    standard string-tension estimator from the wilson_loops observables
    (ops/measure.wilson_loop_means; companion to QCDGPU's plaquette set).

    wloops maps "wloop_RxT" -> mean or (mean, err).  Returns (chi, err)
    with the error linearly propagated (err NaN if any input lacks one).
    W(0, .) and W(., 0) are 1 by definition (zero-area loop), so
    chi(1, 1) = -ln W(1,1).
    """

    def get(rr, tt):
        if rr == 0 or tt == 0:
            return 1.0, 0.0
        v = wloops[f"wloop_{rr}x{tt}"]
        if isinstance(v, (tuple, list)):
            return float(v[0]), float(v[1])
        return float(v), float("nan")

    vals = [get(r, t), get(r - 1, t - 1), get(r, t - 1), get(r - 1, t)]
    means = [m for m, _ in vals]
    if any(m <= 0 for m in means):
        return float("nan"), float("nan")
    chi = -(np.log(means[0]) + np.log(means[1])
            - np.log(means[2]) - np.log(means[3]))
    err = float(np.sqrt(sum((e / m) ** 2 for m, e in vals)))
    return float(chi), err
