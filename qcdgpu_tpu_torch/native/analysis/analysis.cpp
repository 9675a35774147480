// Native time-series statistics (C ABI, ctypes-loaded).
//
// Capability parity with QCDGPU's host-side data_analysis module
// (data_analysis/data_analysis.cpp — SURVEY.md §2 "Data analysis"),
// extended with binning-plateau errors and jackknife (autocorrelation-aware,
// required by the "within MC error" acceptance gates).  utils/stats.py uses
// this library when built and falls back to numpy otherwise.
//
// Build: g++ -O3 -shared -fPIC analysis.cpp -o libanalysis.so

#include <cmath>
#include <cstdint>

extern "C" {

// mean, population variance, naive stderr of the mean
void series_moments(const double* x, int64_t n, double* mean, double* var,
                    double* err_naive) {
    if (n <= 0) {
        *mean = *var = *err_naive = NAN;
        return;
    }
    double s = 0.0;
    for (int64_t i = 0; i < n; ++i) s += x[i];
    double m = s / n;
    double v = 0.0;
    for (int64_t i = 0; i < n; ++i) {
        double d = x[i] - m;
        v += d * d;
    }
    *mean = m;
    *var = v / n;
    *err_naive = (n > 1) ? std::sqrt(v / (n - 1) / n) : NAN;
}

// stderr of the mean from non-overlapping bins of size bs (NaN if <2 bins)
double binned_error(const double* x, int64_t n, int64_t bs) {
    int64_t nb = n / bs;
    if (nb < 2) return NAN;
    double gm = 0.0;
    for (int64_t b = 0; b < nb; ++b) {
        double s = 0.0;
        for (int64_t i = 0; i < bs; ++i) s += x[b * bs + i];
        gm += s / bs;
    }
    gm /= nb;
    double v = 0.0;
    for (int64_t b = 0; b < nb; ++b) {
        double s = 0.0;
        for (int64_t i = 0; i < bs; ++i) s += x[b * bs + i];
        double d = s / bs - gm;
        v += d * d;
    }
    return std::sqrt(v / (nb - 1) / nb);
}

// binning-plateau error: double bin size while >= min_bins bins remain,
// return the largest error seen; *bin_size_out reports the plateau bin.
double plateau_error(const double* x, int64_t n, int64_t min_bins,
                     int64_t* bin_size_out) {
    double m, v, e0;
    series_moments(x, n, &m, &v, &e0);
    double best = e0;
    int64_t best_bs = 1;
    for (int64_t bs = 2; n / bs >= min_bins; bs *= 2) {
        double e = binned_error(x, n, bs);
        if (std::isfinite(e) && e > best) {
            best = e;
            best_bs = bs;
        }
    }
    if (bin_size_out) *bin_size_out = best_bs;
    return best;
}

// delete-one-bin jackknife of the mean: fills *est and *err
void jackknife_mean(const double* x, int64_t n, int64_t bs, double* est,
                    double* err) {
    int64_t nb = n / bs;
    if (nb < 2) {
        *est = NAN;
        *err = NAN;
        return;
    }
    int64_t m = nb * bs;
    double total = 0.0;
    for (int64_t i = 0; i < m; ++i) total += x[i];
    *est = total / m;
    double jm = 0.0;
    double* reps = new double[nb];
    for (int64_t b = 0; b < nb; ++b) {
        double bsum = 0.0;
        for (int64_t i = 0; i < bs; ++i) bsum += x[b * bs + i];
        reps[b] = (total - bsum) / (m - bs);
        jm += reps[b];
    }
    jm /= nb;
    double v = 0.0;
    for (int64_t b = 0; b < nb; ++b) {
        double d = reps[b] - jm;
        v += d * d;
    }
    *err = std::sqrt((double)(nb - 1) / nb * v);
    delete[] reps;
}

// normalized autocorrelation function rho[0..maxlag]
void autocorr(const double* x, int64_t n, int64_t maxlag, double* rho) {
    double m, v, e;
    series_moments(x, n, &m, &v, &e);
    for (int64_t lag = 0; lag <= maxlag; ++lag) {
        if (lag >= n || v <= 0.0) {
            rho[lag] = NAN;
            continue;
        }
        double s = 0.0;
        for (int64_t i = 0; i + lag < n; ++i) s += (x[i] - m) * (x[i + lag] - m);
        rho[lag] = s / ((n - lag) * v);
    }
}

}  // extern "C"
