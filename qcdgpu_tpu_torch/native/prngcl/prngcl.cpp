// Host-side reference random-number generators (C ABI, ctypes-loaded).
//
// Capability parity with QCDGPU's PRNGCL device-RNG library
// (random/prngcl_{ranlux,ranmar,xor128,xor7,mrg32k3a,parkmiller,constant}.cl
// — SURVEY.md §2 "PRNGCL"); the algorithms are re-implemented here from
// their published descriptions (Luescher ranlux; Marsaglia xorshift &
// RANMAR; L'Ecuyer MRG32k3a & xorshift7; Park-Miller minstd), NOT ported
// from the reference.  On TPU the production generator is counter-based
// threefry (ops/rng.py); these host generators serve
//   * the RNG parity suite (moments / KS / plaquette statistics of
//     threefry vs the reference generator family), and
//   * users who want a reference-compatible host stream.
//
// A threefry2x32 implementation is included so the JAX path can be
// cross-checked bit-for-bit against independent native code.
//
// Build: g++ -O3 -shared -fPIC prngcl.cpp -o libprngcl.so  (see ../build.py)

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// threefry2x32-20 (Salmon et al., Random123) — for bitwise cross-check
// ---------------------------------------------------------------------------

static inline uint32_t rotl32(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

void threefry2x32(uint32_t k0, uint32_t k1, const uint32_t* x0,
                  const uint32_t* x1, uint32_t* y0, uint32_t* y1,
                  int64_t n) {
    static const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    for (int64_t i = 0; i < n; ++i) {
        uint32_t a = x0[i] + ks[0];
        uint32_t b = x1[i] + ks[1];
        int inject = 0;
        for (int r = 0; r < 20; ++r) {
            a += b;
            b = rotl32(b, rot[r % 8]);
            b ^= a;
            if ((r + 1) % 4 == 0) {
                ++inject;
                a += ks[inject % 3];
                b += ks[(inject + 1) % 3] + (uint32_t)inject;
            }
        }
        y0[i] = a;
        y1[i] = b;
    }
}

// ---------------------------------------------------------------------------
// RANLUX (Luescher subtract-with-borrow, 24-bit, luxury levels 0..4)
// ---------------------------------------------------------------------------

struct Ranlux {
    uint32_t x[24];
    uint32_t carry;
    int i24, j24;     // lag pointers (r=24, s=10)
    int p;            // luxury period: draw 24, skip p-24
};

static void ranlux_init(Ranlux* g, uint64_t seed, int lux) {
    static const int pvals[5] = {24, 48, 97, 223, 389};
    uint32_t s = (uint32_t)(seed ^ (seed >> 32));
    if (s == 0) s = 314159265u;
    for (int i = 0; i < 24; ++i) {
        s = 69069u * s + 1u;                  // LCG seeding of the 24-bit words
        g->x[i] = (s >> 8) & 0xFFFFFFu;
    }
    g->carry = (g->x[23] == 0) ? 1 : 0;
    g->i24 = 23;
    g->j24 = 9;
    g->p = pvals[lux < 0 ? 0 : (lux > 4 ? 4 : lux)];
}

static inline uint32_t ranlux_step(Ranlux* g) {
    int64_t d = (int64_t)g->x[g->j24] - (int64_t)g->x[g->i24] - (int64_t)g->carry;
    if (d < 0) {
        d += 0x1000000;
        g->carry = 1;
    } else {
        g->carry = 0;
    }
    g->x[g->i24] = (uint32_t)d;
    g->i24 = (g->i24 == 0) ? 23 : g->i24 - 1;
    g->j24 = (g->j24 == 0) ? 23 : g->j24 - 1;
    return (uint32_t)d;
}

void ranlux_fill(uint64_t seed, int lux, double* out, int64_t n) {
    Ranlux g;
    ranlux_init(&g, seed, lux);
    int in_batch = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (in_batch == 24) {                  // luxury: discard p-24 values
            for (int s = 0; s < g.p - 24; ++s) ranlux_step(&g);
            in_batch = 0;
        }
        out[i] = ranlux_step(&g) * (1.0 / 16777216.0);
        ++in_batch;
    }
}

// ---------------------------------------------------------------------------
// RANMAR (Marsaglia-Zaman lagged Fibonacci + slow carry)
// ---------------------------------------------------------------------------

void ranmar_fill(uint64_t seed, double* out, int64_t n) {
    int ij = (int)(seed % 31329u);
    int kl = (int)((seed / 31329u) % 30082u);
    int i = (ij / 177) % 177 + 2, j = ij % 177 + 2;
    int k = (kl / 169) % 178 + 1, l = kl % 169;
    double u[97];
    for (int ii = 0; ii < 97; ++ii) {
        double s = 0.0, t = 0.5;
        for (int jj = 0; jj < 24; ++jj) {
            int m = (((i * j) % 179) * k) % 179;
            i = j; j = k; k = m;
            l = (53 * l + 1) % 169;
            if ((l * m) % 64 >= 32) s += t;
            t *= 0.5;
        }
        u[ii] = s;
    }
    double c = 362436.0 / 16777216.0;
    const double cd = 7654321.0 / 16777216.0;
    const double cm = 16777213.0 / 16777216.0;
    int i97 = 96, j97 = 32;
    for (int64_t q = 0; q < n; ++q) {
        double uni = u[i97] - u[j97];
        if (uni < 0.0) uni += 1.0;
        u[i97] = uni;
        i97 = (i97 == 0) ? 96 : i97 - 1;
        j97 = (j97 == 0) ? 96 : j97 - 1;
        c -= cd;
        if (c < 0.0) c += cm;
        uni -= c;
        if (uni < 0.0) uni += 1.0;
        out[q] = uni;
    }
}

// ---------------------------------------------------------------------------
// XOR128 (Marsaglia xorshift128)
// ---------------------------------------------------------------------------

void xor128_fill(uint64_t seed, double* out, int64_t n) {
    uint32_t x = 123456789u ^ (uint32_t)seed;
    uint32_t y = 362436069u ^ (uint32_t)(seed >> 32);
    uint32_t z = 521288629u;
    uint32_t w = 88675123u + (uint32_t)seed * 2654435761u;
    if (!(x | y | z | w)) x = 1;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t t = x ^ (x << 11);
        x = y; y = z; z = w;
        w = w ^ (w >> 19) ^ t ^ (t >> 8);
        out[i] = w * (1.0 / 4294967296.0);
    }
}

// ---------------------------------------------------------------------------
// XOR7 (Panneton-L'Ecuyer xorshift with 7 xorshifts, 256-bit state)
// ---------------------------------------------------------------------------

void xor7_fill(uint64_t seed, double* out, int64_t n) {
    uint32_t x[8];
    uint32_t s = (uint32_t)(seed ^ (seed >> 32)) | 1u;
    for (int i = 0; i < 8; ++i) {
        s = 69069u * s + 12345u;
        x[i] = s;
    }
    int k = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint32_t t, y;
        t = x[(k + 7) & 7]; t ^= t << 13; y = t ^ (t << 9);
        t = x[(k + 4) & 7]; y ^= t ^ (t << 7);
        t = x[(k + 3) & 7]; y ^= t ^ (t >> 3);
        t = x[(k + 1) & 7]; y ^= t ^ (t >> 10);
        t = x[k];           t ^= t >> 7;  y ^= t ^ (t << 24);
        x[k] = y;
        k = (k + 1) & 7;
        out[i] = y * (1.0 / 4294967296.0);
    }
}

// ---------------------------------------------------------------------------
// MRG32k3a (L'Ecuyer combined multiple recursive generator)
// ---------------------------------------------------------------------------

void mrg32k3a_fill(uint64_t seed, double* out, int64_t n) {
    const double m1 = 4294967087.0, m2 = 4294944443.0;
    const double a12 = 1403580.0, a13n = 810728.0;
    const double a21 = 527612.0, a23n = 1370589.0;
    const double norm = 2.328306549295728e-10;  // 1/(m1+1)
    // scramble the seed into six in-range state words (splitmix64)
    double s[6];
    uint64_t z = seed;
    for (int i = 0; i < 6; ++i) {
        z += 0x9E3779B97F4A7C15ull;
        uint64_t t = z;
        t = (t ^ (t >> 30)) * 0xBF58476D1CE4E5B9ull;
        t = (t ^ (t >> 27)) * 0x94D049BB133111EBull;
        t ^= t >> 31;
        double m = (i < 3) ? m1 : m2;
        s[i] = 1.0 + (double)(t % (uint64_t)(m - 2.0));
    }
    double s10 = s[0], s11 = s[1], s12 = s[2];
    double s20 = s[3], s21 = s[4], s22 = s[5];
    for (int64_t i = 0; i < n; ++i) {
        double p1 = a12 * s11 - a13n * s10;
        long kk = (long)(p1 / m1);
        p1 -= kk * m1;
        if (p1 < 0.0) p1 += m1;
        s10 = s11; s11 = s12; s12 = p1;
        double p2 = a21 * s22 - a23n * s20;
        kk = (long)(p2 / m2);
        p2 -= kk * m2;
        if (p2 < 0.0) p2 += m2;
        s20 = s21; s21 = s22; s22 = p2;
        double z12 = (p1 > p2) ? (p1 - p2) : (p1 - p2 + m1);
        out[i] = (z12 == 0.0 ? m1 : z12) * norm;
    }
}

// ---------------------------------------------------------------------------
// Park-Miller minimal standard
// ---------------------------------------------------------------------------

void parkmiller_fill(uint64_t seed, double* out, int64_t n) {
    uint64_t s = seed % 2147483647ull;
    if (s == 0) s = 1;
    for (int64_t i = 0; i < n; ++i) {
        s = (s * 16807ull) % 2147483647ull;
        out[i] = (double)s / 2147483647.0;
    }
}

// ---------------------------------------------------------------------------
// CONSTANT (debug generator)
// ---------------------------------------------------------------------------

void constant_fill(double value, double* out, int64_t n) {
    for (int64_t i = 0; i < n; ++i) out[i] = value;
}

}  // extern "C"
