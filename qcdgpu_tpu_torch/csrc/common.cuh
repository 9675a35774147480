// Device helpers shared by the qcdgpu_tpu_torch kernels: (re, im) complex
// and N x N matrix algebra (Mat<2>, Mat<3>), the two-row codec, direct
// packed-neighbour addressing, threefry2x32-20, Philox-4x32-10 (the fast
// counter-based source of rng_mode "hw"), the sampler's polynomial
// transcendentals and the block reductions.
// They replace the TPU kernels' inlined helpers (qcdgpu_tpu/ops/pallas/
// core.py: threefry2x32, bits_to_uniform, _codec_rows, shift_comp_packed,
// slab_site_index_packed; qcdgpu_tpu/ops/fastmath.py), which worked on whole
// [Y, Z*T/2] slabs; here each is a per-thread scalar function, so the
// neighbour shifts become address arithmetic instead of rolls and masks.
//
// Every helper keeps the operation order of its plain PyTorch twin
// (qcdgpu_tpu_torch/ops/cuda/core.py, ops/fastmath.py, ops/rng.py), which in
// turn keeps the JAX reference's.  The library is built with -fmad=false
// and without --use_fast_math, so each f32 operation here rounds exactly as
// the twin's does: no multiply-add contraction, IEEE sqrt and division.
//
// Packed layout (one array per (direction mu, parity p), us[2*mu + p]):
// f32 [2 rows, N cols, 2 (re/im), X, Y, Z*T/2], site-minor.  The array of
// parity p holds the links whose base site (x, y, z, t) has
// (x+y+z+t) % 2 == p, at slot ((x*Y + y)*Z + z)*(T/2) + t/2.  Component c of
// a matrix lies at c*V2 + slot (V2 = X*Y*Z*T/2), so threads on neighbouring
// slots load neighbouring words.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace qg {

struct Dims {
  int x, y, z, t;  // lattice extents (T even)
  int t2;          // T / 2
  int v2;          // X*Y*Z*T/2: slots per packed array
};

__host__ inline Dims make_dims(int X, int Y, int Z, int T) {
  Dims d;
  d.x = X; d.y = Y; d.z = Z; d.t = T; d.t2 = T / 2;
  d.v2 = X * Y * Z * (T / 2);
  return d;
}

// One shard of an X/Y-decomposed lattice (ops/cuda/core.py Shard).  Its
// arrays are [2, N, 2, x + 2 hx, y + 2 hy, Z*T/2]: an axis split over the
// mesh carries one halo slab on each side (hx / hy = 1), which the halo
// refresh (ops/cuda/sharded.py) fills with the neighbouring shards' boundary
// slabs; an axis that is not split wraps periodically inside the shard.
// Sites are addressed in interior coordinates (-1 and x / y step into the
// halos); parity and the threefry counter use the global coordinates
// (x0 + x, y0 + y), so a sharded chain draws what the unsharded one draws.
// A kernel runs one thread per interior site; its slot in the padded array
// is encode_slot of the decoded site.  Slots are int: 4 N v2 < 2^31 is
// checked by the wrappers (core.check_packed).
struct ShardDims {
  int x, y, z, t;  // interior extents (Z and T are never split)
  int t2;          // T / 2
  int hx, hy;      // 1 where the axis is split, else 0
  int py;          // padded rows: y + 2 hy
  int v2;          // slots per padded array: (x + 2 hx) * py * z * t2
  int n;           // interior sites per parity: x * y * z * t2
  int x0, y0;      // global coordinates of the first interior slab and row
  int gy;          // global Y extent (the dense site index's row stride)
};

__host__ inline ShardDims make_shard_dims(int lx, int ly, int Z, int T, int hx,
                                          int hy, int x0, int y0, int gy) {
  ShardDims d;
  d.x = lx; d.y = ly; d.z = Z; d.t = T; d.t2 = T / 2;
  d.hx = hx; d.hy = hy;
  d.py = ly + 2 * hy;
  d.v2 = (lx + 2 * hx) * d.py * Z * (T / 2);
  d.n = lx * ly * Z * (T / 2);
  d.x0 = x0; d.y0 = y0; d.gy = gy;
  return d;
}

// threads of a kernel over one parity's sites
__host__ __device__ __forceinline__ int n_sites(const Dims& d) { return d.v2; }
__host__ __device__ __forceinline__ int n_sites(const ShardDims& d) {
  return d.n;
}

struct Links {
  float* p[8];  // us[2*mu + parity]
};

// ---------------------------------------------------------------------------
// complex numbers and N x N matrices (N = 2 or 3)
// ---------------------------------------------------------------------------

struct C { float re, im; };
template <int N> struct Mat { C a[N][N]; };
using M3 = Mat<3>;

__device__ __forceinline__ C cmul(C a, C b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
// a * conj(b)
__device__ __forceinline__ C cmul_conj(C a, C b) {
  return {a.re * b.re + a.im * b.im, a.im * b.re - a.re * b.im};
}
__device__ __forceinline__ C cadd(C a, C b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ C cconj(C a) { return {a.re, -a.im}; }

template <int N>
__device__ __forceinline__ Mat<N> mmul(const Mat<N>& a, const Mat<N>& b) {
  Mat<N> o;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      C acc = cmul(a.a[i][0], b.a[0][k]);
#pragma unroll
      for (int j = 1; j < N; ++j) acc = cadd(acc, cmul(a.a[i][j], b.a[j][k]));
      o.a[i][k] = acc;
    }
  return o;
}

// a @ b^dagger
template <int N>
__device__ __forceinline__ Mat<N> mmul_bdag(const Mat<N>& a, const Mat<N>& b) {
  Mat<N> o;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int k = 0; k < N; ++k) {
      C acc = cmul_conj(a.a[i][0], b.a[k][0]);
#pragma unroll
      for (int j = 1; j < N; ++j) acc = cadd(acc, cmul_conj(a.a[i][j], b.a[k][j]));
      o.a[i][k] = acc;
    }
  return o;
}

template <int N>
__device__ __forceinline__ Mat<N> mdag(const Mat<N>& a) {
  Mat<N> o;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) o.a[i][j] = cconj(a.a[j][i]);
  return o;
}

template <int N>
__device__ __forceinline__ Mat<N> madd(const Mat<N>& a, const Mat<N>& b) {
  Mat<N> o;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) o.a[i][j] = cadd(a.a[i][j], b.a[i][j]);
  return o;
}

// ---------------------------------------------------------------------------
// two-row codec: rows 0-1 stored; SU(3) row 2 = conj(row0 x row1), SU(2)
// stores its whole matrix
// ---------------------------------------------------------------------------

__device__ __forceinline__ void codec_row2(M3& m) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    C a = cmul(m.a[0][(k + 1) % 3], m.a[1][(k + 2) % 3]);
    C b = cmul(m.a[0][(k + 2) % 3], m.a[1][(k + 1) % 3]);
    m.a[2][k] = cconj({a.re - b.re, a.im - b.im});
  }
}

template <int N>
__device__ __forceinline__ Mat<N> load_mat(const float* __restrict__ arr,
                                           int slot, int v2) {
  Mat<N> m;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      m.a[r][j].re = arr[((r * N + j) * 2 + 0) * v2 + slot];
      m.a[r][j].im = arr[((r * N + j) * 2 + 1) * v2 + slot];
    }
  if constexpr (N == 3) codec_row2(m);
  return m;
}

template <int N>
__device__ __forceinline__ void store_rows(float* arr, int slot, int v2,
                                           const Mat<N>& m) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < N; ++j) {
      arr[((r * N + j) * 2 + 0) * v2 + slot] = m.a[r][j].re;
      arr[((r * N + j) * 2 + 1) * v2 + slot] = m.a[r][j].im;
    }
}

// ---------------------------------------------------------------------------
// direct packed-neighbour addressing
// ---------------------------------------------------------------------------

struct Site { int c[4]; };  // (x, y, z, t)

// slot -> (x, y, z, t) for the array of parity p
__device__ __forceinline__ Site decode_slot(int slot, int p, const Dims& d) {
  Site s;
  int k = slot % d.t2;
  int r = slot / d.t2;
  s.c[2] = r % d.z;
  r /= d.z;
  s.c[1] = r % d.y;
  s.c[0] = r / d.y;
  s.c[3] = 2 * k + ((p + s.c[0] + s.c[1] + s.c[2]) & 1);
  return s;
}

__device__ __forceinline__ int dim_of(const Dims& d, int ax) {
  return ax == 0 ? d.x : ax == 1 ? d.y : ax == 2 ? d.z : d.t;
}

// site + delta * axis-hat, periodic
__device__ __forceinline__ Site step(Site s, int ax, int delta, const Dims& d) {
  int n = dim_of(d, ax);
  s.c[ax] = (s.c[ax] + delta + n) % n;
  return s;
}

// slot of a site in the array of its own parity
__device__ __forceinline__ int encode_slot(const Site& s, const Dims& d) {
  return ((s.c[0] * d.y + s.c[1]) * d.z + s.c[2]) * d.t2 + s.c[3] / 2;
}

__device__ __forceinline__ uint32_t dense_index(const Site& s, const Dims& d) {
  return (uint32_t)(((s.c[0] * d.y + s.c[1]) * d.z + s.c[2]) * d.t + s.c[3]);
}

// the slot a thread updates: its own slot in an unpadded array
__device__ __forceinline__ int own_slot(int slot, const Site&, const Dims&) {
  return slot;
}

// --- the same on a halo-padded shard (ShardDims) ---------------------------

// interior index -> interior (x, y, z, t), t by the global parity rule
__device__ __forceinline__ Site decode_slot(int slot, int p,
                                            const ShardDims& d) {
  Site s;
  int k = slot % d.t2;
  int r = slot / d.t2;
  s.c[2] = r % d.z;
  r /= d.z;
  s.c[1] = r % d.y;
  s.c[0] = r / d.y;
  s.c[3] = 2 * k + ((p + d.x0 + s.c[0] + d.y0 + s.c[1] + s.c[2]) & 1);
  return s;
}

// site + delta * axis-hat: into the halo on a split axis, periodic otherwise
__device__ __forceinline__ Site step(Site s, int ax, int delta,
                                     const ShardDims& d) {
  if ((ax == 0 && d.hx) || (ax == 1 && d.hy)) {
    s.c[ax] += delta;
    return s;
  }
  const int n = ax == 0 ? d.x : ax == 1 ? d.y : ax == 2 ? d.z : d.t;
  s.c[ax] = (s.c[ax] + delta + n) % n;
  return s;
}

// slot of a site (interior or halo) in the padded array of its own parity
__device__ __forceinline__ int encode_slot(const Site& s, const ShardDims& d) {
  return (((s.c[0] + d.hx) * d.py + s.c[1] + d.hy) * d.z + s.c[2]) * d.t2 +
         s.c[3] / 2;
}

// the GLOBAL dense index of an interior site (threefry's counter; the
// global volume must stay below 2^31)
__device__ __forceinline__ uint32_t dense_index(const Site& s,
                                                const ShardDims& d) {
  return (uint32_t)((((s.c[0] + d.x0) * d.gy + s.c[1] + d.y0) * d.z + s.c[2]) *
                        d.t + s.c[3]);
}

__device__ __forceinline__ int own_slot(int, const Site& s,
                                        const ShardDims& d) {
  return encode_slot(s, d);
}

// U_dir at a site whose parity is par (D: Dims or ShardDims)
template <int N, class D>
__device__ __forceinline__ Mat<N> load_link(const Links& L, int dir, int par,
                                            const Site& s, const D& d) {
  return load_mat<N>(L.p[2 * dir + par], encode_slot(s, d), d.v2);
}

// ---------------------------------------------------------------------------
// threefry2x32-20 (bit-identical to ops/rng.py)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t& o0, uint32_t& o1) {
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += k0;
  x1 += k1;
#pragma unroll
  for (int r = 0; r < 20; ++r) {
    x0 += x1;
    x1 = rotl32(x1, rot[r % 8]);
    x1 ^= x0;
    if ((r + 1) % 4 == 0) {
      const int inject = (r + 1) / 4;
      x0 += ks[inject % 3];
      x1 += ks[(inject + 1) % 3] + (uint32_t)inject;
    }
  }
  o0 = x0;
  o1 = x1;
}

// ---------------------------------------------------------------------------
// Philox-4x32-10 (Salmon et al., SC'11: Random123's philox4x32 with 10
// rounds; bit-identical to ops/rng.py philox4x32)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void philox4x32(uint32_t k0, uint32_t k1,
                                           uint32_t c0, uint32_t c1,
                                           uint32_t c2, uint32_t c3,
                                           uint32_t o[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c0, hi0 = __umulhi(0xD2511F53u, c0);
    const uint32_t lo1 = 0xCD9E8D57u * c2, hi1 = __umulhi(0xCD9E8D57u, c2);
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  o[0] = c0;
  o[1] = c1;
  o[2] = c2;
  o[3] = c3;
}

// u32 -> f32 in the open interval (0, 1) on the 24-bit grid
__device__ __forceinline__ float bits_to_uniform(uint32_t b) {
  return ((float)(b >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

// ---------------------------------------------------------------------------
// polynomial transcendentals (ops/fastmath.py; coefficients rounded to f32
// from the same double literals)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float log_u01(float x) {
  const int bits = __float_as_int(x);
  const int e = ((bits >> 23) & 0xFF) - 127;
  float m = __int_as_float((bits & 0x007FFFFF) | 0x3F800000);
  const bool big = m > (float)1.41421356;
  m = big ? 0.5f * m : m;
  const float ef = (float)(big ? e + 1 : e);
  const float t = m - 1.0f;
  const float z = t * t;
  float p = (float)7.0376836292e-2;
  p = p * t + (float)-1.1514610310e-1;
  p = p * t + (float)1.1676998740e-1;
  p = p * t + (float)-1.2420140846e-1;
  p = p * t + (float)1.4249322787e-1;
  p = p * t + (float)-1.6668057665e-1;
  p = p * t + (float)2.0000714765e-1;
  p = p * t + (float)-2.4999993993e-1;
  p = p * t + (float)3.3333331174e-1;
  const float y = t * z * p - 0.5f * z + ef * (float)-2.12194440e-4;
  return t + y + ef * (float)0.693359375;
}

__device__ __forceinline__ float poly_cos(float s) {
  float p = (float)-26.426256783374378;
  p = p * s + (float)60.24464137187666;
  p = p * s + (float)-85.45681720669372;
  p = p * s + (float)64.93939402266829;
  p = p * s + (float)-19.739208802178716;
  p = p * s + 1.0f;
  return p;
}

__device__ __forceinline__ float poly_sin(float s) {
  float p = (float)3.8199525848482803;
  p = p * s + (float)-15.094642576822984;
  p = p * s + (float)42.058693944897634;
  p = p * s + (float)-76.70585975306136;
  p = p * s + (float)81.60524927607504;
  p = p * s + (float)-41.341702240399755;
  p = p * s + (float)6.283185307179586;
  return p;
}

// cos(2 pi r)^2, r in [0, 1)
__device__ __forceinline__ float cos2_2pi(float r) {
  const float k = rintf(2.0f * r);
  const float f = r - 0.5f * k;
  const float p = poly_cos(f * f);
  return p * p;
}

// (sin, cos)(2 pi r), r in [0, 1)
__device__ __forceinline__ void sincos_2pi(float r, float& sn, float& cs) {
  const float k = rintf(2.0f * r);
  const float f = r - 0.5f * k;
  const float sign = 1.0f - 2.0f * (k - 2.0f * floorf(k * 0.5f));
  const float s = f * f;
  sn = sign * f * poly_sin(s);
  cs = sign * poly_cos(s);
}

// ---------------------------------------------------------------------------
// deterministic f64 block reduction
// ---------------------------------------------------------------------------

// Tree-sum sh[0..blockDim.x) in a fixed order; the result lands in sh[0].
// blockDim.x must be a power of two.  Every thread of the block must call it.
__device__ __forceinline__ void block_tree_sum(double* sh) {
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    __syncthreads();
    if ((int)threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
  }
  __syncthreads();
}

// Sum one count per thread over the block and add the block's total to
// *total with one 64-bit atomic.  Integer addition is order-free, so the
// result does not depend on the order the blocks run in.  Every thread of
// the block must call it; blockDim.x must be a multiple of 32.
__device__ __forceinline__ void block_count_add(unsigned c,
                                                unsigned long long* total) {
  __shared__ unsigned warp_sums[32];
  c = __reduce_add_sync(0xffffffffu, c);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long s = 0;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += warp_sums[w];
    if (s) atomicAdd(total, s);
  }
}

}  // namespace qg
