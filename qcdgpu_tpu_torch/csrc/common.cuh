// Device helpers shared by the qcdgpu_tpu_torch kernels: (re, im) complex
// and N x N matrix algebra (Mat<2>, Mat<3>), the two-row codec, packed-
// neighbour addressing by slot deltas, threefry2x32-20, Philox-4x32-10 (the fast
// counter-based source of rng_mode "hw"), the sampler's polynomial
// transcendentals and the block reductions.
// They replace the TPU kernels' inlined helpers (qcdgpu_tpu/ops/pallas/
// core.py: threefry2x32, bits_to_uniform, _codec_rows, shift_comp_packed,
// slab_site_index_packed; qcdgpu_tpu/ops/fastmath.py), which worked on whole
// [Y, Z*T/2] slabs; here each is a per-thread scalar function, so the
// neighbour shifts become slot deltas instead of rolls and masks.
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

// n / d for 0 <= n < 2^31 by one multiply-high and a shift, with the
// magic computed on the host (Granlund and Montgomery's round-up method, as
// in CUTLASS's FastDivmod): m = ceil(2^(31 + l) / d), l = ceil(log2 d), is
// exact on that range.  It replaces the ~20-instruction runtime divisions of
// a slot's decode.
struct FastDiv {
  int d;
  uint32_t mul, shr;
};

__host__ inline FastDiv make_fastdiv(int d) {
  FastDiv f = {d, 0u, 0u};
  if (d > 1) {
    int l = 0;
    while ((1ll << l) < d) ++l;
    f.mul = (uint32_t)(((1ull << (31 + l)) + (uint64_t)d - 1) / (uint64_t)d);
    f.shr = (uint32_t)(l - 1);
  }
  return f;
}

__device__ __forceinline__ int div_by(int n, const FastDiv& f) {
  return f.d == 1 ? n : (int)(__umulhi((uint32_t)n, f.mul) >> f.shr);
}

struct Dims {
  int x, y, z, t;  // lattice extents (T even)
  int t2;          // T / 2
  int v2;          // X*Y*Z*T/2: slots per packed array
  FastDiv ft2, fz, fy;  // division by T/2, Z and Y (a slot's decode)
};

__host__ inline Dims make_dims(int X, int Y, int Z, int T) {
  Dims d;
  d.x = X; d.y = Y; d.z = Z; d.t = T; d.t2 = T / 2;
  d.v2 = X * Y * Z * (T / 2);
  d.ft2 = make_fastdiv(d.t2);
  d.fz = make_fastdiv(Z);
  d.fy = make_fastdiv(Y);
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
// A kernel runs one thread per interior site, numbered in slot order over
// the interior; its slot in the padded array is SiteAddr::own.  Slots are
// int: 4 N v2 < 2^31 is checked by the wrappers (core.check_packed).
struct ShardDims {
  int x, y, z, t;  // interior extents (Z and T are never split)
  int t2;          // T / 2
  int hx, hy;      // 1 where the axis is split, else 0
  int py;          // padded rows: y + 2 hy
  int v2;          // slots per padded array: (x + 2 hx) * py * z * t2
  int n;           // interior sites per parity: x * y * z * t2
  int x0, y0;      // global coordinates of the first interior slab and row
  int gy;          // global Y extent (the dense site index's row stride)
  FastDiv ft2, fz, fy;  // division by T/2, Z and the interior Y
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
  d.ft2 = make_fastdiv(d.t2);
  d.fz = make_fastdiv(Z);
  d.fy = make_fastdiv(ly);
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

// L.p[2 * dir + par] by constant-index selects: indexing the parameter
// array with a run-time index makes the compiler copy it to a stack frame,
// and then every link load is a generic load behind a local one
__device__ __forceinline__ float* link_array(const Links& L, int dir,
                                             int par) {
  float* const even = dir == 0 ? L.p[0] : dir == 1 ? L.p[2]
                      : dir == 2 ? L.p[4] : L.p[6];
  float* const odd = dir == 0 ? L.p[1] : dir == 1 ? L.p[3]
                     : dir == 2 ? L.p[5] : L.p[7];
  return par ? odd : even;
}

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
// packed-neighbour addressing: slot deltas, no division, no frame
// ---------------------------------------------------------------------------

// A site of the parity a kernel works on: its own slot, its counter, and
// the slot change of one step along each axis.  The arrays of both
// parities share one layout and a site's slot is linear in x, y and z with
// a wrap on each, and in t through t / 2, so a neighbour's slot (in the
// other parity's array) is own + fwd[a] (+1 along a) or own + bwd[a] (-1),
// and x + mu - nu is own + fwd[mu] + bwd[nu] (mu != nu: the steps act on
// different coordinates).  The deltas are built once per site with
// compare-and-select wraps; fwd / bwd are only indexed by constants (the
// unrolled loops) or through pick(), so they stay in registers.  It
// replaces the decode / step / re-encode of every neighbour (three runtime
// divisions, a `% n` per step and a runtime-indexed coordinate array in a
// stack frame).
struct SiteAddr {
  int own;          // slot in the (padded) array of the site's parity
  uint32_t dense;   // global dense site index (the counter-based sources)
  int fwd[4], bwd[4];
};

// v[i] for a run-time i by constant-index selects (no local array)
__device__ __forceinline__ int pick(int i, const int (&v)[4]) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// the deltas along a spatial axis of extent n and slot stride s at
// coordinate c: periodic, or straight into the halo on a split axis
__device__ __forceinline__ void axis_steps(int c, int n, int s, bool split,
                                           int& f, int& b) {
  f = (!split && c == n - 1) ? -(n - 1) * s : s;
  b = (!split && c == 0) ? (n - 1) * s : -s;
}

// along t, slot t / 2: +1 keeps the pair of an even t and moves an odd t to
// the next pair (T - 1 wraps to 0); -1 the other way round
__device__ __forceinline__ void t_steps(int t, const int T, int t2, int& f,
                                        int& b) {
  const bool odd = (t & 1) != 0;
  f = odd ? (t == T - 1 ? 1 - t2 : 1) : 0;
  b = odd ? 0 : (t == 0 ? t2 - 1 : -1);
}

// thread g (slot order) of parity p on the whole lattice: slot g itself
__device__ __forceinline__ SiteAddr site_addr(int g, int p, const Dims& d) {
  const int r = div_by(g, d.ft2), k = g - r * d.t2;  // r = (x*Y + y)*Z + z
  const int r2 = div_by(r, d.fz), z = r - r2 * d.z;  // r2 = x*Y + y
  const int x = div_by(r2, d.fy), y = r2 - x * d.y;
  const int t = 2 * k + ((p + x + y + z) & 1);
  SiteAddr a;
  a.own = g;
  a.dense = (uint32_t)(r * d.t + t);
  axis_steps(x, d.x, d.y * d.z * d.t2, false, a.fwd[0], a.bwd[0]);
  axis_steps(y, d.y, d.z * d.t2, false, a.fwd[1], a.bwd[1]);
  axis_steps(z, d.z, d.t2, false, a.fwd[2], a.bwd[2]);
  t_steps(t, d.t, d.t2, a.fwd[3], a.bwd[3]);
  return a;
}

// thread g (slot order over the interior) of parity p on a shard: t by the
// global parity rule, the slot in the padded array, the GLOBAL dense index
// (the global volume must stay below 2^31)
__device__ __forceinline__ SiteAddr site_addr(int g, int p,
                                              const ShardDims& d) {
  const int r = div_by(g, d.ft2), k = g - r * d.t2;
  const int r2 = div_by(r, d.fz), z = r - r2 * d.z;
  const int x = div_by(r2, d.fy), y = r2 - x * d.y;
  const int t = 2 * k + ((p + d.x0 + x + d.y0 + y + z) & 1);
  SiteAddr a;
  a.own = (((x + d.hx) * d.py + y + d.hy) * d.z + z) * d.t2 + k;
  a.dense = (uint32_t)((((x + d.x0) * d.gy + y + d.y0) * d.z + z) * d.t + t);
  axis_steps(x, d.x, d.py * d.z * d.t2, d.hx != 0, a.fwd[0], a.bwd[0]);
  axis_steps(y, d.y, d.z * d.t2, d.hy != 0, a.fwd[1], a.bwd[1]);
  axis_steps(z, d.z, d.t2, false, a.fwd[2], a.bwd[2]);
  t_steps(t, d.t, d.t2, a.fwd[3], a.bwd[3]);
  return a;
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

// threadIdx.x and blockIdx read again where they are used: otherwise the
// compiler keeps a kernel's first read alive across all of its work, which
// at the register cap costs K3 a spill
__device__ __forceinline__ unsigned fresh_tid_x() {
#ifdef __CUDA_ARCH__
  unsigned t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
#else
  return threadIdx.x;
#endif
}

// the block's index in the grid, x fastest
__device__ __forceinline__ unsigned fresh_block_index() {
#ifdef __CUDA_ARCH__
  unsigned bx, by;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(by));
  return by * gridDim.x + bx;
#else
  return blockIdx.y * gridDim.x + blockIdx.x;
#endif
}

// Sum K f64 values per thread over the block in a fixed order: a shuffle
// tree in each warp, the warps' sums through shared memory, then thread k
// adds warp sums 0, 1, ... of value k and writes it to row (blockIdx.y *
// gridDim.x + blockIdx.x) of partials [blocks, K].  One barrier.  Every
// thread of the block must call it; blockDim.x must be a multiple of 32.
template <int K>
__device__ __forceinline__ void block_sums(const double (&v)[K],
                                          double* __restrict__ partials) {
  __shared__ double warp_sums[32][K];
  const unsigned tid = fresh_tid_x();
  const int lane = tid & 31, w = tid >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    double s = v[k];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
    if (lane == 0) warp_sums[w][k] = s;
  }
  __syncthreads();
  if ((int)tid < K) {
    double s = warp_sums[0][tid];
    for (int i = 1; i < (int)(blockDim.x >> 5); ++i) s += warp_sums[i][tid];
    partials[(size_t)fresh_block_index() * K + tid] = s;
  }
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
