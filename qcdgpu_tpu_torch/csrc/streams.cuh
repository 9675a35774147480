// The PRNGCL per-site generators as device code, for the stage kernel's
// stream instantiations (stage.cuh, stage_<family>.cu).
//
// Replaces the TPU kernel helpers qcdgpu_tpu/ops/prng_streams.py:
// kernel_stream_draw (K7: xor128, xor7, mrg32k3a, parkmiller, constant, on
// word lists) and kernel_stream_draw_ref (K8: ranlux0-4 and ranmar, whose lag
// window is mutated in absolute slots driven by the scalars (s0, ptr0)).
// Plain PyTorch twin: ops/prng_streams.py draw_words, bit for bit.
//
// Each thread owns one site's words, word k of slot i at ws[k * stride + i]
// ([W, X, Y, Z*T/2], so a warp's loads of one word are coalesced), and no
// other thread touches them: the state is updated in place.  A generator G
// has load(ws, slot, stride, s0, ptr0, skip), next() -> the raw f32 draw on
// [0, 1], and store().  Draws are consumed one at a time in the samplers'
// order, so:
//  - the counter-free generators keep their words in registers and write
//    them back once; xor7 rotates its 8 words after each step, so its
//    walking index stays at slot 0 (the reference's canonical k = 0);
//  - ranlux walks a pointer down its 24-word window, which lives in a local
//    array (in L1) because the pointer is a run-time value; the luxury skip
//    of skip_len subtract-with-borrow steps fires before the draw that
//    finds 24 draws since the last one (the reference's
//    (nb0 + t) % 24 == 0 and nb0 + t > 0);
//  - ranmar's 97-word window stays in device memory, read and written in
//    place at the pointer; its carry is kept on the 2^-24 integer grid.
// u32 -> f32 is the correctly rounded __uint2float_rn (the reference's
// _f32_from_u32 reaches the same value through two exact halves: a TPU
// workaround, not ported).  mrg32k3a forms its products in 64 bits and folds
// 2^32 = c (mod m) where the reference uses 16-bit limbs; the residue is the
// same.
//
// What bounds it: a few integer operations per draw for the counter-free
// generators; ranlux3 adds about 2.25 x 199 SWB steps per site per SU(3)
// heat-bath stage (each two L1 loads and a store); ranmar's window is 388 B
// per site, of which a stage touches its 54 or so slots at 8 B to 12 B each.
#pragma once

#include "stage.cuh"

namespace qg {

__device__ __forceinline__ float open01(float u) {
  return fminf(fmaxf(u, 0x1p-24f), 1.0f - 0x1p-24f);
}

struct Xor128 {
  uint32_t* p;
  int stride;
  uint32_t x, y, z, w;
  __device__ __forceinline__ void load(void* ws, int slot, int stride_,
                                       uint32_t, int, int) {
    p = (uint32_t*)ws + slot;
    stride = stride_;
    x = p[0];
    y = p[stride];
    z = p[2 * stride];
    w = p[3 * stride];
  }
  __device__ __forceinline__ float next() {
    const uint32_t t = x ^ (x << 11);
    const uint32_t w2 = w ^ (w >> 19) ^ t ^ (t >> 8);
    x = y;
    y = z;
    z = w;
    w = w2;
    return __uint2float_rn(w2) * 0x1p-32f;
  }
  __device__ __forceinline__ void store() {
    p[0] = x;
    p[stride] = y;
    p[2 * stride] = z;
    p[3 * stride] = w;
  }
};

struct Xor7 {
  uint32_t* p;
  int stride;
  uint32_t x[8];  // walking index at slot 0
  __device__ __forceinline__ void load(void* ws, int slot, int stride_,
                                       uint32_t, int, int) {
    p = (uint32_t*)ws + slot;
    stride = stride_;
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = p[k * stride];
  }
  __device__ __forceinline__ float next() {
    uint32_t t = x[7];
    t ^= t << 13;
    uint32_t y = t ^ (t << 9);
    t = x[4];
    y ^= t ^ (t << 7);
    t = x[3];
    y ^= t ^ (t >> 3);
    t = x[1];
    y ^= t ^ (t >> 10);
    t = x[0];
    t ^= t >> 7;
    y ^= t ^ (t << 24);
    // write slot k, advance k: rotate so that k stays at slot 0
#pragma unroll
    for (int k = 0; k < 7; ++k) x[k] = x[k + 1];
    x[7] = y;
    return __uint2float_rn(y) * 0x1p-32f;
  }
  __device__ __forceinline__ void store() {
#pragma unroll
    for (int k = 0; k < 8; ++k) p[k * stride] = x[k];
  }
};

// (a * s) mod m for m = 2^32 - c, a < 2^21, s < m: the 53-bit product,
// then 2^32 = c (mod m) folded twice and one conditional subtraction.
__device__ __forceinline__ uint32_t mrg_mulmod(uint32_t a, uint32_t s,
                                               uint32_t m, uint32_t c) {
  uint64_t v = (uint64_t)a * s;                       // < 2^53
  v = (v >> 32) * c + (v & 0xFFFFFFFFull);            // < 2^37
  v = (v >> 32) * c + (v & 0xFFFFFFFFull);            // < 2^32 + 2^21
  return (uint32_t)(v >= m ? v - m : v);
}

__device__ __forceinline__ uint32_t mrg_submod(uint32_t a, uint32_t b,
                                               uint32_t m) {
  return a >= b ? a - b : a + (m - b);
}

struct Mrg32k3a {
  static constexpr uint32_t M1 = 4294967087u, C1 = 209u;
  static constexpr uint32_t M2 = 4294944443u, C2 = 22853u;
  uint32_t* p;
  int stride;
  uint32_t s10, s11, s12, s20, s21, s22;
  __device__ __forceinline__ void load(void* ws, int slot, int stride_,
                                       uint32_t, int, int) {
    p = (uint32_t*)ws + slot;
    stride = stride_;
    s10 = p[0];
    s11 = p[stride];
    s12 = p[2 * stride];
    s20 = p[3 * stride];
    s21 = p[4 * stride];
    s22 = p[5 * stride];
  }
  __device__ __forceinline__ float next() {
    const uint32_t p1 = mrg_submod(mrg_mulmod(1403580u, s11, M1, C1),
                                   mrg_mulmod(810728u, s10, M1, C1), M1);
    const uint32_t p2 = mrg_submod(mrg_mulmod(527612u, s22, M2, C2),
                                   mrg_mulmod(1370589u, s20, M2, C2), M2);
    s10 = s11;
    s11 = s12;
    s12 = p1;
    s20 = s21;
    s21 = s22;
    s22 = p2;
    uint32_t z = mrg_submod(p1, p2, M1);
    if (z == 0) z = M1;
    return __uint2float_rn(z) * (float)2.328306549295728e-10;
  }
  __device__ __forceinline__ void store() {
    p[0] = s10;
    p[stride] = s11;
    p[2 * stride] = s12;
    p[3 * stride] = s20;
    p[4 * stride] = s21;
    p[5 * stride] = s22;
  }
};

struct ParkMiller {
  int* p;
  int s;
  __device__ __forceinline__ void load(void* ws, int slot, int, uint32_t, int,
                                       int) {
    p = (int*)ws + slot;
    s = p[0];
  }
  __device__ __forceinline__ float next() {
    // Schrage's decomposition: every intermediate below 2^31
    const int hi = s / 127773;
    const int t = 16807 * (s - hi * 127773) - 2836 * hi;
    s = t > 0 ? t : t + 2147483647;
    return __int2float_rn(s) * (float)(1.0 / 2147483647.0);
  }
  __device__ __forceinline__ void store() { p[0] = s; }
};

struct Constant {
  float v;
  __device__ __forceinline__ void load(void* ws, int slot, int, uint32_t, int,
                                       int) {
    v = ((const float*)ws)[slot];
  }
  __device__ __forceinline__ float next() { return v; }
  __device__ __forceinline__ void store() {}
};

struct Ranlux {
  int* p;
  int stride;
  int w[24];  // the lag window in absolute slots (local memory)
  int carry, i, nb, skip;
  __device__ __forceinline__ void load(void* ws, int slot, int stride_,
                                       uint32_t s0, int ptr0, int skip_) {
    p = (int*)ws + slot;
    stride = stride_;
    for (int k = 0; k < 24; ++k) w[k] = p[k * stride];
    carry = p[24 * stride];
    i = ptr0;
    nb = (int)s0;
    skip = skip_;
  }
  // one subtract-with-borrow step at the pointer i (j = i - 14 mod 24)
  __device__ __forceinline__ int swb() {
    const int j = i >= 14 ? i - 14 : i + 10;
    int d = w[j] - w[i] - carry;
    carry = d < 0 ? 1 : 0;
    if (carry) d += 1 << 24;
    w[i] = d;
    i = i == 0 ? 23 : i - 1;
    return d;
  }
  __device__ __forceinline__ float next() {
    if (nb == 24) {  // luxury skip: discard skip values
      for (int k = 0; k < skip; ++k) swb();
      nb = 0;
    }
    const int d = swb();
    ++nb;
    return __int2float_rn(d) * 0x1p-24f;
  }
  __device__ __forceinline__ void store() {
    for (int k = 0; k < 24; ++k) p[k * stride] = w[k];
    p[24 * stride] = carry;
  }
};

struct Ranmar {
  static constexpr int CD = 7654321, CM = 16777213;  // in 2^-24 grid units
  float* p;
  int stride;
  int i, ci;
  __device__ __forceinline__ void load(void* ws, int slot, int stride_,
                                       uint32_t s0, int ptr0, int) {
    p = (float*)ws + slot;
    stride = stride_;
    i = ptr0;
    ci = (int)s0;
  }
  __device__ __forceinline__ float next() {
    const int j = i >= 64 ? i - 64 : i + 33;
    float uni = p[i * stride] - p[j * stride];
    uni = uni + (uni < 0.0f ? 1.0f : 0.0f);
    p[i * stride] = uni;
    i = i == 0 ? 96 : i - 1;
    ci -= CD;
    if (ci < 0) ci += CM;
    float out = uni - __int2float_rn(ci) * 0x1p-24f;  // exact: both on the grid
    return out + (out < 0.0f ? 1.0f : 0.0f);
  }
  __device__ __forceinline__ void store() {}
};

// The random source of a stream instantiation: a pair is the next two
// draws, each clamped into (0, 1) by open01.
template <class G>
struct Stream {
  void* ws;
  int stride;
  uint32_t s0;
  int ptr0, skip;

  struct Src {
    // each draw steps the generator: every draw is made, used or not
    static constexpr bool kCounter = false;
    G g;
    __device__ __forceinline__ void subgroup(uint32_t) {}
    __device__ __forceinline__ void pair(uint32_t, float& a, float& b) {
      a = open01(g.next());
      b = open01(g.next());
    }
    __device__ __forceinline__ void close() { g.store(); }
  };

  // slot: the thread's site index, which is also its words' index (a
  // shard's words are unpadded: [W, x, y, Z*T/2] of its interior)
  __device__ __forceinline__ Src open(int slot, const SiteAddr&) const {
    Src src;
    src.g.load(ws, slot, stride, s0, ptr0, skip);
    return src;
  }
};

}  // namespace qg

// The body of stage_<family>.cu: the launchers of family `fam` (generator
// struct `Gen`), unsharded and on a shard, 8 instantiations each.
#define QG_DEFINE_STREAM_LAUNCHER(fam, Gen)                                   \
  namespace qg {                                                              \
  QG_STREAM_LAUNCHER(fam, Dims) {                                             \
    const Stream<Gen> rng = {ws, stride, s0, ptr0, skip};                     \
    return launch_drawing(L, n, kind, track, mu, parity, d, rng, tbn,         \
                          k_trials, n_hit, delta, cnt, s);                    \
  }                                                                           \
  QG_STREAM_LAUNCHER(fam, ShardDims) {                                        \
    const Stream<Gen> rng = {ws, stride, s0, ptr0, skip};                     \
    return launch_drawing(L, n, kind, track, mu, parity, d, rng, tbn,         \
                          k_trials, n_hit, delta, cnt, s);                    \
  }                                                                           \
  }
