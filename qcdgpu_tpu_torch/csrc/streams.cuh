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
// has load(ws, slot, stride, s0, ptr0, skip, per, draws) (per: the draws a
// subgroup takes, draws: the stage's), next() -> the raw f32 draw on [0, 1]
// and store(); it may have subgroup(), called as each subgroup starts.
// Draws are consumed one at a time in the samplers' order, so:
//  - the counter-free generators (K7) keep their words in registers and
//    write them back once; xor7 rotates its 8 words after each step, so its
//    walking index stays at slot 0 (the reference's canonical k = 0);
//  - ranlux and ranmar (K8) keep their lag windows in shared memory, each
//    thread in its own column (word k at k * kStageThreads: a warp's
//    accesses of one word fall in 32 banks whatever the word), because the
//    pointer into them is a run-time value; see Ranlux and Ranmar.
// u32 -> f32 is the correctly rounded __uint2float_rn (the reference's
// _f32_from_u32 reaches the same value through two exact halves: a TPU
// workaround, not ported).  mrg32k3a forms each step in f64 (mrg_step)
// where the reference uses 16-bit limbs; the residue is the same.
//
// What bounds it: a few integer operations per draw for the counter-free
// generators, and 17 f64 ones for mrg32k3a, on a pipe K1 does not use
// otherwise (its 64-bit integer form, about 54 integer instructions a draw
// in the SASS, added 0.12 ms to a 32^4 SU(3) heat-bath stage; the f64 one
// adds 0.04).  Ranlux3 adds about 2.25 luxury skips of 199 subtract-with-
// borrow steps per site per SU(3) heat-bath stage (54 draws), 3 integer
// operations a step at the least; with the window in a local array (a
// stack frame, its pointer a run-time index) each step was two loads and a
// store, one dependent step at a time, and ranlux3's stage took 6.5x the
// Philox one.  Ranmar reads the n + 33 slots below ptr0 + 33 that a stage
// of n draws needs and writes n (of 388 B of window a site); read and
// written in place in device memory, each draw's two loads waited behind
// the previous draw's store, which might alias them.
#pragma once

#include <cstring>
#include <utility>

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
                                       uint32_t, int, int, int, int) {
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

// Made up front in shared memory in 8-step blocks (no rotation moves, no
// state registers in the sampler) it measured 1.36-1.41x slower at SU(3)
// heat-bath (PERF.md): the per-draw shared store and load cost more.
struct Xor7 {
  uint32_t* p;
  int stride;
  uint32_t x[8];  // walking index at slot 0
  __device__ __forceinline__ void load(void* ws, int slot, int stride_,
                                       uint32_t, int, int, int, int) {
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

// MRG32k3a (L'Ecuyer): two order-3 recurrences x_n = (a x_{n-2} - b x_{n-3})
// mod m, m = 2^32 - c, every multiplier below 2^21.  Each step is formed
// in f64, L'Ecuyer's floating-point form (mrg_step): the H100's f64 pipe
// is otherwise idle in K1, whose bound is its f32 instructions, while the
// 64-bit integer form (four wide products and their folds a draw) ran on
// the pipe the f32 work shares.  The state stays in registers as six f64
// integers (twelve registers, no frame and no spill at K1's 128).
// Measured and dropped (PERF.md): a 32-bit integer form with one
// reduction a component, the draws made up front in shared memory (both
// forms; slower), and a jump over the heat-bath trials after the first
// accepted one (no faster than the integer form it jumps in).
constexpr double kMrgM1 = 4294967087.0, kMrgM2 = 4294944443.0;
constexpr double kMrgA12 = 1403580.0, kMrgA13 = 810728.0;
constexpr double kMrgA21 = 527612.0, kMrgA23 = 1370589.0;

// (a x - b y) mod m for a, b < 2^21 and x, y < m < 2^32, the same residue
// as exact integer arithmetic: p = a x - b y is an integer below 2^53 in
// magnitude, so the product a x and the FMA that subtracts b y are exact;
// k = p / m rounded to an integer by the 1.5 x 2^52 shifter, from p times
// the rounded reciprocal inv_m (whose error moves the quotient by less
// than 2^-32, so |p / m - k| <= 1/2 + 2^-32); r = p - k m is exact (k m <
// 2^53) and |r| < m / 2 + 1, so one conditional + m gives the residue in
// [0, m).
__device__ __forceinline__ double mrg_step(double a, double x, double b,
                                           double y, double m,
                                           double inv_m) {
  constexpr double kShift = 6755399441055744.0;  // 1.5 x 2^52
  const double p = __fma_rn(-b, y, __dmul_rn(a, x));
  const double k = __dadd_rn(__fma_rn(p, inv_m, kShift), -kShift);
  const double r = __fma_rn(-k, m, p);
  return r < 0.0 ? __dadd_rn(r, m) : r;
}

struct Mrg32k3a {
  uint32_t* p;
  int stride;
  double s10, s11, s12, s20, s21, s22;
  __device__ __forceinline__ void load(void* ws, int slot, int stride_,
                                       uint32_t, int, int, int, int) {
    p = (uint32_t*)ws + slot;
    stride = stride_;
    s10 = __uint2double_rn(p[0]);
    s11 = __uint2double_rn(p[stride]);
    s12 = __uint2double_rn(p[2 * stride]);
    s20 = __uint2double_rn(p[3 * stride]);
    s21 = __uint2double_rn(p[4 * stride]);
    s22 = __uint2double_rn(p[5 * stride]);
  }
  __device__ __forceinline__ float next() {
    const double p1 = mrg_step(kMrgA12, s11, kMrgA13, s10, kMrgM1,
                               1.0 / kMrgM1);
    const double p2 = mrg_step(kMrgA21, s22, kMrgA23, s20, kMrgM2,
                               1.0 / kMrgM2);
    s10 = s11;
    s11 = s12;
    s12 = p1;
    s20 = s21;
    s21 = s22;
    s22 = p2;
    // (p1 - p2) mod m1, and m1 for 0 (p2 < m2 < m1); an integer below 2^32,
    // rounded to f32 as __uint2float_rn rounds it
    double z = __dadd_rn(p1, -p2);
    if (z <= 0.0) z = __dadd_rn(z, kMrgM1);
    return __double2float_rn(z) * (float)2.328306549295728e-10;
  }
  __device__ __forceinline__ void store() {
    p[0] = __double2uint_rn(s10);
    p[stride] = __double2uint_rn(s11);
    p[2 * stride] = __double2uint_rn(s12);
    p[3 * stride] = __double2uint_rn(s20);
    p[4 * stride] = __double2uint_rn(s21);
    p[5 * stride] = __double2uint_rn(s22);
  }
};

struct ParkMiller {
  int* p;
  int s;
  __device__ __forceinline__ void load(void* ws, int slot, int, uint32_t, int,
                                       int, int, int) {
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
                                       int, int, int) {
    v = ((const float*)ws)[slot];
  }
  __device__ __forceinline__ float next() { return v; }
  __device__ __forceinline__ void store() {}
};

// (i - k) mod 24 for a pointer i in [0, 24) and 0 <= k < 24: the slot k
// steps below i in ranlux's lag window
__device__ __forceinline__ int lag24(int i, int k) {
  const int s = i - k;
  return s < 0 ? s + 24 : s;
}

// M subtract-with-borrow steps on a window in registers held in the
// canonical rotation (r[k] is the slot k steps below the pointer): step t
// writes r[t] from r[t + 14] (j = i - 14), the pointer walking down one slot
// a step.  All slots are compile-time indices.  M = 24 is a whole lag cycle:
// the pointer comes back to r[0] and the rotation is unchanged.  A borrow
// adds 2^24: for d in [-2^24, 2^24), d & (2^24 - 1) is exactly that.
template <int M>
__device__ __forceinline__ void swb_steps(int (&r)[24], int& carry) {
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const int d = r[(t + 14) % 24] - r[t] - carry;
    carry = (int)((unsigned)d >> 31);
    r[t] = d & 0xFFFFFF;
  }
}

// A 4-byte copy from device to shared memory that holds no register
// (cp.async): a thread's copies have landed once it calls wait_copies(), so
// a window's words are all in flight at once.
__device__ __forceinline__ void copy_async4(void* smem, const void* gmem) {
#ifdef __CUDA_ARCH__
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
#else
  memcpy(smem, gmem, 4);
#endif
}

__device__ __forceinline__ void wait_copies() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// ranlux0-4: x_n = x_{n-10} - x_{n-24} - carry on 24-bit words, the skip_len
// luxury values discarded before the draw that finds 24 draws since the
// last skip (the reference's (nb0 + t) % 24 == 0 and nb0 + t > 0).
//
// The window, its carry, pointer i and luxury counter nb live in the
// thread's column of dynamic shared memory (the first 25 words filled by
// cp.async), and as each subgroup starts, its draws are made into the
// column's next words, which the sampler then reads one by one.  So the
// generator's registers are live only while it runs, before each
// subgroup's trials, where K1 holds few values of its own: no frame and no
// spill at K1's 128 registers.  Its draws step the window in shared memory
// one at a time (j = i - 14, the pointer walking down); a luxury skip
// loads the window into registers in the canonical rotation (word k from
// slot (i - k) mod 24), runs skip / 24 whole 24-step blocks on static
// slots, then the remainder skip % 24 (0, 0, 1, 7, 5 for levels 0-4) on
// static slots too, and stores it back under the pointer it was loaded at,
// which moves down by the remainder.  A skip costs 3 integer operations a
// step.  The skip length must be one whose remainder luxury_skip knows
// (launchable).
//
// A column holds at most kMaxPer draws.  A subgroup of more (k_trials or
// n_hit past about 100) runs the kChunked instantiation, which the
// launcher picks from the draw count: it makes them a chunk of kMaxPer at a
// time, the next chunk when the sampler has read the last one, from the
// same pointer, carry and counter, so the words are the same for any
// length.  That refill runs inside the sampler, where K1 holds the most
// values, so it steps its luxury skips in shared memory (a few registers)
// and keeps the count of draws still to make in the column (word 27).
// Only that instantiation carries the refill: in the one every shorter
// subgroup runs, its check cost SU(3) heat-bath 45 % inlined, and 4 %
// (Metropolis 2 %, 25 hits 6 %) as a __noinline__ function with no frame
// (measured, PERF.md).
// Dynamic shared memory: (kHead + min(per, kMaxPer)) words a thread.
// Measured and dropped (PERF.md): the whole window in registers for the
// whole sampler (ptxas, sm_90a, crashed on it at 3 and at 4 blocks an SM),
// the window in shared memory stepped one draw at a time (1.5x slower at
// SU(3) heat-bath), the same with the skip in registers inside the
// sampler (spills), and a 24-draw buffer refilled inside the sampler.
template <bool kChunked>
struct Ranlux {
  // column words: window slot k at k, carry 24, i 25, nb 26, (kChunked)
  // the subgroup's draws still to make 27, then the draws from kHead
  static constexpr int kHead = kChunked ? 28 : 27;
  static constexpr int kMaxPer = 413;  // draws a column holds
  static constexpr int kDynSmem = (kHead + kMaxPer) * kStageThreads * 4;
  using Chunked = Ranlux<true>;  // the instantiation of longer subgroups
  static int dyn_smem_bytes(int per, int) {
    return (kHead + (per < kMaxPer ? per : kMaxPer)) * kStageThreads * 4;
  }
  static bool launchable(int skip, int per) {
    const int rem = skip % 24;
    return skip >= 0 && (kChunked ? per > kMaxPer : per <= kMaxPer) &&
           (rem == 0 || rem == 1 || rem == 5 || rem == 7);
  }
  int* p;
  int* w;  // column word k at w[k * T]
  int stride, skip, per, q;
  __device__ __forceinline__ void load(void* ws, int slot, int stride_,
                                       uint32_t s0, int ptr0, int skip_,
                                       int per_, int) {
    extern __shared__ int lux_cols[];
    w = lux_cols + fresh_tid_x();
    p = (int*)ws + slot;
    stride = stride_;
    skip = skip_;
    per = per_;
#pragma unroll
    for (int k = 0; k < 25; ++k)
      copy_async4(w + k * kStageThreads, p + k * stride);
    wait_copies();
    w[25 * kStageThreads] = ptr0;
    w[26 * kStageThreads] = (int)s0;
    q = 0;
  }
  // one step at the pointer i, in shared memory
  __device__ __forceinline__ int swb(int& i, int& carry) {
    const int j = i >= 14 ? i - 14 : i + 10;
    const int d = w[j * kStageThreads] - w[i * kStageThreads] - carry;
    carry = (int)((unsigned)d >> 31);
    w[i * kStageThreads] = d & 0xFFFFFF;
    i = i == 0 ? 23 : i - 1;
    return d & 0xFFFFFF;
  }
  __device__ __forceinline__ void luxury_skip(int& i, int& carry) {
    int r[24];
    const int i0 = i;
#pragma unroll
    for (int k = 0; k < 24; ++k) r[k] = w[lag24(i0, k) * kStageThreads];
    for (int b = skip / 24; b > 0; --b) swb_steps<24>(r, carry);
    // ranlux0-4: 0, 24, 73, 199, 365 = 24 b + 0, 0, 1, 7, 5 (launchable
    // refuses any other remainder)
    const int rem = skip % 24;
    switch (rem) {
      case 1: swb_steps<1>(r, carry); break;
      case 5: swb_steps<5>(r, carry); break;
      case 7: swb_steps<7>(r, carry); break;
      case 0: break;
    }
    // r[k] is slot (i0 - k) whatever the steps: stored where it was loaded
#pragma unroll
    for (int k = 0; k < 24; ++k) w[lag24(i0, k) * kStageThreads] = r[k];
    i = lag24(i0, rem);
  }
  // the next n draws into the column from kHead: the skips in registers
  // as a subgroup starts, stepped in shared memory for a refill
  template <bool kSkipInRegisters>
  __device__ __forceinline__ void make(int n) {
    int carry = w[24 * kStageThreads], i = w[25 * kStageThreads];
    int nb = w[26 * kStageThreads];
    for (int c = 0; c < n; ++c) {
      if (nb == 24) {
        if constexpr (kSkipInRegisters) {
          luxury_skip(i, carry);
        } else {
          for (int k = 0; k < skip; ++k) swb(i, carry);
        }
        nb = 0;
      }
      w[(kHead + c) * kStageThreads] = swb(i, carry);
      ++nb;
    }
    w[24 * kStageThreads] = carry;
    w[25 * kStageThreads] = i;
    w[26 * kStageThreads] = nb;
    q = 0;
  }
  __device__ __forceinline__ void subgroup() {
    if constexpr (kChunked) {
      w[27 * kStageThreads] = per - kMaxPer;
      make<true>(kMaxPer);
    } else {
      make<true>(per);
    }
  }
  __device__ __forceinline__ float next() {
    if constexpr (kChunked) {
      if (q == kMaxPer) {
        const int left = w[27 * kStageThreads];
        const int n = left < kMaxPer ? left : kMaxPer;
        w[27 * kStageThreads] = left - n;
        make<false>(n);
      }
    }
    const int d = w[(kHead + q) * kStageThreads];
    ++q;
    return __int2float_rn(d) * 0x1p-24f;
  }
  __device__ __forceinline__ void store() {
#pragma unroll
    for (int k = 0; k < 25; ++k) p[k * stride] = w[k * kStageThreads];
  }
};
// ranmar: u_i <- u_i - u_j (+1 if negative), j = i - 64 (mod 97), the
// pointer walking down; the output subtracts the carry, kept on the 2^-24
// integer grid (exact: both on the grid).
//
// A stage of n draws reads the n + 33 slots from ptr0 + 33 down (all 97
// once n > 64): they are staged at load by cp.async, all in flight at once,
// into the thread's column of dynamic shared memory at the relative index
// o = (ptr0 + 33 - slot) mod 97, so draw t reads o = t + 33 (its i) and
// o = t (its j, which draw t - 33 wrote) and writes o = t + 33; the slots
// written are stored back once.  Dynamic shared memory: min(n + 33, 97)
// words a thread.  Measured and dropped (PERF.md): the whole window
// staged by plain loads (slower at SU(2), which reads 51 of the 97 words),
// the staged slots by plain loads (a round trip per few loads), and a ring
// of the last 33 outputs with the other reads through the read-only path
// (no faster than reading and writing the window in place).
struct Ranmar {
  static constexpr int kDynSmem = 97 * kStageThreads * 4;
  static constexpr int CD = 7654321, CM = 16777213;  // in 2^-24 grid units
  static int dyn_smem_bytes(int, int draws) {
    return (draws + 33 < 97 ? draws + 33 : 97) * kStageThreads * 4;
  }
  float* p;
  float* b;  // relative index o at b[o * kStageThreads]
  int stride;
  int ptr, ci, t, oi, oj;
  __device__ __forceinline__ void load(void* ws, int slot, int stride_,
                                       uint32_t s0, int ptr0, int, int,
                                       int draws) {
    extern __shared__ float mar_cols[];
    b = mar_cols + fresh_tid_x();
    p = (float*)ws + slot;
    stride = stride_;
    const int m = draws + 33 < 97 ? draws + 33 : 97;
    int s = ptr0 + 33 >= 97 ? ptr0 + 33 - 97 : ptr0 + 33;
    for (int o = 0; o < m; ++o) {
      copy_async4(b + o * kStageThreads, p + s * stride);
      s = s == 0 ? 96 : s - 1;
    }
    wait_copies();
    ptr = ptr0;
    ci = (int)s0;
    t = 0;
    oi = 33;
    oj = 0;
  }
  __device__ __forceinline__ float next() {
    float uni = b[oi * kStageThreads] - b[oj * kStageThreads];
    uni = uni + (uni < 0.0f ? 1.0f : 0.0f);
    b[oi * kStageThreads] = uni;
    oi = oi == 96 ? 0 : oi + 1;
    oj = oj == 96 ? 0 : oj + 1;
    ++t;
    ci -= CD;
    if (ci < 0) ci += CM;
    const float out = uni - __int2float_rn(ci) * 0x1p-24f;
    return out + (out < 0.0f ? 1.0f : 0.0f);
  }
  __device__ __forceinline__ void store() {
    int s = ptr, o = 33;
    for (int k = t < 97 ? t : 97; k > 0; --k) {
      p[s * stride] = b[o * kStageThreads];
      s = s == 0 ? 96 : s - 1;
      o = o == 96 ? 0 : o + 1;
    }
  }
};

// whether generator G makes its draws as each subgroup starts (Ranlux)
template <class G, class = void>
struct HasSubgroup : std::false_type {};
template <class G>
struct HasSubgroup<G, std::void_t<decltype(std::declval<G&>().subgroup())>>
    : std::true_type {};
// whether generator G refuses some launches (Ranlux::launchable)
template <class G, class = void>
struct HasLaunchable : std::false_type {};
template <class G>
struct HasLaunchable<G, std::void_t<decltype(G::launchable(0, 0))>>
    : std::true_type {};

// The random source of a stream instantiation: a pair is the next two
// draws, each clamped into (0, 1) by open01.  The launcher fills in the
// draws a subgroup and the stage take (stage.cuh stage_per_slots pairs,
// times the subgroups) and the dynamic shared memory its generator asks
// for them (kDynSmem: the most); it refuses a launch the generator cannot
// run (launchable).
template <class G>
struct Stream {
  static constexpr int kDynSmem = DynSmemOf<G>::value;
  void* ws;
  int stride;
  uint32_t s0;
  int ptr0, skip;
  int per, draws;
  int dyn_smem;

  static Stream make(void* ws, int stride, uint32_t s0, int ptr0, int skip,
                     int n, int kind, int k_trials, int n_hit) {
    const int per = 2 * (int)stage_per_slots(kind, k_trials, n_hit);
    const int draws = per * (n == 3 ? 3 : 1);
    int smem = 0;
    if constexpr (kDynSmem > 0) smem = G::dyn_smem_bytes(per, draws);
    return {ws, stride, s0, ptr0, skip, per, draws, smem};
  }
  bool launchable() const {
    if constexpr (HasLaunchable<G>::value) return G::launchable(skip, per);
    return true;
  }

  struct Src {
    // each draw steps the generator: every draw is made, used or not
    static constexpr bool kCounter = false;
    G g;
    __device__ __forceinline__ void subgroup(uint32_t) {
      if constexpr (HasSubgroup<G>::value) g.subgroup();
    }
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
    src.g.load(ws, slot, stride, s0, ptr0, skip, per, draws);
    return src;
  }
};

// the instantiation that runs generator G's longer subgroups (G::Chunked:
// Ranlux), or G itself
template <class G, class = void>
struct ChunkedOf { using type = G; };
template <class G>
struct ChunkedOf<G, std::void_t<typename G::Chunked>> {
  using type = typename G::Chunked;
};

// A stage of generator G on geometry D: its instantiation for the launch's
// draw count (G, or its chunked one past G::kMaxPer draws a subgroup),
// refused if the generator cannot run it.
template <class G, class D>
int launch_stream(const Links& L, int n, int kind, bool track, int mu,
                  int parity, const D& d, void* ws, int stride, uint32_t s0,
                  int ptr0, int skip, float tbn, int k_trials, int n_hit,
                  float delta, unsigned long long* cnt, cudaStream_t s) {
  const auto rng = Stream<G>::make(ws, stride, s0, ptr0, skip, n, kind,
                                   k_trials, n_hit);
  using GC = typename ChunkedOf<G>::type;
  if constexpr (!std::is_same_v<GC, G>) {
    if (rng.per > G::kMaxPer)
      return launch_stream<GC>(
          L, n, kind, track, mu, parity, d, ws, stride, s0, ptr0, skip, tbn,
          k_trials, n_hit, delta, cnt, s);
  }
  if (!rng.launchable()) return (int)cudaErrorInvalidValue;
  return launch_drawing(L, n, kind, track, mu, parity, d, rng, tbn, k_trials,
                        n_hit, delta, cnt, s);
}

}  // namespace qg

// The body of stage_<family>.cu: the launchers of family `fam` (generator
// struct `Gen`), unsharded and on a shard, 8 instantiations each (16 for
// ranlux: its chunked one too).
#define QG_DEFINE_STREAM_LAUNCHER(fam, Gen)                                   \
  namespace qg {                                                              \
  QG_STREAM_LAUNCHER(fam, Dims) {                                             \
    return launch_stream<Gen>(L, n, kind, track, mu, parity, d, ws, stride,   \
                              s0, ptr0, skip, tbn, k_trials, n_hit, delta,    \
                              cnt, s);                                        \
  }                                                                           \
  QG_STREAM_LAUNCHER(fam, ShardDims) {                                        \
    return launch_stream<Gen>(L, n, kind, track, mu, parity, d, ws, stride,   \
                              s0, ptr0, skip, tbn, k_trials, n_hit, delta,    \
                              cnt, s);                                        \
  }                                                                           \
  }
