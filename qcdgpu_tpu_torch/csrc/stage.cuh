// K1: one checkerboard stage of SU(2) or SU(3) on the packed link state:
// Kennedy-Pendleton heat-bath, overrelaxation or n-hit Metropolis, with an
// optional tracked count, drawing from threefry or a PRNGCL stream.
//
// Replaces the TPU kernel qcdgpu_tpu/ops/pallas/update.py:_stage_kernel
// (built by _stage_call, and by _stage_call_ytiled for the Y-tiled grid that
// the TPU runs at 32^4): kind in {heatbath, overrelax, metropolis}, N in
// {2, 3}, track_acc on or off, rng_mode "threefry" (stage.cu) or
// "prngcl:<gen>" (stage_<family>.cu, with the draws of streams.cuh).  Plain
// PyTorch twin: ops/cuda/update.py:stage_update_ref.
//
// K1a, the same kernel on a halo-padded shard of an X/Y mesh (the TPU
// kernel's local_x / local_y > 0 form, update.py:602-726, driven by
// ops/pallas/sharded.py), is the geometry parameter D = ShardDims
// (common.cuh) instead of Dims: one thread per interior site, neighbours
// stepping into the halo slabs on a split axis, parity and the threefry
// counter from global coordinates.  Every unsharded instantiation has a
// sharded twin; with D = Dims the code is the unsharded kernel's.
//
// What it computes, for every site x of parity p (one thread each):
//   A = sum_{nu != mu} [ U_nu(x+mu) (U_nu(x) U_mu(x+nu))^+
//                        + (U_mu(x-nu) U_nu(x+mu-nu))^+ U_nu(x-nu) ],
//   W = U_mu(x) A, then for the Cabibbo-Marinari subgroups ((0,1) for SU(2);
//   (0,1), (0,2), (1,2) for SU(3)): an SU(2) element u from the (i, j)
//   block of W by the stage's kind, U <- u U and W <- u W.  Rows 0-1 of U
//   are stored in place.  With TRACK, the stage adds to a device counter the
//   sites whose heat-bath trials all failed, or the accepted Metropolis
//   hits.
//
// What bounds it on an H100: per site it reads 19 links (12 f32 each at
// SU(3), 8 at SU(2); each link neighbours 8 sites, so much of it comes from
// L1/L2) and does about 3.5k f32 operations of SU(3) matrix algebra (0.9k at
// SU(2)) plus 0.6k per subgroup for heat-bath or n_hit x 0.1k for
// Metropolis, and up to 2k integer operations of threefry (or the stream
// generator's steps, a few hundred to a few thousand: ranlux3's luxury skips
// are the most).  That is above the card's f32-per-HBM-byte balance point,
// so it is bound by instruction throughput and registers rather than by HBM
// bandwidth; overrelaxation draws nothing and sits closest to the bandwidth
// floor.
//
// What the design does about that: one thread per site, so no shared memory
// and no synchronisation (except the tracked count's one block reduction
// and one 64-bit atomic per block); neighbours are addressed directly
// (decode slot, step the coordinate, re-encode) instead of the TPU kernel's
// roll-and-mask shifts of whole slabs; random numbers are drawn per trial or
// hit on demand rather than as stored uniforms.  The kind, N, tracking and
// the random source are template parameters, so each instantiation carries
// only its own branch.  The algebra is fully unrolled and lives in
// registers; __launch_bounds__(128) lets the compiler use up to 255
// registers per thread, so it need not spill.
//
// The random source R (struct Threefry here, Stream<G> in streams.cuh) opens
// a per-site source after the staples; its pair(j, a, b) gives uniforms
// 2j and 2j+1 of the current subgroup, in the reference's order: heat-bath
// trial t takes pairs 2t and 2t+1, the direction pair 2K; Metropolis hit h
// pairs 2h and 2h+1.  Threefry computes a pair from its slot; a stream's
// pairs are its next two draws, which the samplers request in exactly that
// order.
//
// In place is safe: the stage writes us[2*mu + p] only at the thread's own
// slot and reads that array nowhere else (U_mu at x +- nu has parity 1 - p),
// so no thread reads a link another thread writes; a stream's words are the
// thread's own site's too.
#pragma once

#include "common.cuh"

namespace qg {

enum Kind { HEATBATH = 0, OVERRELAX = 1, METROPOLIS = 2 };

struct Quat { float c[4]; };

template <int N>
__device__ __forceinline__ Quat quat_from_block(const Mat<N>& w, int i, int j) {
  return {{0.5f * (w.a[i][i].re + w.a[j][j].re),
           0.5f * (w.a[i][j].im + w.a[j][i].im),
           0.5f * (w.a[i][j].re - w.a[j][i].re),
           0.5f * (w.a[i][i].im - w.a[j][j].im)}};
}

__device__ __forceinline__ Quat quat_mul(const Quat& p, const Quat& q) {
  return {{p.c[0] * q.c[0] - p.c[1] * q.c[1] - p.c[2] * q.c[2] - p.c[3] * q.c[3],
           p.c[0] * q.c[1] + q.c[0] * p.c[1] - (p.c[2] * q.c[3] - p.c[3] * q.c[2]),
           p.c[0] * q.c[2] + q.c[0] * p.c[2] - (p.c[3] * q.c[1] - p.c[1] * q.c[3]),
           p.c[0] * q.c[3] + q.c[0] * p.c[3] - (p.c[1] * q.c[2] - p.c[2] * q.c[1])}};
}

__device__ __forceinline__ Quat quat_conj(const Quat& q) {
  return {{q.c[0], -q.c[1], -q.c[2], -q.c[3]}};
}

// m <- embed(M(q); rows i, j) @ m
template <int N>
__device__ __forceinline__ void subgroup_left_mul(const Quat& q, int i, int j,
                                                  Mat<N>& m) {
  const C u00 = {q.c[0], q.c[3]};
  const C u01 = {q.c[2], q.c[1]};
  const C u10 = {-q.c[2], q.c[1]};
  const C u11 = {q.c[0], -q.c[3]};
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const C mi = m.a[i][k], mj = m.a[j][k];
    m.a[i][k] = cadd(cmul(u00, mi), cmul(u01, mj));
    m.a[j][k] = cadd(cmul(u10, mi), cmul(u11, mj));
  }
}

// threefry2x32 keyed by (stage key, dense site index, slot): a subgroup's
// pair j is slot slot0 + j (ops/cuda/update.py stage_update_ref).
struct Threefry {
  uint32_t k0, k1;

  struct Src {
    uint32_t k0, k1, sidx, slot0;
    __device__ __forceinline__ void subgroup(uint32_t first_slot) {
      slot0 = first_slot;
    }
    __device__ __forceinline__ void pair(uint32_t j, float& a, float& b) {
      uint32_t b0, b1;
      threefry2x32(k0, k1, sidx, slot0 + j, b0, b1);
      a = bits_to_uniform(b0);
      b = bits_to_uniform(b1);
    }
    __device__ __forceinline__ void close() {}
  };

  template <class D>
  __device__ __forceinline__ Src open(int, const Site& x, const D& d) const {
    return {k0, k1, dense_index(x, d), 0u};
  }
};

// Kennedy-Pendleton multiplier for one subgroup (ops/cuda/update.py
// heatbath_flip): k_trials masked trials, first accepted wins, identity on
// exhaustion (reported in `exhausted`).  Trial t draws pairs 2t (r1, r2)
// and 2t + 1 (r3, r4); the direction draws pair 2 k_trials.
template <class S>
__device__ __forceinline__ Quat heatbath_flip(const Quat& q_w, float tbn,
                                              S& src, int k_trials,
                                              bool& exhausted) {
  const float n2 = q_w.c[0] * q_w.c[0] + q_w.c[1] * q_w.c[1] +
                   q_w.c[2] * q_w.c[2] + q_w.c[3] * q_w.c[3];
  const float rk = 1.0f / sqrtf(fmaxf(n2, 1e-38f));
  const float k = n2 * rk;
  const Quat v = {{q_w.c[0] * rk, q_w.c[1] * rk, q_w.c[2] * rk, q_w.c[3] * rk}};
  const float a = tbn * k;
  const float inv2a = 1.0f / (2.0f * fmaxf(a, 1e-10f));
  float lam2_sel = 0.0f;
  bool ok = false;
  for (int t = 0; t < k_trials; ++t) {
    float r1, r2, r3, r4;
    src.pair(2u * t, r1, r2);
    src.pair(2u * t + 1u, r3, r4);
    const float c2 = cos2_2pi(r2);
    const float lam2 = -inv2a * (log_u01(r1) + c2 * log_u01(r3));
    const bool acc = (r4 * r4) <= (1.0f - lam2);
    if (acc && !ok) lam2_sel = lam2;
    ok = ok || acc;
  }
  exhausted = !ok;
  const float x0 = fminf(fmaxf(1.0f - 2.0f * lam2_sel, -1.0f), 1.0f);
  const float rho = sqrtf(fmaxf(1.0f - x0 * x0, 0.0f));
  float d0, d1;
  src.pair(2u * k_trials, d0, d1);
  const float ct = 2.0f * d0 - 1.0f;
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  float sph, cph;
  sincos_2pi(d1, sph, cph);
  const Quat w = {{x0, rho * st * cph, rho * st * sph, rho * ct}};
  if (ok && k > 1e-30f) return quat_mul(w, quat_conj(v));
  return {{1.0f, 0.0f, 0.0f, 0.0f}};
}

// Overrelaxation multiplier (v^+)^2, v = q_w/|q_w| (ops/cuda/update.py
// overrelax_flip): quat_mul(q_w^+, q_w^+) times the reciprocal of |q_w|^2.
__device__ __forceinline__ Quat overrelax_flip(const Quat& q_w) {
  const float n2 = q_w.c[0] * q_w.c[0] + q_w.c[1] * q_w.c[1] +
                   q_w.c[2] * q_w.c[2] + q_w.c[3] * q_w.c[3];
  const Quat qc = quat_conj(q_w);
  const float inv = 1.0f / fmaxf(n2, 1e-38f);
  const Quat u = quat_mul(qc, qc);
  if (n2 > 1e-38f)
    return {{u.c[0] * inv, u.c[1] * inv, u.c[2] * inv, u.c[3] * inv}};
  return {{1.0f, 0.0f, 0.0f, 0.0f}};
}

// n_hit Metropolis hits on one subgroup (ops/cuda/update.py
// metropolis_flip).  Hit h draws (u0, u1) from pair 2h and (u2, u3) from
// pair 2h + 1; accepted hits are added to n_acc.  A rejected hit multiplies
// by the identity, as the plain version does, so both round alike.
template <class S>
__device__ __forceinline__ Quat metropolis_flip(const Quat& q_w, float tbn,
                                                S& src, int n_hit, float delta,
                                                unsigned& n_acc) {
  Quat acc_u = {{1.0f, 0.0f, 0.0f, 0.0f}};
  Quat q_cur = q_w;
  for (int h = 0; h < n_hit; ++h) {
    float u0, u1, u2, u3;
    src.pair(2u * h, u0, u1);
    src.pair(2u * h + 1u, u2, u3);
    const float w1 = delta * (2.0f * u0 - 1.0f);
    const float w2 = delta * (2.0f * u1 - 1.0f);
    const float w3 = delta * (2.0f * u2 - 1.0f);
    const float w0 = 1.0f;
    const float rn = 1.0f / sqrtf(w0 * w0 + w1 * w1 + w2 * w2 + w3 * w3);
    const Quat w = {{w0 * rn, w1 * rn, w2 * rn, w3 * rn}};
    const float new0 = quat_mul(w, q_cur).c[0];
    const float dlp = tbn * (new0 - q_cur.c[0]);
    const bool accept = log_u01(u3) < dlp;
    n_acc += accept ? 1u : 0u;
    const Quat w_eff = accept ? w : Quat{{1.0f, 0.0f, 0.0f, 0.0f}};
    acc_u = quat_mul(w_eff, acc_u);
    q_cur = quat_mul(w_eff, q_cur);
  }
  return acc_u;
}

// One site's stage; returns its tracked count (0 unless TRACK).  slot: the
// thread's site index (over the interior of a shard, D = ShardDims; over the
// whole lattice, D = Dims, where it is also the site's array slot).
template <int N, int KIND, bool TRACK, class R, class D>
__device__ __forceinline__ unsigned stage_site(const Links& L, int slot, int mu,
                                               int parity, const D& d,
                                               const R& rng, float tbn,
                                               int k_trials, int n_hit,
                                               float delta) {
  const int p = parity, q = parity ^ 1;
  const Site x = decode_slot(slot, p, d);

  // staple sum A in _staple_W's order: nu ascending, term = fwd + bwd
  Mat<N> acc;
  bool first = true;
#pragma unroll
  for (int nu = 0; nu < 4; ++nu) {
    if (nu == mu) continue;
    const Site xpm = step(x, mu, 1, d);
    const Site xpn = step(x, nu, 1, d);
    const Site xmn = step(x, nu, -1, d);
    const Site xpmmn = step(xpm, nu, -1, d);
    // forward: U_nu(x+mu) [U_nu(x) U_mu(x+nu)]^+
    const Mat<N> inner = mmul(load_link<N>(L, nu, p, x, d),
                              load_link<N>(L, mu, q, xpn, d));
    const Mat<N> fwd = mmul_bdag(load_link<N>(L, nu, q, xpm, d), inner);
    // backward: [U_mu(x-nu) U_nu(x+mu-nu)]^+ U_nu(x-nu)
    const Mat<N> bwd = mmul(
        mdag(mmul(load_link<N>(L, mu, q, xmn, d), load_link<N>(L, nu, p, xpmmn, d))),
        load_link<N>(L, nu, q, xmn, d));
    const Mat<N> term = madd(fwd, bwd);
    acc = first ? term : madd(acc, term);
    first = false;
  }
  float* target = L.p[2 * mu + p];
  const int own = own_slot(slot, x, d);
  Mat<N> u = load_mat<N>(target, own, d.v2);
  Mat<N> w = mmul(u, acc);

  typename R::Src src = rng.open(slot, x, d);
  const uint32_t per_slots = KIND == HEATBATH ? 2u * k_trials + 1u
                             : KIND == METROPOLIS ? 2u * n_hit : 0u;
  constexpr int n_sg = N == 3 ? 3 : 1;
  const int sg[3][2] = {{0, 1}, {0, 2}, {1, 2}};
  unsigned count = 0;
#pragma unroll
  for (int s = 0; s < n_sg; ++s) {
    const int i = sg[s][0], j = sg[s][1];
    const Quat q_w = quat_from_block(w, i, j);
    Quat flip;
    if constexpr (KIND == HEATBATH) {
      bool exhausted;
      src.subgroup(per_slots * s);
      flip = heatbath_flip(q_w, tbn, src, k_trials, exhausted);
      if (TRACK) count += exhausted ? 1u : 0u;
    } else if constexpr (KIND == METROPOLIS) {
      src.subgroup(per_slots * s);
      flip = metropolis_flip(q_w, tbn, src, n_hit, delta, count);
    } else {
      flip = overrelax_flip(q_w);
    }
    subgroup_left_mul(flip, i, j, u);
    subgroup_left_mul(flip, i, j, w);
  }
  store_rows(target, own, d.v2, u);
  src.close();
  return TRACK ? count : 0u;
}

template <int N, int KIND, bool TRACK, class R, class D>
__global__ void __launch_bounds__(128)
stage_kernel(Links L, int mu, int parity, D d, R rng, float tbn,
             int k_trials, int n_hit, float delta, unsigned long long* count) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (TRACK) {
    // every thread joins the block's count reduction
    const unsigned c = slot < n_sites(d)
        ? stage_site<N, KIND, TRACK>(L, slot, mu, parity, d, rng, tbn,
                                     k_trials, n_hit, delta)
        : 0u;
    block_count_add(c, count);
  } else {
    if (slot >= n_sites(d)) return;
    stage_site<N, KIND, TRACK>(L, slot, mu, parity, d, rng, tbn, k_trials,
                               n_hit, delta);
  }
}

template <int N, int KIND, bool TRACK, class R, class D>
int launch_stage(const Links& L, int mu, int parity, const D& d,
                 const R& rng, float tbn, int k_trials, int n_hit, float delta,
                 unsigned long long* count, cudaStream_t s) {
  const int threads = 128;
  const int blocks = (n_sites(d) + threads - 1) / threads;
  stage_kernel<N, KIND, TRACK, R, D><<<blocks, threads, 0, s>>>(
      L, mu, parity, d, rng, tbn, k_trials, n_hit, delta, count);
  return (int)cudaGetLastError();
}

// The drawing kinds (heat-bath, Metropolis) of one random source on one
// geometry: 8 instantiations, chosen at run time.
template <class R, class D>
int launch_drawing(const Links& L, int n, int kind, bool track, int mu,
                   int parity, const D& d, const R& rng, float tbn,
                   int k_trials, int n_hit, float delta,
                   unsigned long long* cnt, cudaStream_t s) {
#define QG_STAGE(NN, KK, TT)                                                  \
  if (n == NN && kind == KK && track == TT)                                   \
    return launch_stage<NN, KK, TT>(L, mu, parity, d, rng, tbn, k_trials,     \
                                    n_hit, delta, cnt, s);
  QG_STAGE(3, HEATBATH, false)
  QG_STAGE(3, HEATBATH, true)
  QG_STAGE(3, METROPOLIS, false)
  QG_STAGE(3, METROPOLIS, true)
  QG_STAGE(2, HEATBATH, false)
  QG_STAGE(2, HEATBATH, true)
  QG_STAGE(2, METROPOLIS, false)
  QG_STAGE(2, METROPOLIS, true)
#undef QG_STAGE
  return (int)cudaErrorInvalidValue;
}

// One launcher per stream family and geometry (D: Dims or ShardDims), each
// family defined in its own source (stage_<family>.cu) so that nvcc builds
// them in parallel.
#define QG_STREAM_LAUNCHER(fam, D)                                            \
  int launch_stream_##fam(const Links& L, int n, int kind, bool track,        \
                          int mu, int parity, const D& d, void* ws,           \
                          int stride, uint32_t s0, int ptr0, int skip,        \
                          float tbn, int k_trials, int n_hit, float delta,    \
                          unsigned long long* cnt, cudaStream_t s)
#define QG_DECLARE_STREAM_LAUNCHERS(D)                                        \
  QG_STREAM_LAUNCHER(xor128, D);                                              \
  QG_STREAM_LAUNCHER(xor7, D);                                                \
  QG_STREAM_LAUNCHER(mrg32k3a, D);                                            \
  QG_STREAM_LAUNCHER(parkmiller, D);                                          \
  QG_STREAM_LAUNCHER(constant, D);                                            \
  QG_STREAM_LAUNCHER(ranlux, D);                                              \
  QG_STREAM_LAUNCHER(ranmar, D);
QG_DECLARE_STREAM_LAUNCHERS(Dims)
QG_DECLARE_STREAM_LAUNCHERS(ShardDims)
#undef QG_DECLARE_STREAM_LAUNCHERS

}  // namespace qg
