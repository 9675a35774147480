// K1: one checkerboard stage of SU(2) or SU(3) on the packed link state:
// Kennedy-Pendleton heat-bath, overrelaxation or n-hit Metropolis, with an
// optional tracked count, drawing from threefry, Philox or a PRNGCL stream.
//
// Replaces the TPU kernel qcdgpu_tpu/ops/pallas/update.py:_stage_kernel
// (built by _stage_call, and by _stage_call_ytiled for the Y-tiled grid that
// the TPU runs at 32^4): kind in {heatbath, overrelax, metropolis}, N in
// {2, 3}, track_acc on or off, rng_mode "threefry" (stage.cu), "hw" (the
// TPU's hardware PRNG, K9, replaced by Philox: stage_philox.cu) or
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
// K1c, the same stage over the C chains of a beta scan in one launch
// (stage_chains_kernel below, built from stage_chains.cu): each chain runs
// stage_site on its own arrays with its own coupling and key.  K1ac is K1c
// on a shard (D = ShardDims, stage_chains_sharded.cu): a block of chains
// of a scan on an X/Y mesh.
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
// L1/L2) and does 5.5k f32 operations at SU(3) heat-bath (3.5k of staple
// algebra, 0.6k per subgroup of sampling; 0.9k + 0.3k at SU(2)), plus the
// draws: ~80 integer operations a Philox or threefry call, or a stream
// generator's steps (ranlux3's luxury skips the most).  The library is
// built with -fmad=false (the twin's bits), so every f32 multiply and add
// is an instruction of its own: at one f32 instruction per lane per clock
// (33.5e12 a second) SU(3) heat-bath cannot take less than 0.086 ms at
// 32^4, above its 0.068 ms HBM bound.  Instruction slots and the latency of the
// gathers, with 16 warps an SM, bound it; overrelaxation draws nothing and
// sits closest to the bandwidth floor.  Tensor cores do not apply: these
// are 3x3 complex f32 products that must round as the twin does, and wgmma
// has no f32 input.
//
// What the design does about that: one thread per site, no shared memory
// and no synchronisation (except the tracked count's one block reduction
// and one 64-bit atomic per block).  A site's neighbours are slot deltas
// built once (common.cuh SiteAddr: three multiply-high divisions, compare-
// and-select wraps; the TPU kernel's roll-and-mask shifts of whole slabs
// become address arithmetic), every mu-dependent value and link array is
// chosen by constant-index selects, so nothing lives in a stack frame, and
// each link is multiplied in as it is loaded.  Random numbers are drawn per
// trial or hit on demand; a heat-bath trial after a site's first accepted
// one is not computed (nor drawn, for the counter-based sources).  The
// kind, N, tracking, the random source and the geometry are template
// parameters, so each instantiation carries only its own branch.  128
// threads a block, at least 4 blocks an SM (kStageMinBlocks).  Measured
// and dropped on the H100 (PERF.md): 96 registers (spills), one wave
// of persistent blocks walking the sites, L1 prefetch of the next staple
// term, mu as a template parameter; all slower.  So was shared memory:
// of a site's 19 links, the sites of a block's (z, t) lines share only
// U_mu of the other parity at x +- z and x +- t (for mu along x or y, 4
// loads become 1.25 with a halo line each side), and L1 already serves
// those repeats.  Staging them in shared memory, decoded once or by
// cp.async behind the first staple term, made K1 1.17-1.24x slower at
// SU(3) 32^4 and 1.05x at SU(2), with the same bits.
//
// The random source R (struct Threefry or Philox here, Stream<G> in
// streams.cuh) opens a per-site source after the staples; its pair(j, a, b)
// gives uniforms 2j and 2j+1 of the current subgroup, in the reference's
// order: heat-bath trial t takes pairs 2t and 2t+1, the direction pair 2K;
// Metropolis hit h pairs 2h and 2h+1.  Threefry computes a pair from its
// slot, Philox (rng_mode "hw", stage_philox.cu) half a block from the
// slot's block; a stream's pairs are its next two draws, which the samplers
// request in exactly that order.
//
// In place is safe: the stage writes us[2*mu + p] only at the thread's own
// slot and reads that array nowhere else (U_mu at x +- nu has parity 1 - p),
// so no thread reads a link another thread writes; a stream's words are the
// thread's own site's too.
#pragma once

#include <type_traits>

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
    // a draw is a function of its slot: draws nobody uses need not be made
    static constexpr bool kCounter = true;
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

  __device__ __forceinline__ Src open(int, const SiteAddr& a) const {
    return {k0, k1, a.dense, 0u};
  }
};

// Philox-4x32-10 keyed by the stage key (rng_mode "hw": the counter-based
// source that replaces the TPU kernel's hardware PRNG, update.py:543-554 and
// core.hw_uniforms): slot s, numbered as threefry's, is words 2 (s & 1) and
// 2 (s & 1) + 1 of the block at counter (dense site index, s >> 1, 0, 0)
// (ops/cuda/update.py stage_update_ref).  The source keeps the last block,
// so two consecutive slots cost one Philox call; the draws are the same
// words whichever order the slots are asked for in.
struct Philox {
  uint32_t k0, k1;

  struct Src {
    static constexpr bool kCounter = true;
    uint32_t k0, k1, sidx, slot0, blk;
    uint32_t w[4];
    __device__ __forceinline__ void subgroup(uint32_t first_slot) {
      slot0 = first_slot;
    }
    __device__ __forceinline__ void pair(uint32_t j, float& a, float& b) {
      const uint32_t s = slot0 + j;
      if ((s >> 1) != blk) {
        blk = s >> 1;
        philox4x32(k0, k1, sidx, blk, 0u, 0u, w);
      }
      const bool odd = (s & 1u) != 0u;
      a = bits_to_uniform(odd ? w[2] : w[0]);
      b = bits_to_uniform(odd ? w[3] : w[1]);
    }
    __device__ __forceinline__ void close() {}
  };

  __device__ __forceinline__ Src open(int, const SiteAddr& a) const {
    // blk: no block yet (a slot's block index is below 2^31)
    return {k0, k1, a.dense, 0u, 0xFFFFFFFFu, {0u, 0u, 0u, 0u}};
  }
};

// Kennedy-Pendleton multiplier for one subgroup (ops/cuda/update.py
// heatbath_flip): k_trials masked trials, first accepted wins, identity on
// exhaustion (reported in `exhausted`).  Trial t draws pairs 2t (r1, r2)
// and 2t + 1 (r3, r4); the direction draws pair 2 k_trials.  The result
// depends only on the first accepted trial, so the trials after it are not
// computed: a counter-based source (S::kCounter) stops drawing too, and a
// warp leaves the loop when its last site has accepted; a stream's
// generator must still step through every trial's draws, so only their
// arithmetic is skipped.  Same bits as computing all k_trials.
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
    if (S::kCounter && ok) break;
    float r1, r2, r3, r4;
    src.pair(2u * t, r1, r2);
    src.pair(2u * t + 1u, r3, r4);
    if (!ok) {
      const float c2 = cos2_2pi(r2);
      const float lam2 = -inv2a * (log_u01(r1) + c2 * log_u01(r3));
      if ((r4 * r4) <= (1.0f - lam2)) {
        lam2_sel = lam2;
        ok = true;
      }
    }
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

// Random slots (pairs of draws) one subgroup of a stage takes: the
// sampler's uniforms (ops/cuda/update.py uniforms_per_subgroup: 4 k_trials
// + 2 for heat-bath, 4 n_hit for Metropolis) in whole pairs; a stream
// source's launcher sizes its buffers from it too (streams.cuh Stream).
__host__ __device__ __forceinline__ unsigned stage_per_slots(int kind,
                                                             int k_trials,
                                                             int n_hit) {
  return kind == HEATBATH ? 2u * k_trials + 1u
         : kind == METROPOLIS ? 2u * n_hit : 0u;
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
  const int p = parity, q = parity ^ 1, v2 = d.v2;
  const SiteAddr x = site_addr(slot, p, d);
  const int xpm = x.own + pick(mu, x.fwd);  // x + mu
  const float* umu_q = link_array(L, mu, q);

  // staple sum A in _staple_W's order: nu ascending, term = fwd + bwd; each
  // link is multiplied in as soon as it is loaded
  Mat<N> acc;
  bool first = true;
#pragma unroll
  for (int nu = 0; nu < 4; ++nu) {
    if (nu == mu) continue;
    const float* unu_p = link_array(L, nu, p);
    const float* unu_q = link_array(L, nu, q);
    const int xmn = x.own + x.bwd[nu];  // x - nu
    // forward: U_nu(x+mu) [U_nu(x) U_mu(x+nu)]^+
    const Mat<N> inner = mmul(load_mat<N>(unu_p, x.own, v2),
                              load_mat<N>(umu_q, x.own + x.fwd[nu], v2));
    const Mat<N> fwd = mmul_bdag(load_mat<N>(unu_q, xpm, v2), inner);
    // backward: [U_mu(x-nu) U_nu(x+mu-nu)]^+ U_nu(x-nu)
    const Mat<N> bwd = mmul(
        mdag(mmul(load_mat<N>(umu_q, xmn, v2),
                  load_mat<N>(unu_p, xpm + x.bwd[nu], v2))),
        load_mat<N>(unu_q, xmn, v2));
    const Mat<N> term = madd(fwd, bwd);
    acc = first ? term : madd(acc, term);
    first = false;
  }
  float* target = link_array(L, mu, p);
  Mat<N> u = load_mat<N>(target, x.own, v2);
  Mat<N> w = mmul(u, acc);

  typename R::Src src = rng.open(slot, x);
  const uint32_t per_slots = stage_per_slots(KIND, k_trials, n_hit);
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
  store_rows(target, x.own, v2, u);
  src.close();
  return TRACK ? count : 0u;
}

// Threads per block, and the blocks an SM must hold at once, which caps a
// thread's registers at 65536 / (128 x 4) = 128: SU(3) uses all of them
// with no spill (a cap of 96, 5 blocks, spills and measured slower).
constexpr int kStageThreads = 128;
constexpr int kStageMinBlocks = 4;
// A random source that keeps state in dynamic shared memory names the most
// a block may ask (kDynSmem, bytes) and carries what a launch asks
// (dyn_smem): the lag-window streams (streams.cuh Ranlux, Ranmar)
template <class R, class = void>
struct DynSmemOf { static constexpr int value = 0; };
template <class R>
struct DynSmemOf<R, std::void_t<decltype(R::kDynSmem)>> {
  static constexpr int value = R::kDynSmem;
};
template <int N, int KIND, bool TRACK, class R, class D>
__global__ void __launch_bounds__(kStageThreads, kStageMinBlocks)
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
  const int blocks = (n_sites(d) + kStageThreads - 1) / kStageThreads;
  int smem = 0;
  if constexpr (DynSmemOf<R>::value > 0) {
    smem = rng.dyn_smem;
    // past 48 KB the kernel must be let ask for it; the attribute is the
    // function's on the current card only, so it is set at every such launch
    if (smem > 48 * 1024) {
      const cudaError_t set = cudaFuncSetAttribute(
          stage_kernel<N, KIND, TRACK, R, D>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (set != cudaSuccess) return (int)set;
    }
  }
  stage_kernel<N, KIND, TRACK, R, D><<<blocks, kStageThreads, smem, s>>>(
      L, mu, parity, d, rng, tbn, k_trials, n_hit, delta, count);
  return (int)cudaGetLastError();
}

// K1c: K1 batched over C independent chains (a beta scan), the chain on
// blockIdx.y.  Replaces the TPU kernel vmapped over the chain axis
// (qcdgpu_tpu/models/ensemble.py:120-131 vmaps make_pallas_sweep: the
// batch axis becomes a grid dimension, beta rides the scalar channel).
// Chain c's arrays start chain_stride floats after chain c-1's (each
// us[2*mu + p] is [C, 2, N, 2, X, Y, Z*T/2]); the offset is 64-bit, since
// C arrays may pass 2^31 floats together.  Its coupling and key live on
// the device for the whole run: tbn = betas[c] * two_over_n (the f32
// product update.two_beta_over_n forms), and the stage key is derived
// here, threefry2x32(base_keys[c], (sweep_idx, stage_id)) = rng.stage_key,
// so a stage costs one launch and no host key for any C.  Each site runs
// the single-chain stage_site, so chain c computes exactly what K1 does on
// its own arrays; the tracked count goes to count[c].
//
// K1ac, the same kernel with D = ShardDims (stage_chains_sharded.cu): one
// shard of an X/Y mesh over a block of chains (the reference vmaps the
// sharded stage body of ops/pallas/sharded.py over each device's chain
// block, models/ensemble.py:96-131), each chain's arrays halo-padded
// ([C, 2, N, 2, lx + 2 hx, ly + 2 hy, Z*T/2], chain_stride the padded
// floats per chain), the counters from global coordinates as K1a's: chain
// c computes what K1a does on its own padded arrays.
//
// The blocks an SM must hold are K1's (kStageMinBlocks), except for SU(3)
// overrelaxation on a shard: with the chain's eight offset pointers it
// spills 4 bytes at K1's 128-register cap (ptxas for sm_90a), so it is
// built for 3 blocks an SM (at most 168 registers).
template <int N, int KIND, class D>
constexpr int kChainMinBlocks =
    N == 3 && KIND == OVERRELAX && std::is_same_v<D, ShardDims>
        ? 3 : kStageMinBlocks;

template <int N, int KIND, bool TRACK, class R, class D>
__global__ void __launch_bounds__(kStageThreads,
                                  (kChainMinBlocks<N, KIND, D>))
stage_chains_kernel(Links L, long long chain_stride, int mu, int parity,
                    D d, const float* __restrict__ betas,
                    float two_over_n, const uint32_t* __restrict__ base_keys,
                    uint32_t sweep_idx, uint32_t stage_id, int k_trials,
                    int n_hit, float delta, unsigned long long* count) {
  const int c = blockIdx.y;
  const size_t off = (size_t)c * (size_t)chain_stride;
  Links Lc;
#pragma unroll
  for (int k = 0; k < 8; ++k) Lc.p[k] = L.p[k] + off;
  const float tbn = betas[c] * two_over_n;
  uint32_t k0 = 0u, k1 = 0u;  // overrelaxation draws nothing
  if constexpr (KIND != OVERRELAX)
    threefry2x32(base_keys[2 * c], base_keys[2 * c + 1], sweep_idx, stage_id,
                 k0, k1);
  const R rng = {k0, k1};
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if constexpr (TRACK) {
    const unsigned n_ = slot < n_sites(d)
        ? stage_site<N, KIND, TRACK>(Lc, slot, mu, parity, d, rng, tbn,
                                     k_trials, n_hit, delta)
        : 0u;
    block_count_add(n_, count + c);
  } else {
    if (slot >= n_sites(d)) return;
    stage_site<N, KIND, TRACK>(Lc, slot, mu, parity, d, rng, tbn, k_trials,
                               n_hit, delta);
  }
}

// The per-chain arguments of K1c / K1ac.
struct Chains {
  long long stride;        // floats from one chain's array to the next
  int n;                   // C, gridDim.y
  const float* betas;      // f32 [C]
  float two_over_n;        // f32(2 / N)
  const uint32_t* keys;    // base keys [C, 2]
  uint32_t sweep_idx, stage_id;
};

template <int N, int KIND, bool TRACK, class R, class D>
int launch_stage_chains(const Links& L, const Chains& ch, int mu, int parity,
                        const D& d, int k_trials, int n_hit, float delta,
                        unsigned long long* count, cudaStream_t s) {
  const dim3 grid((n_sites(d) + kStageThreads - 1) / kStageThreads, ch.n);
  stage_chains_kernel<N, KIND, TRACK, R, D><<<grid, kStageThreads, 0, s>>>(
      L, ch.stride, mu, parity, d, ch.betas, ch.two_over_n, ch.keys,
      ch.sweep_idx, ch.stage_id, k_trials, n_hit, delta, count);
  return (int)cudaGetLastError();
}

template <class R, class D>
int launch_chains_drawing(const Links& L, const Chains& ch, int n, int kind,
                          bool track, int mu, int parity, const D& d,
                          int k_trials, int n_hit, float delta,
                          unsigned long long* cnt, cudaStream_t s) {
#define QG_STAGE(NN, KK, TT)                                                  \
  if (n == NN && kind == KK && track == TT)                                   \
    return launch_stage_chains<NN, KK, TT, R>(L, ch, mu, parity, d,           \
                                              k_trials, n_hit, delta, cnt, s);
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

// The 18 instantiations of K1c (D = Dims) or K1ac (D = ShardDims),
// chosen at run time: threefry for every kind, N in {2, 3}, tracked or not
// (10), and Philox (rng_mode "hw": heat-bath and Metropolis, 8).
template <class D>
int stage_chains(const Links& L, const Chains& ch, int n, int kind,
                 int track, int philox, int mu, int parity, const D& d,
                 int k_trials, int n_hit, float delta,
                 unsigned long long* cnt, cudaStream_t s) {
  if (ch.n < 1 || ch.n > 65535 || ch.stride < 0 ||
      (track && (cnt == nullptr || kind == OVERRELAX)) ||
      (philox && kind == OVERRELAX))
    return (int)cudaErrorInvalidValue;
  if (philox)
    return launch_chains_drawing<Philox>(L, ch, n, kind, track != 0, mu,
                                         parity, d, k_trials, n_hit, delta,
                                         cnt, s);
  if (kind == OVERRELAX) {
    if (n == 3)
      return launch_stage_chains<3, OVERRELAX, false, Threefry>(
          L, ch, mu, parity, d, k_trials, n_hit, delta, cnt, s);
    if (n == 2)
      return launch_stage_chains<2, OVERRELAX, false, Threefry>(
          L, ch, mu, parity, d, k_trials, n_hit, delta, cnt, s);
    return (int)cudaErrorInvalidValue;
  }
  return launch_chains_drawing<Threefry>(L, ch, n, kind, track != 0, mu,
                                         parity, d, k_trials, n_hit, delta,
                                         cnt, s);
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
