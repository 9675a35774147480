// K1: one checkerboard heat-bath stage of SU(3) on the packed link state.
//
// Replaces the TPU kernel qcdgpu_tpu/ops/pallas/update.py:_stage_kernel
// (built by _stage_call, and by _stage_call_ytiled for the Y-tiled grid that
// the TPU runs at 32^4) with kind="heatbath", rng_mode="threefry", SU(3),
// no tracking.  Plain PyTorch twin: ops/cuda/update.py:stage_update_ref.
//
// What it computes, for every site x of parity p (one thread each):
//   A = sum_{nu != mu} [ U_nu(x+mu) (U_nu(x) U_mu(x+nu))^+
//                        + (U_mu(x-nu) U_nu(x+mu-nu))^+ U_nu(x-nu) ],
//   W = U_mu(x) A, then for the Cabibbo-Marinari subgroups (0,1), (0,2),
//   (1,2): a Kennedy-Pendleton heat-bath SU(2) element u from the (i, j)
//   block of W, U <- u U and W <- u W.  Rows 0-1 of U are stored in place.
//
// What bounds it on an H100: per site it reads 19 links (12 f32 each; about
// 0.9 KB, much of it from L1/L2 since each link neighbours 8 sites) and does
// about 3.5k f32 operations of matrix algebra, 1.8k more in the three
// Kennedy-Pendleton subgroups and 2k integer operations of threefry.  That
// is well above the card's f32-per-HBM-byte balance point, so it is bound by
// instruction throughput and registers rather than by HBM bandwidth.
//
// What the design does about that: one thread per site, so no shared memory
// and no synchronisation; neighbours are addressed directly (decode slot,
// step the coordinate, re-encode) instead of the TPU kernel's roll-and-mask
// shifts of whole slabs; random numbers come from threefry in registers,
// drawn per trial on demand rather than as 54 stored uniforms.  The 3x3
// algebra is fully unrolled and lives in registers; __launch_bounds__(128)
// lets the compiler use up to 255 registers per thread, so it need not
// spill.
//
// In place is safe: the stage writes us[2*mu + p] only at the thread's own
// slot and reads that array nowhere else (U_mu at x +- nu has parity 1 - p),
// so no thread reads a link another thread writes.
#include "common.cuh"

namespace qg {

struct Quat { float c[4]; };

__device__ __forceinline__ Quat quat_from_block(const M3& w, int i, int j) {
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
__device__ __forceinline__ void subgroup_left_mul(const Quat& q, int i, int j,
                                                  M3& m) {
  const C u00 = {q.c[0], q.c[3]};
  const C u01 = {q.c[2], q.c[1]};
  const C u10 = {-q.c[2], q.c[1]};
  const C u11 = {q.c[0], -q.c[3]};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const C mi = m.a[i][k], mj = m.a[j][k];
    m.a[i][k] = cadd(cmul(u00, mi), cmul(u01, mj));
    m.a[j][k] = cadd(cmul(u10, mi), cmul(u11, mj));
  }
}

// Kennedy-Pendleton multiplier for one subgroup (ops/cuda/update.py
// heatbath_flip): k_trials masked trials, first accepted wins, identity on
// exhaustion.  Trial t draws slots slot0 + 2t (r1, r2) and slot0 + 2t + 1
// (r3, r4); the direction draws slot slot0 + 2 k_trials.
__device__ __forceinline__ Quat heatbath_flip(const Quat& q_w, float tbn,
                                              uint32_t k0, uint32_t k1,
                                              uint32_t sidx, uint32_t slot0,
                                              int k_trials) {
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
    uint32_t b0, b1, b2, b3;
    threefry2x32(k0, k1, sidx, slot0 + 2u * t, b0, b1);
    threefry2x32(k0, k1, sidx, slot0 + 2u * t + 1u, b2, b3);
    const float r1 = bits_to_uniform(b0), r2 = bits_to_uniform(b1);
    const float r3 = bits_to_uniform(b2), r4 = bits_to_uniform(b3);
    const float c2 = cos2_2pi(r2);
    const float lam2 = -inv2a * (log_u01(r1) + c2 * log_u01(r3));
    const bool acc = (r4 * r4) <= (1.0f - lam2);
    if (acc && !ok) lam2_sel = lam2;
    ok = ok || acc;
  }
  const float x0 = fminf(fmaxf(1.0f - 2.0f * lam2_sel, -1.0f), 1.0f);
  const float rho = sqrtf(fmaxf(1.0f - x0 * x0, 0.0f));
  uint32_t d0, d1;
  threefry2x32(k0, k1, sidx, slot0 + 2u * k_trials, d0, d1);
  const float ct = 2.0f * bits_to_uniform(d0) - 1.0f;
  const float st = sqrtf(fmaxf(1.0f - ct * ct, 0.0f));
  float sph, cph;
  sincos_2pi(bits_to_uniform(d1), sph, cph);
  const Quat w = {{x0, rho * st * cph, rho * st * sph, rho * ct}};
  if (ok && k > 1e-30f) return quat_mul(w, quat_conj(v));
  return {{1.0f, 0.0f, 0.0f, 0.0f}};
}

__global__ void __launch_bounds__(128)
stage_heatbath_su3_kernel(Links L, int mu, int parity, Dims d, uint32_t k0,
                          uint32_t k1, float tbn, int k_trials) {
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= d.v2) return;
  const int p = parity, q = parity ^ 1;
  const Site x = decode_slot(slot, p, d);

  // staple sum A in _staple_W's order: nu ascending, term = fwd + bwd
  M3 acc;
  bool first = true;
#pragma unroll
  for (int nu = 0; nu < 4; ++nu) {
    if (nu == mu) continue;
    const Site xpm = step(x, mu, 1, d);
    const Site xpn = step(x, nu, 1, d);
    const Site xmn = step(x, nu, -1, d);
    const Site xpmmn = step(xpm, nu, -1, d);
    // forward: U_nu(x+mu) [U_nu(x) U_mu(x+nu)]^+
    const M3 inner = mmul(load_link(L, nu, p, x, d), load_link(L, mu, q, xpn, d));
    const M3 fwd = mmul_bdag(load_link(L, nu, q, xpm, d), inner);
    // backward: [U_mu(x-nu) U_nu(x+mu-nu)]^+ U_nu(x-nu)
    const M3 bwd = mmul(
        mdag(mmul(load_link(L, mu, q, xmn, d), load_link(L, nu, p, xpmmn, d))),
        load_link(L, nu, q, xmn, d));
    const M3 term = madd(fwd, bwd);
    acc = first ? term : madd(acc, term);
    first = false;
  }
  float* target = L.p[2 * mu + p];
  M3 u = load_mat(target, slot, d.v2);
  M3 w = mmul(u, acc);

  const uint32_t sidx = dense_index(x, d);
  const uint32_t per_slots = 2u * k_trials + 1u;
  const int sg[3][2] = {{0, 1}, {0, 2}, {1, 2}};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int i = sg[s][0], j = sg[s][1];
    const Quat flip = heatbath_flip(quat_from_block(w, i, j), tbn, k0, k1,
                                    sidx, per_slots * s, k_trials);
    subgroup_left_mul(flip, i, j, u);
    subgroup_left_mul(flip, i, j, w);
  }
  store_rows(target, slot, d.v2, u);
}

}  // namespace qg

extern "C" int qg_stage_heatbath_su3(void* u0, void* u1, void* u2, void* u3,
                                     void* u4, void* u5, void* u6, void* u7,
                                     int mu, int parity, int X, int Y, int Z,
                                     int T, unsigned int k0, unsigned int k1,
                                     float two_beta_over_n, int k_trials,
                                     void* stream) {
  qg::Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3, (float*)u4,
                  (float*)u5, (float*)u6, (float*)u7}};
  const qg::Dims d = qg::make_dims(X, Y, Z, T);
  const int threads = 128;
  const int blocks = (d.v2 + threads - 1) / threads;
  qg::stage_heatbath_su3_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      L, mu, parity, d, k0, k1, two_beta_over_n, k_trials);
  return (int)cudaGetLastError();
}
