// K2: reunitarization of one packed (direction, parity) array, SU(3) and
// SU(2).
//
// Replaces the TPU kernel qcdgpu_tpu/ops/pallas/reunit.py:_reunit_kernel
// (built by _reunit_call).  Plain PyTorch twin:
// ops/cuda/reunit.py:reunitarize_dir_ref.
//
// What it computes, per link.  SU(3): Gram-Schmidt on the two stored rows
// (row 0 normalised; row 1 <- row 1 - <r0, row 1> r0, normalised); row 2 is
// implicit in the codec, so it needs no projection.  SU(2): the quaternion
// of the stored 2x2 matrix, renormalised, written back as a matrix.
//
// What bounds it on an H100: it is site-local and streams 48 bytes in and
// 48 bytes out per link at SU(3) (32 and 32 at SU(2)) with ~100 flops (~30),
// so it is bound by HBM bandwidth.
// The design is therefore the plainest one: one thread per slot, component
// planes read and written coalesced, in place, nothing staged in shared
// memory.
//
// K2c (qg_reunit_chains) is the same kernel over one chain-stacked array
// [C, 2, N, 2, X, Y, Z*T/2] of a beta scan, chain on blockIdx.y (the
// reference vmaps _reunit_kernel through make_pallas_sweep,
// models/ensemble.py:125): 8 launches per reunitarization for any C.
#include "common.cuh"

namespace qg {

__device__ __forceinline__ void norm_row(C r[3]) {
  float s = r[0].re * r[0].re + r[0].im * r[0].im;
  s = s + (r[1].re * r[1].re + r[1].im * r[1].im);
  s = s + (r[2].re * r[2].re + r[2].im * r[2].im);
  const float inv = 1.0f / sqrtf(s);
#pragma unroll
  for (int j = 0; j < 3; ++j) r[j] = {r[j].re * inv, r[j].im * inv};
}

// chain_stride: floats from one chain's array to the next (0, one chain)
__global__ void reunit_su3_kernel(float* __restrict__ arr, int v2,
                                  long long chain_stride) {
  arr += (size_t)blockIdx.y * (size_t)chain_stride;
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= v2) return;
  C r0[3], m1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    r0[j] = {arr[(j * 2 + 0) * v2 + slot], arr[(j * 2 + 1) * v2 + slot]};
    m1[j] = {arr[((3 + j) * 2 + 0) * v2 + slot], arr[((3 + j) * 2 + 1) * v2 + slot]};
  }
  norm_row(r0);
  // inner product conj(r0) . m1, accumulated as the reference does
  C ip = cmul_conj(m1[0], r0[0]);
  ip = cadd(ip, cmul_conj(m1[1], r0[1]));
  ip = cadd(ip, cmul_conj(m1[2], r0[2]));
  C r1[3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
    r1[j] = {m1[j].re - (ip.re * r0[j].re - ip.im * r0[j].im),
             m1[j].im - (ip.re * r0[j].im + ip.im * r0[j].re)};
  norm_row(r1);
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    arr[(j * 2 + 0) * v2 + slot] = r0[j].re;
    arr[(j * 2 + 1) * v2 + slot] = r0[j].im;
    arr[((3 + j) * 2 + 0) * v2 + slot] = r1[j].re;
    arr[((3 + j) * 2 + 1) * v2 + slot] = r1[j].im;
  }
}

// quaternion projection + renormalisation, in the order of reference
// ops/pallas/reunit.py; stored layout [r][j][re/im]
__global__ void reunit_su2_kernel(float* __restrict__ arr, int v2,
                                  long long chain_stride) {
  arr += (size_t)blockIdx.y * (size_t)chain_stride;
  const int slot = blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= v2) return;
  float m[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) m[c] = arr[c * v2 + slot];
  // m[(r * 2 + j) * 2 + (0 re | 1 im)]
  float a0 = 0.5f * (m[0] + m[6]);
  float a1 = 0.5f * (m[3] + m[5]);
  float a2 = 0.5f * (m[2] - m[4]);
  float a3 = 0.5f * (m[1] - m[7]);
  const float inv = 1.0f / sqrtf(a0 * a0 + a1 * a1 + a2 * a2 + a3 * a3);
  a0 = a0 * inv; a1 = a1 * inv; a2 = a2 * inv; a3 = a3 * inv;
  const float out[8] = {a0, a3, a2, a1, -a2, a1, a0, -a3};
#pragma unroll
  for (int c = 0; c < 8; ++c) arr[c * v2 + slot] = out[c];
}

int reunit(float* arr, int n, int v2, int n_chains, cudaStream_t s) {
  if (n_chains < 1 || n_chains > 65535) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const dim3 grid((v2 + threads - 1) / threads, n_chains);
  const long long stride = 4LL * n * v2;
  if (n == 3)
    reunit_su3_kernel<<<grid, threads, 0, s>>>(arr, v2, stride);
  else if (n == 2)
    reunit_su2_kernel<<<grid, threads, 0, s>>>(arr, v2, stride);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace qg

// n: 2 or 3; v2: slots of the array
extern "C" int qg_reunit(void* arr, int n, int v2, void* stream) {
  return qg::reunit((float*)arr, n, v2, 1, (cudaStream_t)stream);
}

// K2c: n_chains chains' arrays, each 4 n v2 floats, one after the other
extern "C" int qg_reunit_chains(void* arr, int n, int v2, int n_chains,
                                void* stream) {
  return qg::reunit((float*)arr, n, v2, n_chains, (cudaStream_t)stream);
}
