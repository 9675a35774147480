// K2: SU(3) reunitarization of one packed (direction, parity) array.
//
// Replaces the TPU kernel qcdgpu_tpu/ops/pallas/reunit.py:_reunit_kernel
// (built by _reunit_call) for SU(3).  Plain PyTorch twin:
// ops/cuda/reunit.py:reunitarize_dir_ref.
//
// What it computes, per link: Gram-Schmidt on the two stored rows
// (row 0 normalised; row 1 <- row 1 - <r0, row 1> r0, normalised).  Row 2 is
// implicit in the codec, so it needs no projection.
//
// What bounds it on an H100: it is site-local and streams 48 bytes in and
// 48 bytes out per link with ~100 flops, so it is bound by HBM bandwidth.
// The design is therefore the plainest one: one thread per slot, component
// planes read and written coalesced, in place, nothing staged in shared
// memory.
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

__global__ void reunit_su3_kernel(float* __restrict__ arr, int v2) {
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

}  // namespace qg

extern "C" int qg_reunit_su3(void* arr, int v2, void* stream) {
  const int threads = 256;
  const int blocks = (v2 + threads - 1) / threads;
  qg::reunit_su3_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (float*)arr, v2);
  return (int)cudaGetLastError();
}
