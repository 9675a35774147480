// K3 plane sums and K4 Polyakov sums on the packed link state, SU(3) and
// SU(2) (template parameter N).
//
// K3 replaces the TPU kernel qcdgpu_tpu/ops/pallas/measure.py:_plq_kernel
// (built by _plq_call; the TPU runs its Y-tiled wrapper plane_sums_tiled at
// 32^4 through _plq_sharded_kernel with local_x = 0, the same function).
// K4 replaces measure.py:_poly_kernel (built by _poly_call; at 32^4 the TPU
// runs polyakov_sums_tiled through _poly_sharded_kernel, again the same
// function).  Plain PyTorch twins: ops/cuda/measure.py:plane_sums_ref and
// polyakov_sums_ref.
//
// K3, per site x (one thread for each site of either parity): for the six
// planes (0,1), (0,2), (0,3), (1,2), (1,3), (2,3), Re tr[(U_mu(x)
// U_nu(x+mu)) (U_nu(x) U_mu(x+nu))^+] in f32, summed over sites in f64.
// K4, per spatial column (x, y, z): the ordered product U_t(t=0) ... U_t(T-1)
// walked in t, taking slot t/2 of us[6 + (x+y+z+t) % 2]; tr re/im summed in
// f64.  Walking t in a thread replaces the TPU kernel's lane-roll ladder and
// is valid for any T, including T/2 odd.
//
// What bounds them on an H100: K3 reads each link 4 times per parity pass
// (~0.2 GB at SU(3) 32^4, mostly L2 hits) for ~4k flops per site, so it is
// compute-bound like the stage kernel; K4 touches only the temporal links
// (1/4 of the state) with one thread per column, so it is bound by
// bandwidth and by its small thread count (X*Y*Z).
//
// Reduction: the TPU kernels carry f32 Kahan sums across a sequential grid;
// blocks here run in no order, so each block tree-reduces its threads' f64
// values in shared memory into a [n_blocks, n_out] scratch, and a second
// one-block kernel sums the partials in a fixed order.  No atomics: a run's
// measurement series is reproducible bit for bit.
#include "common.cuh"

namespace qg {

template <int N>
__global__ void plane_sums_kernel(Links L, Dims d,
                                  double* __restrict__ partials) {
  extern __shared__ double sh[];
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = g < 2 * d.v2;
  float tr6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) {
    const int p = g >= d.v2 ? 1 : 0;
    const int q = p ^ 1;
    const Site x = decode_slot(g - p * d.v2, p, d);
    const int planes[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};
#pragma unroll
    for (int pl = 0; pl < 6; ++pl) {
      const int mu = planes[pl][0], nu = planes[pl][1];
      const Mat<N> a = mmul(load_link<N>(L, mu, p, x, d),
                            load_link<N>(L, nu, q, step(x, mu, 1, d), d));
      const Mat<N> b = mmul(load_link<N>(L, nu, p, x, d),
                            load_link<N>(L, mu, q, step(x, nu, 1, d), d));
      float tr = 0.f;
#pragma unroll
      for (int r = 0; r < N; ++r)
#pragma unroll
        for (int c = 0; c < N; ++c) {
          const float t = a.a[r][c].re * b.a[r][c].re + a.a[r][c].im * b.a[r][c].im;
          tr = (r == 0 && c == 0) ? t : tr + t;
        }
      tr6[pl] = tr;
    }
  }
#pragma unroll
  for (int pl = 0; pl < 6; ++pl) {
    sh[threadIdx.x] = (double)tr6[pl];
    block_tree_sum(sh);
    if (threadIdx.x == 0) partials[blockIdx.x * 6 + pl] = sh[0];
  }
}

template <int N>
__global__ void polyakov_sums_kernel(const float* __restrict__ u6,
                                     const float* __restrict__ u7, Dims d,
                                     double* __restrict__ partials) {
  extern __shared__ double sh[];
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_col = d.x * d.y * d.z;
  float tr_re = 0.f, tr_im = 0.f;
  if (col < n_col) {
    const int sig = (col % d.z + (col / d.z) % d.y + col / (d.z * d.y)) & 1;
    const int base = col * d.t2;
    Mat<N> prod = load_mat<N>(sig ? u7 : u6, base, d.v2);
    for (int t = 1; t < d.t; ++t) {
      const float* arr = ((sig + t) & 1) ? u7 : u6;
      prod = mmul(prod, load_mat<N>(arr, base + t / 2, d.v2));
    }
    tr_re = prod.a[0][0].re;
    tr_im = prod.a[0][0].im;
#pragma unroll
    for (int r = 1; r < N; ++r) {
      tr_re = tr_re + prod.a[r][r].re;
      tr_im = tr_im + prod.a[r][r].im;
    }
  }
  sh[threadIdx.x] = (double)tr_re;
  block_tree_sum(sh);
  if (threadIdx.x == 0) partials[blockIdx.x * 2 + 0] = sh[0];
  sh[threadIdx.x] = (double)tr_im;
  block_tree_sum(sh);
  if (threadIdx.x == 0) partials[blockIdx.x * 2 + 1] = sh[0];
}

// out[o] = sum_b partials[b * n_out + o], in a fixed order (one block)
__global__ void finish_sums_kernel(const double* __restrict__ partials,
                                   int n_blocks, int n_out,
                                   double* __restrict__ out) {
  extern __shared__ double sh[];
  for (int o = 0; o < n_out; ++o) {
    double s = 0.0;
    for (int b = threadIdx.x; b < n_blocks; b += blockDim.x)
      s += partials[b * n_out + o];
    sh[threadIdx.x] = s;
    block_tree_sum(sh);
    if (threadIdx.x == 0) out[o] = sh[0];
  }
}

inline bool pow2_block(int block) {
  return block >= 32 && block <= 1024 && (block & (block - 1)) == 0;
}

}  // namespace qg

// n: 2 or 3; partials: f64 [n_blocks * 6] with
// n_blocks = ceil(2 * V2 / block); out: f64 [6]
extern "C" int qg_plane_sums(void* u0, void* u1, void* u2, void* u3, void* u4,
                             void* u5, void* u6, void* u7, int n, int X,
                             int Y, int Z, int T, int block, void* partials,
                             void* out, void* stream) {
  if (!qg::pow2_block(block) || (n != 2 && n != 3))
    return (int)cudaErrorInvalidValue;
  qg::Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3, (float*)u4,
                  (float*)u5, (float*)u6, (float*)u7}};
  const qg::Dims d = qg::make_dims(X, Y, Z, T);
  const int n_blocks = (2 * d.v2 + block - 1) / block;
  const size_t smem = block * sizeof(double);
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 3)
    qg::plane_sums_kernel<3><<<n_blocks, block, smem, s>>>(L, d,
                                                          (double*)partials);
  else
    qg::plane_sums_kernel<2><<<n_blocks, block, smem, s>>>(L, d,
                                                          (double*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qg::finish_sums_kernel<<<1, block, smem, s>>>((double*)partials, n_blocks, 6,
                                                (double*)out);
  return (int)cudaGetLastError();
}

// n: 2 or 3; partials: f64 [n_blocks * 2] with
// n_blocks = ceil(X*Y*Z / block); out: f64 [2] = (sum re tr, sum im tr)
extern "C" int qg_polyakov_sums(void* u6, void* u7, int n, int X, int Y,
                                int Z, int T, int block, void* partials,
                                void* out, void* stream) {
  if (!qg::pow2_block(block) || (n != 2 && n != 3))
    return (int)cudaErrorInvalidValue;
  const qg::Dims d = qg::make_dims(X, Y, Z, T);
  const int n_blocks = (X * Y * Z + block - 1) / block;
  const size_t smem = block * sizeof(double);
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 3)
    qg::polyakov_sums_kernel<3><<<n_blocks, block, smem, s>>>(
        (const float*)u6, (const float*)u7, d, (double*)partials);
  else
    qg::polyakov_sums_kernel<2><<<n_blocks, block, smem, s>>>(
        (const float*)u6, (const float*)u7, d, (double*)partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  qg::finish_sums_kernel<<<1, block, smem, s>>>((double*)partials, n_blocks, 2,
                                                (double*)out);
  return (int)cudaGetLastError();
}
