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
// K5a and K5b are the same kernels on one halo-padded shard of an X/Y mesh
// (D = ShardDims instead of Dims): they replace measure.py:
// _plq_sharded_kernel (call :316, plane_sums_local) and _poly_sharded_kernel
// (call :422, polyakov_sums_local).  K5a reads the +1 neighbours from the
// shard's halos; K5b walks the interior columns (T is never split) with the
// global parity.  The caller adds the shards' sums in a fixed order.  Plain
// twins: ops/cuda/measure.py:plane_sums_local_ref, polyakov_sums_local_ref.
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
// K3c / K4c (qg_plane_sums_chains, qg_polyakov_sums_chains) are K3 / K4 on
// the chain-stacked arrays [C, 2, N, 2, X, Y, Z*T/2] of a beta scan, chain
// on blockIdx.y (the reference vmaps measure_all_split over the chains,
// models/ensemble.py:129-131): partials [C, n_blocks, k], and the finish
// kernel one block per chain.  Each chain's blocks and finish run in K3 /
// K4's order, so its sums are K3 / K4's on that chain's arrays, bit for bit.
//
// Reduction: the TPU kernels carry f32 Kahan sums across a sequential grid;
// blocks here run in no order, so each block tree-reduces its threads' f64
// values in shared memory into a [n_blocks, n_out] scratch, and a second
// one-block kernel sums the partials in a fixed order.  No atomics: a run's
// measurement series is reproducible bit for bit.
#include "common.cuh"

namespace qg {

// Only the unsharded geometry has a chain axis (K3c/K4c): the shard forms
// (K5a/K5b) compile without its offsets and keep their registers (K5a
// SU(3) sits at 128, the most that lets two 256-thread blocks share an
// SM).
template <class D> constexpr bool kChains = false;
template <> constexpr bool kChains<Dims> = true;

// chain_stride: floats from one chain's array to the next (0, one chain);
// chain blockIdx.y writes partials row block blockIdx.y * gridDim.x
template <int N, class D>
__global__ void plane_sums_kernel(Links L, D d, long long chain_stride,
                                  double* __restrict__ partials) {
  extern __shared__ double sh[];
  if constexpr (kChains<D>) {
    const size_t off = (size_t)blockIdx.y * (size_t)chain_stride;
#pragma unroll
    for (int k = 0; k < 8; ++k) L.p[k] += off;
    partials += (size_t)blockIdx.y * gridDim.x * 6;
  }
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int nv = n_sites(d);
  const bool active = g < 2 * nv;
  float tr6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (active) {
    const int p = g >= nv ? 1 : 0;
    const int q = p ^ 1;
    const Site x = decode_slot(g - p * nv, p, d);
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

// a spatial column (x, y, z) of the lattice or of a shard's interior: the
// parity of (x, y, z, t = 0) and the slot of its t = 0, 1 pair
__device__ __forceinline__ void poly_column(int col, const Dims& d, int& sig,
                                            int& base) {
  sig = (col % d.z + (col / d.z) % d.y + col / (d.z * d.y)) & 1;
  base = col * d.t2;
}

__device__ __forceinline__ void poly_column(int col, const ShardDims& d,
                                            int& sig, int& base) {
  const int z = col % d.z, y = (col / d.z) % d.y, x = col / (d.z * d.y);
  sig = (d.x0 + x + d.y0 + y + z) & 1;
  base = (((x + d.hx) * d.py + y + d.hy) * d.z + z) * d.t2;
}

template <int N, class D>
__global__ void polyakov_sums_kernel(const float* __restrict__ u6,
                                     const float* __restrict__ u7, D d,
                                     long long chain_stride,
                                     double* __restrict__ partials) {
  extern __shared__ double sh[];
  if constexpr (kChains<D>) {
    const size_t off = (size_t)blockIdx.y * (size_t)chain_stride;
    u6 += off;
    u7 += off;
    partials += (size_t)blockIdx.y * gridDim.x * 2;
  }
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_col = d.x * d.y * d.z;
  float tr_re = 0.f, tr_im = 0.f;
  if (col < n_col) {
    int sig, base;
    poly_column(col, d, sig, base);
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

// out[o] = sum_b partials[b * n_out + o], in a fixed order (one block per
// chain: chain blockIdx.x reads its partials and writes its n_out sums)
__global__ void finish_sums_kernel(const double* __restrict__ partials,
                                   int n_blocks, int n_out,
                                   double* __restrict__ out) {
  extern __shared__ double sh[];
  partials += (size_t)blockIdx.x * n_blocks * n_out;
  out += (size_t)blockIdx.x * n_out;
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

inline bool chain_count_ok(int n_chains) {
  return n_chains >= 1 && n_chains <= 65535;
}

// n_chains chains, each array's chains chain_stride floats apart (one
// chain: 1, 0); partials [n_chains, n_blocks, 6], out [n_chains, 6]
template <class D>
int plane_sums(const Links& L, int n, const D& d, int block, double* partials,
               double* out, cudaStream_t s, int n_chains = 1,
               long long chain_stride = 0) {
  if (!pow2_block(block) || (n != 2 && n != 3) || !chain_count_ok(n_chains))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (2 * n_sites(d) + block - 1) / block;
  const size_t smem = block * sizeof(double);
  const dim3 grid(n_blocks, n_chains);
  if (n == 3)
    plane_sums_kernel<3><<<grid, block, smem, s>>>(L, d, chain_stride,
                                                   partials);
  else
    plane_sums_kernel<2><<<grid, block, smem, s>>>(L, d, chain_stride,
                                                   partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_sums_kernel<<<n_chains, block, smem, s>>>(partials, n_blocks, 6,
                                                   out);
  return (int)cudaGetLastError();
}

// partials [n_chains, n_blocks, 2], out [n_chains, 2]
template <class D>
int polyakov_sums(const float* u6, const float* u7, int n, const D& d,
                  int block, double* partials, double* out, cudaStream_t s,
                  int n_chains = 1, long long chain_stride = 0) {
  if (!pow2_block(block) || (n != 2 && n != 3) || !chain_count_ok(n_chains))
    return (int)cudaErrorInvalidValue;
  const int n_blocks = (d.x * d.y * d.z + block - 1) / block;
  const size_t smem = block * sizeof(double);
  const dim3 grid(n_blocks, n_chains);
  if (n == 3)
    polyakov_sums_kernel<3><<<grid, block, smem, s>>>(u6, u7, d, chain_stride,
                                                      partials);
  else
    polyakov_sums_kernel<2><<<grid, block, smem, s>>>(u6, u7, d, chain_stride,
                                                      partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_sums_kernel<<<n_chains, block, smem, s>>>(partials, n_blocks, 2,
                                                   out);
  return (int)cudaGetLastError();
}

}  // namespace qg

// n: 2 or 3; partials: f64 [n_blocks * 6] with
// n_blocks = ceil(2 * V2 / block); out: f64 [6]
extern "C" int qg_plane_sums(void* u0, void* u1, void* u2, void* u3, void* u4,
                             void* u5, void* u6, void* u7, int n, int X,
                             int Y, int Z, int T, int block, void* partials,
                             void* out, void* stream) {
  const qg::Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3,
                        (float*)u4, (float*)u5, (float*)u6, (float*)u7}};
  return qg::plane_sums(L, n, qg::make_dims(X, Y, Z, T), block,
                        (double*)partials, (double*)out, (cudaStream_t)stream);
}

// K5a: qg_plane_sums over one shard's interior sites (u0..u7 its padded
// arrays, geometry as qg_stage_shard); n_blocks = ceil(2 * lx*ly*Z*T/2 /
// block).  The caller sums the shards.
extern "C" int qg_plane_sums_local(void* u0, void* u1, void* u2, void* u3,
                                   void* u4, void* u5, void* u6, void* u7,
                                   int n, int lx, int ly, int Z, int T, int hx,
                                   int hy, int x0, int y0, int gy, int block,
                                   void* partials, void* out, void* stream) {
  const qg::Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3,
                        (float*)u4, (float*)u5, (float*)u6, (float*)u7}};
  return qg::plane_sums(L, n,
                        qg::make_shard_dims(lx, ly, Z, T, hx, hy, x0, y0, gy),
                        block, (double*)partials, (double*)out,
                        (cudaStream_t)stream);
}

// n: 2 or 3; partials: f64 [n_blocks * 2] with
// n_blocks = ceil(X*Y*Z / block); out: f64 [2] = (sum re tr, sum im tr)
extern "C" int qg_polyakov_sums(void* u6, void* u7, int n, int X, int Y,
                                int Z, int T, int block, void* partials,
                                void* out, void* stream) {
  return qg::polyakov_sums((const float*)u6, (const float*)u7, n,
                           qg::make_dims(X, Y, Z, T), block, (double*)partials,
                           (double*)out, (cudaStream_t)stream);
}

// K5b: qg_polyakov_sums over one shard's interior columns (u6, u7 its padded
// temporal arrays; T is never split, so no halo is read); n_blocks =
// ceil(lx*ly*Z / block).
extern "C" int qg_polyakov_sums_local(void* u6, void* u7, int n, int lx,
                                      int ly, int Z, int T, int hx, int hy,
                                      int x0, int y0, int gy, int block,
                                      void* partials, void* out,
                                      void* stream) {
  return qg::polyakov_sums(
      (const float*)u6, (const float*)u7, n,
      qg::make_shard_dims(lx, ly, Z, T, hx, hy, x0, y0, gy), block,
      (double*)partials, (double*)out, (cudaStream_t)stream);
}

// K3c: qg_plane_sums over n_chains chain-stacked arrays (u0..u7 [C, 2, n,
// 2, X, Y, Z*T/2]; chain_stride = 4 n X Y Z T / 2 floats); partials f64
// [n_chains * n_blocks * 6], out f64 [n_chains, 6]
extern "C" int qg_plane_sums_chains(void* u0, void* u1, void* u2, void* u3,
                                    void* u4, void* u5, void* u6, void* u7,
                                    long long chain_stride, int n_chains,
                                    int n, int X, int Y, int Z, int T,
                                    int block, void* partials, void* out,
                                    void* stream) {
  const qg::Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3,
                        (float*)u4, (float*)u5, (float*)u6, (float*)u7}};
  return qg::plane_sums(L, n, qg::make_dims(X, Y, Z, T), block,
                        (double*)partials, (double*)out, (cudaStream_t)stream,
                        n_chains, chain_stride);
}

// K4c: qg_polyakov_sums over n_chains chain-stacked temporal arrays;
// partials f64 [n_chains * n_blocks * 2], out f64 [n_chains, 2]
extern "C" int qg_polyakov_sums_chains(void* u6, void* u7,
                                       long long chain_stride, int n_chains,
                                       int n, int X, int Y, int Z, int T,
                                       int block, void* partials, void* out,
                                       void* stream) {
  return qg::polyakov_sums((const float*)u6, (const float*)u7, n,
                           qg::make_dims(X, Y, Z, T), block, (double*)partials,
                           (double*)out, (cudaStream_t)stream, n_chains,
                           chain_stride);
}
