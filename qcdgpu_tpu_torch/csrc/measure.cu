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
// shard's halos; K5b runs K4's lanes over the interior columns (T is never
// split) with the global parity.  The caller adds the shards' sums in a
// fixed order.  Plain twins: ops/cuda/measure.py:plane_sums_local_ref,
// polyakov_sums_local_ref.
//
// K3, per site x (one thread for each site of either parity): for the six
// planes (0,1), (0,2), (0,3), (1,2), (1,3), (2,3), Re tr[(U_mu(x)
// U_nu(x+mu)) (U_nu(x) U_mu(x+nu))^+] in f32, summed over sites in f64.
// K4, per spatial column (x, y, z): tr of the ordered product U_t(t=0) ...
// U_t(T-1), U_t(t) in slot t/2 of us[6 + (x+y+z+t) % 2]; tr re/im summed in
// f64.  A column's T/2 slots are contiguous, so K4 runs a group of lanes
// per column, lane k on slot k (the TPU kernel's lanes are slots too, and
// pltpu.roll becomes __shfl_down_sync): neighbouring lanes load
// neighbouring words, and a column's T - 1 products run as a log-depth
// ladder instead of a chain in one thread.  The association, a function
// of T alone and the same in K4, K4c, K5b and K5bc (and in the plain twin,
// ops/cuda/measure.py:polyakov_columns_ref):
//   pairs:  V_s = U_{2s} U_{2s+1}, s < T/2 (the reference's level 0);
//   units:  W = ceil(T/2 / 32) slots a lane, m = ceil(T/2 / W) units,
//           unit k = ((V_{kW} V_{kW+1}) ...) V_{min(kW+W, T/2)-1}, left to
//           right (W = 1, unit k = V_k, for every T/2 <= 32);
//   ladder: lad_0 = unit, lad_j(k) = lad_{j-1}(k) lad_{j-1}(k + 2^(j-1)),
//           the product of units [k, k + 2^j) (the reference's lad[j]);
//   chunks: for each set bit j of m, low to high, the chunk lad_j(pos_j),
//           pos_j = m with bits 0..j cleared, multiplies the product of
//           the lower chunks from the left: P = C_hi (... (C_mid C_lo)).
// The reference (qcdgpu_tpu/ops/pallas/measure.py:196-203) folds the same
// chunks from the left, ((C_hi C_mid) C_lo); the two agree wherever m has
// at most two set bits (every T/2 <= 6 and every power of two among them).
// Folding from the right keeps one ladder level live, not all of them.
// Valid for any even T.
//
// What bounds them on an H100: K3 reads each link 4 times per parity pass
// (~0.2 GB at SU(3) 32^4, mostly L2 hits) for 3.3k f32 operations per site
// at -fmad=false, so it is bound by instruction slots and gather latency
// like the stage kernel (0.10 ms of f32 instructions at 32^4, above its
// 0.06 ms HBM bound); K4 reads only the temporal links (1/4 of the state)
// once, coalesced, but its ladder does about 2.5x the products of a walk in
// t (each lane multiplies at every level: m (1 + log2 m) products a column
// at W = 1, not T - 1), and at -fmad=false those alone take longer than
// the HBM bound (SU(3) 32^4: 0.017 ms of f32 instructions against 0.015),
// plus 2N^2 shuffles a level (PERF.md, tools/port_kernel_ab.py).
//
// K3's design: the slot deltas of common.cuh (no division, no frame), each
// distinct link loaded and decoded once per site (16, not 24), 128
// registers at 2 blocks of 256 an SM, and the block's six sums by shuffles
// with one barrier (block_sums) in place of six shared-memory trees.  Where Z*T/2 is a multiple of 128
// (16^4, 32^4, 64^4) a block covers 128 slots of both parities, whole
// (z, t) lines of one (x, y) row, and shares its links through shared
// memory (plane_sums_tile_kernel): each thread decodes its own four links
// into the tile once, and a site reads its own links and its z and t
// neighbours there, loading only its x and y neighbours (10.5 loads and
// decodes a site, not 16; faster than the register kernel at SU(3) and
// SU(2) 32^4, PERF.md).  The other shapes (24^3 x 6: Z*T/2 = 72) and the
// shards (K5a) run the register kernel, plane_sums_kernel.  Both compute a
// site's traces with the same operations (plane_site, plane_tile_site), so
// only the order of the f64 sums differs.
//
// K3c / K4c (qg_plane_sums_chains, qg_polyakov_sums_chains) are K3 / K4 on
// the chain-stacked arrays [C, 2, N, 2, X, Y, Z*T/2] of a beta scan, chain
// on blockIdx.y (the reference vmaps measure_all_split over the chains,
// models/ensemble.py:129-131): partials [C, n_blocks, k], and the finish
// kernel one block per chain.  Each chain's blocks and finish run in K3 /
// K4's order, so its sums are K3 / K4's on that chain's arrays, bit for bit.
// K5ac / K5bc (qg_plane_sums_local_chains, qg_polyakov_sums_local_chains)
// are the same on one shard of a scan on an X/Y mesh: a block of chains'
// padded arrays [C, 2, N, 2, lx + 2 hx, ly + 2 hy, Z*T/2] (the reference
// vmaps the sharded measurement body, ops/pallas/sharded.py, over each
// device's chain block, models/ensemble.py:96-131); chain c's sums are
// K5a / K5b's on its own padded arrays, bit for bit.  The caller adds each
// chain's shard sums in shard order.  One kernel serves one chain and C:
// the single-chain entry points pass C = 1 and a chain stride of 0.
//
// Reduction: the TPU kernels carry f32 Kahan sums across a sequential grid;
// blocks here run in no order, so each block reduces its threads' f64
// values in a fixed order (block_sums: shuffles, one barrier) into a
// [n_blocks, n_out] scratch, and a second one-block kernel sums the
// partials in a fixed order.  No atomics: a run's measurement series is
// reproducible bit for bit.
#include <type_traits>

#include "common.cuh"

namespace qg {

// K3's block (the wrappers' REDUCE_BLOCK) and the blocks an SM must hold
// at once, which caps its registers at 65536 / (256 x 2) = 128 (SU(3)
// takes them all; uncapped it takes 201 and ran slower on the H100).
constexpr int kPlaneThreads = 256;
constexpr int kPlaneMinBlocks = 2;

// The six plaquettes at site g of either parity (g < nv: parity 0 slot g,
// else parity 1 slot g - nv), in f32 as the plain version forms them: the
// four links U_a(x) loaded and decoded once, each neighbour link U_nu(x+mu)
// once (16 loads, not one per use: 24).  The planes are computed in the
// order (0,1), (0,2), (1,2), (0,3), (1,3), (2,3), U_3 last: in PLANES order
// the shard form spilled at the 128-register cap.
template <int N, class D>
__device__ __forceinline__ void plane_site(const Links& L, int g, const D& d,
                                           float (&tr6)[6]) {
  const int nv = n_sites(d), v2 = d.v2;
  const int p = g >= nv ? 1 : 0;
  const int q = p ^ 1;
  const SiteAddr x = site_addr(g - p * nv, p, d);
  Mat<N> own[4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
    own[a] = load_mat<N>(link_array(L, a, p), x.own, v2);
  // (mu, nu, the plane's index in PLANES order)
  const int planes[6][3] = {{0, 1, 0}, {0, 2, 1}, {1, 2, 3},
                            {0, 3, 2}, {1, 3, 4}, {2, 3, 5}};
#pragma unroll
  for (int pl = 0; pl < 6; ++pl) {
    const int mu = planes[pl][0], nu = planes[pl][1];
    const Mat<N> a = mmul(own[mu], load_mat<N>(link_array(L, nu, q),
                                               x.own + x.fwd[mu], v2));
    const Mat<N> b = mmul(own[nu], load_mat<N>(link_array(L, mu, q),
                                               x.own + x.fwd[nu], v2));
    float tr = 0.f;
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int c = 0; c < N; ++c) {
        const float t = a.a[r][c].re * b.a[r][c].re + a.a[r][c].im * b.a[r][c].im;
        tr = (r == 0 && c == 0) ? t : tr + t;
      }
    tr6[planes[pl][2]] = tr;
  }
}

// chain_stride: floats from one chain's array to the next (0, one chain);
// chain blockIdx.y writes partials row block blockIdx.y * gridDim.x.  The
// block's six sums by block_sums (shuffles, one barrier).
template <int N, class D>
__global__ void __launch_bounds__(kPlaneThreads, kPlaneMinBlocks)
plane_sums_kernel(Links L, D d, long long chain_stride,
                  double* __restrict__ partials) {
  const size_t off = (size_t)blockIdx.y * (size_t)chain_stride;
#pragma unroll
  for (int k = 0; k < 8; ++k) L.p[k] += off;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  float tr6[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (g < 2 * n_sites(d)) plane_site<N>(L, g, d, tr6);
  double v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = (double)tr6[k];
  block_sums(v, partials);
}

// K3's tile: a block of kPlaneThreads threads holds kTileSlots slots of
// both parities (threads 0-127 parity 0, 128-255 parity 1) on whole (z, t)
// lines of one (x, y) row, plus the line after its last (z + 1, wrapped;
// T/2 <= 32 slots).  Its rows are kTileLen long whatever T is, so that
// every component sits at a constant offset (a run-time stride cost the
// kernel a spill at the 128-register cap).
constexpr int kTileSlots = kPlaneThreads / 2;
constexpr int kTileLen = kTileSlots + 32;

inline bool tile_fits(const Dims& d) {
  return d.t2 <= kTileLen - kTileSlots && kTileSlots % d.t2 == 0 &&
         (d.z * d.t2) % kTileSlots == 0;
}

// the decoded matrix of direction a, parity p at tile slot j, structure of
// arrays: component c at tile[((p * 4 + a) * 2 N^2 + c) * kTileLen + j]
template <int N>
__device__ __forceinline__ void tile_put(float* tile, int p, int a, int j,
                                         const Mat<N>& m) {
  float* t = tile + (p * 4 + a) * 2 * N * N * kTileLen + j;
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      t[((r * N + c) * 2 + 0) * kTileLen] = m.a[r][c].re;
      t[((r * N + c) * 2 + 1) * kTileLen] = m.a[r][c].im;
    }
}

template <int N>
__device__ __forceinline__ Mat<N> tile_get(const float* tile, int p, int a,
                                           int j) {
  const float* t = tile + (p * 4 + a) * 2 * N * N * kTileLen + j;
  Mat<N> m;
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      m.a[r][c].re = t[((r * N + c) * 2 + 0) * kTileLen];
      m.a[r][c].im = t[((r * N + c) * 2 + 1) * kTileLen];
    }
  return m;
}

// thread tid of tile b: its four own links into the tile, and the first
// T/2 threads of each parity the links of the line after the tile
template <int N>
__device__ __forceinline__ void plane_tile_fill(const Links& L, const Dims& d,
                                                float* tile, int tid, int b) {
  const int p = tid >= kTileSlots ? 1 : 0, i = tid - p * kTileSlots;
  const int s0 = b * kTileSlots;
#pragma unroll
  for (int a = 0; a < 4; ++a)
    tile_put<N>(tile, p, a, i, load_mat<N>(link_array(L, a, p), s0 + i, d.v2));
  if (i < d.t2) {
    const int r = div_by(s0, d.ft2);  // (x Y + y) Z + z0
    const int z0 = r - div_by(r, d.fz) * d.z;
    int z = z0 + kTileSlots / d.t2;  // the line after the tile, wrapped
    z = z == d.z ? 0 : z;
    const int slot = s0 + (z - z0) * d.t2 + i;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      tile_put<N>(tile, p, a, kTileSlots + i,
                  load_mat<N>(link_array(L, a, p), slot, d.v2));
  }
}

// plane_site's traces for thread tid of tile b, the z and t neighbours and
// the own links from the tile (same operations, same bits)
template <int N>
__device__ __forceinline__ void plane_tile_site(const Links& L, const Dims& d,
                                                const float* tile, int tid,
                                                int b, float (&tr6)[6]) {
  const int p = tid >= kTileSlots ? 1 : 0, i = tid - p * kTileSlots;
  const int q = p ^ 1, v2 = d.v2;
  const SiteAddr x = site_addr(b * kTileSlots + i, p, d);
  const int planes[6][3] = {{0, 1, 0}, {0, 2, 1}, {1, 2, 3},
                            {0, 3, 2}, {1, 3, 4}, {2, 3, 5}};
#pragma unroll
  for (int pl = 0; pl < 6; ++pl) {
    const int mu = planes[pl][0], nu = planes[pl][1];
    // U_nu(x + mu), U_mu(x + nu): a z step is the next line of the tile, a
    // t step stays on the line
    const Mat<N> unu_xpm =
        mu == 2 ? tile_get<N>(tile, q, nu, i + d.t2)
        : mu == 3 ? tile_get<N>(tile, q, nu, i + x.fwd[3])
        : load_mat<N>(link_array(L, nu, q), x.own + x.fwd[mu], v2);
    const Mat<N> umu_xpn =
        nu == 2 ? tile_get<N>(tile, q, mu, i + d.t2)
        : nu == 3 ? tile_get<N>(tile, q, mu, i + x.fwd[3])
        : load_mat<N>(link_array(L, mu, q), x.own + x.fwd[nu], v2);
    const Mat<N> a = mmul(tile_get<N>(tile, p, mu, i), unu_xpm);
    const Mat<N> c = mmul(tile_get<N>(tile, p, nu, i), umu_xpn);
    float tr = 0.f;
#pragma unroll
    for (int r = 0; r < N; ++r)
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float t = a.a[r][k].re * c.a[r][k].re +
                        a.a[r][k].im * c.a[r][k].im;
        tr = (r == 0 && k == 0) ? t : tr + t;
      }
    tr6[planes[pl][2]] = tr;
  }
}

// K3 / K3c where tile_fits: dynamic shared memory of tile_bytes(N); chain
// blockIdx.y as plane_sums_kernel
template <int N>
__global__ void __launch_bounds__(kPlaneThreads, kPlaneMinBlocks)
plane_sums_tile_kernel(Links L, Dims d, long long chain_stride,
                       double* __restrict__ partials) {
  extern __shared__ float tile[];
  const size_t off = (size_t)blockIdx.y * (size_t)chain_stride;
#pragma unroll
  for (int k = 0; k < 8; ++k) L.p[k] += off;
  plane_tile_fill<N>(L, d, tile, threadIdx.x, blockIdx.x);
  __syncthreads();
  float tr6[6];
  plane_tile_site<N>(L, d, tile, threadIdx.x, blockIdx.x, tr6);
  double v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = (double)tr6[k];
  block_sums(v, partials);
}

inline size_t tile_bytes(int n) {
  return (size_t)2 * 4 * 2 * n * n * kTileLen * sizeof(float);
}

template <int N>
cudaError_t launch_plane_tile(const Links& L, const Dims& d, dim3 grid,
                              long long chain_stride, double* partials,
                              cudaStream_t s) {
  const size_t smem = tile_bytes(N);  // 90 KB at SU(3), 40 KB at SU(2)
  cudaError_t err = cudaFuncSetAttribute(
      plane_sums_tile_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  plane_sums_tile_kernel<N><<<grid, kPlaneThreads, smem, s>>>(
      L, d, chain_stride, partials);
  return cudaGetLastError();
}

// K4's lanes for a column of T/2 slots (a function of T alone): W slots a
// lane, m = ceil(T/2 / W) lanes holding a unit each, groups of L = 2^lg
// lanes (the smallest power of two >= m), so that a group never straddles
// a warp
struct PolyLanes {
  int w, m, lg;
};

__host__ inline PolyLanes poly_lanes(int t2) {
  PolyLanes pl;
  pl.w = (t2 + 31) / 32;
  pl.m = (t2 + pl.w - 1) / pl.w;
  pl.lg = 0;
  while ((1 << pl.lg) < pl.m) ++pl.lg;
  return pl;
}

// a spatial column (x, y, z) of the lattice or of a shard's interior: the
// parity of (x, y, z, t = 0) and the slot of its t = 0, 1 pair
__device__ __forceinline__ void poly_column(int col, const Dims& d, int& sig,
                                            int& base) {
  const int r = div_by(col, d.fz), z = col - r * d.z;  // r = x*Y + y
  const int x = div_by(r, d.fy), y = r - x * d.y;
  sig = (x + y + z) & 1;
  base = col * d.t2;
}

__device__ __forceinline__ void poly_column(int col, const ShardDims& d,
                                            int& sig, int& base) {
  const int r = div_by(col, d.fz), z = col - r * d.z;
  const int x = div_by(r, d.fy), y = r - x * d.y;
  sig = (d.x0 + x + d.y0 + y + z) & 1;
  base = (((x + d.hx) * d.py + y + d.hy) * d.z + z) * d.t2;
}

// the matrix of the lane delta above in the warp (a lane past the warp's
// end gets its own); every lane of the warp must call it
template <int N>
__device__ __forceinline__ Mat<N> shfl_down_mat(const Mat<N>& a, int delta) {
  Mat<N> o;
#pragma unroll
  for (int r = 0; r < N; ++r)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      o.a[r][c].re = __shfl_down_sync(0xffffffffu, a.a[r][c].re, delta);
      o.a[r][c].im = __shfl_down_sync(0xffffffffu, a.a[r][c].im, delta);
    }
  return o;
}

// Lane k of column col: its unit, the ordered product V_{kW} ... V_{kW+W-1}
// (walked left to right, cut at T/2) of the slot pairs V_s = U_{2s}
// U_{2s+1}; zero on a lane without a unit.  Then the ladder over the
// group: at level j every lane holds lad_j(k) = lad_{j-1}(k)
// lad_{j-1}(k + 2^(j-1)), the product of units [k, k + 2^j) wherever that
// span lies in the column (elsewhere values no valid product reads), and
// where bit j of m is set, the chunk lad_j at pos_j = m with bits 0..j
// cleared is folded into lane 0's acc from the left.  -> (tr re, tr im) of
// the column's loop on lane 0 of its group, 0 on the other lanes.  Every
// lane of the warp must call it, those past the last column (col < 0)
// too: they hold no unit.
template <int N, class D>
__device__ __forceinline__ void poly_lane(const float* __restrict__ u6,
                                          const float* __restrict__ u7,
                                          const D& d, const PolyLanes& pl,
                                          int col, int k, float& tr_re,
                                          float& tr_im) {
  Mat<N> v = {};
  if (col >= 0 && k < pl.m) {
    int sig, base;
    poly_column(col, d, sig, base);
    const float* first = sig ? u7 : u6;  // t = 2s has the column's parity
    const float* second = sig ? u6 : u7;
    int s = base + k * pl.w;
    const int end = min(s + pl.w, base + d.t2);
    v = mmul(load_mat<N>(first, s, d.v2), load_mat<N>(second, s, d.v2));
    for (++s; s < end; ++s)
      v = mmul(v, mmul(load_mat<N>(first, s, d.v2),
                       load_mat<N>(second, s, d.v2)));
  }
  Mat<N> acc;
  bool have = false;
#pragma unroll
  for (int j = 0; j < 6; ++j) {  // m <= 32: levels 0..5
    if ((1 << j) > pl.m) break;
    if (j > 0) v = mmul(v, shfl_down_mat(v, 1 << (j - 1)));
    if (pl.m & (1 << j)) {
      const int pos = (pl.m >> (j + 1)) << (j + 1);
      const Mat<N> term = pos ? shfl_down_mat(v, pos) : v;
      if (have)
        acc = mmul(term, acc);
      else
        acc = term;
      have = true;
    }
  }
  tr_re = tr_im = 0.f;
  if (col >= 0 && k == 0) {
    tr_re = acc.a[0][0].re;
    tr_im = acc.a[0][0].im;
#pragma unroll
    for (int r = 1; r < N; ++r) {
      tr_re = tr_re + acc.a[r][r].re;
      tr_im = tr_im + acc.a[r][r].im;
    }
  }
}

// one thread per (column, lane), the columns' groups in column order; chain
// blockIdx.y as plane_sums_kernel.  The block's two sums by block_sums.
template <int N, class D>
__global__ void polyakov_sums_kernel(const float* __restrict__ u6,
                                     const float* __restrict__ u7, D d,
                                     PolyLanes pl, long long chain_stride,
                                     double* __restrict__ partials) {
  const size_t off = (size_t)blockIdx.y * (size_t)chain_stride;
  const int g = blockIdx.x * blockDim.x + threadIdx.x;
  const int col = g >> pl.lg;
  float tr_re, tr_im;
  poly_lane<N>(u6 + off, u7 + off, d, pl, col < d.x * d.y * d.z ? col : -1,
               g & ((1 << pl.lg) - 1), tr_re, tr_im);
  const double v[2] = {(double)tr_re, (double)tr_im};
  block_sums(v, partials);
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
// chain: 1, 0); partials [n_chains, n_blocks, 6] with n_blocks =
// ceil(2 * sites per parity / kPlaneThreads), out [n_chains, 6]
template <class D>
int plane_sums(const Links& L, int n, const D& d, double* partials,
               double* out, cudaStream_t s, int n_chains = 1,
               long long chain_stride = 0) {
  if ((n != 2 && n != 3) || !chain_count_ok(n_chains))
    return (int)cudaErrorInvalidValue;
  const int block = kPlaneThreads;
  const int n_blocks = (2 * n_sites(d) + block - 1) / block;
  const size_t smem = block * sizeof(double);  // the finish kernel's
  const dim3 grid(n_blocks, n_chains);
  bool tiled = false;
  if constexpr (std::is_same_v<D, Dims>) tiled = tile_fits(d);
  cudaError_t err;
  if (tiled) {
    if constexpr (std::is_same_v<D, Dims>)
      err = n == 3 ? launch_plane_tile<3>(L, d, grid, chain_stride, partials, s)
                   : launch_plane_tile<2>(L, d, grid, chain_stride, partials,
                                          s);
  } else {
    if (n == 3)
      plane_sums_kernel<3><<<grid, block, 0, s>>>(L, d, chain_stride,
                                                  partials);
    else
      plane_sums_kernel<2><<<grid, block, 0, s>>>(L, d, chain_stride,
                                                  partials);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return (int)err;
  finish_sums_kernel<<<n_chains, block, smem, s>>>(partials, n_blocks, 6,
                                                   out);
  return (int)cudaGetLastError();
}

// partials [n_chains, n_blocks, 2] with n_blocks = ceil(columns * L /
// block), out [n_chains, 2]
template <class D>
int polyakov_sums(const float* u6, const float* u7, int n, const D& d,
                  int block, double* partials, double* out, cudaStream_t s,
                  int n_chains = 1, long long chain_stride = 0) {
  if (!pow2_block(block) || (n != 2 && n != 3) || !chain_count_ok(n_chains))
    return (int)cudaErrorInvalidValue;
  const PolyLanes pl = poly_lanes(d.t2);
  const long long threads = (long long)d.x * d.y * d.z << pl.lg;
  const int n_blocks = (int)((threads + block - 1) / block);
  const dim3 grid(n_blocks, n_chains);
  if (n == 3)
    polyakov_sums_kernel<3><<<grid, block, 0, s>>>(u6, u7, d, pl,
                                                   chain_stride, partials);
  else
    polyakov_sums_kernel<2><<<grid, block, 0, s>>>(u6, u7, d, pl,
                                                   chain_stride, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  finish_sums_kernel<<<n_chains, block, block * sizeof(double), s>>>(
      partials, n_blocks, 2, out);
  return (int)cudaGetLastError();
}

}  // namespace qg

// n: 2 or 3; partials: f64 [n_blocks * 6] with
// n_blocks = ceil(2 * V2 / 256) (kPlaneThreads); out: f64 [6]
extern "C" int qg_plane_sums(void* u0, void* u1, void* u2, void* u3, void* u4,
                             void* u5, void* u6, void* u7, int n, int X,
                             int Y, int Z, int T, void* partials, void* out,
                             void* stream) {
  const qg::Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3,
                        (float*)u4, (float*)u5, (float*)u6, (float*)u7}};
  return qg::plane_sums(L, n, qg::make_dims(X, Y, Z, T), (double*)partials,
                        (double*)out, (cudaStream_t)stream);
}

// K5a: qg_plane_sums over one shard's interior sites (u0..u7 its padded
// arrays, geometry as qg_stage_shard); n_blocks = ceil(2 * lx*ly*Z*T/2 /
// 256).  The caller sums the shards.
extern "C" int qg_plane_sums_local(void* u0, void* u1, void* u2, void* u3,
                                   void* u4, void* u5, void* u6, void* u7,
                                   int n, int lx, int ly, int Z, int T, int hx,
                                   int hy, int x0, int y0, int gy,
                                   void* partials, void* out, void* stream) {
  const qg::Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3,
                        (float*)u4, (float*)u5, (float*)u6, (float*)u7}};
  return qg::plane_sums(L, n,
                        qg::make_shard_dims(lx, ly, Z, T, hx, hy, x0, y0, gy),
                        (double*)partials, (double*)out, (cudaStream_t)stream);
}

// n: 2 or 3; partials: f64 [n_blocks * 2] with
// n_blocks = ceil(X*Y*Z * L / block) (L: poly_lanes(T / 2)); out: f64 [2] =
// (sum re tr, sum im tr)
extern "C" int qg_polyakov_sums(void* u6, void* u7, int n, int X, int Y,
                                int Z, int T, int block, void* partials,
                                void* out, void* stream) {
  return qg::polyakov_sums((const float*)u6, (const float*)u7, n,
                           qg::make_dims(X, Y, Z, T), block, (double*)partials,
                           (double*)out, (cudaStream_t)stream);
}

// K5b: qg_polyakov_sums over one shard's interior columns (u6, u7 its padded
// temporal arrays; T is never split, so no halo is read); n_blocks =
// ceil(lx*ly*Z * L / block).
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
                                    void* partials, void* out, void* stream) {
  const qg::Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3,
                        (float*)u4, (float*)u5, (float*)u6, (float*)u7}};
  return qg::plane_sums(L, n, qg::make_dims(X, Y, Z, T), (double*)partials,
                        (double*)out, (cudaStream_t)stream, n_chains,
                        chain_stride);
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

// K5ac: qg_plane_sums_local over n_chains chain-stacked padded arrays of one
// shard (u0..u7 [C, 2, n, 2, lx + 2 hx, ly + 2 hy, Z*T/2]; chain_stride the
// padded floats per chain); partials f64 [n_chains * n_blocks * 6], out f64
// [n_chains, 6]
extern "C" int qg_plane_sums_local_chains(
    void* u0, void* u1, void* u2, void* u3, void* u4, void* u5, void* u6,
    void* u7, long long chain_stride, int n_chains, int n, int lx, int ly,
    int Z, int T, int hx, int hy, int x0, int y0, int gy, void* partials,
    void* out, void* stream) {
  const qg::Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3,
                        (float*)u4, (float*)u5, (float*)u6, (float*)u7}};
  return qg::plane_sums(L, n,
                        qg::make_shard_dims(lx, ly, Z, T, hx, hy, x0, y0, gy),
                        (double*)partials, (double*)out, (cudaStream_t)stream,
                        n_chains, chain_stride);
}

// K5bc: qg_polyakov_sums_local over n_chains chain-stacked padded temporal
// arrays of one shard; partials f64 [n_chains * n_blocks * 2], out f64
// [n_chains, 2]
extern "C" int qg_polyakov_sums_local_chains(
    void* u6, void* u7, long long chain_stride, int n_chains, int n, int lx,
    int ly, int Z, int T, int hx, int hy, int x0, int y0, int gy, int block,
    void* partials, void* out, void* stream) {
  return qg::polyakov_sums(
      (const float*)u6, (const float*)u7, n,
      qg::make_shard_dims(lx, ly, Z, T, hx, hy, x0, y0, gy), block,
      (double*)partials, (double*)out, (cudaStream_t)stream, n_chains,
      chain_stride);
}
