// K1 drawing from Philox-4x32-10 (rng_mode "hw"): heat-bath and Metropolis,
// SU(3) and SU(2), tracked or not, over the whole lattice (qg_stage_philox)
// and on a halo-padded shard of an X/Y mesh (K1a: qg_stage_philox_shard).
//
// Replaces the hardware-PRNG branch of the TPU kernel (K9:
// qcdgpu_tpu/ops/pallas/update.py:543-554 seeds pltpu.prng_seed per (stage
// key, x, y) slab; core.py:161-175 hw_uniforms draws its bits), which no
// other machine can reproduce.  Philox is counter-based, so the chain stays
// a function of (seed, sweep index) and a resumed or sharded run draws what
// the uninterrupted, unsharded one draws.  Overrelaxation draws nothing: an
// hw run uses the threefry build's overrelaxation instantiations
// (stage.cu).  The kernel is stage.cuh's, with R = Philox.
//
// Its own source, so that nvcc builds its 16 instantiations in parallel
// with the others.
#include "stage.cuh"

namespace qg {

template <class D>
int stage_philox(const Links& L, int n, int kind, int track, int mu,
                 int parity, const D& d, unsigned int k0, unsigned int k1,
                 float tbn, int k_trials, int n_hit, float delta,
                 unsigned long long* cnt, cudaStream_t s) {
  if ((track && cnt == nullptr) || kind == OVERRELAX)
    return (int)cudaErrorInvalidValue;
  const Philox rng = {k0, k1};
  return launch_drawing(L, n, kind, track != 0, mu, parity, d, rng, tbn,
                        k_trials, n_hit, delta, cnt, s);
}

}  // namespace qg

// qg_stage's arguments; kind: heat-bath or Metropolis.
extern "C" int qg_stage_philox(void* u0, void* u1, void* u2, void* u3,
                               void* u4, void* u5, void* u6, void* u7, int n,
                               int kind, int track, int mu, int parity, int X,
                               int Y, int Z, int T, unsigned int k0,
                               unsigned int k1, float two_beta_over_n,
                               int k_trials, int n_hit, float delta,
                               void* count, void* stream) {
  using namespace qg;
  const Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3,
                    (float*)u4, (float*)u5, (float*)u6, (float*)u7}};
  return stage_philox(L, n, kind, track, mu, parity, make_dims(X, Y, Z, T),
                      k0, k1, two_beta_over_n, k_trials, n_hit, delta,
                      (unsigned long long*)count, (cudaStream_t)stream);
}

// K1a: qg_stage_shard's arguments (the shard geometry of qg::ShardDims).
extern "C" int qg_stage_philox_shard(
    void* u0, void* u1, void* u2, void* u3, void* u4, void* u5, void* u6,
    void* u7, int n, int kind, int track, int mu, int parity, int lx, int ly,
    int Z, int T, int hx, int hy, int x0, int y0, int gy, unsigned int k0,
    unsigned int k1, float two_beta_over_n, int k_trials, int n_hit,
    float delta, void* count, void* stream) {
  using namespace qg;
  const Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3,
                    (float*)u4, (float*)u5, (float*)u6, (float*)u7}};
  return stage_philox(L, n, kind, track, mu, parity,
                      make_shard_dims(lx, ly, Z, T, hx, hy, x0, y0, gy), k0,
                      k1, two_beta_over_n, k_trials, n_hit, delta,
                      (unsigned long long*)count, (cudaStream_t)stream);
}
