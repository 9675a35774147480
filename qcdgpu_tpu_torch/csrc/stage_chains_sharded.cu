// K1ac entry point: K1c on one halo-padded shard of an X/Y mesh, over a
// block of chains (a beta scan on a mesh: the reference's chain x lattice
// tier, qcdgpu_tpu/models/ensemble.py:96-131, vmaps the sharded stage body
// of ops/pallas/sharded.py, and with it the local_x / local_y form of
// update.py:_stage_kernel, over each device's chain block).  The same 18
// instantiations as K1c (stage_chains.cu) with D = ShardDims: the kernel,
// stage_chains_kernel, and its dispatch are stage.cuh's, so chain c is K1a
// on its own padded arrays, bit for bit, and keys its draws by the global
// site as K1a does.
//
// What bounds it is what bounds K1a, times the block's chains: at 24^3 x 6
// on (2,2,1,1) a shard has 10,368 sites a parity, 81 blocks of 128 threads
// a chain, under one wave on 132 SMs alone; 11 chains make 891 blocks.
// One launch per shard per stage whatever the block's chain count is.
//
// Its own source, so that nvcc builds its 18 instantiations in parallel
// with the others.
#include "stage.cuh"

// u0..u7: the shard's chain-stacked padded arrays us[2*mu + p], [C, 2, N,
// 2, lx + 2 hx, ly + 2 hy, Z*T/2]; chain_stride: floats per chain of one
// padded array; the shard geometry as qg_stage_shard's (lx, ly, Z, T, hx,
// hy, x0, y0, global Y); the other arguments are qg_stage_chains'.
extern "C" int qg_stage_chains_sharded(
    void* u0, void* u1, void* u2, void* u3, void* u4, void* u5, void* u6,
    void* u7, long long chain_stride, int n_chains, int n, int kind,
    int track, int philox, int mu, int parity, int lx, int ly, int Z, int T,
    int hx, int hy, int x0, int y0, int gy, void* betas, float two_over_n,
    void* base_keys, unsigned int sweep_idx, unsigned int stage_id,
    int k_trials, int n_hit, float delta, void* count, void* stream) {
  using namespace qg;
  const Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3,
                    (float*)u4, (float*)u5, (float*)u6, (float*)u7}};
  const Chains ch = {chain_stride, n_chains, (const float*)betas, two_over_n,
                     (const uint32_t*)base_keys, sweep_idx, stage_id};
  return stage_chains(L, ch, n, kind, track, philox, mu, parity,
                      make_shard_dims(lx, ly, Z, T, hx, hy, x0, y0, gy),
                      k_trials, n_hit, delta, (unsigned long long*)count,
                      (cudaStream_t)stream);
}
