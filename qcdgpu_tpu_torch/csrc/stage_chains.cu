// K1c entry point: the checkerboard stage batched over C independent
// chains (a beta scan), for threefry (every kind, N in {2, 3}, tracked or
// not: 10 instantiations) and Philox (rng_mode "hw": heat-bath and
// Metropolis, 8).  The kernel, stage_chains_kernel, its dispatch
// (stage_chains) and its note on what it replaces are in stage.cuh; each
// site runs the single-chain stage_site, so chain c is K1 on its own
// arrays, bit for bit.
//
// What bounds it is what bounds K1 (stage.cuh), times C: the chains are
// independent, so C x K1's blocks run in one launch (at 24^3 x 6, 324
// blocks of 128 threads per chain, under one wave of K1 on 132 SMs; with
// 11 chains 3564 blocks, 6.75 waves).  One launch per stage whatever C
// is: a sweep of HB + n_or OR passes is 8 (1 + n_or) launches.
//
// Its own source, so that nvcc builds its 18 instantiations in parallel
// with the others.
#include "stage.cuh"

// u0..u7: the chain-stacked arrays us[2*mu + p], [C, 2, N, 2, X, Y,
// Z*T/2]; chain_stride: floats per chain of one array (4 N X Y Z T / 2);
// n_chains: C (at most 65535); philox: nonzero for rng_mode "hw"
// (heat-bath or Metropolis); betas: f32 [C]; two_over_n: f32(2 / n);
// base_keys: u32 [C, 2]; sweep_idx, stage_id: the stage key's counter;
// count: u64 [C] (tracked, heat-bath or Metropolis only).  The other
// arguments are qg_stage's.
extern "C" int qg_stage_chains(void* u0, void* u1, void* u2, void* u3,
                               void* u4, void* u5, void* u6, void* u7,
                               long long chain_stride, int n_chains, int n,
                               int kind, int track, int philox, int mu,
                               int parity, int X, int Y, int Z, int T,
                               void* betas, float two_over_n, void* base_keys,
                               unsigned int sweep_idx, unsigned int stage_id,
                               int k_trials, int n_hit, float delta,
                               void* count, void* stream) {
  using namespace qg;
  const Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3,
                    (float*)u4, (float*)u5, (float*)u6, (float*)u7}};
  const Chains ch = {chain_stride, n_chains, (const float*)betas, two_over_n,
                     (const uint32_t*)base_keys, sweep_idx, stage_id};
  return stage_chains(L, ch, n, kind, track, philox, mu, parity,
                      make_dims(X, Y, Z, T), k_trials, n_hit, delta,
                      (unsigned long long*)count, (cudaStream_t)stream);
}
