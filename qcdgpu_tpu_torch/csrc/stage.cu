// K1 entry points: the threefry instantiations (every kind, N in {2, 3},
// tracked or not) and the dispatch of the PRNGCL stream instantiations,
// which live one family per source (stage_<family>.cu).  The kernel itself,
// its cost model and its design are in stage.cuh; the stream draws in
// streams.cuh.
#include "stage.cuh"

// n: 2 or 3; kind: qg::Kind; track: nonzero to add the stage's count to
// *count (u64 on the device; heat-bath or Metropolis only).
extern "C" int qg_stage(void* u0, void* u1, void* u2, void* u3, void* u4,
                        void* u5, void* u6, void* u7, int n, int kind,
                        int track, int mu, int parity, int X, int Y, int Z,
                        int T, unsigned int k0, unsigned int k1,
                        float two_beta_over_n, int k_trials, int n_hit,
                        float delta, void* count, void* stream) {
  using namespace qg;
  const Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3, (float*)u4,
                    (float*)u5, (float*)u6, (float*)u7}};
  const Dims d = make_dims(X, Y, Z, T);
  unsigned long long* cnt = (unsigned long long*)count;
  cudaStream_t s = (cudaStream_t)stream;
  if (track && (cnt == nullptr || kind == OVERRELAX))
    return (int)cudaErrorInvalidValue;
  const Threefry rng = {k0, k1};
  if (kind == OVERRELAX) {
    if (n == 3)
      return launch_stage<3, OVERRELAX, false>(L, mu, parity, d, rng,
                                               two_beta_over_n, k_trials,
                                               n_hit, delta, cnt, s);
    if (n == 2)
      return launch_stage<2, OVERRELAX, false>(L, mu, parity, d, rng,
                                               two_beta_over_n, k_trials,
                                               n_hit, delta, cnt, s);
    return (int)cudaErrorInvalidValue;
  }
  return launch_drawing(L, n, kind, track != 0, mu, parity, d, rng,
                        two_beta_over_n, k_trials, n_hit, delta, cnt, s);
}

// A stage drawing from PRNGCL streams.  family: index into
// ops/prng_streams.py FAMILIES (xor128, xor7, mrg32k3a, parkmiller, constant,
// ranlux, ranmar); words: the active parity's state [W, X, Y, Z*T/2] (word
// k of slot i at words[k * stride + i]); s0, ptr0: the lag generators'
// scalars (ranlux nb and pointer, ranmar carry * 2^24 and pointer); skip:
// ranlux's luxury skip length.  Heat-bath or Metropolis only.
extern "C" int qg_stage_stream(void* u0, void* u1, void* u2, void* u3,
                               void* u4, void* u5, void* u6, void* u7, int n,
                               int kind, int track, int mu, int parity, int X,
                               int Y, int Z, int T, int family, void* words,
                               int stride, unsigned int s0, int ptr0,
                               int skip, float two_beta_over_n, int k_trials,
                               int n_hit, float delta, void* count,
                               void* stream) {
  using namespace qg;
  const Links L = {{(float*)u0, (float*)u1, (float*)u2, (float*)u3, (float*)u4,
                    (float*)u5, (float*)u6, (float*)u7}};
  const Dims d = make_dims(X, Y, Z, T);
  unsigned long long* cnt = (unsigned long long*)count;
  cudaStream_t s = (cudaStream_t)stream;
  if ((track && cnt == nullptr) || kind == OVERRELAX || words == nullptr ||
      stride != d.v2 || skip < 0)
    return (int)cudaErrorInvalidValue;
#define QG_FAMILY(IDX, fam)                                                   \
  if (family == IDX)                                                          \
    return launch_stream_##fam(L, n, kind, track != 0, mu, parity, d, words,  \
                               stride, s0, ptr0, skip, two_beta_over_n,       \
                               k_trials, n_hit, delta, cnt, s);
  QG_FAMILY(0, xor128)
  QG_FAMILY(1, xor7)
  QG_FAMILY(2, mrg32k3a)
  QG_FAMILY(3, parkmiller)
  QG_FAMILY(4, constant)
  QG_FAMILY(5, ranlux)
  QG_FAMILY(6, ranmar)
#undef QG_FAMILY
  return (int)cudaErrorInvalidValue;
}
