// K1 entry points: the threefry instantiations (every kind, N in {2, 3},
// tracked or not) and the dispatch of the PRNGCL stream instantiations,
// which live one family per source (stage_<family>.cu), each over the whole
// lattice (qg_stage, qg_stage_stream) and on a halo-padded shard of an X/Y
// mesh (K1a: qg_stage_shard, qg_stage_stream_shard).  The kernel itself,
// its cost model and its design are in stage.cuh; the stream draws in
// streams.cuh.
#include "stage.cuh"

namespace qg {

template <class D>
int stage_threefry(const Links& L, int n, int kind, int track, int mu,
                   int parity, const D& d, unsigned int k0, unsigned int k1,
                   float tbn, int k_trials, int n_hit, float delta,
                   unsigned long long* cnt, cudaStream_t s) {
  if (track && (cnt == nullptr || kind == OVERRELAX))
    return (int)cudaErrorInvalidValue;
  const Threefry rng = {k0, k1};
  if (kind == OVERRELAX) {
    if (n == 3)
      return launch_stage<3, OVERRELAX, false>(L, mu, parity, d, rng, tbn,
                                               k_trials, n_hit, delta, cnt, s);
    if (n == 2)
      return launch_stage<2, OVERRELAX, false>(L, mu, parity, d, rng, tbn,
                                               k_trials, n_hit, delta, cnt, s);
    return (int)cudaErrorInvalidValue;
  }
  return launch_drawing(L, n, kind, track != 0, mu, parity, d, rng, tbn,
                        k_trials, n_hit, delta, cnt, s);
}

template <class D>
int stage_stream(const Links& L, int n, int kind, int track, int mu,
                 int parity, const D& d, int family, void* words, int stride,
                 unsigned int s0, int ptr0, int skip, float tbn, int k_trials,
                 int n_hit, float delta, unsigned long long* cnt,
                 cudaStream_t s) {
  if ((track && cnt == nullptr) || kind == OVERRELAX || words == nullptr ||
      stride != n_sites(d) || skip < 0)
    return (int)cudaErrorInvalidValue;
#define QG_FAMILY(IDX, fam)                                                   \
  if (family == IDX)                                                          \
    return launch_stream_##fam(L, n, kind, track != 0, mu, parity, d, words,  \
                               stride, s0, ptr0, skip, tbn, k_trials, n_hit,  \
                               delta, cnt, s);
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

inline Links make_links(void* u0, void* u1, void* u2, void* u3, void* u4,
                        void* u5, void* u6, void* u7) {
  return {{(float*)u0, (float*)u1, (float*)u2, (float*)u3, (float*)u4,
           (float*)u5, (float*)u6, (float*)u7}};
}

}  // namespace qg

// n: 2 or 3; kind: qg::Kind; track: nonzero to add the stage's count to
// *count (u64 on the device; heat-bath or Metropolis only).
extern "C" int qg_stage(void* u0, void* u1, void* u2, void* u3, void* u4,
                        void* u5, void* u6, void* u7, int n, int kind,
                        int track, int mu, int parity, int X, int Y, int Z,
                        int T, unsigned int k0, unsigned int k1,
                        float two_beta_over_n, int k_trials, int n_hit,
                        float delta, void* count, void* stream) {
  using namespace qg;
  return stage_threefry(make_links(u0, u1, u2, u3, u4, u5, u6, u7), n, kind,
                        track, mu, parity, make_dims(X, Y, Z, T), k0, k1,
                        two_beta_over_n, k_trials, n_hit, delta,
                        (unsigned long long*)count, (cudaStream_t)stream);
}

// K1a: qg_stage on one shard (u0..u7 its padded arrays): interior extents
// lx, ly, halo flags hx, hy, global offsets x0, y0 and global Y extent gy
// (qg::ShardDims).
extern "C" int qg_stage_shard(void* u0, void* u1, void* u2, void* u3,
                              void* u4, void* u5, void* u6, void* u7, int n,
                              int kind, int track, int mu, int parity, int lx,
                              int ly, int Z, int T, int hx, int hy, int x0,
                              int y0, int gy, unsigned int k0,
                              unsigned int k1, float two_beta_over_n,
                              int k_trials, int n_hit, float delta,
                              void* count, void* stream) {
  using namespace qg;
  return stage_threefry(make_links(u0, u1, u2, u3, u4, u5, u6, u7), n, kind,
                        track, mu, parity,
                        make_shard_dims(lx, ly, Z, T, hx, hy, x0, y0, gy), k0,
                        k1, two_beta_over_n, k_trials, n_hit, delta,
                        (unsigned long long*)count, (cudaStream_t)stream);
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
  return stage_stream(make_links(u0, u1, u2, u3, u4, u5, u6, u7), n, kind,
                      track, mu, parity, make_dims(X, Y, Z, T), family, words,
                      stride, s0, ptr0, skip, two_beta_over_n, k_trials,
                      n_hit, delta, (unsigned long long*)count,
                      (cudaStream_t)stream);
}

// K1a with streams: qg_stage_stream on one shard; words are the shard's
// unpadded interior words [W, lx, ly, Z*T/2] (stride lx*ly*Z*T/2).
extern "C" int qg_stage_stream_shard(
    void* u0, void* u1, void* u2, void* u3, void* u4, void* u5, void* u6,
    void* u7, int n, int kind, int track, int mu, int parity, int lx, int ly,
    int Z, int T, int hx, int hy, int x0, int y0, int gy, int family,
    void* words, int stride, unsigned int s0, int ptr0, int skip,
    float two_beta_over_n, int k_trials, int n_hit, float delta, void* count,
    void* stream) {
  using namespace qg;
  return stage_stream(make_links(u0, u1, u2, u3, u4, u5, u6, u7), n, kind,
                      track, mu, parity,
                      make_shard_dims(lx, ly, Z, T, hx, hy, x0, y0, gy),
                      family, words, stride, s0, ptr0, skip, two_beta_over_n,
                      k_trials, n_hit, delta, (unsigned long long*)count,
                      (cudaStream_t)stream);
}
