// Per-step clearing kernels for Hopper (sm_90a): the paper's "naive custom
// CUDA" ablation.
//
// naive_chunk_step_kernel replaces the TPU kernel
// repro/kernels/naive_clearing.py::_chunk_step_kernel_body (launched by
// pl.pallas_call in naive_clearing_chunk, once per step from a host scan).
// naive_legacy_step_kernel replaces repro/kernels/naive_clearing.py::
// _step_kernel_body (pallas_call in the legacy one-shot naive_clearing).
//
// Both compute exactly one step of simulate_step per launch with the
// persistent kernels' device step and launch layout (kinetic_step.cuh: a
// team of W warps per market, four levels a thread in registers, integer
// bins in shared memory, shuffle reductions and raking scans; and, as for
// the persistent kernels, a market spread over a thread-block cluster of
// C = ctas_per_market CTAs whose bins are summed through distributed
// shared memory: the instances <true>, launched with cudaLaunchKernelEx and
// a cluster dimension of C), but nothing persists: each launch loads the market's books, scalars, params row (and
// in stats_only mode its six running stats) from device memory, recomputes
// every agent's (seed, gid) hash round and type, runs one step and writes
// everything back. That is the point of the ablation: the two designs
// differ in persistence alone, so every piece of state crossing device
// memory and every per-call computation redone each step is what giving up
// persistence costs, and a chunk of n steps costs n launches.
//
// The C entries loop the launches themselves on the caller's stream,
// ping-ponging between two state buffers, and check cudaGetLastError()
// after each launch. The loop is in C, not in Python, because the TPU
// ablation's host scan compiles into one XLA program whose dispatches never
// pass through the interpreter; a Python loop of ctypes calls would add host
// time that is not the cost of giving up persistence.
//
// What bounds them on this card: at the paper's shape (A=256, L=128) still
// operations, as for the persistent kernel, because the books (2·M·L
// floats in and out per step) stay in the 50 MB L2. With few agents and
// many levels (A=32, L=1024) the per-step book traffic outgrows L2 and
// device-memory bytes bind instead. Nothing in the design hides that: it
// is the cost the persistent kernels remove.

#include <type_traits>

#include "kinetic_step.cuh"
#include "open_fill.cuh"

// One body for both, as in kinetic_clearing.cu: the legacy contract lives in
// the ChunkArgs kc_naive_clearing fills, never in the kernel. CLUSTER
// spreads a market over a thread-block cluster.
template <bool CLUSTER>
__device__ __forceinline__ void step_body(const ChunkArgs& g, int s) {
  one_step_market<std::conditional_t<CLUSTER, ClusterBins, CtaBins>>(g, s);
}

template <bool CLUSTER>
__global__ void naive_chunk_step_kernel(ChunkArgs g, int s) {
  step_body<CLUSTER>(g, s);
}

template <bool CLUSTER>
__global__ void naive_legacy_step_kernel(ChunkArgs g, int s) {
  step_body<CLUSTER>(g, s);
}

// One market state in device memory: books [M, L], scalars [M, 1] and,
// in stats_only mode, the running stats [M, 6] (else null).
struct StateBufs {
  const float* bid;
  const float* ask;
  const float* last;
  const float* pmid;
  const float* stats;
};

struct OutBufs {
  float* bid;
  float* ask;
  float* last;
  float* pmid;
  float* stats;
};

// The launch-s destination of an n-launch ping-pong that ends in `out`.
static inline OutBufs pick(int s, int n, const OutBufs& out,
                           const OutBufs& scratch) {
  return ((n - 1 - s) % 2 == 0) ? out : scratch;
}

static inline StateBufs as_input(const OutBufs& o) {
  return StateBufs{o.bid, o.ask, o.last, o.pmid, o.stats};
}

// n launches of `kernel`, steps g.step0 .. g.step0 + n - 1, from `src` into
// `out` through `tmp`; external orders go to the first launch only. At
// C = g.ctas_per_market > 1 each launch is M clusters of C CTAs; a cluster
// the card cannot place fails the launch, and nothing runs in its stead.
template <class K>
static int launch_steps(K kernel, ChunkArgs g, StateBufs src,
                        const OutBufs& out, const OutBufs& tmp, int n,
                        void* stream) {
  const int C = g.ctas_per_market;
  size_t smem;
  int err = check_shape(g.L, g.A, g.warps_per_market, g.markets_per_cta,
                        AGENTS_FRESH, C, &smem);
  if (err == 0) err = allow_cluster(kernel, smem, C);
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(&attr, grid_of(g), cta_of(g), smem, C, stream);
  const float* ext_buy = g.ext_buy;
  const float* ext_ask = g.ext_ask;
  for (int s = 0; s < n; ++s) {
    const OutBufs dst = pick(s, n, out, tmp);
    g.bid = src.bid; g.ask = src.ask; g.last = src.last; g.pmid = src.pmid;
    g.stats_in = src.stats;
    g.bid_out = dst.bid; g.ask_out = dst.ask; g.last_out = dst.last;
    g.pmid_out = dst.pmid; g.stats_out = dst.stats;
    g.ext_buy = s == 0 ? ext_buy : nullptr;
    g.ext_ask = s == 0 ? ext_ask : nullptr;
    if (C > 1) {
      const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, g, s);
      if (e != cudaSuccess) return (int)e;
    } else {
      kernel<<<grid_of(g), cta_of(g), smem, (cudaStream_t)stream>>>(g, s);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = as_input(dst);
  }
  return 0;
}

// launch_steps of the chunk (legacy = false) or legacy step kernel, the
// cluster instance at g.ctas_per_market > 1.
static int launch_kernel(bool legacy, const ChunkArgs& g,
                         const StateBufs& src, const OutBufs& out,
                         const OutBufs& tmp, int n, void* stream) {
  if (g.ctas_per_market > 1) {
    return legacy ? launch_steps(naive_legacy_step_kernel<true>, g, src, out,
                                 tmp, n, stream)
                  : launch_steps(naive_chunk_step_kernel<true>, g, src, out,
                                 tmp, n, stream);
  }
  return legacy ? launch_steps(naive_legacy_step_kernel<false>, g, src, out,
                               tmp, n, stream)
                : launch_steps(naive_chunk_step_kernel<false>, g, src, out,
                               tmp, n, stream);
}

extern "C" {

// Launches naive_chunk_step_kernel n_valid times on `stream`, steps step0
// .. step0 + n_valid - 1; the final state lands in the *_out buffers and
// the *_tmp buffers are scratch of the same shapes. External orders go to
// the first launch only. Returns the first non-zero cudaGetLastError() (or
// cudaErrorInvalidValue for a launch shape check_shape refuses).
// stats_in/stats_out/stats_tmp are non-null exactly in stats_only mode,
// where the three paths are null. n_valid must be >= 1.
int kc_naive_clearing_chunk(
    const int* market_ids, const float* bid, const float* ask,
    const float* last, const float* pmid, const float* ext_buy,
    const float* ext_ask, const float* peer_mid, const float* fparams,
    const int* iparams, const float* stats_in, float* bid_out,
    float* ask_out, float* last_out, float* pmid_out, float* stats_out,
    float* bid_tmp, float* ask_tmp, float* last_tmp, float* pmid_tmp,
    float* stats_tmp, float* price_path, float* volume_path,
    float* mid_path, int M, int A, int L, int chunk, int step0, int n_valid,
    int warps_per_market, int markets_per_cta, int ctas_per_market,
    uint32_t seed, void* stream) {
  const ChunkArgs g{market_ids, bid, ask, last, pmid, ext_buy, ext_ask,
                    peer_mid, fparams, iparams, 1, stats_in, nullptr,
                    nullptr, nullptr, nullptr, price_path, volume_path,
                    mid_path, nullptr, M, A, L, chunk, step0, n_valid, seed,
                    warps_per_market, markets_per_cta, ctas_per_market};
  const OutBufs out{bid_out, ask_out, last_out, pmid_out, stats_out};
  const OutBufs tmp{bid_tmp, ask_tmp, last_tmp, pmid_tmp, stats_tmp};
  const int err = launch_kernel(false, g,
                                StateBufs{bid, ask, last, pmid, stats_in},
                                out, tmp, n_valid, stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// Launches naive_legacy_step_kernel S times (steps 0 .. S-1, paths
// [M, S]) on `stream`; the final state lands in the *_out buffers.
// fparams/iparams hold one row. S must be >= 1.
int kc_naive_clearing(
    const float* bid, const float* ask, const float* last, const float* pmid,
    const float* fparams, const int* iparams, float* bid_out, float* ask_out,
    float* last_out, float* pmid_out, float* bid_tmp, float* ask_tmp,
    float* last_tmp, float* pmid_tmp, float* price_path, float* volume_path,
    int M, int A, int L, int S, int warps_per_market, int markets_per_cta,
    int ctas_per_market, uint32_t seed, void* stream) {
  const ChunkArgs g{nullptr, bid, ask, last, pmid, nullptr, nullptr,
                    nullptr, fparams, iparams, 0, nullptr, nullptr, nullptr,
                    nullptr, nullptr, price_path, volume_path, nullptr,
                    nullptr, M, A, L, S, 0, S, seed, warps_per_market,
                    markets_per_cta, ctas_per_market};
  const OutBufs out{bid_out, ask_out, last_out, pmid_out, nullptr};
  const OutBufs tmp{bid_tmp, ask_tmp, last_tmp, pmid_tmp, nullptr};
  const int err = launch_kernel(true, g,
                                StateBufs{bid, ask, last, pmid, nullptr},
                                out, tmp, S, stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// Resident CTAs per SM of the chunk step kernel (legacy = 0) or the legacy
// step kernel (legacy = 1) at a launch shape of one CTA a market, or at a
// cluster shape (ctas_per_market > 1) the clusters the card holds at once,
// into *ctas; returns the CUDA error of the query, else cudaGetLastError().
int kc_occupancy(int legacy, int A, int L, int warps_per_market,
                 int markets_per_cta, int ctas_per_market, int* ctas) {
  size_t smem;
  const int bad = check_shape(L, A, warps_per_market, markets_per_cta,
                              AGENTS_FRESH, ctas_per_market, &smem);
  if (bad != 0) return bad;
  const int threads = 32 * warps_per_market * markets_per_cta;
  const int C = ctas_per_market;
  int err;
  if (C > 1) {
    err = legacy ? resident_clusters(naive_legacy_step_kernel<true>, threads,
                                     smem, C, ctas)
                 : resident_clusters(naive_chunk_step_kernel<true>, threads,
                                     smem, C, ctas);
  } else {
    err = legacy ? resident_ctas(naive_legacy_step_kernel<false>, threads,
                                 smem, ctas)
                 : resident_ctas(naive_chunk_step_kernel<false>, threads,
                                 smem, ctas);
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

}  // extern "C"
