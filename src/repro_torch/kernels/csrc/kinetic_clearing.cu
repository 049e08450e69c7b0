// Persistent clearing kernels for Hopper (sm_90a).
//
// kinetic_chunk_kernel replaces the TPU kernel
// repro/kernels/kinetic_clearing.py::_chunk_kernel_body (launched by
// pl.pallas_call in kinetic_clearing_chunk). It runs up to `chunk` steps of
// simulate_step for every market while the market's books stay on chip:
// the paper's own CUDA design, which the Pallas kernel adapted for the TPU.
//
// kinetic_legacy_kernel replaces repro/kernels/kinetic_clearing.py::
// _kernel_body (pallas_call in the legacy one-shot kinetic_clearing): the
// same persistent loop over all S steps of a scalar MarketConfig, with the
// market id equal to the row, one params row read by every team, no
// external orders, no stats and no mid path. Its arbitrageurs see their own
// market's previous mid at every step (simulate_step with peer_mid=None),
// not a column frozen at entry.
//
// Layout (kinetic_step.cuh): a team of W = max(1, L/128) warps per market
// (8 past the registers mode where four one-warp teams do not fit a CTA),
// four levels per thread, the books in registers for all the steps and only
// the incoming bins in shared memory, so the books touch device memory only
// at entry and exit. Each agent's step-invariant hash round and type are
// computed once per call: in registers while a thread has at most 8 agents
// (AGENTS_REGISTERS), else in the CTA's shared memory (AGENTS_SHARED);
// where the keys and type bytes do not fit a CTA's shared memory they are
// recomputed at every step (AGENTS_FRESH), as the per-step kernels do, and
// only the books and bins stay on chip. In any of the three modes a market
// may spread its agents over a thread-block cluster of C = ctas_per_market
// CTAs on neighbouring SMs (kinetic_step.cuh: ClusterBins), each CTA holding
// its own agents' keys and types: the instances <AGENTS, true>, launched
// with cudaLaunchKernelEx and a cluster dimension of C. C = 1 is a
// CLUSTER = false instance, launched as before.
//
// What bounds them on this card: operations, not bytes. Per step a market
// moves nothing through device memory, while every agent draws the
// counter-hash uniforms its archetype reads (a lowbias32 round for the step
// and one per channel, once the (seed, gid) round is hoisted) and evaluates
// its archetype: mostly 32-bit integer work, which Hopper issues at half
// the FP32 rate, plus conversions at an eighth of it
// (kinetic_clearing.py::op_count). The design spends the issue slots on
// that work alone: no block barriers at L <= 128, shuffle reductions and
// raking scans over four levels a thread, integer bins, and path writes 32
// steps at a time.

#include <type_traits>

#include "kinetic_step.cuh"

// The two kernels share one body on purpose: everything that makes the
// legacy contract (no market ids, one params row at params_stride 0, a null
// peer column, no external orders, stats or mid path) is carried by the
// ChunkArgs its C entry fills, never by the kernel. They stay two kernels
// so each TPU kernel has its own name in the launch counts and ptxas report;
// a change to one body is a change to both. AGENTS is an AgentMode;
// CLUSTER spreads a market over a thread-block cluster.
template <int AGENTS, bool CLUSTER>
__device__ __forceinline__ void persistent_body(const ChunkArgs& g) {
  using Bins = std::conditional_t<CLUSTER, ClusterBins, CtaBins>;
  if constexpr (AGENTS == AGENTS_REGISTERS) {
    persistent_market<RegAgents, Bins>(g);
  } else if constexpr (AGENTS == AGENTS_SHARED) {
    persistent_market<SmemAgents, Bins>(g);
  } else {
    persistent_market<FreshAgents, Bins>(g);
  }
}

template <int AGENTS, bool CLUSTER = false>
__global__ void kinetic_chunk_kernel(ChunkArgs g) {
  persistent_body<AGENTS, CLUSTER>(g);
}

template <int AGENTS, bool CLUSTER = false>
__global__ void kinetic_legacy_kernel(ChunkArgs g) {
  persistent_body<AGENTS, CLUSTER>(g);
}

template <class K>
static int launch(K kernel, const ChunkArgs& g, size_t smem, void* stream) {
  const int err = allow_smem(kernel, smem);
  if (err != 0) return err;
  kernel<<<grid_of(g), cta_of(g), smem, (cudaStream_t)stream>>>(g);
  return (int)cudaGetLastError();
}

// M clusters of g.ctas_per_market CTAs. A cluster the card cannot place
// fails the launch (its error is returned); nothing runs in its stead.
template <class K>
static int launch_cluster(K kernel, const ChunkArgs& g, size_t smem,
                          void* stream) {
  const int err = allow_cluster(kernel, smem, g.ctas_per_market);
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      &attr, grid_of(g), cta_of(g), smem, g.ctas_per_market, stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, g);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

template <int AGENTS>
static int launch_mode(bool legacy, const ChunkArgs& g, size_t smem,
                       void* stream) {
  if (g.ctas_per_market > 1) {
    return legacy ? launch_cluster(kinetic_legacy_kernel<AGENTS, true>, g,
                                   smem, stream)
                  : launch_cluster(kinetic_chunk_kernel<AGENTS, true>, g,
                                   smem, stream);
  }
  return legacy ? launch(kinetic_legacy_kernel<AGENTS>, g, smem, stream)
                : launch(kinetic_chunk_kernel<AGENTS>, g, smem, stream);
}

static int launch_persistent(bool legacy, const ChunkArgs& g, int agents,
                             void* stream) {
  size_t smem;
  const int bad = check_shape(g.L, g.A, g.warps_per_market,
                              g.markets_per_cta, agents, g.ctas_per_market,
                              &smem);
  if (bad != 0) return bad;
  switch (agents) {
    case AGENTS_REGISTERS:
      return launch_mode<AGENTS_REGISTERS>(legacy, g, smem, stream);
    case AGENTS_SHARED:
      return launch_mode<AGENTS_SHARED>(legacy, g, smem, stream);
    default:
      return launch_mode<AGENTS_FRESH>(legacy, g, smem, stream);
  }
}

// What the card holds of an AGENTS instance: clusters of C > 1 CTAs, else
// CTAs per SM.
template <int AGENTS>
static int occupancy_mode(bool legacy, int threads, size_t smem, int C,
                          int* ctas) {
  if (C > 1) {
    return legacy ? resident_clusters(kinetic_legacy_kernel<AGENTS, true>,
                                      threads, smem, C, ctas)
                  : resident_clusters(kinetic_chunk_kernel<AGENTS, true>,
                                      threads, smem, C, ctas);
  }
  return legacy ? resident_ctas(kinetic_legacy_kernel<AGENTS>, threads, smem,
                                ctas)
                : resident_ctas(kinetic_chunk_kernel<AGENTS>, threads, smem,
                                ctas);
}

extern "C" {

// Launches the chunk kernel on `stream` and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a launch shape check_shape refuses). ext_buy,
// ext_ask may be null (no external orders). stats_in/stats_out ([M, 6])
// are non-null exactly in stats_only mode, where the three paths are null.
int kc_kinetic_clearing_chunk(
    const int* market_ids, const float* bid, const float* ask,
    const float* last, const float* pmid, const float* ext_buy,
    const float* ext_ask, const float* peer_mid, const float* fparams,
    const int* iparams, const float* stats_in, float* bid_out,
    float* ask_out, float* last_out, float* pmid_out, float* price_path,
    float* volume_path, float* mid_path, float* stats_out, int M, int A,
    int L, int chunk, int step0, int n_valid, int warps_per_market,
    int markets_per_cta, int agents, int ctas_per_market, uint32_t seed,
    void* stream) {
  const ChunkArgs g{market_ids, bid, ask, last, pmid, ext_buy, ext_ask,
                    peer_mid, fparams, iparams, 1, stats_in, bid_out,
                    ask_out, last_out, pmid_out, price_path, volume_path,
                    mid_path, stats_out, M, A, L, chunk, step0, n_valid,
                    seed, warps_per_market, markets_per_cta,
                    ctas_per_market};
  const int err = launch_persistent(false, g, agents, stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// Launches the legacy one-shot kernel (S steps, paths [M, S]) on `stream`
// and returns cudaGetLastError(). fparams/iparams hold one row.
int kc_kinetic_clearing(
    const float* bid, const float* ask, const float* last, const float* pmid,
    const float* fparams, const int* iparams, float* bid_out, float* ask_out,
    float* last_out, float* pmid_out, float* price_path, float* volume_path,
    int M, int A, int L, int S, int warps_per_market, int markets_per_cta,
    int agents, int ctas_per_market, uint32_t seed, void* stream) {
  const ChunkArgs g{nullptr, bid, ask, last, pmid, nullptr, nullptr,
                    nullptr, fparams, iparams, 0, nullptr, bid_out, ask_out,
                    last_out, pmid_out, price_path, volume_path, nullptr,
                    nullptr, M, A, L, S, 0, S, seed, warps_per_market,
                    markets_per_cta, ctas_per_market};
  const int err = launch_persistent(true, g, agents, stream);
  return err != 0 ? err : (int)cudaGetLastError();
}

// Resident CTAs per SM of the chunk kernel (legacy = 0) or the legacy
// kernel (legacy = 1) at a launch shape of one CTA a market, or at a
// cluster shape (ctas_per_market > 1) the clusters the card holds at once,
// into *ctas; returns the CUDA error of the query, else cudaGetLastError().
int kc_occupancy(int legacy, int A, int L, int warps_per_market,
                 int markets_per_cta, int agents, int ctas_per_market,
                 int* ctas) {
  size_t smem;
  const int bad = check_shape(L, A, warps_per_market, markets_per_cta,
                              agents, ctas_per_market, &smem);
  if (bad != 0) return bad;
  const int threads = 32 * warps_per_market * markets_per_cta;
  const int C = ctas_per_market;
  int err;
  switch (agents) {
    case AGENTS_REGISTERS:
      err = occupancy_mode<AGENTS_REGISTERS>(legacy, threads, smem, C, ctas);
      break;
    case AGENTS_SHARED:
      err = occupancy_mode<AGENTS_SHARED>(legacy, threads, smem, C, ctas);
      break;
    default:
      err = occupancy_mode<AGENTS_FRESH>(legacy, threads, smem, C, ctas);
  }
  return err != 0 ? err : (int)cudaGetLastError();
}

}  // extern "C"
