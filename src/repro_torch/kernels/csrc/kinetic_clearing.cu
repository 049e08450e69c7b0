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
// market id equal to the row, one params row read by every block, no
// external orders, no stats and no mid path. Its arbitrageurs see their own
// market's previous mid at every step (simulate_step with peer_mid=None),
// not a column frozen at entry.
//
// Layout (kinetic_step.cuh): one block per market (grid M), blockDim =
// max(32, L). The bid/ask books, the incoming buy/sell bins and the two scan
// buffers sit in shared memory (6·L floats) for all the steps, so the books
// touch device memory only at entry and exit.
//
// What bounds them on this card: operations, not bytes. Per step a market
// moves nothing through device memory, while every agent draws five
// counter-hash uniforms (seven lowbias32 rounds, two shared by the five
// channels) and evaluates its archetype: about 10^2 integer/f32 operations
// per agent-step against a few bytes per market-step of output. The design
// keeps all step state in shared memory and registers, bins with
// shared-memory atomicAdd, and scans with log-depth block scans; the hash
// prefix over (seed, gid, step) is computed once per agent-step and shared by
// the five channels.

#include "kinetic_step.cuh"

__global__ void kinetic_chunk_kernel(
    const int* __restrict__ market_ids, const float* __restrict__ bid_in,
    const float* __restrict__ ask_in, const float* __restrict__ last_in,
    const float* __restrict__ pmid_in, const float* __restrict__ ext_buy,
    const float* __restrict__ ext_ask, const float* __restrict__ peer_mid,
    const float* __restrict__ fparams, const int* __restrict__ iparams,
    const float* __restrict__ stats_in, float* __restrict__ bid_out,
    float* __restrict__ ask_out, float* __restrict__ last_out,
    float* __restrict__ pmid_out, float* __restrict__ price_path,
    float* __restrict__ volume_path, float* __restrict__ mid_path,
    float* __restrict__ stats_out, int A, int L, int chunk, int step0,
    int n_valid, uint32_t seed) {
  extern __shared__ float smem[];
  __shared__ int red_i[64];
  __shared__ float red_f[64];
  const BookSmem b = book_smem(smem, L, red_i, red_f);

  const int m = blockIdx.x;
  const size_t row = (size_t)m * L;
  load_books(b, bid_in, ask_in, row, L);
  float last = last_in[m];
  float pmid = pmid_in[m];
  const float peer = peer_mid[m];  // frozen for the whole chunk
  const uint32_t market = (uint32_t)market_ids[m];
  const MarketRow p = load_row(fparams + (size_t)m * NUM_FLOAT_COLS,
                               iparams + (size_t)m * NUM_INT_COLS);
  float st[NUM_STATS];
  if (stats_in != nullptr) {
    for (int k = 0; k < NUM_STATS; ++k) st[k] = stats_in[(size_t)m * NUM_STATS + k];
  }
  const float* eb0 = ext_buy != nullptr ? ext_buy + row : nullptr;
  const float* ea0 = ext_ask != nullptr ? ext_ask + row : nullptr;
  const uint32_t seed_g = seed ^ SEED_GOLDEN;
  __syncthreads();

  for (int s = 0; s < n_valid; ++s) {
    float mid, volume;
    market_step(b, p, s == 0 ? eb0 : nullptr, s == 0 ? ea0 : nullptr, peer,
                market, seed_g, step0 + s, A, L, last, pmid, mid, volume);
    // 10. The step's outputs.
    if (threadIdx.x == 0) {
      if (stats_in != nullptr) {
        stats_update(st, mid, volume);
      } else {
        const size_t o = (size_t)m * chunk + s;
        price_path[o] = last;
        volume_path[o] = volume;
        mid_path[o] = mid;
      }
    }
    __syncthreads();
  }

  store_books(b, bid_out, ask_out, row, L);
  if (threadIdx.x == 0) {
    last_out[m] = last;
    pmid_out[m] = pmid;
    if (stats_in != nullptr) {
      for (int k = 0; k < NUM_STATS; ++k) stats_out[(size_t)m * NUM_STATS + k] = st[k];
    }
  }
}

__global__ void kinetic_legacy_kernel(
    const float* __restrict__ bid_in, const float* __restrict__ ask_in,
    const float* __restrict__ last_in, const float* __restrict__ pmid_in,
    const float* __restrict__ fparams, const int* __restrict__ iparams,
    float* __restrict__ bid_out, float* __restrict__ ask_out,
    float* __restrict__ last_out, float* __restrict__ pmid_out,
    float* __restrict__ price_path, float* __restrict__ volume_path, int A,
    int L, int S, uint32_t seed) {
  extern __shared__ float smem[];
  __shared__ int red_i[64];
  __shared__ float red_f[64];
  const BookSmem b = book_smem(smem, L, red_i, red_f);

  const int m = blockIdx.x;
  const size_t row = (size_t)m * L;
  load_books(b, bid_in, ask_in, row, L);
  float last = last_in[m];
  float pmid = pmid_in[m];
  const MarketRow p = load_row(fparams, iparams);  // one row for every block
  const uint32_t seed_g = seed ^ SEED_GOLDEN;
  __syncthreads();

  for (int s = 0; s < S; ++s) {
    float mid, volume;
    // The peer is the market's own previous mid, read at every step.
    market_step(b, p, nullptr, nullptr, pmid, (uint32_t)m, seed_g, s, A, L,
                last, pmid, mid, volume);
    if (threadIdx.x == 0) {
      const size_t o = (size_t)m * S + s;
      price_path[o] = last;
      volume_path[o] = volume;
    }
    __syncthreads();
  }

  store_books(b, bid_out, ask_out, row, L);
  if (threadIdx.x == 0) {
    last_out[m] = last;
    pmid_out[m] = pmid;
  }
}

extern "C" {

// Launches the chunk kernel on `stream` and returns cudaGetLastError().
// ext_buy, ext_ask may be null (no external orders). stats_in/stats_out
// ([M, 6]) are non-null exactly in stats_only mode, where the three paths
// are null.
int kc_kinetic_clearing_chunk(
    const int* market_ids, const float* bid, const float* ask,
    const float* last, const float* pmid, const float* ext_buy,
    const float* ext_ask, const float* peer_mid, const float* fparams,
    const int* iparams, const float* stats_in, float* bid_out,
    float* ask_out, float* last_out, float* pmid_out, float* price_path,
    float* volume_path, float* mid_path, float* stats_out, int M, int A,
    int L, int chunk, int step0, int n_valid, uint32_t seed, void* stream) {
  kinetic_chunk_kernel<<<M, block_threads(L), book_smem_bytes(L),
                         (cudaStream_t)stream>>>(
      market_ids, bid, ask, last, pmid, ext_buy, ext_ask, peer_mid, fparams,
      iparams, stats_in, bid_out, ask_out, last_out, pmid_out, price_path,
      volume_path, mid_path, stats_out, A, L, chunk, step0, n_valid, seed);
  return (int)cudaGetLastError();
}

// Launches the legacy one-shot kernel (S steps, paths [M, S]) on `stream`
// and returns cudaGetLastError(). fparams/iparams hold one row.
int kc_kinetic_clearing(
    const float* bid, const float* ask, const float* last, const float* pmid,
    const float* fparams, const int* iparams, float* bid_out, float* ask_out,
    float* last_out, float* pmid_out, float* price_path, float* volume_path,
    int M, int A, int L, int S, uint32_t seed, void* stream) {
  kinetic_legacy_kernel<<<M, block_threads(L), book_smem_bytes(L),
                          (cudaStream_t)stream>>>(
      bid, ask, last, pmid, fparams, iparams, bid_out, ask_out, last_out,
      pmid_out, price_path, volume_path, A, L, S, seed);
  return (int)cudaGetLastError();
}

}  // extern "C"
