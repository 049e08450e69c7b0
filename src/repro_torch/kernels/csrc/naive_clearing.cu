// Per-step clearing kernels for Hopper (sm_90a): the paper's "naive custom
// CUDA" ablation.
//
// naive_chunk_step_kernel replaces the TPU kernel
// repro/kernels/naive_clearing.py::_chunk_step_kernel_body (launched by
// pl.pallas_call in naive_clearing_chunk, once per step from a host scan).
// naive_legacy_step_kernel replaces repro/kernels/naive_clearing.py::
// _step_kernel_body (pallas_call in the legacy one-shot naive_clearing).
//
// Both compute exactly one step of simulate_step per launch with the same
// device step as the persistent kernels (kinetic_step.cuh), but nothing
// persists: each launch loads the market's books, scalars, params row (and
// in stats_only mode its six running stats) from device memory into shared
// memory, runs one step and writes everything back. That is the point of
// the ablation: every piece of state crosses device memory between steps,
// and a chunk of n steps costs n launches.
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

#include "kinetic_step.cuh"

__global__ void naive_chunk_step_kernel(
    const int* __restrict__ market_ids, const float* __restrict__ bid_in,
    const float* __restrict__ ask_in, const float* __restrict__ last_in,
    const float* __restrict__ pmid_in, const float* __restrict__ ext_buy,
    const float* __restrict__ ext_ask, const float* __restrict__ peer_mid,
    const float* __restrict__ fparams, const int* __restrict__ iparams,
    const float* __restrict__ stats_in, float* __restrict__ bid_out,
    float* __restrict__ ask_out, float* __restrict__ last_out,
    float* __restrict__ pmid_out, float* __restrict__ price_path,
    float* __restrict__ volume_path, float* __restrict__ mid_path,
    float* __restrict__ stats_out, int A, int L, int chunk, int s, int step,
    uint32_t seed) {
  extern __shared__ float smem[];
  __shared__ int red_i[64];
  __shared__ float red_f[64];
  const BookSmem b = book_smem(smem, L, red_i, red_f);

  const int m = blockIdx.x;
  const size_t row = (size_t)m * L;
  load_books(b, bid_in, ask_in, row, L);
  float last = last_in[m];
  float pmid = pmid_in[m];
  const MarketRow p = load_row(fparams + (size_t)m * NUM_FLOAT_COLS,
                               iparams + (size_t)m * NUM_INT_COLS);
  __syncthreads();

  float mid, volume;
  market_step(b, p, ext_buy != nullptr ? ext_buy + row : nullptr,
              ext_ask != nullptr ? ext_ask + row : nullptr, peer_mid[m],
              (uint32_t)market_ids[m], seed ^ SEED_GOLDEN, step, A, L, last,
              pmid, mid, volume);

  store_books(b, bid_out, ask_out, row, L);
  if (threadIdx.x == 0) {
    last_out[m] = last;
    pmid_out[m] = pmid;
    if (stats_in != nullptr) {
      float st[NUM_STATS];
      for (int k = 0; k < NUM_STATS; ++k) st[k] = stats_in[(size_t)m * NUM_STATS + k];
      stats_update(st, mid, volume);
      for (int k = 0; k < NUM_STATS; ++k) stats_out[(size_t)m * NUM_STATS + k] = st[k];
    } else {
      const size_t o = (size_t)m * chunk + s;
      price_path[o] = last;
      volume_path[o] = volume;
      mid_path[o] = mid;
    }
  }
}

__global__ void naive_legacy_step_kernel(
    const float* __restrict__ bid_in, const float* __restrict__ ask_in,
    const float* __restrict__ last_in, const float* __restrict__ pmid_in,
    const float* __restrict__ fparams, const int* __restrict__ iparams,
    float* __restrict__ bid_out, float* __restrict__ ask_out,
    float* __restrict__ last_out, float* __restrict__ pmid_out,
    float* __restrict__ price_path, float* __restrict__ volume_path, int A,
    int L, int S, int s, uint32_t seed) {
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
  __syncthreads();

  float mid, volume;
  // The peer is the market's own previous mid (simulate_step, peer_mid=None).
  market_step(b, p, nullptr, nullptr, pmid, (uint32_t)m, seed ^ SEED_GOLDEN,
              s, A, L, last, pmid, mid, volume);

  store_books(b, bid_out, ask_out, row, L);
  if (threadIdx.x == 0) {
    last_out[m] = last;
    pmid_out[m] = pmid;
    const size_t o = (size_t)m * S + s;
    price_path[o] = last;
    volume_path[o] = volume;
  }
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

extern "C" {

// Launches naive_chunk_step_kernel n_valid times on `stream`, steps step0
// .. step0 + n_valid - 1; the final state lands in the *_out buffers and
// the *_tmp buffers are scratch of the same shapes. External orders go to
// the first launch only. Returns the first non-zero cudaGetLastError().
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
    uint32_t seed, void* stream) {
  const OutBufs out{bid_out, ask_out, last_out, pmid_out, stats_out};
  const OutBufs tmp{bid_tmp, ask_tmp, last_tmp, pmid_tmp, stats_tmp};
  StateBufs src{bid, ask, last, pmid, stats_in};
  for (int s = 0; s < n_valid; ++s) {
    const OutBufs dst = pick(s, n_valid, out, tmp);
    naive_chunk_step_kernel<<<M, block_threads(L), book_smem_bytes(L),
                              (cudaStream_t)stream>>>(
        market_ids, src.bid, src.ask, src.last, src.pmid,
        s == 0 ? ext_buy : nullptr, s == 0 ? ext_ask : nullptr, peer_mid,
        fparams, iparams, src.stats, dst.bid, dst.ask, dst.last, dst.pmid,
        price_path, volume_path, mid_path, dst.stats, A, L, chunk, s,
        step0 + s, seed);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = as_input(dst);
  }
  return 0;
}

// Launches naive_legacy_step_kernel S times (steps 0 .. S-1, paths
// [M, S]) on `stream`; the final state lands in the *_out buffers.
// fparams/iparams hold one row. S must be >= 1.
int kc_naive_clearing(
    const float* bid, const float* ask, const float* last, const float* pmid,
    const float* fparams, const int* iparams, float* bid_out, float* ask_out,
    float* last_out, float* pmid_out, float* bid_tmp, float* ask_tmp,
    float* last_tmp, float* pmid_tmp, float* price_path, float* volume_path,
    int M, int A, int L, int S, uint32_t seed, void* stream) {
  const OutBufs out{bid_out, ask_out, last_out, pmid_out, nullptr};
  const OutBufs tmp{bid_tmp, ask_tmp, last_tmp, pmid_tmp, nullptr};
  StateBufs src{bid, ask, last, pmid, nullptr};
  for (int s = 0; s < S; ++s) {
    const OutBufs dst = pick(s, S, out, tmp);
    naive_legacy_step_kernel<<<M, block_threads(L), book_smem_bytes(L),
                               (cudaStream_t)stream>>>(
        src.bid, src.ask, src.last, src.pmid, fparams, iparams, dst.bid,
        dst.ask, dst.last, dst.pmid, price_path, volume_path, A, L, S, s,
        seed);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = as_input(dst);
  }
  return 0;
}

}  // extern "C"
