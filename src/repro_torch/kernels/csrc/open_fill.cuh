// The open fill (sm_90a): a session's opening leaves written on the card
// from the distinct rows of its spec (repro_torch/kernels/open_fill.py).
//
// It replaces no TPU kernel. The JAX package builds, checks and uploads
// every one of a session's M rows on the host (params.pack_params,
// step.initial_state, stats.init_stats), though a sweep's spec holds a few
// distinct rows, often one; while it did so the card sat idle between two
// ensembles. Here the host uploads the B rows of its blocks as one int32
// table [B, FILL_COLS] (params.py::block_table: the float params' bits,
// the int params, the opening depth's bits and spread, the block's first
// market), and one launch writes, for market m of block b:
//   * the packed params, row b of the table (floats [M, 11], ints [M, 11]);
//   * the opening books [M, L]: q at L/2 -/+ ceil(spread/2), (l == p) * q
//     at every level l, seed_books' own product (so 0 * q elsewhere);
//   * last and pmid [M] at L / 2;
//   * with stats (non-null, [M, NUM_STATS]) the accumulators of
//     init_stats: 0, 0, 0, +inf, -inf, 0.
//
// What bounds it: stores. It reads a few ints a market and writes
// (2L + 28) x 4 bytes, 8.4 MB at M = 8192, L = 128 and 67 MB at L = 1024:
// 3-20 us at 3.35 TB/s. One warp a market, eight a CTA; the warp finds the
// market's block by a binary search of the blocks' first markets (the
// table is a few rows and stays in L1), then writes each book row with
// consecutive 16-byte stores, lane after lane.
#pragma once

#include "kinetic_step.cuh"

#define FILL_QUOTE (NUM_FLOAT_COLS + NUM_INT_COLS)
#define FILL_SPREAD (FILL_QUOTE + 1)
#define FILL_START (FILL_QUOTE + 2)
#define FILL_COLS (FILL_QUOTE + 3)
#define FILL_WARPS 8

struct OpenFillArgs {
  const int* table;  // [B, FILL_COLS]
  float* floats;     // [M, NUM_FLOAT_COLS]
  int* ints;         // [M, NUM_INT_COLS]
  float* bid;        // [M, L]
  float* ask;        // [M, L]
  float* last;       // [M]
  float* pmid;       // [M]
  float* stats;      // [M, NUM_STATS], or null without stats_only
  int B, M, L;
};

__device__ __forceinline__ float fill_level(int l, int quote, float q) {
  return (l == quote ? 1.0f : 0.0f) * q;
}

__device__ __forceinline__ float4 fill_levels(int l, int quote, float q) {
  return make_float4(fill_level(l, quote, q), fill_level(l + 1, quote, q),
                     fill_level(l + 2, quote, q),
                     fill_level(l + 3, quote, q));
}

__global__ void open_fill_kernel(OpenFillArgs g) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * FILL_WARPS + (threadIdx.x >> 5);
  if (m >= g.M) return;
  // The market's block: the last whose first market is <= m.
  int lo = 0, hi = g.B - 1;
  while (lo < hi) {
    const int half = (lo + hi + 1) >> 1;
    if (g.table[(size_t)half * FILL_COLS + FILL_START] <= m) {
      lo = half;
    } else {
      hi = half - 1;
    }
  }
  const int* row = g.table + (size_t)lo * FILL_COLS;
  if (lane < NUM_FLOAT_COLS) {
    g.floats[(size_t)m * NUM_FLOAT_COLS + lane] = __int_as_float(row[lane]);
  } else if (lane < FILL_QUOTE) {
    g.ints[(size_t)m * NUM_INT_COLS + lane - NUM_FLOAT_COLS] = row[lane];
  }
  if (lane == 0) {
    const float mid0 = (float)(g.L / 2);
    g.last[m] = mid0;
    g.pmid[m] = mid0;
  }
  if (g.stats != nullptr && lane < NUM_STATS) {
    // count, sum_mid, sumsq_mid, min_mid, max_mid, sum_volume
    const float inf = __int_as_float(0x7f800000);
    g.stats[(size_t)m * NUM_STATS + lane] =
        lane == 3 ? inf : (lane == 4 ? -inf : 0.0f);
  }
  const float q = __int_as_float(row[FILL_QUOTE]);
  const int spread = row[FILL_SPREAD];
  const int half = spread / 2 + spread % 2;
  const int pb = g.L / 2 - half, pa = g.L / 2 + half;
  float4* bid = reinterpret_cast<float4*>(g.bid + (size_t)m * g.L);
  float4* ask = reinterpret_cast<float4*>(g.ask + (size_t)m * g.L);
  for (int i = lane; i < g.L / 4; i += 32) {
    bid[i] = fill_levels(4 * i, pb, q);
    ask[i] = fill_levels(4 * i, pa, q);
  }
}

// The C entry: writes a session's opening params, books, mids and (stats
// non-null) accumulators from the B block rows of `table` on `stream`
// (nothing for M = 0); returns cudaGetLastError(). Each kernel library
// that includes this header exports it.
extern "C" int kc_open_fill(const int* table, float* floats, int* ints,
                            float* bid, float* ask, float* last, float* pmid,
                            float* stats, int B, int M, int L,
                            void* stream) {
  if (M > 0) {
    const unsigned ctas = (unsigned)((M + FILL_WARPS - 1) / FILL_WARPS);
    open_fill_kernel<<<ctas, 32 * FILL_WARPS, 0, (cudaStream_t)stream>>>(
        OpenFillArgs{table, floats, ints, bid, ask, last, pmid, stats, B, M,
                     L});
  }
  return (int)cudaGetLastError();
}
