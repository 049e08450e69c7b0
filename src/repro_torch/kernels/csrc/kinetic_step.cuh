// Device pieces shared by the port's four clearing kernels (sm_90a).
//
// One block clears one market; blockDim = max(32, L). Thread l < L owns
// price level l; every thread takes agents a = tid, tid + blockDim, ...
// market_step() runs one step of simulate_step (repro_torch.core.step) on
// the block's books in shared memory: the scenario shock, best quotes and
// the book imbalance, the agents' decisions on the counter hash, atomicAdd
// binning, the two block scans, the tournament argmax and the residual
// books. The kernels differ only in where the books live between steps
// and in where a step's outputs go.
//
// Bitwise contract with the plain PyTorch version:
//   * built with -fmad=false and without --use_fast_math, so a*b+c rounds
//     twice as the reference does;
//   * the imbalance division is __fdiv_rn; the half-to-even round is rintf;
//     floors are floorf; the hash is uint32_t arithmetic;
//   * every sum (bins, book sums, scans) is an integer-valued float far below
//     2^24, so atomics and any reduction order give the same bits.
//
// Each .cu that includes this header is built into its own shared library,
// so the extern "C" helpers at the end are defined once per library.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Column order of the packed parameter operands. It must equal FLOAT_FIELDS
// and INT_FIELDS of repro_torch/core/params.py; the wrapper compares these
// strings with its own tuples when it loads a library.
#define KC_FLOAT_COLS "shock_intensity,shock_cancel,p_marketable,q_max," \
    "noise_delta,maker_half_spread,fundamental,fundamentalist_kappa," \
    "whale_size,hft_threshold,arb_kappa"
#define KC_INT_COLS "shock_step,num_makers,num_momentum," \
    "num_fundamentalists,num_whales,num_hft,num_informed,num_arbitrageurs," \
    "whale_period,informed_horizon,coupling_peer"

enum FloatCol {
  F_SHOCK_INTENSITY, F_SHOCK_CANCEL, F_P_MARKETABLE, F_Q_MAX, F_NOISE_DELTA,
  F_MAKER_HALF_SPREAD, F_FUNDAMENTAL, F_FUNDAMENTALIST_KAPPA, F_WHALE_SIZE,
  F_HFT_THRESHOLD, F_ARB_KAPPA, NUM_FLOAT_COLS
};
enum IntCol {
  I_SHOCK_STEP, I_NUM_MAKERS, I_NUM_MOMENTUM, I_NUM_FUNDAMENTALISTS,
  I_NUM_WHALES, I_NUM_HFT, I_NUM_INFORMED, I_NUM_ARBITRAGEURS,
  I_WHALE_PERIOD, I_INFORMED_HORIZON, I_COUPLING_PEER, NUM_INT_COLS
};

// Agent strategy classes (repro_torch/core/config.py).
enum AgentType {
  NOISE = 0, MOMENTUM = 1, MAKER = 2, FUNDAMENTALIST = 3, WHALE = 4, HFT = 5,
  INFORMED = 6, ARBITRAGEUR = 7
};

#define FULL_MASK 0xFFFFFFFFu
#define NUM_STATS 6
#define SEED_GOLDEN 0x9E3779B9u

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// uniform32 for one channel, given the shared prefix
// mix32(mix32((seed ^ GOLDEN) + gid * K_GID) + step * K_STEP).
__device__ __forceinline__ float channel_uniform(uint32_t prefix, uint32_t ch) {
  const uint32_t bits = mix32(prefix + ch * 0x27D4EB2Fu);
  return __uint2float_rn(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// Block-wide max(bb), min(ba), sum(sb), sum(sa); every thread gets the result.
__device__ __forceinline__ void block_quotes(int& bb, int& ba, float& sb,
                                             float& sa, int* ri, float* rf) {
  for (int o = 16; o > 0; o >>= 1) {
    bb = max(bb, __shfl_xor_sync(FULL_MASK, bb, o));
    ba = min(ba, __shfl_xor_sync(FULL_MASK, ba, o));
    sb += __shfl_xor_sync(FULL_MASK, sb, o);
    sa += __shfl_xor_sync(FULL_MASK, sa, o);
  }
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    ri[warp] = bb; ri[32 + warp] = ba; rf[warp] = sb; rf[32 + warp] = sa;
  }
  __syncthreads();
  bb = ri[0]; ba = ri[32]; sb = rf[0]; sa = rf[32];
  for (int w = 1; w < nw; ++w) {
    bb = max(bb, ri[w]); ba = min(ba, ri[32 + w]);
    sb += rf[w]; sa += rf[32 + w];
  }
  __syncthreads();
}

// Tournament argmax: the larger value wins, ties go to the lower tick.
__device__ __forceinline__ bool beats(float v2, int i2, float v1, int i1) {
  return v2 > v1 || (v2 == v1 && i2 < i1);
}

__device__ __forceinline__ void block_argmax(float& v, int& idx, float* rv,
                                             int* ri) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, v, o);
    const int oi = __shfl_xor_sync(FULL_MASK, idx, o);
    if (beats(ov, oi, v, idx)) { v = ov; idx = oi; }
  }
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) { rv[warp] = v; ri[warp] = idx; }
  __syncthreads();
  v = rv[0]; idx = ri[0];
  for (int w = 1; w < nw; ++w) {
    if (beats(rv[w], ri[w], v, idx)) { v = rv[w]; idx = ri[w]; }
  }
  __syncthreads();
}

// One market's scenario params, read from one packed row.
struct MarketRow {
  float shock_intensity, shock_cancel, p_marketable, q_max, noise_delta;
  float maker_half, fundamental, fund_kappa, whale_size, hft_threshold;
  float arb_kappa;
  int shock_step, whale_period, informed_horizon;
  // Cumulative upper bounds of the agent-type blocks, in assignment order.
  int up_maker, up_momentum, up_fund, up_whale, up_hft, up_informed, up_arb;
};

__device__ __forceinline__ MarketRow load_row(const float* fp, const int* ip) {
  MarketRow p;
  p.shock_intensity = fp[F_SHOCK_INTENSITY];
  p.shock_cancel = fp[F_SHOCK_CANCEL];
  p.p_marketable = fp[F_P_MARKETABLE];
  p.q_max = fp[F_Q_MAX];
  p.noise_delta = fp[F_NOISE_DELTA];
  p.maker_half = fp[F_MAKER_HALF_SPREAD];
  p.fundamental = fp[F_FUNDAMENTAL];
  p.fund_kappa = fp[F_FUNDAMENTALIST_KAPPA];
  p.whale_size = fp[F_WHALE_SIZE];
  p.hft_threshold = fp[F_HFT_THRESHOLD];
  p.arb_kappa = fp[F_ARB_KAPPA];
  p.shock_step = ip[I_SHOCK_STEP];
  p.whale_period = max(ip[I_WHALE_PERIOD], 1);
  p.informed_horizon = ip[I_INFORMED_HORIZON];
  p.up_maker = ip[I_NUM_MAKERS];
  p.up_momentum = p.up_maker + ip[I_NUM_MOMENTUM];
  p.up_fund = p.up_momentum + ip[I_NUM_FUNDAMENTALISTS];
  p.up_whale = p.up_fund + ip[I_NUM_WHALES];
  p.up_hft = p.up_whale + ip[I_NUM_HFT];
  p.up_informed = p.up_hft + ip[I_NUM_INFORMED];
  p.up_arb = p.up_informed + ip[I_NUM_ARBITRAGEURS];
  return p;
}

// The block's shared-memory working set: 6·L floats (dynamic) plus the
// reduction scratch.
struct BookSmem {
  float* bid;   // resting bids
  float* ask;   // resting asks
  float* tb;    // incoming buy bins, then total buy
  float* ta;    // incoming sell bins, then total ask
  float* dc;    // cumulative demand (suffix scan)
  float* sc;    // cumulative supply (prefix scan)
  int* red_i;   // [64]
  float* red_f; // [64]
};

__device__ __forceinline__ BookSmem book_smem(float* smem, int L, int* red_i,
                                              float* red_f) {
  return BookSmem{smem, smem + L, smem + 2 * L, smem + 3 * L, smem + 4 * L,
                  smem + 5 * L, red_i, red_f};
}

// One step of simulate_step for the block's market at absolute `step`.
// `peer` is the arbitrageurs' peer mid; `eb`/`ea` are the market's external
// order rows (null: none). Advances `last` and `pmid` and leaves the step's
// mid and cleared volume in every thread. The caller synchronises before it
// touches the books again.
__device__ __forceinline__ void market_step(
    const BookSmem& b, const MarketRow& p, const float* eb, const float* ea,
    float peer, uint32_t market, uint32_t seed_g, int step, int A, int L,
    float& last, float& pmid, float& mid_out, float& volume_out) {
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const bool owns_level = tid < L;
  const float top = (float)(L - 1);

  // 1. Scenario shock: withdraw a fraction of every resting bid level.
  if (owns_level && step == p.shock_step) {
    const float v = b.bid[tid];
    b.bid[tid] = v - floorf(v * p.shock_cancel);
  }
  __syncthreads();

  // 2-4. Best quotes, book sums, imbalance.
  int bb = -1, ba = L;
  float sb = 0.f, sa = 0.f;
  if (owns_level) {
    sb = b.bid[tid];
    sa = b.ask[tid];
    if (sb > 0.f) bb = tid;
    if (sa > 0.f) ba = tid;
  }
  block_quotes(bb, ba, sb, sa, b.red_i, b.red_f);
  const float mid = (bb >= 0 && ba < L) ? (float)(bb + ba) * 0.5f : last;
  const float depth = sb + sa;
  const float imb = depth > 0.f ? __fdiv_rn(sb - sa, depth) : 0.f;

  if (owns_level) { b.tb[tid] = 0.f; b.ta[tid] = 0.f; }
  __syncthreads();

  // 5. Agents: draw, decide on the own archetype, bin with atomicAdd.
  const uint32_t ustep = (uint32_t)step;
  for (int a = tid; a < A; a += T) {
    const uint32_t gid = market * (uint32_t)A + (uint32_t)a;
    const uint32_t prefix =
        mix32(mix32(seed_g + gid * 0x85EBCA6Bu) + ustep * 0xC2B2AE35u);
    const float u_side = channel_uniform(prefix, 0);
    const float u_price = channel_uniform(prefix, 1);
    const float u_mkt = channel_uniform(prefix, 2);
    const float u_qty = channel_uniform(prefix, 3);
    const float u_shock = channel_uniform(prefix, 4);

    const int type = a < p.up_maker ? MAKER
                   : a < p.up_momentum ? MOMENTUM
                   : a < p.up_fund ? FUNDAMENTALIST
                   : a < p.up_whale ? WHALE
                   : a < p.up_hft ? HFT
                   : a < p.up_informed ? INFORMED
                   : a < p.up_arb ? ARBITRAGEUR : NOISE;
    const bool coin = u_side < 0.5f;
    const float jitter = u_price * 2.0f - 1.0f;
    bool side;
    float price_f;
    switch (type) {
      case MOMENTUM: {
        const float ret = mid - pmid;
        side = ret != 0.f ? ret > 0.f : coin;
        price_f = mid + (side ? 1.0f : -1.0f);
        break;
      }
      case MAKER:
        side = ((a + step) % 2) == 0;
        price_f = side ? mid - p.maker_half : mid + p.maker_half;
        break;
      case FUNDAMENTALIST: {
        const float dev = p.fundamental - mid;
        side = dev != 0.f ? dev > 0.f : coin;
        price_f = mid + dev * p.fund_kappa + jitter;
        break;
      }
      case WHALE:
        side = coin;
        price_f = side ? top : 0.f;
        break;
      case HFT:
        side = fabsf(imb) > p.hft_threshold ? imb > 0.f : coin;
        price_f = mid + (side ? 1.0f : -1.0f);
        break;
      case INFORMED: {
        const bool window = p.shock_step >= 0 &&
                            step >= p.shock_step - p.informed_horizon &&
                            step < p.shock_step;
        side = !window && coin;
        price_f = window ? 0.f : mid + jitter;
        break;
      }
      case ARBITRAGEUR: {
        const float gap = peer - mid;
        side = gap != 0.f ? gap > 0.f : coin;
        price_f = mid + gap * p.arb_kappa + jitter;
        break;
      }
      default:  // NOISE
        side = coin;
        price_f = mid + jitter * p.noise_delta;
        break;
    }
    if (type != MAKER) {
      if (u_mkt < p.p_marketable) price_f = side ? top : 0.f;
      if (step == p.shock_step && u_shock < p.shock_intensity) {
        side = false;
        price_f = 0.f;
      }
    }
    const int price = (int)fminf(fmaxf(rintf(price_f), 0.f), top);
    float qty = 1.0f + floorf(u_qty * p.q_max);
    if (type == WHALE) qty = (step % p.whale_period) == 0 ? p.whale_size : 0.f;
    if (qty != 0.f) atomicAdd(side ? &b.tb[price] : &b.ta[price], qty);
  }
  __syncthreads();

  // 6. Totals over resting + incoming flow (+ external orders).
  if (owns_level) {
    float tb = b.bid[tid] + b.tb[tid];
    float ta = b.ask[tid] + b.ta[tid];
    if (eb != nullptr) tb += eb[tid];
    if (ea != nullptr) ta += ea[tid];
    b.tb[tid] = tb; b.ta[tid] = ta;
    b.dc[tid] = tb; b.sc[tid] = ta;
  }
  __syncthreads();

  // 7. Hillis–Steele scans: suffix (demand) and prefix (supply).
  for (int off = 1; off < L; off <<= 1) {
    float d = 0.f, c = 0.f;
    if (owns_level) {
      d = b.dc[tid] + (tid + off < L ? b.dc[tid + off] : 0.f);
      c = b.sc[tid] + (tid >= off ? b.sc[tid - off] : 0.f);
    }
    __syncthreads();
    if (owns_level) { b.dc[tid] = d; b.sc[tid] = c; }
    __syncthreads();
  }

  // 8. Executable volume and the clearing tick.
  float volume = -1.f;
  int p_star = L;
  if (owns_level) { volume = fminf(b.dc[tid], b.sc[tid]); p_star = tid; }
  block_argmax(volume, p_star, b.red_f, b.red_i);

  // 9. Priority allocation and the residual books.
  if (owns_level) {
    const float tb = b.tb[tid], ta = b.ta[tid];
    const float traded_b = fminf(tb, fmaxf(0.f, volume - (b.dc[tid] - tb)));
    const float traded_s = fminf(ta, fmaxf(0.f, volume - (b.sc[tid] - ta)));
    b.bid[tid] = tb - traded_b;
    b.ask[tid] = ta - traded_s;
  }
  last = volume > 0.f ? (float)p_star : last;
  pmid = mid;
  mid_out = mid;
  volume_out = volume;
}

// The in-stream statistics update (repro_torch.core.stats.accumulate).
__device__ __forceinline__ void stats_update(float* st, float mid,
                                             float volume) {
  st[0] = st[0] + 1.0f;
  st[1] = st[1] + mid;
  st[2] = st[2] + mid * mid;
  st[3] = fminf(st[3], mid);
  st[4] = fmaxf(st[4], mid);
  st[5] = st[5] + volume;
}

__device__ __forceinline__ void load_books(const BookSmem& b,
                                           const float* bid_in,
                                           const float* ask_in, size_t row,
                                           int L) {
  if ((int)threadIdx.x < L) {
    b.bid[threadIdx.x] = bid_in[row + threadIdx.x];
    b.ask[threadIdx.x] = ask_in[row + threadIdx.x];
  }
}

__device__ __forceinline__ void store_books(const BookSmem& b, float* bid_out,
                                            float* ask_out, size_t row,
                                            int L) {
  if ((int)threadIdx.x < L) {
    bid_out[row + threadIdx.x] = b.bid[threadIdx.x];
    ask_out[row + threadIdx.x] = b.ask[threadIdx.x];
  }
}

// Launch shape shared by every kernel: one block per market.
static inline int block_threads(int L) { return L < 32 ? 32 : L; }
static inline size_t book_smem_bytes(int L) {
  return 6 * (size_t)L * sizeof(float);
}

extern "C" {

const char* kc_float_cols() { return KC_FLOAT_COLS; }
const char* kc_int_cols() { return KC_INT_COLS; }
const char* kc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
