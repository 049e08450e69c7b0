// Persistent chunk clearing kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/kinetic_clearing.py::_chunk_kernel_body
// (launched by pl.pallas_call in kinetic_clearing_chunk). It runs up to
// `chunk` steps of simulate_step for every market while the market's books
// stay on chip: the paper's own CUDA design, which the Pallas kernel adapted
// for the TPU.
//
// Layout: one block per market (grid M), blockDim = max(32, L). Thread l < L
// owns price level l; every thread takes agents a = tid, tid + blockDim, ...
// The bid/ask books, the incoming buy/sell bins and the two scan buffers sit
// in shared memory (6·L floats) for all n_valid steps, so the books touch
// device memory only at entry and exit.
//
// What bounds it on this card: operations, not bytes. Per step a market
// moves nothing through device memory, while every agent draws five
// counter-hash uniforms (seven lowbias32 rounds, two shared by the five
// channels) and evaluates its archetype: about 10^2 integer/f32 operations
// per agent-step against a few bytes per market-step of output. The design
// keeps all step state in shared memory and registers, bins with
// shared-memory atomicAdd, and scans with log-depth block scans; the hash
// prefix over (seed, gid, step) is computed once per agent-step and shared by
// the five channels.
//
// Bitwise contract with the plain PyTorch version (repro_torch.core.step):
//   * built with -fmad=false and without --use_fast_math, so a*b+c rounds
//     twice as the reference does;
//   * the imbalance division is __fdiv_rn; the half-to-even round is rintf;
//     floors are floorf; the hash is uint32_t arithmetic;
//   * every sum (bins, book sums, scans) is an integer-valued float far below
//     2^24, so atomics and any reduction order give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

// Column order of the packed parameter operands. It must equal FLOAT_FIELDS
// and INT_FIELDS of repro_torch/core/params.py; the wrapper compares these
// strings with its own tuples when it loads the library.
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
  float* s_bid = smem;          // resting bids
  float* s_ask = smem + L;      // resting asks
  float* s_tb = smem + 2 * L;   // incoming buy bins, then total buy
  float* s_ta = smem + 3 * L;   // incoming sell bins, then total ask
  float* s_dc = smem + 4 * L;   // cumulative demand (suffix scan)
  float* s_sc = smem + 5 * L;   // cumulative supply (prefix scan)
  __shared__ int red_i[64];
  __shared__ float red_f[64];

  const int m = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const bool owns_level = tid < L;
  const size_t row = (size_t)m * L;

  if (owns_level) {
    s_bid[tid] = bid_in[row + tid];
    s_ask[tid] = ask_in[row + tid];
  }
  float last = last_in[m];
  float pmid = pmid_in[m];
  const float peer = peer_mid[m];
  const uint32_t market = (uint32_t)market_ids[m];

  const float* fp = fparams + (size_t)m * NUM_FLOAT_COLS;
  const int* ip = iparams + (size_t)m * NUM_INT_COLS;
  const float shock_intensity = fp[F_SHOCK_INTENSITY];
  const float shock_cancel = fp[F_SHOCK_CANCEL];
  const float p_marketable = fp[F_P_MARKETABLE];
  const float q_max = fp[F_Q_MAX];
  const float noise_delta = fp[F_NOISE_DELTA];
  const float maker_half = fp[F_MAKER_HALF_SPREAD];
  const float fundamental = fp[F_FUNDAMENTAL];
  const float fund_kappa = fp[F_FUNDAMENTALIST_KAPPA];
  const float whale_size = fp[F_WHALE_SIZE];
  const float hft_threshold = fp[F_HFT_THRESHOLD];
  const float arb_kappa = fp[F_ARB_KAPPA];
  const int shock_step = ip[I_SHOCK_STEP];
  const int whale_period = max(ip[I_WHALE_PERIOD], 1);
  const int informed_horizon = ip[I_INFORMED_HORIZON];
  // Cumulative upper bounds of the agent-type blocks, in assignment order.
  const int up_maker = ip[I_NUM_MAKERS];
  const int up_momentum = up_maker + ip[I_NUM_MOMENTUM];
  const int up_fund = up_momentum + ip[I_NUM_FUNDAMENTALISTS];
  const int up_whale = up_fund + ip[I_NUM_WHALES];
  const int up_hft = up_whale + ip[I_NUM_HFT];
  const int up_informed = up_hft + ip[I_NUM_INFORMED];
  const int up_arb = up_informed + ip[I_NUM_ARBITRAGEURS];

  float st[NUM_STATS];
  if (stats_in != nullptr) {
    for (int k = 0; k < NUM_STATS; ++k) st[k] = stats_in[(size_t)m * NUM_STATS + k];
  }
  const uint32_t seed_g = seed ^ 0x9E3779B9u;
  const float top = (float)(L - 1);
  __syncthreads();

  for (int s = 0; s < n_valid; ++s) {
    const int step = step0 + s;

    // 1. Scenario shock: withdraw a fraction of every resting bid level.
    if (owns_level && step == shock_step) {
      const float b = s_bid[tid];
      s_bid[tid] = b - floorf(b * shock_cancel);
    }
    __syncthreads();

    // 2-4. Best quotes, book sums, imbalance.
    int bb = -1, ba = L;
    float sb = 0.f, sa = 0.f;
    if (owns_level) {
      sb = s_bid[tid];
      sa = s_ask[tid];
      if (sb > 0.f) bb = tid;
      if (sa > 0.f) ba = tid;
    }
    block_quotes(bb, ba, sb, sa, red_i, red_f);
    const float mid = (bb >= 0 && ba < L) ? (float)(bb + ba) * 0.5f : last;
    const float depth = sb + sa;
    const float imb = depth > 0.f ? __fdiv_rn(sb - sa, depth) : 0.f;

    if (owns_level) { s_tb[tid] = 0.f; s_ta[tid] = 0.f; }
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

      const int type = a < up_maker ? MAKER
                     : a < up_momentum ? MOMENTUM
                     : a < up_fund ? FUNDAMENTALIST
                     : a < up_whale ? WHALE
                     : a < up_hft ? HFT
                     : a < up_informed ? INFORMED
                     : a < up_arb ? ARBITRAGEUR : NOISE;
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
          price_f = side ? mid - maker_half : mid + maker_half;
          break;
        case FUNDAMENTALIST: {
          const float dev = fundamental - mid;
          side = dev != 0.f ? dev > 0.f : coin;
          price_f = mid + dev * fund_kappa + jitter;
          break;
        }
        case WHALE:
          side = coin;
          price_f = side ? top : 0.f;
          break;
        case HFT:
          side = fabsf(imb) > hft_threshold ? imb > 0.f : coin;
          price_f = mid + (side ? 1.0f : -1.0f);
          break;
        case INFORMED: {
          const bool window = shock_step >= 0 &&
                              step >= shock_step - informed_horizon &&
                              step < shock_step;
          side = !window && coin;
          price_f = window ? 0.f : mid + jitter;
          break;
        }
        case ARBITRAGEUR: {
          const float gap = peer - mid;
          side = gap != 0.f ? gap > 0.f : coin;
          price_f = mid + gap * arb_kappa + jitter;
          break;
        }
        default:  // NOISE
          side = coin;
          price_f = mid + jitter * noise_delta;
          break;
      }
      if (type != MAKER) {
        if (u_mkt < p_marketable) price_f = side ? top : 0.f;
        if (step == shock_step && u_shock < shock_intensity) {
          side = false;
          price_f = 0.f;
        }
      }
      const int price = (int)fminf(fmaxf(rintf(price_f), 0.f), top);
      float qty = 1.0f + floorf(u_qty * q_max);
      if (type == WHALE) qty = (step % whale_period) == 0 ? whale_size : 0.f;
      if (qty != 0.f) atomicAdd(side ? &s_tb[price] : &s_ta[price], qty);
    }
    __syncthreads();

    // 6. Totals over resting + incoming flow (+ external orders at step 0).
    if (owns_level) {
      float tb = s_bid[tid] + s_tb[tid];
      float ta = s_ask[tid] + s_ta[tid];
      if (s == 0 && ext_buy != nullptr) tb += ext_buy[row + tid];
      if (s == 0 && ext_ask != nullptr) ta += ext_ask[row + tid];
      s_tb[tid] = tb; s_ta[tid] = ta;
      s_dc[tid] = tb; s_sc[tid] = ta;
    }
    __syncthreads();

    // 7. Hillis–Steele scans: suffix (demand) and prefix (supply).
    for (int off = 1; off < L; off <<= 1) {
      float d = 0.f, c = 0.f;
      if (owns_level) {
        d = s_dc[tid] + (tid + off < L ? s_dc[tid + off] : 0.f);
        c = s_sc[tid] + (tid >= off ? s_sc[tid - off] : 0.f);
      }
      __syncthreads();
      if (owns_level) { s_dc[tid] = d; s_sc[tid] = c; }
      __syncthreads();
    }

    // 8. Executable volume and the clearing tick.
    float volume = -1.f;
    int p_star = L;
    if (owns_level) { volume = fminf(s_dc[tid], s_sc[tid]); p_star = tid; }
    block_argmax(volume, p_star, red_f, red_i);

    // 9. Priority allocation and the residual books.
    if (owns_level) {
      const float tb = s_tb[tid], ta = s_ta[tid];
      const float traded_b = fminf(tb, fmaxf(0.f, volume - (s_dc[tid] - tb)));
      const float traded_s = fminf(ta, fmaxf(0.f, volume - (s_sc[tid] - ta)));
      s_bid[tid] = tb - traded_b;
      s_ask[tid] = ta - traded_s;
    }
    last = volume > 0.f ? (float)p_star : last;
    pmid = mid;

    // 10. The step's outputs.
    if (tid == 0) {
      if (stats_in != nullptr) {
        st[0] = st[0] + 1.0f;
        st[1] = st[1] + mid;
        st[2] = st[2] + mid * mid;
        st[3] = fminf(st[3], mid);
        st[4] = fmaxf(st[4], mid);
        st[5] = st[5] + volume;
      } else {
        const size_t p = (size_t)m * chunk + s;
        price_path[p] = last;
        volume_path[p] = volume;
        mid_path[p] = mid;
      }
    }
    __syncthreads();
  }

  if (owns_level) {
    bid_out[row + tid] = s_bid[tid];
    ask_out[row + tid] = s_ask[tid];
  }
  if (tid == 0) {
    last_out[m] = last;
    pmid_out[m] = pmid;
    if (stats_in != nullptr) {
      for (int k = 0; k < NUM_STATS; ++k) stats_out[(size_t)m * NUM_STATS + k] = st[k];
    }
  }
}

extern "C" {

const char* kc_float_cols() { return KC_FLOAT_COLS; }
const char* kc_int_cols() { return KC_INT_COLS; }
const char* kc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches the kernel on `stream` and returns cudaGetLastError(). ext_buy,
// ext_ask may be null (no external orders). stats_in/stats_out ([M, 6]) are
// non-null exactly in stats_only mode, where the three paths are null.
int kc_kinetic_clearing_chunk(
    const int* market_ids, const float* bid, const float* ask,
    const float* last, const float* pmid, const float* ext_buy,
    const float* ext_ask, const float* peer_mid, const float* fparams,
    const int* iparams, const float* stats_in, float* bid_out,
    float* ask_out, float* last_out, float* pmid_out, float* price_path,
    float* volume_path, float* mid_path, float* stats_out, int M, int A,
    int L, int chunk, int step0, int n_valid, uint32_t seed, void* stream) {
  const int threads = L < 32 ? 32 : L;
  const size_t smem = 6 * (size_t)L * sizeof(float);
  kinetic_chunk_kernel<<<M, threads, smem, (cudaStream_t)stream>>>(
      market_ids, bid, ask, last, pmid, ext_buy, ext_ask, peer_mid, fparams,
      iparams, stats_in, bid_out, ask_out, last_out, pmid_out, price_path,
      volume_path, mid_path, stats_out, A, L, chunk, step0, n_valid, seed);
  return (int)cudaGetLastError();
}

}  // extern "C"
