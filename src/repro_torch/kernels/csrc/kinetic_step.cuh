// Device pieces shared by the port's four clearing kernels (sm_90a).
//
// Layout: a *market team* of W warps (T = 32·W threads) clears one market,
// and one CTA holds `markets_per_cta` teams. Thread t of a team owns the
// LPL contiguous levels [LPL·t, LPL·t + LPL) ∩ [0, L) and keeps their
// bid/ask in registers for the whole call; agent a is handled by thread
// a mod T, so a warp holds 32 consecutive agent ids (mostly one
// archetype). LPL = levels_per_lane(L, W) = max(4, L / T): four levels a
// lane wherever the team has L / 128 warps or more (the per-step kernels
// and every market cluster, always), and in the persistent kernels' own
// CTA, in the registers mode, up to 32 where a narrower team clears a wide
// book (a template argument: one instance of each for 8, 16 and 32). The
// launch rule (repro_torch/kernels/autotune.py::auto_tile) takes
// W = max(1, L / 128) while a thread holds its agents in registers: a
// market is one warp up to L = 128 (four markets per CTA) and 2-8 warps
// beyond (one market per CTA), except that a persistent kernel's grid of
// many markets past L = 128 takes the fewest warps whose registers hold
// the agents, at L / (32·W) levels a lane; past the registers mode, eight
// warps wherever shared memory holds fewer than four one-warp teams a CTA;
// the timed sweep may launch any other shape check_shape below accepts.
//
// A market cluster (any agent mode of the persistent kernels, the fresh
// mode of the per-step ones; one team a CTA): C CTAs of a thread-block
// cluster, C in {2, 4, 8, 16}, clear one market together. Each CTA holds its own copy of the market's books in
// registers and handles its own agents, a ≡ r·T + t (mod C·T) for CTA rank
// r, whose keys and types it alone holds (in registers, in its own shared
// memory, or recomputed). Each bins into its own shared memory; after one
// cluster barrier a step, every thread sums its own levels' bins over the
// C CTAs through distributed shared memory, so every copy of the books
// clears alike and only rank 0 writes the outputs. C = 1 is the one-CTA
// layout above, compiled without any of this.
//
// market_step() runs one step of simulate_step (repro_torch.core.step):
// the scenario shock, best quotes and the book imbalance, the agents'
// decisions on the counter hash, integer atomicAdd binning into the team's
// shared-memory bins, the two raking scans (a serial scan of the lane's
// own levels, then a shuffle scan of the lane totals), the argmax and the
// residual books. Quotes, sums, scans and the argmax are warp shuffles
// over each lane's serial pass through its own levels; a one-warp team
// crosses no __syncthreads() at all, at any L (__syncwarp orders the
// bins), and a several-warp team adds one barrier per reduction (four a
// step) to combine the warp totals with a second shuffle tree.
//
// Bitwise contract with the plain PyTorch version:
//   * built with -fmad=false and without --use_fast_math, so a*b+c rounds
//     twice as the reference does;
//   * the imbalance division is __fdiv_rn; the half-to-even round is rintf;
//     floors are floorf; the hash is uint32_t arithmetic;
//   * every sum (bins, book sums, scans) is an integer-valued float far below
//     2^24, so atomics and any reduction order give the same bits. Every
//     agent quantity is an integer (1 + floor(u·q_max), or the
//     integer-valued whale_size), so the bins add ints and convert once.
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
#define K_GID 0x85EBCA6Bu
#define K_STEP 0xC2B2AE35u
#define K_CHAN 0x27D4EB2Fu

// The launch rule's constants; repro_torch/kernels/autotune.py repeats them.
#define LEVELS_PER_LANE 4
#define LEVELS_PER_WARP (32 * LEVELS_PER_LANE)
#define MAX_LEVELS_PER_LANE 32  // a persistent one-warp team at L = 1024
#define MAX_TEAM_WARPS 8
#define REG_AGENTS 8          // agent slots a thread holds in registers
#define MAX_CTA_THREADS 256
#define MAX_DYNAMIC_SMEM (232448 - 1024)  // 227 KB less the static scratch
#define MAX_CLUSTER_CTAS 16   // CTAs a market cluster may take (non-portable)
#define PORTABLE_CLUSTER_CTAS 8

// The bins' element type. Every quantity is an integer below 2^24, so int
// bins give the float bins' bits, and the shared-memory int atomicAdd is a
// native ATOMS.ADD where the float one is a compare-and-swap loop.
typedef int bin_t;

// The thread-block cluster, in PTX (sm_90): this CTA's rank and the
// cluster's CTAs, the barrier over every thread of the cluster (arrive
// with release, wait with acquire: what each CTA wrote before it is
// visible to every CTA after it), and a peer CTA's copy of a shared
// variable, as a generic address (distributed shared memory).
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_ctas() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return (int)n;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n\t"
               "barrier.cluster.wait.acquire;" ::: "memory");
}
template <class T>
__device__ __forceinline__ T* cluster_peer(T* p, int rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;"
               : "=l"(out) : "l"(p), "r"((uint32_t)rank));
  return reinterpret_cast<T*>(out);
}

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// The step-invariant first round mix32((seed ^ GOLDEN) + gid * K_GID).
__device__ __forceinline__ uint32_t agent_key(uint32_t seed_g,
                                              uint32_t market, int A, int a) {
  return mix32(seed_g + (market * (uint32_t)A + (uint32_t)a) * K_GID);
}

// uniform32 for one channel, given the shared prefix
// mix32(key + step * K_STEP).
__device__ __forceinline__ float channel_uniform(uint32_t prefix, uint32_t ch) {
  const uint32_t bits = mix32(prefix + ch * K_CHAN);
  return __uint2float_rn(bits >> 8) * 5.9604644775390625e-08f;  // 2^-24
}

// Tournament argmax: the larger value wins, ties go to the lower tick.
__device__ __forceinline__ bool beats(float v2, int i2, float v1, int i1) {
  return v2 > v1 || (v2 == v1 && i2 < i1);
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

__device__ __forceinline__ int agent_type(int a, const MarketRow& p) {
  return a < p.up_maker ? MAKER
       : a < p.up_momentum ? MOMENTUM
       : a < p.up_fund ? FUNDAMENTALIST
       : a < p.up_whale ? WHALE
       : a < p.up_hft ? HFT
       : a < p.up_informed ? INFORMED
       : a < p.up_arb ? ARBITRAGEUR : NOISE;
}

// ---------------------------------------------------------------------------
// The market team.

struct Team {
  int W;     // warps per market
  int T;     // threads per market (32·W)
  int t;     // thread within the team
  int lane;  // lane within the warp
  int warp;  // warp within the team
  int slot;  // team within the CTA
};

__device__ __forceinline__ Team make_team(int W) {
  Team tm;
  tm.W = W;
  tm.T = 32 * W;
  tm.t = (int)threadIdx.x % tm.T;
  tm.lane = (int)threadIdx.x & 31;
  tm.warp = tm.t >> 5;
  tm.slot = (int)threadIdx.x / tm.T;
  return tm;
}

// A team of several warps is the whole CTA (the launch rule gives it one
// market per CTA), so its barrier is __syncthreads().
__device__ __forceinline__ void team_sync(const Team& tm) {
  if (tm.W == 1) __syncwarp(); else __syncthreads();
}

// Warp totals of a several-warp team, one slot per warp and reduction.
struct TeamScratch {
  int bb[MAX_TEAM_WARPS], ba[MAX_TEAM_WARPS], idx[MAX_TEAM_WARPS];
  float sb[MAX_TEAM_WARPS], sa[MAX_TEAM_WARPS];
  float demand[MAX_TEAM_WARPS], supply[MAX_TEAM_WARPS], vol[MAX_TEAM_WARPS];
};

// The teams' bins (and hoisted agents); 16-byte aligned for int4 access.
extern __shared__ __align__(16) int kc_smem[];
__shared__ TeamScratch kc_scratch;

// max(bb), min(ba), sum(sb), sum(sa) over the team; every thread gets them.
__device__ __forceinline__ void quotes_reduce(int& bb, int& ba, float& sb,
                                              float& sa) {
  for (int o = 16; o > 0; o >>= 1) {
    bb = max(bb, __shfl_xor_sync(FULL_MASK, bb, o));
    ba = min(ba, __shfl_xor_sync(FULL_MASK, ba, o));
    sb += __shfl_xor_sync(FULL_MASK, sb, o);
    sa += __shfl_xor_sync(FULL_MASK, sa, o);
  }
}

__device__ __forceinline__ void team_quotes(const Team& tm, int L, int& bb,
                                            int& ba, float& sb, float& sa) {
  quotes_reduce(bb, ba, sb, sa);
  if (tm.W == 1) return;
  TeamScratch& s = kc_scratch;
  if (tm.lane == 0) {
    s.bb[tm.warp] = bb; s.ba[tm.warp] = ba;
    s.sb[tm.warp] = sb; s.sa[tm.warp] = sa;
  }
  __syncthreads();
  const bool has = tm.lane < tm.W;
  bb = has ? s.bb[tm.lane] : -1;
  ba = has ? s.ba[tm.lane] : L;
  sb = has ? s.sb[tm.lane] : 0.f;
  sa = has ? s.sa[tm.lane] : 0.f;
  quotes_reduce(bb, ba, sb, sa);
}

// Inclusive suffix (of `sfx`) and prefix (of `pfx`) sums over the lanes.
__device__ __forceinline__ void lane_scans(int lane, float& sfx, float& pfx) {
  for (int o = 1; o < 32; o <<= 1) {
    const float d = __shfl_down_sync(FULL_MASK, sfx, o);
    const float u = __shfl_up_sync(FULL_MASK, pfx, o);
    if (lane + o < 32) sfx += d;
    if (lane >= o) pfx += u;
  }
}

// The raking scans' offsets: `after` = the buy totals of every later thread
// of the team, `before` = the sell totals of every earlier one, given the
// thread's own totals lb, la.
__device__ __forceinline__ void team_scan_offsets(const Team& tm, float lb,
                                                  float la, float& after,
                                                  float& before) {
  float sfx = lb, pfx = la;
  lane_scans(tm.lane, sfx, pfx);
  after = sfx - lb;   // exact: integers below 2^24
  before = pfx - la;
  if (tm.W == 1) return;
  TeamScratch& s = kc_scratch;
  const float wb = __shfl_sync(FULL_MASK, sfx, 0);
  const float wa = __shfl_sync(FULL_MASK, pfx, 31);
  if (tm.lane == 0) { s.demand[tm.warp] = wb; s.supply[tm.warp] = wa; }
  __syncthreads();
  const bool has = tm.lane < tm.W;
  float xb = has ? s.demand[tm.lane] : 0.f;
  float xa = has ? s.supply[tm.lane] : 0.f;
  lane_scans(tm.lane, xb, xa);
  // Lane w + 1 holds the later warps' demand (0 past the last warp); lane
  // w - 1 the earlier warps' supply.
  after += __shfl_sync(FULL_MASK, xb, tm.warp + 1);
  const float bx = __shfl_sync(FULL_MASK, xa, max(tm.warp - 1, 0));
  before += tm.warp > 0 ? bx : 0.f;
}

__device__ __forceinline__ void argmax_reduce(float& v, int& idx) {
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(FULL_MASK, v, o);
    const int oi = __shfl_xor_sync(FULL_MASK, idx, o);
    if (beats(ov, oi, v, idx)) { v = ov; idx = oi; }
  }
}

__device__ __forceinline__ void team_argmax(const Team& tm, int L, float& v,
                                            int& idx) {
  argmax_reduce(v, idx);
  if (tm.W == 1) return;
  TeamScratch& s = kc_scratch;
  if (tm.lane == 0) { s.vol[tm.warp] = v; s.idx[tm.warp] = idx; }
  __syncthreads();
  const bool has = tm.lane < tm.W;
  v = has ? s.vol[tm.lane] : -1.f;
  idx = has ? s.idx[tm.lane] : L;
  argmax_reduce(v, idx);
}

// ---------------------------------------------------------------------------
// Where an agent's step-invariant key and type come from. A thread handles
// the agents a = first + j·stride below A, j = 0, 1, ...: an AgentSpan,
// which the bins give (one CTA a market: first = t, stride = T; CTA rank r
// of a market cluster of C: first = r·T + t, stride = C·T), so a warp holds
// 32 consecutive agent ids. Each policy hands f(a, key, type) every such
// agent. The span is passed to each call, never stored: at one CTA a market
// the walk is then the team's own t + k·T, and the registers mode keeps
// its 95 registers (a stored copy took it to 104).

struct AgentSpan {
  int first, stride;
};

// Computed once per call, held in registers: slot k is agent
// first + k·stride, so a market holds at most REG_AGENTS·T·C agents.
struct RegAgents {
  static constexpr bool kSmem = false;
  uint32_t key[REG_AGENTS];
  uint32_t types;  // 4 bits per slot

  __device__ __forceinline__ void init(const Team&, AgentSpan s,
                                       const MarketRow& p, uint32_t seed_g,
                                       uint32_t market, int A, int, int*) {
    types = 0u;
#pragma unroll
    for (int k = 0; k < REG_AGENTS; ++k) {
      const int a = s.first + k * s.stride;
      key[k] = a < A ? agent_key(seed_g, market, A, a) : 0u;
      types |= (uint32_t)agent_type(a, p) << (4 * k);
    }
  }

  template <class F>
  __device__ __forceinline__ void each(const Team&, AgentSpan s, int A,
                                       F&& f) const {
#pragma unroll
    for (int k = 0; k < REG_AGENTS; ++k) {
      const int a = s.first + k * s.stride;
      if (a < A) f(a, key[k], (int)((types >> (4 * k)) & 15u));
    }
  }
};

// Computed once per call, held in the CTA's shared memory after its bins:
// K keys, then K type bytes (K = agent_slots below). Agent first + j·stride
// takes the CTA's slot j·T + t (at one CTA a market, slot a). Each thread
// reads back only what it wrote.
struct SmemAgents {
  static constexpr bool kSmem = true;
  uint32_t* key;
  uint8_t* type;

  __device__ __forceinline__ void init(const Team& tm, AgentSpan s,
                                       const MarketRow& p, uint32_t seed_g,
                                       uint32_t market, int A, int K,
                                       int* area) {
    key = reinterpret_cast<uint32_t*>(area);
    type = reinterpret_cast<uint8_t*>(area + K);
    for (int a = s.first, i = tm.t; a < A; a += s.stride, i += tm.T) {
      key[i] = agent_key(seed_g, market, A, a);
      type[i] = (uint8_t)agent_type(a, p);
    }
  }

  template <class F>
  __device__ __forceinline__ void each(const Team& tm, AgentSpan s, int A,
                                       F&& f) const {
    for (int a = s.first, i = tm.t; a < A; a += s.stride, i += tm.T)
      f(a, key[i], (int)type[i]);
  }
};

// Recomputed at every step: the per-step kernels, which keep nothing, and
// a persistent kernel whose CTA's keys and types fit neither registers nor
// shared memory (the books still stay on chip across the chunk).
struct FreshAgents {
  static constexpr bool kSmem = false;
  const MarketRow* p;
  uint32_t seed_g, market;

  __device__ __forceinline__ void init(const Team&, AgentSpan,
                                       const MarketRow& row, uint32_t seed,
                                       uint32_t mkt, int, int, int*) {
    p = &row; seed_g = seed; market = mkt;
  }

  template <class F>
  __device__ __forceinline__ void each(const Team&, AgentSpan s, int A,
                                       F&& f) const {
    for (int a = s.first; a < A; a += s.stride)
      f(a, agent_key(seed_g, market, A, a), agent_type(a, *p));
  }
};

// Agent slots K of a CTA's key area: its market's A agents at one CTA a
// market; at C > 1 a cluster CTA's share, ⌈A / (C·T)⌉·T, slot j·T + t
// holding agent first + j·stride.
static inline __host__ __device__ int agent_slots(int A, int T, int C) {
  return C > 1 ? (A + C * T - 1) / (C * T) * T : A;
}

// 32-bit words of one team's dynamic shared memory: its buy and sell bins
// (2L; two parity buffers, 4L, on a market cluster), then (SmemAgents only)
// K = agent_slots keys and K type bytes.
static inline __host__ __device__ int team_smem_words(int L, int A, int T,
                                                      int C,
                                                      bool agents_in_smem) {
  const int K = agent_slots(A, T, C);
  return (C > 1 ? 4 : 2) * L + (agents_in_smem ? K + (K + 3) / 4 : 0);
}

// Where a kernel keeps each agent's step-invariant key and type: the agent
// mode of the launch shape (autotune.py AGENT_MODES, in this order). The
// persistent kernels take any of the three; the per-step kernels keep
// nothing across steps, so they always run AGENTS_FRESH (at one CTA a
// market or on a cluster).
enum AgentMode { AGENTS_SHARED = 0, AGENTS_REGISTERS = 1, AGENTS_FRESH = 2 };

// Levels a lane of a team of W warps holds at L: four up to L = 128·W,
// else L / (32·W) (a persistent team in the registers mode at one CTA a
// market; check_shape refuses it anywhere else).
static inline __host__ __device__ int levels_per_lane(int L, int W) {
  const int lpl = L / (32 * W);
  return lpl > LEVELS_PER_LANE ? lpl : LEVELS_PER_LANE;
}

// 0 when (W, MPC, agents, C) is a launch shape the kernels can run for
// (L, A), else cudaErrorInvalidValue. C CTAs a market (a cluster) in any
// agent mode, at one team a CTA; the registers mode holds REG_AGENTS
// agents a thread of the cluster. A lane holds at most `max_lpl` levels:
// LEVELS_PER_LANE for the per-step kernels (check_shape), up to
// MAX_LEVELS_PER_LANE for the persistent ones (check_persistent_shape),
// and more than four only in the registers mode at one CTA a market.
static inline int check_lanes(int L, int A, int W, int MPC, int agents,
                              int C, int max_lpl, size_t* smem) {
  const bool pow2 = L >= 4 && L <= 1024 && (L & (L - 1)) == 0;
  const bool w_ok = W == 1 || W == 2 || W == 4 || W == 8;
  const bool c_ok = C >= 1 && C <= MAX_CLUSTER_CTAS && (C & (C - 1)) == 0;
  if (!pow2 || A < 1 || !w_ok || levels_per_lane(L, W) > max_lpl ||
      (levels_per_lane(L, W) > LEVELS_PER_LANE &&
       (agents != AGENTS_REGISTERS || C != 1)) || MPC < 1 ||
      (W > 1 && MPC != 1) || 32 * W * MPC > MAX_CTA_THREADS ||
      agents < AGENTS_SHARED || agents > AGENTS_FRESH || !c_ok ||
      (agents == AGENTS_REGISTERS && A > REG_AGENTS * 32 * W * C) ||
      (C > 1 && MPC != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  *smem = (size_t)MPC * 4 *
          team_smem_words(L, A, 32 * W, C, agents == AGENTS_SHARED);
  return *smem <= MAX_DYNAMIC_SMEM ? 0 : (int)cudaErrorInvalidValue;
}

static inline int check_shape(int L, int A, int W, int MPC, int agents,
                              int C, size_t* smem) {
  return check_lanes(L, A, W, MPC, agents, C, LEVELS_PER_LANE, smem);
}

static inline int check_persistent_shape(int L, int A, int W, int MPC,
                                         int agents, int C, size_t* smem) {
  return check_lanes(L, A, W, MPC, agents, C, MAX_LEVELS_PER_LANE, smem);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory. Without the
// opt-in a CTA's dynamic and static shared memory together stay within
// 48 KB, and every kernel here has kc_scratch as its static part: a shape
// whose dynamic part alone fits 48 KB but not beside the scratch (one team
// of 1,536 words a CTA eight times: L=128, A=1024 in the shared mode at
// eight markets a CTA) needs the opt-in too.
template <class K>
static inline int allow_smem(K kernel, size_t smem) {
  if (smem + sizeof(TeamScratch) <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <class K>
static inline int resident_ctas(K kernel, int threads, size_t smem,
                                int* ctas) {
  int err = allow_smem(kernel, smem);
  if (err == 0) {
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        ctas, kernel, threads, smem);
  }
  return err;
}

// Lets `kernel` take `smem` bytes and, past the portable 8, a cluster of
// `ctas` CTAs.
template <class K>
static inline int allow_cluster(K kernel, size_t smem, int ctas) {
  int err = allow_smem(kernel, smem);
  if (err == 0 && ctas > PORTABLE_CLUSTER_CTAS) {
    err = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// A launch configuration of `grid` CTAs in clusters of `ctas` along x.
static inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr,
                                                dim3 grid, dim3 cta,
                                                size_t smem, int ctas,
                                                void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = cta;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)ctas;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of `ctas` CTAs of `kernel` the card holds at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot place one).
template <class K>
static inline int resident_clusters(K kernel, int threads, size_t smem,
                                    int ctas, int* clusters) {
  const int err = allow_cluster(kernel, smem, ctas);
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      &attr, dim3((unsigned)ctas), dim3((unsigned)threads), smem, ctas,
      nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)kernel,
                                             &cfg);
}

// ---------------------------------------------------------------------------
// One step.

// A thread's LPL levels: resting books between steps, totals within one.
template <int LPL = LEVELS_PER_LANE>
struct Book {
  float bid[LPL], ask[LPL];
};

// Where a step's orders are binned and summed: the team's own bins
// (CtaBins, SwizzledBins) or a market cluster's (ClusterBins). span() gives
// a thread its agents, add() bins one order, sync() is the barrier after
// the binning, take() hands a thread the step's totals at the four levels
// lv0 + j (0 past L) and resets what it read for a later step, leader()
// says whether this CTA writes the outputs, and finish() ends the call.

// The team's 2L bins in its CTA's shared memory (buy [0, L), sell
// [L, 2L)), read and reset in place.
struct CtaBins {
  static constexpr bool kCluster = false;
  bin_t* b;

  __device__ __forceinline__ void init(const Team& tm, int* area, int L) {
    b = reinterpret_cast<bin_t*>(area);
    for (int k = tm.t; k < 2 * L; k += tm.T) b[k] = (bin_t)0;
  }
  // The team handles every agent of its market.
  __device__ __forceinline__ AgentSpan span(const Team& tm) const {
    return AgentSpan{tm.t, tm.T};
  }
  __device__ __forceinline__ void add(int, int bin, int q) const {
    atomicAdd(&b[bin], (bin_t)q);
  }
  __device__ __forceinline__ void sync(const Team& tm) const { team_sync(tm); }
  __device__ __forceinline__ void take(const Team&, int, int lv0, int L,
                                       bin_t* buy, bin_t* sell) const {
#pragma unroll
    for (int j = 0; j < LEVELS_PER_LANE; ++j) {
      const int lv = lv0 + j;
      buy[j] = sell[j] = (bin_t)0;
      if (lv < L) {
        buy[j] = b[lv];
        sell[j] = b[L + lv];
        b[lv] = (bin_t)0;
        b[L + lv] = (bin_t)0;
      }
    }
  }
  __device__ __forceinline__ bool leader() const { return true; }
  __device__ __forceinline__ void finish() const {}
};

// CtaBins for lanes of more than four levels, where L = LPL·T. Bin i lives
// at word i ^ ((i >> 5) & 31), a permutation within each row of 32 words:
// lane t's level j, bin LPL·t + j, would sit in bank (LPL·t + j) mod 32
// (a 32-way conflict across the warp at 32 levels a lane), and sits in a
// bank of its own here for every j, in take() and in its resets. The
// agents' atomicAdd lands where their orders fall, as before.
struct SwizzledBins : CtaBins {
  __device__ __forceinline__ static int at(int i) {
    return i ^ ((i >> 5) & 31);
  }
  __device__ __forceinline__ void add(int, int bin, int q) const {
    atomicAdd(&b[at(bin)], (bin_t)q);
  }
  __device__ __forceinline__ void take(const Team&, int, int lv0, int L,
                                       bin_t* buy, bin_t* sell) const {
#pragma unroll
    for (int j = 0; j < LEVELS_PER_LANE; ++j) {
      const int kb = at(lv0 + j), ks = at(L + lv0 + j);
      buy[j] = b[kb];
      sell[j] = b[ks];
      b[kb] = (bin_t)0;
      b[ks] = (bin_t)0;
    }
  }
};

// A market cluster's bins: each CTA bins its own agents into its own
// shared memory, and after the cluster barrier each thread sums its levels
// over the C CTAs through distributed shared memory (ints: the order of
// the sum changes no bit). Two buffers of 2L, by step parity, so one
// barrier a step is enough: after step s's barrier every peer has read
// the buffer of step s - 1, and a thread resets its levels of it there.
struct ClusterBins {
  static constexpr bool kCluster = true;
  bin_t* b;
  int L2, rank, ranks;

  __device__ __forceinline__ void init(const Team& tm, int* area, int L) {
    b = reinterpret_cast<bin_t*>(area);
    L2 = 2 * L;
    rank = cluster_rank();
    ranks = cluster_ctas();
    for (int k = tm.t; k < 2 * L2; k += tm.T) b[k] = (bin_t)0;
  }
  // CTA rank r handles the agents a ≡ r·T + t (mod C·T).
  __device__ __forceinline__ AgentSpan span(const Team& tm) const {
    return AgentSpan{rank * tm.T + tm.t, ranks * tm.T};
  }
  __device__ __forceinline__ bin_t* at(int step) const {
    return b + (step & 1) * L2;
  }
  __device__ __forceinline__ void add(int step, int bin, int q) const {
    atomicAdd(at(step) + bin, (bin_t)q);
  }
  // Every CTA of the cluster has binned this step, and its bins are
  // visible to the peers.
  __device__ __forceinline__ void sync(const Team&) const { cluster_sync(); }
  // L is a multiple of 4, so a thread owns four levels or none: one int4
  // a side and CTA.
  __device__ __forceinline__ void take(const Team&, int step, int lv0, int L,
                                       bin_t* buy, bin_t* sell) const {
    static_assert(LEVELS_PER_LANE == 4, "one int4 a side");
    int4 tb = make_int4(0, 0, 0, 0), ts = tb;
    if (lv0 < L) {
      const bin_t* cur = at(step);
#pragma unroll 8
      for (int r = 0; r < ranks; ++r) {
        const int4 pb = *cluster_peer(
            reinterpret_cast<const int4*>(cur + lv0), r);
        const int4 ps = *cluster_peer(
            reinterpret_cast<const int4*>(cur + L + lv0), r);
        tb.x += pb.x; tb.y += pb.y; tb.z += pb.z; tb.w += pb.w;
        ts.x += ps.x; ts.y += ps.y; ts.z += ps.z; ts.w += ps.w;
      }
      bin_t* prev = at(step + 1);
      *reinterpret_cast<int4*>(prev + lv0) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(prev + L + lv0) = make_int4(0, 0, 0, 0);
    }
    buy[0] = tb.x; buy[1] = tb.y; buy[2] = tb.z; buy[3] = tb.w;
    sell[0] = ts.x; sell[1] = ts.y; sell[2] = ts.z; sell[3] = ts.w;
  }
  __device__ __forceinline__ bool leader() const { return rank == 0; }
  // No CTA leaves (and frees its shared memory) while a peer may read it.
  __device__ __forceinline__ void finish() const { cluster_sync(); }
};

// One agent's order at this step: returns its quantity (0: none) and sets
// `bin` (buy bins [0, L), sell bins [L, 2L)).
__device__ __forceinline__ int agent_order(
    const MarketRow& p, int a, uint32_t key, int type, int step, float mid,
    float pmid, float imb, float peer, int L, int& bin) {
  const float top = (float)(L - 1);
  const uint32_t prefix = mix32(key + (uint32_t)step * K_STEP);
  const float u_side = channel_uniform(prefix, 0);
  const float u_price = channel_uniform(prefix, 1);
  const float u_mkt = channel_uniform(prefix, 2);
  const float u_qty = channel_uniform(prefix, 3);
  const float u_shock = channel_uniform(prefix, 4);

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
  bin = side ? price : L + price;
  return (int)qty;
}

// Steps 8 and 9 of market_step for a lane of LPL > 4 levels, all inside
// the book, given `after` (the later lanes' demand) and `supply` (the
// supply of the earlier lanes and this one's). The running sums are not
// held: walking down from the lane's top level, the cumulative demand at
// level j is `after` plus the lane's bids at j and above, and the
// cumulative supply is `supply` less its asks above j; the second walk
// recomputes them for the residual books. Every term is an integer-valued
// float below 2^24, so each is the reference's cumulative sum bit for bit.
// Leaves the team's volume and clearing tick in every thread.
template <int LPL>
__device__ __forceinline__ void wide_clear(const Team& tm, Book<LPL>& bk,
                                           int L, float after, float supply,
                                           float& volume, int& p_star) {
  const int lv0 = tm.t * LPL;

  // 8. Executable volume and the clearing tick.
  float dc = after, sc = supply;
#pragma unroll
  for (int j = LPL - 1; j >= 0; --j) {
    dc += bk.bid[j];
    const float v = fminf(dc, sc);
    if (beats(v, lv0 + j, volume, p_star)) {
      volume = v;
      p_star = lv0 + j;
    }
    sc -= bk.ask[j];
  }
  team_argmax(tm, L, volume, p_star);

  // 9. Priority allocation and the residual books: the demand strictly
  // above level j and the supply strictly below it.
  float above = after, below = supply;
#pragma unroll
  for (int j = LPL - 1; j >= 0; --j) {
    const float tb = bk.bid[j], ta = bk.ask[j];
    below -= ta;
    const float traded_b = fminf(tb, fmaxf(0.f, volume - above));
    const float traded_s = fminf(ta, fmaxf(0.f, volume - below));
    bk.bid[j] = tb - traded_b;
    bk.ask[j] = ta - traded_s;
    above += tb;
  }
}

// One step of simulate_step for the team's market at absolute `step`, on
// the books in `bk` and the team's `bins` (a CtaBins, SwizzledBins or
// ClusterBins, zero where this step bins on entry). `peer` is the
// arbitrageurs' peer mid; `eb`/`ea` are the market's external order rows
// (null: none). Advances `last` and `pmid` and leaves the step's mid and
// cleared volume in every thread of the team.
template <int LPL, class Agents, class Bins>
__device__ __forceinline__ void market_step(
    const Team& tm, Book<LPL>& bk, const Bins& bins, const MarketRow& p,
    const Agents& agents, const float* eb, const float* ea, float peer,
    int step, int A, int L, float& last, float& pmid, float& mid_out,
    float& volume_out) {
  // A lane of more than four levels exists only where L = LPL·T, so every
  // one of its levels lies inside the book.
  constexpr bool kFull = LPL > LEVELS_PER_LANE;
  const int lv0 = tm.t * LPL;

  // 1. Scenario shock: withdraw a fraction of every resting bid level.
  if (step == p.shock_step) {
#pragma unroll
    for (int j = 0; j < LPL; ++j) {
      const float v = bk.bid[j];
      if (kFull || lv0 + j < L) bk.bid[j] = v - floorf(v * p.shock_cancel);
    }
  }

  // 2-4. Best quotes, book sums, imbalance.
  int bb = -1, ba = L;
  float sb = 0.f, sa = 0.f;
#pragma unroll
  for (int j = 0; j < LPL; ++j) {
    if (kFull || lv0 + j < L) {
      sb += bk.bid[j];
      sa += bk.ask[j];
      if (bk.bid[j] > 0.f) bb = lv0 + j;
      if (bk.ask[j] > 0.f && ba == L) ba = lv0 + j;
    }
  }
  team_quotes(tm, L, bb, ba, sb, sa);
  const float mid = (bb >= 0 && ba < L) ? (float)(bb + ba) * 0.5f : last;
  const float depth = sb + sa;
  const float imb = depth > 0.f ? __fdiv_rn(sb - sa, depth) : 0.f;

  // 5. Agents: draw, decide on the own archetype, bin with atomicAdd. The
  // warp sees its lanes' bin resets first; a several-warp team saw the
  // other warps' at the reductions' barriers.
  __syncwarp();
  agents.each(tm, bins.span(tm), A, [&](int a, uint32_t key, int type) {
    int bin;
    const int q = agent_order(p, a, key, type, step, mid, pmid, imb, peer, L,
                              bin);
    if (q != 0) bins.add(step, bin, q);
  });
  bins.sync(tm);

  // 6. Totals over resting + incoming flow (+ external orders), in place,
  // four levels at a time; the bins are reset for a later step. A wide
  // lane adds the external orders first, in a pass of their own (exact
  // integers: the same bits); with the bins' pass free of their branches
  // kernel 1 took 4% less time at L = 1024.
  float lb = 0.f, la = 0.f;
  if constexpr (kFull) {
    if (eb != nullptr) {
#pragma unroll
      for (int j = 0; j < LPL; ++j) bk.bid[j] += eb[lv0 + j];
    }
    if (ea != nullptr) {
#pragma unroll
      for (int j = 0; j < LPL; ++j) bk.ask[j] += ea[lv0 + j];
    }
  }
#pragma unroll
  for (int g = 0; g < LPL; g += LEVELS_PER_LANE) {
    bin_t inb[LEVELS_PER_LANE], ina[LEVELS_PER_LANE];
    bins.take(tm, step, lv0 + g, L, inb, ina);
#pragma unroll
    for (int j = 0; j < LEVELS_PER_LANE; ++j) {
      const int lv = lv0 + g + j;
      if (kFull || lv < L) {
        float tb = bk.bid[g + j] + (float)inb[j];
        float ta = bk.ask[g + j] + (float)ina[j];
        if (!kFull && eb != nullptr) tb += eb[lv];
        if (!kFull && ea != nullptr) ta += ea[lv];
        bk.bid[g + j] = tb;
        bk.ask[g + j] = ta;
        lb += tb;
        la += ta;
      }
    }
  }

  // 7. Raking scans: cumulative demand (suffix) and supply (prefix).
  float after, before;
  team_scan_offsets(tm, lb, la, after, before);
  float volume = -1.f;
  int p_star = L;
  if constexpr (kFull) {
    wide_clear(tm, bk, L, after, before + la, volume, p_star);
  } else {
    float dc[LEVELS_PER_LANE], sc[LEVELS_PER_LANE];
#pragma unroll
    for (int j = LEVELS_PER_LANE - 1; j >= 0; --j) {
      after += bk.bid[j];
      dc[j] = after;
    }
#pragma unroll
    for (int j = 0; j < LEVELS_PER_LANE; ++j) {
      before += bk.ask[j];
      sc[j] = before;
    }

    // 8. Executable volume and the clearing tick.
#pragma unroll
    for (int j = 0; j < LEVELS_PER_LANE; ++j) {
      const float v = fminf(dc[j], sc[j]);
      if (lv0 + j < L && beats(v, lv0 + j, volume, p_star)) {
        volume = v;
        p_star = lv0 + j;
      }
    }
    team_argmax(tm, L, volume, p_star);

    // 9. Priority allocation and the residual books.
#pragma unroll
    for (int j = 0; j < LEVELS_PER_LANE; ++j) {
      if (lv0 + j < L) {
        const float tb = bk.bid[j], ta = bk.ask[j];
        const float traded_b = fminf(tb, fmaxf(0.f, volume - (dc[j] - tb)));
        const float traded_s = fminf(ta, fmaxf(0.f, volume - (sc[j] - ta)));
        bk.bid[j] = tb - traded_b;
        bk.ask[j] = ta - traded_s;
      }
    }
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

// ---------------------------------------------------------------------------
// The kernels' operands and bodies.

// Operands of every clearing kernel. A chunk call fills all of them; the
// legacy one-shot entries leave market_ids, ext_*, peer_mid, stats_* and
// mid_path null and read one params row (params_stride 0).
struct ChunkArgs {
  const int* market_ids;  // null: the row is the market id
  const float* bid;
  const float* ask;
  const float* last;
  const float* pmid;
  const float* ext_buy;   // null: no external orders
  const float* ext_ask;
  const float* peer_mid;  // null: the market's own previous mid, each step
  const float* fparams;
  const int* iparams;
  int params_stride;      // 1: a row per market; 0: one row for all
  const float* stats_in;  // non-null exactly in stats_only mode
  float* bid_out;
  float* ask_out;
  float* last_out;
  float* pmid_out;
  float* price_path;      // [M, chunk]
  float* volume_path;
  float* mid_path;        // null: not written
  float* stats_out;
  int M, A, L, chunk, step0, n_valid;
  uint32_t seed;
  int warps_per_market, markets_per_cta;
  int ctas_per_market;    // 1, or the CTAs of a market cluster
};

// What a team reads at entry: its market's row, id and books.
struct MarketIn {
  int m;          // the row
  size_t row;     // m · L
  MarketRow p;
  uint32_t market;
};

__device__ __forceinline__ MarketIn market_in(const ChunkArgs& g, int m) {
  MarketIn in;
  in.m = m;
  in.row = (size_t)m * g.L;
  const size_t r = (size_t)m * g.params_stride;
  in.p = load_row(g.fparams + r * NUM_FLOAT_COLS,
                  g.iparams + r * NUM_INT_COLS);
  in.market = g.market_ids != nullptr ? (uint32_t)g.market_ids[m]
                                      : (uint32_t)m;
  return in;
}

template <int LPL>
__device__ __forceinline__ void load_book(const Team& tm, Book<LPL>& bk,
                                          const float* bid, const float* ask,
                                          int L) {
#pragma unroll
  for (int j = 0; j < LPL; ++j) {
    const int lv = tm.t * LPL + j;
    bk.bid[j] = lv < L ? bid[lv] : 0.f;
    bk.ask[j] = lv < L ? ask[lv] : 0.f;
  }
}

template <int LPL>
__device__ __forceinline__ void store_book(const Team& tm,
                                           const Book<LPL>& bk, float* bid,
                                           float* ask, int L) {
#pragma unroll
  for (int j = 0; j < LPL; ++j) {
    const int lv = tm.t * LPL + j;
    if (lv < L) { bid[lv] = bk.bid[j]; ask[lv] = bk.ask[j]; }
  }
}

// The persistent body (kernels 1 and 3): up to `chunk` steps with the books
// in registers, LPL levels a lane, the step-invariant agent keys and types
// computed once (or, fresh, at every step), and the per-step outputs
// buffered in warp 0 (lane s mod 32 holds step s) and written 32 steps at a
// time. With ClusterBins the CTAs of a cluster of C = g.ctas_per_market
// clear one market, each holding its own agents' keys and types, and rank
// 0 writes its outputs.
template <class Agents, class Bins, int LPL = LEVELS_PER_LANE>
__device__ __forceinline__ void persistent_market(const ChunkArgs& g) {
  const Team tm = make_team(g.warps_per_market);
  const int C = Bins::kCluster ? g.ctas_per_market : 1;
  const int m = Bins::kCluster
                    ? (int)blockIdx.x / C
                    : (int)blockIdx.x * g.markets_per_cta + tm.slot;
  // The ragged last CTA: a team past M leaves. Teams share a CTA only when
  // each is one warp, and those never cross __syncthreads(). A cluster is
  // one market, so none is ragged.
  if (m >= g.M) return;
  const int L = g.L, A = g.A;
  int* area = kc_smem + tm.slot * team_smem_words(L, A, tm.T, C,
                                                  Agents::kSmem);
  const MarketIn in = market_in(g, m);
  Book<LPL> bk;
  load_book(tm, bk, g.bid + in.row, g.ask + in.row, L);
  Bins bins;
  bins.init(tm, area, L);
  const bool writes = bins.leader();
  Agents agents;
  agents.init(tm, bins.span(tm), in.p, g.seed ^ SEED_GOLDEN, in.market, A,
              agent_slots(A, tm.T, C),
              area + team_smem_words(L, A, tm.T, C, false));
  float last = g.last[m];
  float pmid = g.pmid[m];
  const float peer0 = g.peer_mid != nullptr ? g.peer_mid[m] : 0.f;
  const bool stats = g.stats_in != nullptr;
  float st[NUM_STATS];
  if (stats) {
    for (int k = 0; k < NUM_STATS; ++k) st[k] = g.stats_in[(size_t)m * NUM_STATS + k];
  }
  float kp = 0.f, kv = 0.f, km = 0.f;  // the buffered path entries

  for (int s = 0; s < g.n_valid; ++s) {
    const bool first = s == 0;
    // The chunk's peer is frozen at entry; the legacy one is the own mid.
    const float peer = g.peer_mid != nullptr ? peer0 : pmid;
    float mid, volume;
    market_step(tm, bk, bins, in.p, agents,
                first && g.ext_buy != nullptr ? g.ext_buy + in.row : nullptr,
                first && g.ext_ask != nullptr ? g.ext_ask + in.row : nullptr,
                peer, g.step0 + s, A, L, last, pmid, mid, volume);
    if (stats) {
      stats_update(st, mid, volume);
      continue;
    }
    const int lane_s = s & 31;
    if (tm.lane == lane_s) { kp = last; kv = volume; km = mid; }
    if ((lane_s == 31 || s == g.n_valid - 1) && writes && tm.warp == 0 &&
        tm.lane <= lane_s) {
      const size_t o = (size_t)m * g.chunk + (s - lane_s) + tm.lane;
      g.price_path[o] = kp;
      g.volume_path[o] = kv;
      if (g.mid_path != nullptr) g.mid_path[o] = km;
    }
  }

  if (writes) {
    store_book(tm, bk, g.bid_out + in.row, g.ask_out + in.row, L);
    if (tm.t == 0) {
      g.last_out[m] = last;
      g.pmid_out[m] = pmid;
      if (stats) {
        for (int k = 0; k < NUM_STATS; ++k) g.stats_out[(size_t)m * NUM_STATS + k] = st[k];
      }
    }
  }
  bins.finish();
}

// The per-step body (kernels 2 and 4): step step0 + s from the state in
// device memory back to device memory. Nothing persists, so the agents'
// keys and types are recomputed here at every launch. With ClusterBins the
// CTAs of a cluster of C = g.ctas_per_market clear one market, as in
// persistent_market: each loads the market's books, bins its own agents,
// sums the cluster's bins through distributed shared memory, and rank 0
// writes the outputs. ClusterBins keeps its second parity buffer, which a
// single step only resets: one shared-memory layout for every cluster.
template <class Bins>
__device__ __forceinline__ void one_step_market(const ChunkArgs& g, int s) {
  const Team tm = make_team(g.warps_per_market);
  const int C = Bins::kCluster ? g.ctas_per_market : 1;
  const int m = Bins::kCluster
                    ? (int)blockIdx.x / C
                    : (int)blockIdx.x * g.markets_per_cta + tm.slot;
  if (m >= g.M) return;  // the ragged last CTA; a cluster is never ragged
  const int L = g.L, A = g.A;
  const MarketIn in = market_in(g, m);
  Book<> bk;
  load_book(tm, bk, g.bid + in.row, g.ask + in.row, L);
  Bins bins;
  bins.init(tm, kc_smem + tm.slot * team_smem_words(L, A, tm.T, C, false),
            L);
  FreshAgents agents;
  agents.init(tm, bins.span(tm), in.p, g.seed ^ SEED_GOLDEN, in.market, A,
              A, nullptr);
  float last = g.last[m];
  float pmid = g.pmid[m];
  const float peer = g.peer_mid != nullptr ? g.peer_mid[m] : pmid;
  float mid, volume;
  market_step(tm, bk, bins, in.p, agents,
              g.ext_buy != nullptr ? g.ext_buy + in.row : nullptr,
              g.ext_ask != nullptr ? g.ext_ask + in.row : nullptr, peer,
              g.step0 + s, A, L, last, pmid, mid, volume);

  if (bins.leader()) {
    store_book(tm, bk, g.bid_out + in.row, g.ask_out + in.row, L);
    if (tm.t == 0) {
      g.last_out[m] = last;
      g.pmid_out[m] = pmid;
      if (g.stats_in != nullptr) {
        float st[NUM_STATS];
        for (int k = 0; k < NUM_STATS; ++k) st[k] = g.stats_in[(size_t)m * NUM_STATS + k];
        stats_update(st, mid, volume);
        for (int k = 0; k < NUM_STATS; ++k) g.stats_out[(size_t)m * NUM_STATS + k] = st[k];
      } else {
        const size_t o = (size_t)m * g.chunk + s;
        g.price_path[o] = last;
        g.volume_path[o] = volume;
        if (g.mid_path != nullptr) g.mid_path[o] = mid;
      }
    }
  }
  bins.finish();
}

// The launch of `g`'s shape: grid (a cluster's CTAs side by side), CTA
// threads.
static inline dim3 grid_of(const ChunkArgs& g) {
  return dim3((unsigned)((g.M + g.markets_per_cta - 1) / g.markets_per_cta *
                         g.ctas_per_market));
}
static inline dim3 cta_of(const ChunkArgs& g) {
  return dim3((unsigned)(32 * g.warps_per_market * g.markets_per_cta));
}

extern "C" {

const char* kc_float_cols() { return KC_FLOAT_COLS; }
const char* kc_int_cols() { return KC_INT_COLS; }
const char* kc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
