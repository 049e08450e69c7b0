"""Agent archetypes (paper §III-C) and ``decide`` in NumPy.

Every archetype is evaluated on the full ``[M, A]`` lattice and selected
per agent by the per-market type lattice (makers first, then momentum,
fundamentalists, whales, HFTs, informed traders, arbitrageurs, then noise,
by agent index); the masks are disjoint, so the value at each agent is
exactly its own archetype's output. The dispatch is fixed over the eight
archetypes, as the CUDA kernel's is.

All five RNG channels are drawn every step, in the order side, price,
marketable, quantity, shock: the stateful PCG64 stream depends on it. The
counter stream skips the shock channel where every market's shock
intensity is zero, and an archetype whose count column is all zero is not
evaluated; both are invisible in the values.

All float math is float32, every constant cast through ``np.float32``, so
no operation promotes to float64.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import numpy as np

from repro_torch.core.host import rng

# Strategy-class ids and RNG channels (``repro_torch.core.config``'s).
NOISE = 0
MOMENTUM = 1
MAKER = 2
FUNDAMENTALIST = 3
WHALE = 4
HFT = 5
INFORMED = 6
ARBITRAGEUR = 7
CH_SIDE = 0
CH_PRICE = 1
CH_MKT = 2
CH_QTY = 3
CH_SHOCK = 4


def assign_agent_types(num_agents: int, num_makers, num_momentum,
                       num_fundamentalists, num_whales=0, num_hft=0,
                       num_informed=0, num_arbitrageurs=0):
    """int32 strategy-class lattice broadcastable to [M, A] from scalar
    counts (one row) or ``[M, 1]`` int32 count columns."""
    a = np.arange(num_agents, dtype=np.int32)[None, :]
    blocks = (
        (MAKER, num_makers),
        (MOMENTUM, num_momentum),
        (FUNDAMENTALIST, num_fundamentalists),
        (WHALE, num_whales),
        (HFT, num_hft),
        (INFORMED, num_informed),
        (ARBITRAGEUR, num_arbitrageurs),
    )
    # Cumulative upper bounds per block; fold highest-threshold first so
    # each earlier (smaller) block overrides the later ones.
    uppers = []
    cum = np.asarray(0, dtype=np.int32)
    for tid, count in blocks:
        cum = cum + np.asarray(count, dtype=np.int32)
        uppers.append((tid, cum))
    out = np.full_like(a, np.int32(NOISE))
    for tid, upper in reversed(uppers):
        out = np.where(a < upper, np.int32(tid), out)
    return out


def agent_types(params, num_agents: int):
    """Per-market strategy-class lattice (int32 ``[M, A]``) of ``params``,
    a host view of :class:`repro_torch.core.params.MarketParams`."""
    return assign_agent_types(num_agents, params.num_makers,
                              params.num_momentum,
                              params.num_fundamentalists,
                              params.num_whales, params.num_hft,
                              params.num_informed, params.num_arbitrageurs)


class ArchetypeContext(NamedTuple):
    """Per-step inputs every archetype sees (all ``[M, A]``-broadcastable)."""

    params: Any              # per-market [M, 1] host columns
    mid: np.ndarray          # float32[M, 1] current mid price
    prev_mid: np.ndarray     # float32[M, 1] previous step's mid price
    step_i: np.ndarray       # int32 scalar step index
    agent_ids: np.ndarray    # int32[1, A] agent indices within a market
    u_side: np.ndarray       # float32[M, A] side-channel uniforms
    u_price: np.ndarray      # float32[M, A] price-channel uniforms
    imbalance: np.ndarray    # float32[M, 1] resting-book imbalance
    peer_mid: np.ndarray     # float32[M, 1] coupled peer's frozen mid
    num_levels: int          # L


def _noise(ctx: ArchetypeContext):
    """Random side; price = mid + U[-Δ, Δ] with per-market Δ."""
    f32 = np.float32
    side_buy = ctx.u_side < f32(0.5)
    delta = np.asarray(ctx.params.noise_delta, dtype=f32)
    eta = (ctx.u_price * f32(2.0) - f32(1.0)) * delta
    return side_buy, ctx.mid + eta


def _momentum(ctx: ArchetypeContext):
    """Trend follower: side = sgn(mid_t - mid_{t-1}); price = mid ± 1."""
    f32 = np.float32
    ret = np.sign(ctx.mid - ctx.prev_mid)  # float32[M, 1]
    ret = ret + np.zeros_like(ctx.u_side)  # broadcast [M, A]
    side_buy = np.where(ret != f32(0.0), ret > f32(0.0), ctx.u_side < f32(0.5))
    price_f = ctx.mid + np.where(side_buy, f32(1.0), f32(-1.0))
    return side_buy, price_f


def _maker(ctx: ArchetypeContext):
    """Market maker: alternate on parity of (a + s); per-market half-spread."""
    f32 = np.float32
    side_buy = ((ctx.agent_ids + ctx.step_i) % np.int32(2)) == np.int32(0)
    half = np.asarray(ctx.params.maker_half_spread, dtype=f32)
    price_f = np.where(side_buy, ctx.mid - half, ctx.mid + half)
    return side_buy, price_f


def _fundamentalist(ctx: ArchetypeContext):
    """Mean reversion toward the per-market fundamental F, quoting part-way
    back (strength kappa) with a unit jitter; random side at F."""
    f32 = np.float32
    fundamental = np.asarray(ctx.params.fundamental, dtype=f32)
    dev = fundamental - ctx.mid               # float32[M, 1]
    dev = dev + np.zeros_like(ctx.u_side)     # broadcast [M, A]
    side_buy = np.where(dev != f32(0.0), dev > f32(0.0), ctx.u_side < f32(0.5))
    jitter = ctx.u_price * f32(2.0) - f32(1.0)
    kappa = np.asarray(ctx.params.fundamentalist_kappa, dtype=f32)
    price_f = ctx.mid + dev * kappa + jitter
    return side_buy, price_f


def _whale(ctx: ArchetypeContext):
    """A marketable block order on a random side; ``decide`` zeroes the
    quantity off the sweep cadence."""
    f32 = np.float32
    side_buy = ctx.u_side < f32(0.5)
    L = ctx.num_levels
    price_f = np.where(side_buy, f32(L - 1), f32(0.0)) + np.zeros_like(
        ctx.u_side)
    return side_buy, price_f


def _hft(ctx: ArchetypeContext):
    """Join the pressure side one tick through the mid when |imbalance|
    exceeds the per-market trigger; noise side below it."""
    f32 = np.float32
    imb = ctx.imbalance + np.zeros_like(ctx.u_side)  # broadcast [M, A]
    thr = np.asarray(ctx.params.hft_threshold, dtype=f32)
    side_buy = np.where(np.abs(imb) > thr, imb > f32(0.0),
                        ctx.u_side < f32(0.5))
    price_f = ctx.mid + np.where(side_buy, f32(1.0), f32(-1.0))
    return side_buy, price_f


def _informed(ctx: ArchetypeContext):
    """Sells marketably through the ``informed_horizon`` steps before
    ``shock_step``; noise-like otherwise."""
    f32 = np.float32
    shock_step = np.asarray(ctx.params.shock_step, dtype=np.int32)
    horizon = np.asarray(ctx.params.informed_horizon, dtype=np.int32)
    false_b = np.zeros_like(ctx.u_side) > f32(0.0)  # all-False [M, A]
    window = ((shock_step >= np.int32(0))
              & (ctx.step_i >= shock_step - horizon)
              & (ctx.step_i < shock_step)) | false_b
    calm_side = ctx.u_side < f32(0.5)
    calm_price = ctx.mid + (ctx.u_price * f32(2.0) - f32(1.0))
    side_buy = np.where(window, false_b, calm_side)
    price_f = np.where(window, f32(0.0), calm_price)
    return side_buy, price_f


def _arbitrageur(ctx: ArchetypeContext):
    """Chase the gap to the coupled peer's frozen mid, quoting part-way
    toward it with a unit jitter."""
    f32 = np.float32
    gap = ctx.peer_mid - ctx.mid              # float32[M, 1]
    gap = gap + np.zeros_like(ctx.u_side)     # broadcast [M, A]
    side_buy = np.where(gap != f32(0.0), gap > f32(0.0), ctx.u_side < f32(0.5))
    kappa = np.asarray(ctx.params.arb_kappa, dtype=f32)
    jitter = ctx.u_price * f32(2.0) - f32(1.0)
    price_f = ctx.mid + gap * kappa + jitter
    return side_buy, price_f


#: type_id -> fn(ctx) -> (side_buy, price_f), folded in id order.
ARCHETYPES: Dict[int, Callable] = {
    NOISE: _noise, MOMENTUM: _momentum, MAKER: _maker,
    FUNDAMENTALIST: _fundamentalist, WHALE: _whale, HFT: _hft,
    INFORMED: _informed, ARBITRAGEUR: _arbitrageur,
}


def decide(cfg, params, mid, prev_mid, step, market_ids, agent_ids,
           uniform_fn=None, atype=None, seed=None, imbalance=None,
           peer_mid=None):
    """Vectorized agent decisions for one step.

    ``cfg`` supplies ``num_agents``, ``num_levels`` and the RNG ``seed``;
    ``params`` the per-market ``[M, 1]`` host columns; ``market_ids``
    (int32[M, 1]) and ``agent_ids`` (int32[A] or [1, A]) the RNG
    coordinate. ``uniform_fn(gid, step, channel) -> float32[M, A]``
    replaces the counter stream (then ``seed`` is ignored); ``seed``
    overrides ``cfg.seed``. ``atype`` is the step-invariant type lattice
    (``None`` → :func:`agent_types`); ``imbalance`` (``None`` → 0) feeds
    HFTs and ``peer_mid`` (``None`` → ``prev_mid``) arbitrageurs.

    Returns side_buy bool[M, A], price int32[M, A], qty float32[M, A].
    """
    A = cfg.num_agents
    L = cfg.num_levels
    f32 = np.float32

    agent_ids = np.reshape(np.asarray(agent_ids, dtype=np.int32), (1, -1))
    market_ids = np.reshape(np.asarray(market_ids, dtype=np.int32), (-1, 1))
    gid = (market_ids * np.int32(A) + agent_ids).astype(np.uint32)  # [M, A]
    step_u = np.asarray(step).astype(np.uint32)

    if uniform_fn is None:
        seed = cfg.seed if seed is None else seed

        def u(channel):
            return rng.uniform32(seed, gid, step_u, channel)
    else:
        def u(channel):
            return uniform_fn(gid, step_u, channel)

    u_side = u(CH_SIDE)
    u_price = u(CH_PRICE)
    u_mkt = u(CH_MKT)
    u_qty = u(CH_QTY)
    skip_shock = uniform_fn is None and not np.asarray(
        params.shock_intensity).any()
    u_shock = None if skip_shock else u(CH_SHOCK)

    if atype is None:
        atype = agent_types(params, A)
    mid = np.asarray(mid, dtype=np.float32)
    prev_mid = np.asarray(prev_mid, dtype=np.float32)
    step_i = np.asarray(step).astype(np.int32)
    imbalance = (np.zeros_like(mid) if imbalance is None
                 else np.asarray(imbalance, dtype=np.float32))
    peer_mid = (prev_mid if peer_mid is None
                else np.asarray(peer_mid, dtype=np.float32))

    ctx = ArchetypeContext(params=params, mid=mid, prev_mid=prev_mid,
                           step_i=step_i, agent_ids=agent_ids,
                           u_side=u_side, u_price=u_price,
                           imbalance=imbalance, peer_mid=peer_mid,
                           num_levels=L)

    count_cols = {MAKER: params.num_makers, MOMENTUM: params.num_momentum,
                  FUNDAMENTALIST: params.num_fundamentalists,
                  WHALE: params.num_whales, HFT: params.num_hft,
                  INFORMED: params.num_informed,
                  ARBITRAGEUR: params.num_arbitrageurs}

    def empty(tid):
        col = count_cols.get(tid)
        return col is not None and not np.asarray(col).any()

    zero_f = np.zeros_like(u_side)
    zero_b = zero_f > f32(0.0)  # all-False bool[M, A] broadcast template
    side_buy, price_f = ARCHETYPES[NOISE](ctx)
    side_buy = side_buy | zero_b
    price_f = price_f + zero_f
    for tid in sorted(ARCHETYPES)[1:]:
        if empty(tid):
            continue
        s, p = ARCHETYPES[tid](ctx)
        mask = atype == np.int32(tid)
        side_buy = np.where(mask, s | zero_b, side_buy)
        price_f = np.where(mask, p + zero_f, price_f)

    is_maker = atype == MAKER

    # Marketable orders (never for makers): force to the grid boundary.
    p_mkt = np.asarray(params.p_marketable, dtype=f32)
    marketable = (u_mkt < p_mkt) & ~is_maker
    price_f = np.where(
        marketable,
        np.where(side_buy, f32(L - 1), f32(0.0)),
        price_f,
    )

    # Flash-crash panic: panicking non-makers sell marketably at the
    # per-market shock step.
    if u_shock is not None:
        shock_step = np.asarray(params.shock_step, dtype=np.int32)
        shock_int = np.asarray(params.shock_intensity, dtype=f32)
        at_shock = (step_i == shock_step) | zero_b
        panic = (u_shock < shock_int) & ~is_maker & at_shock
        side_buy = np.where(panic, zero_b, side_buy)
        price_f = np.where(panic, f32(0.0) + zero_f, price_f)

    # Round half to even, prune to the grid (paper §III-A).
    price = np.clip(np.round(price_f), f32(0.0), f32(L - 1)).astype(np.int32)

    # Integer quantity q = 1 + floor(u * q_max) in {1..q_max}, kept in f32.
    q_max = np.asarray(params.q_max, dtype=f32)
    qty = f32(1.0) + np.floor(u_qty * q_max)

    # Whale cadence: whale_size lots on sweep steps, zero lots otherwise.
    if not empty(WHALE):
        is_whale = (atype == np.int32(WHALE)) | zero_b
        period = np.maximum(
            np.asarray(params.whale_period, dtype=np.int32), np.int32(1))
        at_sweep = ((step_i % period) == np.int32(0)) | zero_b
        wq = np.asarray(params.whale_size, dtype=f32) + zero_f
        qty = np.where(is_whale, np.where(at_sweep, wq, zero_f), qty)
    return side_buy, price, qty
