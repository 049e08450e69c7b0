"""Agent archetypes (paper §III-C) and ``decide`` on torch tensors.

Every archetype is evaluated on the full ``[M, A]`` lattice and selected
per agent by the per-market type lattice; the masks are disjoint, so the
value at each agent is exactly its own archetype's output. The CUDA kernel
evaluates only each agent's own archetype, which gives the same values.

All five RNG channels are drawn every step for every agent (the fixed
five-channel draw schedule). All float math is float32, one rounding per
operation, in the order the JAX package writes it.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple

import torch

from repro_torch.core import params as params_mod
from repro_torch.core import rng
from repro_torch.core.config import (ARBITRAGEUR, CH_MKT, CH_PRICE, CH_QTY,
                                     CH_SHOCK, CH_SIDE, FUNDAMENTALIST, HFT,
                                     INFORMED, MAKER, MOMENTUM, NOISE, WHALE)
from repro_torch.core.params import MarketParams


class ArchetypeContext(NamedTuple):
    """Per-step inputs every archetype sees (all ``[M, A]``-broadcastable)."""

    params: MarketParams      # per-market [M, 1] torch columns
    mid: torch.Tensor         # float32[M, 1] current mid price
    prev_mid: torch.Tensor    # float32[M, 1] previous step's mid price
    step_i: int               # absolute step index
    agent_ids: torch.Tensor   # int32[1, A]
    u_side: torch.Tensor      # float32[M, A]
    u_price: torch.Tensor     # float32[M, A]
    imbalance: torch.Tensor   # float32[M, 1] resting-book imbalance
    peer_mid: torch.Tensor    # float32[M, 1] coupled peer's frozen mid
    num_levels: int


def _pm(side_buy: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    """``mid ± 1`` by side."""
    return mid + torch.where(side_buy, 1.0, -1.0).to(torch.float32)


def _toward(target_gap, ctx: ArchetypeContext, kappa):
    """Side toward a gap (random at zero), quoting ``mid + gap·κ + jitter``."""
    side_buy = torch.where(target_gap != 0.0, target_gap > 0.0,
                           ctx.u_side < 0.5)
    jitter = ctx.u_price * 2.0 - 1.0
    return side_buy, ctx.mid + target_gap * kappa + jitter


def _noise(ctx: ArchetypeContext):
    eta = (ctx.u_price * 2.0 - 1.0) * ctx.params.noise_delta
    return ctx.u_side < 0.5, ctx.mid + eta


def _momentum(ctx: ArchetypeContext):
    ret = torch.sign(ctx.mid - ctx.prev_mid)
    side_buy = torch.where(ret != 0.0, ret > 0.0, ctx.u_side < 0.5)
    return side_buy, _pm(side_buy, ctx.mid)


def _maker(ctx: ArchetypeContext):
    side_buy = ((ctx.agent_ids + ctx.step_i) % 2) == 0
    half = ctx.params.maker_half_spread
    return side_buy, torch.where(side_buy, ctx.mid - half, ctx.mid + half)


def _fundamentalist(ctx: ArchetypeContext):
    return _toward(ctx.params.fundamental - ctx.mid, ctx,
                   ctx.params.fundamentalist_kappa)


def _whale(ctx: ArchetypeContext):
    side_buy = ctx.u_side < 0.5
    L = ctx.num_levels
    return side_buy, torch.where(side_buy, float(L - 1), 0.0).to(torch.float32)


def _hft(ctx: ArchetypeContext):
    imb = ctx.imbalance
    side_buy = torch.where(imb.abs() > ctx.params.hft_threshold, imb > 0.0,
                           ctx.u_side < 0.5)
    return side_buy, _pm(side_buy, ctx.mid)


def _informed(ctx: ArchetypeContext):
    shock_step = ctx.params.shock_step
    window = ((shock_step >= 0)
              & (ctx.step_i >= shock_step - ctx.params.informed_horizon)
              & (ctx.step_i < shock_step))
    calm_price = ctx.mid + (ctx.u_price * 2.0 - 1.0)
    side_buy = ~window & (ctx.u_side < 0.5)
    return side_buy, torch.where(window, 0.0, calm_price)


def _arbitrageur(ctx: ArchetypeContext):
    return _toward(ctx.peer_mid - ctx.mid, ctx, ctx.params.arb_kappa)


#: type_id -> fn(ctx) -> (side_buy, price_f), folded in id order. The
#: kernels hard-code these eight, so there is no ``register_archetype``.
ARCHETYPES: Dict[int, Callable] = {
    NOISE: _noise, MOMENTUM: _momentum, MAKER: _maker,
    FUNDAMENTALIST: _fundamentalist, WHALE: _whale, HFT: _hft,
    INFORMED: _informed, ARBITRAGEUR: _arbitrageur,
}


def archetype_names() -> Dict[int, str]:
    """{type_id: name} of the archetypes, in id order."""
    return {NOISE: "noise", MOMENTUM: "momentum", MAKER: "maker",
            FUNDAMENTALIST: "fundamentalist", WHALE: "whale", HFT: "hft",
            INFORMED: "informed", ARBITRAGEUR: "arbitrageur"}


def decide(cfg, params: MarketParams, mid, prev_mid, step: int, market_ids,
           atype=None, seed=None, imbalance=None, peer_mid=None,
           uniform_fn=None, agent_ids=None):
    """Vectorized agent decisions for one step.

    ``cfg`` supplies ``num_agents``, ``num_levels`` and the RNG ``seed``;
    ``params`` holds per-market ``[M, 1]`` torch columns; ``market_ids`` the
    int32[M, 1] global market indices of the RNG coordinate. ``imbalance``
    (``None`` → 0) feeds HFTs; ``peer_mid`` (``None`` → ``prev_mid``) feeds
    arbitrageurs. ``uniform_fn(gid, step, channel) -> float32[M, A]`` (on
    ``gid``'s device) replaces the counter stream (the ``numpy-splitmix64`` and
    ``numpy-pcg64`` reference backends); it is called once per channel in
    the fixed order side, price, marketable, quantity, shock, and ``seed``
    is then ignored. ``None`` keeps the counter stream the kernels draw.
    ``agent_ids`` (int32 ``[A]`` or ``[1, A]``, the agents' indices within a
    market) defaults to ``arange(A)``, the ids the kernels hard-code.

    Returns side_buy bool[M, A], price int32[M, A], qty float32[M, A].
    """
    A, L = cfg.num_agents, cfg.num_levels
    device = mid.device
    seed = cfg.seed if seed is None else seed
    step = int(step)
    if agent_ids is None:
        agent_ids = torch.arange(A, dtype=torch.int32, device=device)
    agent_ids = torch.as_tensor(agent_ids, dtype=torch.int32,
                                device=device).reshape(1, -1)
    gid = market_ids.reshape(-1, 1).to(torch.int64) * A + agent_ids
    if uniform_fn is None:
        def uniform_fn(gid, step, channel):
            return rng.uniform32(seed, gid, step, channel)
    # A list, not a generator: a stateful stream must be drawn in this order.
    u_side, u_price, u_mkt, u_qty, u_shock = [
        uniform_fn(gid, step, ch)
        for ch in (CH_SIDE, CH_PRICE, CH_MKT, CH_QTY, CH_SHOCK)]

    if atype is None:
        atype = params_mod.agent_types(params, A, device)
    imbalance = torch.zeros_like(mid) if imbalance is None else imbalance
    peer_mid = prev_mid if peer_mid is None else peer_mid
    ctx = ArchetypeContext(params=params, mid=mid, prev_mid=prev_mid,
                           step_i=step, agent_ids=agent_ids, u_side=u_side,
                           u_price=u_price, imbalance=imbalance,
                           peer_mid=peer_mid, num_levels=L)

    shape = u_side.shape
    side_buy = price_f = None
    for tid in sorted(ARCHETYPES):
        s, p = ARCHETYPES[tid](ctx)
        s, p = s.expand(shape), p.expand(shape)
        if side_buy is None:
            side_buy, price_f = s, p
        else:
            mask = atype == tid
            side_buy = torch.where(mask, s, side_buy)
            price_f = torch.where(mask, p, price_f)

    not_maker = atype != MAKER
    edge = torch.where(side_buy, float(L - 1), 0.0).to(torch.float32)
    marketable = (u_mkt < params.p_marketable) & not_maker
    price_f = torch.where(marketable, edge, price_f)

    # Flash-crash panic: panicking non-makers sell marketably.
    panic = ((u_shock < params.shock_intensity) & not_maker
             & (params.shock_step == step))
    side_buy = side_buy & ~panic
    price_f = torch.where(panic, 0.0, price_f)

    price = torch.clamp(torch.round(price_f), 0.0, float(L - 1)).to(torch.int32)
    qty = 1.0 + torch.floor(u_qty * params.q_max)

    # Whale cadence: whale_size lots on sweep steps, zero lots otherwise.
    period = torch.clamp(params.whale_period, min=1)
    at_sweep = (step % period) == 0
    wq = torch.where(at_sweep, params.whale_size, 0.0)
    qty = torch.where(atype == WHALE, wq, qty)
    return side_buy, price, qty
