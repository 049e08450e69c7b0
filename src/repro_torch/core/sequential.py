"""Sequential-clearing reference mechanism (Steinbacher et al.) on torch
tensors.

The engine clears each step as one uniform-price call auction over the
aggregate order flow (:mod:`repro_torch.core.auction`). The classical ABM
literature instead matches orders one agent at a time against the resting
book; this module is that reference, used to quantify the gap:

  * identical agent decisions: the same :func:`repro_torch.core.agents.decide`
    draws on the fixed five-channel schedule, so a trajectory difference is
    the clearing mechanism's alone;
  * order-by-order immediate matching in agent-index order, vectorized over
    the market axis: a buy at limit ``p`` fills against resting asks at
    levels ``<= p`` (lowest first), the residual rests at ``p``; sells are
    symmetric against resting bids (highest first);
  * exact-integer f32 arithmetic throughout (cumsum/min/clip of integer
    masses), so it equals the JAX package's sequential reference bit for
    bit.

It runs on the ``numpy`` backend family with ``clearing="sequential"`` and
in :func:`repro_torch.kernels.ref.simulate_reference_sequential`; no kernel
has a sequential mode.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import agents
from repro_torch.core import params as params_mod
from repro_torch.core.params import MarketParams
from repro_torch.core.step import MarketState, StepOutput, quote_phase


def match_order(bid, ask, exec_price, side_buy, price, qty):
    """Match ONE order per market against the resting books, immediately.

    ``side_buy`` bool[M, 1], ``price`` int32[M, 1] (limit level), ``qty``
    f32[M, 1] (integer-valued lots); ``bid``/``ask`` the resting f32[M, L]
    books. Returns ``(bid, ask, fill, exec_price)``: ``fill`` is the executed
    quantity and ``exec_price`` the marginal executed level (the previous
    value where nothing traded). Both sides are evaluated and selected by
    the side mask, as in the JAX package.
    """
    L = bid.shape[-1]
    levels = torch.arange(L, dtype=torch.int32, device=bid.device)[None, :]
    onehot = (levels == price).to(torch.float32)     # [M, L] at the limit
    idx = price.to(torch.int64)

    # Buy: sweep asks at levels <= p, lowest first.
    s_cum = torch.cumsum(ask, dim=-1)                # prefix supply
    fill_b = torch.minimum(qty, torch.gather(s_cum, 1, idx))
    below = s_cum - ask                              # supply strictly below l
    traded_a = torch.minimum(torch.clamp(fill_b - below, min=0.0), ask)
    bid_buy = bid + onehot * (qty - fill_b)          # residual rests at p
    ask_buy = ask - traded_a
    lvl_b = torch.where(traded_a > 0.0, levels, -1).amax(
        dim=-1, keepdim=True)                        # marginal (highest) level

    # Sell: sweep bids at levels >= p, highest first.
    d_cum = torch.flip(torch.cumsum(torch.flip(bid, (-1,)), dim=-1), (-1,))
    fill_s = torch.minimum(qty, torch.gather(d_cum, 1, idx))
    above = d_cum - bid                              # demand strictly above l
    traded_b = torch.minimum(torch.clamp(fill_s - above, min=0.0), bid)
    bid_sell = bid - traded_b
    ask_sell = ask + onehot * (qty - fill_s)
    lvl_s = torch.where(traded_b > 0.0, levels, L).amin(
        dim=-1, keepdim=True)                        # marginal (lowest) level

    new_bid = torch.where(side_buy, bid_buy, bid_sell)
    new_ask = torch.where(side_buy, ask_buy, ask_sell)
    fill = torch.where(side_buy, fill_b, fill_s)
    lvl = torch.where(side_buy, lvl_b, lvl_s)
    exec_price = torch.where(fill > 0.0, lvl.to(torch.float32), exec_price)
    return new_bid, new_ask, fill, exec_price


def simulate_step_sequential(cfg, state: MarketState, step_idx: int,
                             market_ids, uniform_fn=None,
                             params: Optional[MarketParams] = None,
                             atype=None, seed=None, peer_mid=None):
    """Advance all markets one step under sequential clearing.

    The prelude (shock overlay, mid, imbalance) and the ``decide`` call are
    :func:`repro_torch.core.step.simulate_step`'s; the call auction is
    replaced by the agent-ordered matching loop. The reported price is the
    marginal level of the last executing order, falling back to the
    previous last price on no-trade steps.
    """
    if params is None:
        params = params_mod.scalar_params(cfg, state.bid.device)
    step_idx = int(step_idx)
    bid, mid, imbalance = quote_phase(params, state, step_idx)
    side_buy, price, qty = agents.decide(
        cfg, params, mid, state.prev_mid, step_idx, market_ids, atype=atype,
        seed=seed, imbalance=imbalance, peer_mid=peer_mid,
        uniform_fn=uniform_fn)

    ask = state.ask
    volume = torch.zeros_like(mid)
    exec_price = state.last_price + torch.zeros_like(mid)
    for a in range(cfg.num_agents):
        bid, ask, fill, exec_price = match_order(
            bid, ask, exec_price, side_buy[:, a:a + 1], price[:, a:a + 1],
            qty[:, a:a + 1])
        volume = volume + fill

    new_last = torch.where(volume > 0.0, exec_price, state.last_price)
    new_state = MarketState(bid=bid, ask=ask, last_price=new_last,
                            prev_mid=mid)
    return new_state, StepOutput(price=new_last, volume=volume, mid=mid)
