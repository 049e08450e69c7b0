"""Sequential-clearing reference mechanism (Steinbacher et al.) in NumPy.

The same agent decisions as :func:`repro_torch.core.host.step.simulate_step`
(the identical ``decide`` call on the fixed five-channel schedule), then
order-by-order immediate matching in agent-index order, vectorized over the
market axis: a buy at limit ``p`` fills against resting asks at levels
``<= p`` (lowest first) and its residual rests at ``p``; sells are
symmetric against resting bids (highest first). Every quantity is an exact
integer in f32.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.host import agents
from repro_torch.core.host.step import MarketState, StepOutput, quote_phase


def match_order(bid, ask, exec_price, side_buy, price, qty):
    """Match ONE order per market against the resting books, immediately.

    ``side_buy`` bool[M, 1], ``price`` int32[M, 1] (limit level), ``qty``
    f32[M, 1] (integer-valued lots); ``bid``/``ask`` the resting f32[M, L]
    books. Returns ``(bid, ask, fill, exec_price)``: ``fill`` is the
    executed quantity and ``exec_price`` the marginal executed level (the
    previous value where nothing traded). Both sides are evaluated and
    selected by the side mask.
    """
    f32 = np.float32
    L = bid.shape[-1]
    levels = np.arange(L, dtype=np.int32)[None, :]
    onehot = (levels == price).astype(f32)            # [M, L] at the limit

    # Buy: sweep asks at levels <= p, lowest first.
    s_cum = np.cumsum(ask, axis=-1)                   # prefix supply
    elig_b = np.take_along_axis(s_cum, price, axis=-1)
    fill_b = np.minimum(qty, elig_b)
    below = s_cum - ask                               # supply strictly below l
    traded_a = np.clip(fill_b - below, f32(0.0), ask)
    bid_buy = bid + onehot * (qty - fill_b)           # residual rests at p
    ask_buy = ask - traded_a
    lvl_b = np.max(np.where(traded_a > f32(0.0), levels, np.int32(-1)),
                   axis=-1, keepdims=True)            # marginal (highest) level

    # Sell: sweep bids at levels >= p, highest first.
    d_cum = np.flip(np.cumsum(np.flip(bid, -1), axis=-1), -1)  # suffix demand
    elig_s = np.take_along_axis(d_cum, price, axis=-1)
    fill_s = np.minimum(qty, elig_s)
    above = d_cum - bid                               # demand strictly above l
    traded_b = np.clip(fill_s - above, f32(0.0), bid)
    bid_sell = bid - traded_b
    ask_sell = ask + onehot * (qty - fill_s)
    lvl_s = np.min(np.where(traded_b > f32(0.0), levels, np.int32(L)),
                   axis=-1, keepdims=True)            # marginal (lowest) level

    new_bid = np.where(side_buy, bid_buy, bid_sell)
    new_ask = np.where(side_buy, ask_buy, ask_sell)
    fill = np.where(side_buy, fill_b, fill_s)
    lvl = np.where(side_buy, lvl_b, lvl_s)
    exec_price = np.where(fill > f32(0.0), lvl.astype(f32), exec_price)
    return new_bid, new_ask, fill, exec_price


def simulate_step_sequential(cfg, state: MarketState, step_idx, market_ids,
                             params, uniform_fn=None, atype=None, seed=None,
                             peer_mid=None):
    """Advance all markets one step under sequential clearing.

    The shock overlay, the mid, the identical ``decide`` call, then the
    agent-ordered matching loop. Returns ``(MarketState, StepOutput)``; the
    step's price is the marginal level of the last executing order, the
    previous last price on a step without trade.
    """
    f32 = np.float32
    A = cfg.num_agents
    resting_bid, mid, imbalance = quote_phase(params, state, step_idx)

    agent_ids = np.arange(A, dtype=np.int32)
    side_buy, price, qty = agents.decide(
        cfg, params, mid, state.prev_mid, step_idx, market_ids, agent_ids,
        uniform_fn=uniform_fn, atype=atype, seed=seed,
        imbalance=imbalance, peer_mid=peer_mid,
    )

    bid, ask = resting_bid, state.ask
    volume = np.zeros_like(mid)
    exec_price = np.asarray(state.last_price, dtype=f32) + np.zeros_like(mid)
    for a in range(A):
        bid, ask, fill, exec_price = match_order(
            bid, ask, exec_price,
            side_buy[:, a:a + 1], price[:, a:a + 1], qty[:, a:a + 1])
        volume = volume + fill

    executed = volume > f32(0.0)
    new_last = np.where(executed, exec_price, state.last_price)
    new_state = MarketState(bid=bid, ask=ask, last_price=new_last,
                            prev_mid=mid)
    out = StepOutput(price=new_last, volume=volume, mid=mid)
    return new_state, out
