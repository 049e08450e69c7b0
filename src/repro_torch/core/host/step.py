"""One simulation step (paper Alg. 1 lines 5-22) in NumPy.

``simulate_step`` is the complete per-step semantics: scenario overlay ->
best quotes and book imbalance -> agent decisions -> ``np.add.at`` binning
(the paper's CPU implementation) -> clearing -> residual book update.
``params`` is a host view of :class:`repro_torch.core.params.MarketParams`:
any object with the 22 ``[M, 1]`` numpy columns as attributes.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np

from repro_torch.core.host import agents, auction


class MarketState(NamedTuple):
    bid: np.ndarray         # float32[M, L] resting bid quantities
    ask: np.ndarray         # float32[M, L] resting ask quantities
    last_price: np.ndarray  # float32[M, 1]
    prev_mid: np.ndarray    # float32[M, 1]


class StepOutput(NamedTuple):
    price: np.ndarray   # float32[M, 1] clearing price (last price if none)
    volume: np.ndarray  # float32[M, 1] transacted volume
    mid: np.ndarray     # float32[M, 1] mid price used for decisions


def seed_books(num_levels: int, quote_qty, spread):
    """(bid, ask) float32[M, L] opening books: quotes of per-market depth
    ``quote_qty`` (f32[M]) straddling L/2 at ``ceil(spread / 2)`` ticks
    (``spread`` int32[M])."""
    L = num_levels
    half = spread // 2 + spread % 2                      # int32[M]
    pb = (np.int32(L // 2) - half)[:, None]              # int32[M, 1]
    pa = (np.int32(L // 2) + half)[:, None]
    q = np.asarray(quote_qty, dtype=np.float32)[:, None] # f32[M, 1]
    levels = np.arange(L, dtype=np.int32)[None, :]
    bid = (levels == pb).astype(np.float32) * q
    ask = (levels == pa).astype(np.float32) * q
    return bid, ask


def initial_state(spec) -> MarketState:
    """Opening state of an ``EnsembleSpec`` (its per-market
    ``initial_quote_qty`` and ``initial_spread``)."""
    bid, ask = seed_books(spec.num_levels,
                          np.asarray(spec.initial_quote_qty, np.float32),
                          np.asarray(spec.initial_spread, np.int32))
    m0 = np.float32(spec.mid0)
    ones = np.ones((spec.num_markets, 1), dtype=np.float32)
    return MarketState(bid=bid, ask=ask, last_price=ones * m0,
                       prev_mid=ones * m0)


def bin_orders_scatter(side_buy, price, qty, M, L):
    """Order aggregation with ``np.add.at``; every bin sum is an
    integer-valued float32 below 2**24, so the order of the adds is
    invisible."""
    buy = np.zeros((M, L), dtype=np.float32)
    sell = np.zeros((M, L), dtype=np.float32)
    m_idx = np.broadcast_to(np.arange(M)[:, None], price.shape)
    qb = (qty * side_buy.astype(np.float32)).astype(np.float32)
    qs = (qty * (~side_buy).astype(np.float32)).astype(np.float32)
    np.add.at(buy, (m_idx, price), qb)
    np.add.at(sell, (m_idx, price), qs)
    return buy, sell


def apply_scenario_shock(params, bid, step_idx):
    """Flash-crash liquidity withdrawal: at each market's shock step a
    fraction ``shock_cancel`` of every resting bid level is cancelled
    (``floor`` keeps the book integer-valued). Markets with the shock
    disabled or elsewhere are untouched; with every ``shock_cancel`` zero
    the overlay is skipped."""
    if not np.asarray(params.shock_cancel).any():
        return bid
    f32 = np.float32
    shock_step = np.asarray(params.shock_step, dtype=np.int32)   # [M, 1]
    shock_cancel = np.asarray(params.shock_cancel, dtype=f32)    # [M, 1]
    at_shock = np.asarray(step_idx).astype(np.int32) == shock_step
    cancelled = np.floor(bid * shock_cancel)
    return np.where(at_shock, bid - cancelled, bid)


def resolve_peer_mids(prev_mid, coupling_peer, market_ids=None):
    """Gather each market's coupled peer mid (``< 0`` means self) from the
    full ``[M, 1]`` mid column at a chunk boundary; ``market_ids`` are the
    rows' own global indices (default ``arange(M)``)."""
    prev_mid = np.asarray(prev_mid, dtype=np.float32)
    peer = np.reshape(np.asarray(coupling_peer, dtype=np.int32), (-1, 1))
    if market_ids is None:
        own = np.arange(prev_mid.shape[0], dtype=np.int32)[:, None]
    else:
        own = np.reshape(np.asarray(market_ids, dtype=np.int32), (-1, 1))
    resolved = np.where(peer < np.int32(0), own, peer)
    return np.take_along_axis(prev_mid, resolved, axis=0)


def quote_phase(params, state: MarketState, step_idx):
    """The prelude both clearing mechanisms share: the shock overlay, then
    the mid and the resting-book imbalance the agents see. Returns
    ``(resting_bid, mid, imbalance)``."""
    f32 = np.float32
    resting_bid = apply_scenario_shock(params, state.bid, step_idx)
    _, _, mid = auction.best_quotes(resting_bid, state.ask, state.last_price)

    # Exact-integer f32 sums (book mass stays far below 2^24), one IEEE
    # division.
    sum_bid = np.sum(resting_bid, axis=-1, keepdims=True)
    sum_ask = np.sum(state.ask, axis=-1, keepdims=True)
    depth = sum_bid + sum_ask
    safe_depth = np.where(depth > f32(0.0), depth, f32(1.0))  # no 0/0
    imbalance = np.where(depth > f32(0.0), (sum_bid - sum_ask) / safe_depth,
                         np.zeros_like(depth))
    return resting_bid, mid, imbalance


def simulate_step(cfg, state: MarketState, step_idx, market_ids, params,
                  scan: str = "cumsum", uniform_fn: Callable = None,
                  ext_buy=None, ext_ask=None, atype=None, seed=None,
                  peer_mid: Optional[np.ndarray] = None):
    """Advance all markets one step. Returns (MarketState, StepOutput).

    ``cfg`` supplies ``num_agents``, ``num_levels`` and ``seed``; ``params``
    the per-market ``[M, 1]`` host columns. ``ext_buy``/``ext_ask``
    (float32[M, L]) join the incoming flow after binning, as if one extra
    agent had quoted them. ``atype`` is the hoisted type lattice, ``seed``
    a runtime override of the counter stream's, ``uniform_fn`` another
    stream (see :func:`repro_torch.core.host.agents.decide`), and
    ``peer_mid`` the chunk-frozen coupling column (``None`` →
    ``state.prev_mid``). Inputs are never written.
    """
    f32 = np.float32
    resting_bid, mid, imbalance = quote_phase(params, state, step_idx)

    agent_ids = np.arange(cfg.num_agents, dtype=np.int32)
    side_buy, price, qty = agents.decide(
        cfg, params, mid, state.prev_mid, step_idx, market_ids, agent_ids,
        uniform_fn=uniform_fn, atype=atype, seed=seed,
        imbalance=imbalance, peer_mid=peer_mid,
    )
    buy, sell = bin_orders_scatter(side_buy, price, qty, price.shape[0],
                                   cfg.num_levels)

    # Incoming orders join the resting book; clearing runs over the total.
    total_buy = resting_bid + buy
    total_ask = state.ask + sell
    if ext_buy is not None:
        total_buy = total_buy + ext_buy
    if ext_ask is not None:
        total_ask = total_ask + ext_ask

    cleared = auction.clear(total_buy, total_ask, scan=scan)

    executed = cleared["volume"] > f32(0.0)
    new_last = np.where(
        executed, cleared["p_star"].astype(np.float32), state.last_price
    )
    new_state = MarketState(
        bid=cleared["new_bid"],
        ask=cleared["new_ask"],
        last_price=new_last,
        prev_mid=mid,
    )
    out = StepOutput(price=new_last, volume=cleared["volume"], mid=mid)
    return new_state, out
