"""One simulation step (paper Alg. 1 lines 5-22) on torch tensors.

``simulate_step`` is the complete per-step semantics: scenario overlay ->
best quotes and book imbalance -> agent decisions -> scatter binning ->
clearing -> residual book update. It is the plain version that the CUDA
kernel (``kernels/csrc/kinetic_clearing.cu``) is held against.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import agents, auction
from repro_torch.core import params as params_mod
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.params import MarketParams


class MarketState(NamedTuple):
    bid: torch.Tensor         # float32[M, L] resting bid quantities
    ask: torch.Tensor         # float32[M, L] resting ask quantities
    last_price: torch.Tensor  # float32[M, 1]
    prev_mid: torch.Tensor    # float32[M, 1]


class StepOutput(NamedTuple):
    price: torch.Tensor   # float32[M, 1] clearing price (last price if none)
    volume: torch.Tensor  # float32[M, 1] transacted volume
    mid: torch.Tensor     # float32[M, 1] mid price used for decisions


def initial_state(cfg, device=DEFAULT_DEVICE) -> MarketState:
    """Opening state for a ``MarketConfig`` or ``EnsembleSpec`` on
    ``device``."""
    device = resolve_device(device)
    bid, ask = cfg.initial_books(device)
    m0 = torch.full((cfg.num_markets, 1), cfg.mid0, dtype=torch.float32,
                    device=device)
    return MarketState(bid=bid, ask=ask, last_price=m0, prev_mid=m0.clone())


def bin_orders_scatter(side_buy, price, qty, num_levels: int):
    """Order aggregation with ``scatter_add_`` (the counterpart of the NumPy
    reference's ``np.add.at``). Exact-integer f32 adds make the result
    independent of the order of the adds."""
    M = price.shape[0]
    idx = price.to(torch.int64)
    side = side_buy.to(torch.float32)
    buy = qty.new_zeros((M, num_levels)).scatter_add_(1, idx, qty * side)
    sell = qty.new_zeros((M, num_levels)).scatter_add_(1, idx, qty * (1.0 - side))
    return buy, sell


def apply_scenario_shock(params: MarketParams, bid, step_idx: int):
    """Flash-crash liquidity withdrawal: at each market's shock step a
    fraction ``shock_cancel`` of every resting bid level is cancelled
    (``floor`` keeps the book integer-valued)."""
    cancelled = torch.floor(bid * params.shock_cancel)
    return torch.where(params.shock_step == step_idx, bid - cancelled, bid)


def resolve_peer_mids(prev_mid, coupling_peer, market_ids=None):
    """Gather each market's coupled peer mid (``< 0`` means self) from the
    full ``[M, 1]`` mid column at a chunk boundary."""
    peer = coupling_peer.reshape(-1, 1).to(torch.int64)
    if market_ids is None:
        own = torch.arange(prev_mid.shape[0], device=prev_mid.device)[:, None]
    else:
        own = market_ids.reshape(-1, 1).to(torch.int64)
    resolved = torch.where(peer < 0, own, peer)
    return torch.gather(prev_mid, 0, resolved)


def quote_phase(params: MarketParams, state: MarketState, step_idx: int):
    """The step's prelude, shared by both clearing mechanisms: the shock
    overlay, then the mid and the resting-book imbalance the agents see.
    Returns ``(resting_bid, mid, imbalance)``."""
    resting_bid = apply_scenario_shock(params, state.bid, step_idx)
    _, _, mid = auction.best_quotes(resting_bid, state.ask, state.last_price)

    # Resting-book imbalance: exact-integer f32 sums, one IEEE division.
    sum_bid = resting_bid.sum(dim=-1, keepdim=True)
    sum_ask = state.ask.sum(dim=-1, keepdim=True)
    depth = sum_bid + sum_ask
    safe_depth = torch.where(depth > 0.0, depth, 1.0)
    imbalance = torch.where(depth > 0.0, (sum_bid - sum_ask) / safe_depth, 0.0)
    return resting_bid, mid, imbalance


def simulate_step(cfg, state: MarketState, step_idx: int, market_ids,
                  scan: str = "cumsum", ext_buy=None, ext_ask=None,
                  params: Optional[MarketParams] = None, atype=None,
                  seed=None, peer_mid=None, uniform_fn=None):
    """Advance all markets one step. Returns (MarketState, StepOutput).

    ``cfg`` supplies ``num_agents``, ``num_levels`` and ``seed``; ``params``
    the per-market ``[M, 1]`` torch columns (derived from a scalar ``cfg``
    when omitted). ``ext_buy``/``ext_ask`` (float32[M, L]) join the incoming
    flow after binning. ``peer_mid`` is the chunk-frozen coupling column
    (``None`` → ``state.prev_mid``). ``uniform_fn`` replaces the counter
    stream (see :func:`repro_torch.core.agents.decide`).
    """
    device = state.bid.device
    if params is None:
        params = params_mod.scalar_params(cfg, device)
    step_idx = int(step_idx)

    resting_bid, mid, imbalance = quote_phase(params, state, step_idx)
    side_buy, price, qty = agents.decide(
        cfg, params, mid, state.prev_mid, step_idx, market_ids, atype=atype,
        seed=seed, imbalance=imbalance, peer_mid=peer_mid,
        uniform_fn=uniform_fn)
    buy, sell = bin_orders_scatter(side_buy, price, qty, cfg.num_levels)

    total_buy = resting_bid + buy
    total_ask = state.ask + sell
    if ext_buy is not None:
        total_buy = total_buy + ext_buy
    if ext_ask is not None:
        total_ask = total_ask + ext_ask

    cleared = auction.clear(total_buy, total_ask, scan=scan)
    new_last = torch.where(cleared["volume"] > 0.0,
                           cleared["p_star"].to(torch.float32),
                           state.last_price)
    new_state = MarketState(bid=cleared["new_bid"], ask=cleared["new_ask"],
                            last_price=new_last, prev_mid=mid)
    return new_state, StepOutput(price=new_last, volume=cleared["volume"],
                                 mid=mid)
