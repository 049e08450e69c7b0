"""The torch oracle: a plain loop of ``simulate_step`` over the horizon.

Mirrors ``simulate_reference`` and ``simulate_reference_sequential`` of
the JAX package: scalar-config params, per-step self-coupling
(``peer_mid=None``), market ids ``arange(M)``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.result import SimResult
from repro_torch.core.sequential import simulate_step_sequential
from repro_torch.core.step import MarketState, initial_state, simulate_step


def run_reference(cfg, state: MarketState, scan: str = "cumsum",
                  step_fn=None
                  ) -> Tuple[MarketState, torch.Tensor, torch.Tensor]:
    """Run ``cfg.num_steps`` steps of a ``MarketConfig`` from ``state``
    (steps ``0 .. S-1``); returns the final state and the ``[M, S]`` price
    and volume paths. ``step_fn(cfg, state, step, market_ids)`` replaces
    the call-auction step (the sequential reference)."""
    M = state.bid.shape[0]
    dev = state.bid.device
    market_ids = torch.arange(M, dtype=torch.int32, device=dev)[:, None]
    if step_fn is None:
        def step_fn(cfg, state, s, market_ids):
            return simulate_step(cfg, state, s, market_ids, scan=scan)
    prices, volumes = [], []
    for s in range(cfg.num_steps):
        state, out = step_fn(cfg, state, s, market_ids)
        prices.append(out.price)
        volumes.append(out.volume)
    empty = torch.zeros((M, 0), dtype=torch.float32, device=dev)
    return (state, torch.cat(prices, dim=1) if prices else empty,
            torch.cat(volumes, dim=1) if volumes else empty)


def simulate_reference(cfg, scan: str = "cumsum",
                       device="cuda") -> SimResult:
    """Run ``cfg.num_steps`` steps of a ``MarketConfig`` from its opening
    books and return the terminal :class:`SimResult`."""
    state, prices, volumes = run_reference(
        cfg, initial_state(cfg, resolve_device(device)), scan)
    return _result(state, prices, volumes)


def simulate_reference_sequential(cfg, device="cuda") -> SimResult:
    """The sequential-clearing reference (Steinbacher et al.): the same
    agent decisions, order-by-order matching instead of the call auction;
    equal bit for bit to the ``numpy`` backend with
    ``clearing="sequential"``."""
    state, prices, volumes = run_reference(
        cfg, initial_state(cfg, resolve_device(device)),
        step_fn=simulate_step_sequential)
    return _result(state, prices, volumes)


def _result(state, prices, volumes) -> SimResult:
    return SimResult(bid=state.bid, ask=state.ask,
                     last_price=state.last_price, prev_mid=state.prev_mid,
                     price_path=prices, volume_path=volumes)
