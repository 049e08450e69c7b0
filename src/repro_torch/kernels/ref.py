"""The torch oracle: a plain loop of ``simulate_step`` over the horizon.

Mirrors ``simulate_reference`` of the JAX package: scalar-config params,
per-step self-coupling (``peer_mid=None``), market ids ``arange(M)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.result import SimResult
from repro_torch.core.step import initial_state, simulate_step


def simulate_reference(cfg, scan: str = "cumsum",
                       device="cuda") -> SimResult:
    """Run ``cfg.num_steps`` steps of a ``MarketConfig`` from its opening
    books and return the terminal :class:`SimResult`."""
    dev = resolve_device(device)
    state = initial_state(cfg, dev)
    market_ids = torch.arange(cfg.num_markets, dtype=torch.int32,
                              device=dev)[:, None]
    prices, volumes = [], []
    for s in range(cfg.num_steps):
        state, out = simulate_step(cfg, state, s, market_ids, scan=scan)
        prices.append(out.price)
        volumes.append(out.volume)
    empty = torch.zeros((cfg.num_markets, 0), dtype=torch.float32, device=dev)
    return SimResult(bid=state.bid, ask=state.ask,
                     last_price=state.last_price, prev_mid=state.prev_mid,
                     price_path=torch.cat(prices, dim=1) if prices else empty,
                     volume_path=torch.cat(volumes, dim=1) if volumes else empty)
