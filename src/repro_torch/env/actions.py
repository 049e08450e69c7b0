"""Action validation + lowering for :meth:`Session.step`.

One external limit order per market, an :class:`ExternalOrders` triple
(``side_buy``, ``price``, ``qty``), is lowered onto the reserved
``ext_buy``/``ext_ask`` slot as two float32[M, L] quantity grids with one
nonzero entry per market. Malformed actions raise ``ValueError`` here, at
the API boundary.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core.result import to_host
from repro_torch.core.session import ExternalOrders


def _field(value: Any, name: str, num_markets: int) -> np.ndarray:
    """Host copy of one action field, shape-checked: scalar, [M] or [M, 1]."""
    arr = to_host(value)
    shape = arr.shape
    if arr.size not in (1, num_markets):
        raise ValueError(
            f"actions.{name} must broadcast to [{num_markets}] (one order "
            f"per market); got shape {shape} ({arr.size} entries) — market "
            "mismatch")
    if arr.ndim > 2 or (arr.ndim == 2 and shape[1] != 1):
        raise ValueError(f"actions.{name} must be a scalar, [{num_markets}] "
                         f"or [{num_markets}, 1] array; got shape {shape}")
    return arr


def validate_actions(actions: Any, num_markets: int,
                     num_levels: int) -> ExternalOrders:
    """Normalize an action triple to host arrays and validate it: market
    count, prices on the grid and integral, quantities >= 0."""
    if isinstance(actions, dict):
        try:
            actions = ExternalOrders(actions["side_buy"], actions["price"],
                                     actions["qty"])
        except KeyError as exc:
            raise ValueError(f"action mapping is missing key "
                             f"{exc.args[0]!r}; need side_buy/price/qty") \
                from None
    if not isinstance(actions, ExternalOrders):
        try:
            side_buy, price, qty = actions
        except (TypeError, ValueError):
            raise ValueError(
                "actions must be an ExternalOrders, a (side_buy, price, qty) "
                f"triple, or a mapping with those keys; got "
                f"{type(actions).__name__}") from None
        actions = ExternalOrders(side_buy, price, qty)

    side_buy = _field(actions.side_buy, "side_buy", num_markets)
    price = _field(actions.price, "price", num_markets)
    qty = _field(actions.qty, "qty", num_markets)
    if np.issubdtype(price.dtype, np.floating) and (price != np.floor(price)).any():
        raise ValueError("actions.price must be integer tick indices; got "
                         f"fractional values (e.g. {float(price.reshape(-1)[0])})")
    p = price.astype(np.int64)
    if ((p < 0) | (p >= num_levels)).any():
        bad = np.unique(p[(p < 0) | (p >= num_levels)])[:8]
        raise ValueError(f"actions.price must lie on the grid [0, {num_levels})"
                         f"; got off-grid level(s) {bad.tolist()} — level "
                         "mismatch")
    q = qty.astype(np.float32)
    if (q < 0).any():
        raise ValueError(f"actions.qty must be >= 0 lots (0 is a no-op order);"
                         f" got {np.unique(q[q < 0])[:8].tolist()}")
    return ExternalOrders(side_buy, price, qty)


def lower_actions(orders: ExternalOrders, num_markets: int, num_levels: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower a validated order triple to ``(ext_buy, ext_ask)``
    float32[M, L] grids on ``device``."""
    M, L = num_markets, num_levels
    side = np.broadcast_to(np.asarray(orders.side_buy).astype(bool)
                           .reshape(-1), (M,))
    tick = np.broadcast_to(np.rint(np.asarray(orders.price)).astype(np.int64)
                           .reshape(-1), (M,))
    tick = np.clip(tick, 0, L - 1)
    lots = np.broadcast_to(np.asarray(orders.qty, np.float32).reshape(-1), (M,))
    lots = np.maximum(lots, np.float32(0.0))
    ext_buy = np.zeros((M, L), np.float32)
    ext_ask = np.zeros((M, L), np.float32)
    rows = np.arange(M)
    ext_buy[rows, tick] = np.where(side, lots, np.float32(0.0))
    ext_ask[rows, tick] = np.where(side, np.float32(0.0), lots)
    return (torch.from_numpy(ext_buy).to(device),
            torch.from_numpy(ext_ask).to(device))
