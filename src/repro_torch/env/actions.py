"""Action validation + lowering for :meth:`Session.step` and the RL env.

One external limit order per market, an :class:`ExternalOrders` triple
(``side_buy``, ``price``, ``qty``), is lowered onto the reserved
``ext_buy``/``ext_ask`` slot as two float32[M, L] quantity grids with one
nonzero entry per market. Both RL front doors, :meth:`Session.step` and
:meth:`repro_torch.env.MarketEnv.step`, share this module.

Malformed actions raise ``ValueError`` here, at the API boundary. The value
checks (prices on the grid and integral, quantities >= 0) read the
operands on the host; a rollout on the card skips them, as the JAX
package's traced rollouts do. :func:`lower_actions` sanitizes on the
device instead: prices round half to even and clip to the grid,
quantities clamp at 0, which leaves a valid action's bits as they are.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.core.result import to_host
from repro_torch.core.session import ExternalOrders


def _field(value: Any, name: str, num_markets: int) -> Any:
    """Shape-check one action field (scalar, [M] or [M, 1]) without
    copying a tensor to the host."""
    shape = tuple(value.shape) if isinstance(value, torch.Tensor) \
        else np.shape(value)
    size = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if size not in (1, num_markets):
        raise ValueError(
            f"actions.{name} must broadcast to [{num_markets}] (one order "
            f"per market); got shape {shape} ({size} entries) — market "
            "mismatch")
    if len(shape) > 2 or (len(shape) == 2 and shape[1] != 1):
        raise ValueError(f"actions.{name} must be a scalar, [{num_markets}] "
                         f"or [{num_markets}, 1] array; got shape {shape}")
    return value


def validate_actions(actions: Any, num_markets: int, num_levels: int,
                     check_values: bool = True) -> ExternalOrders:
    """Normalize an action triple and validate it: the market count and,
    with ``check_values``, prices on the grid and integral and quantities
    >= 0, on host copies (which it returns). Without ``check_values`` the
    fields pass through as they are."""
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
    if not check_values:
        return ExternalOrders(side_buy, price, qty)
    side_buy, price, qty = to_host(side_buy), to_host(price), to_host(qty)
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
        bad = np.unique(q[q < 0])[:8]
        raise ValueError(
            f"actions.qty must be >= 0 lots (0 is a no-op order); got "
            f"negative quantit{'y' if bad.size == 1 else 'ies'} "
            f"{bad.tolist()}")
    return ExternalOrders(side_buy, price, qty)


def lower_actions(orders: ExternalOrders, num_markets: int, num_levels: int,
                  device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lower an order triple to ``(ext_buy, ext_ask)`` float32[M, L] grids
    with torch ops on ``device`` (host arrays and scalars are taken as they
    are, a tensor on the device is never copied to the host): round half to
    even, clip the tick to [0, L) (a non-finite or out-of-range price
    saturates, NaN to tick 0, as the JAX package's conversion does), clamp
    the lots at 0, and one-hot by ``arange(L)``."""
    M, L = num_markets, num_levels

    def column(x):
        return torch.as_tensor(x, device=device).reshape(-1).expand(M)

    side = column(orders.side_buy).to(torch.bool)[:, None]
    price = column(orders.price)
    if price.is_floating_point():
        price = torch.nan_to_num(torch.round(price), nan=0.0)
    tick = price.clamp(0, L - 1).to(torch.int64)[:, None]
    lots = column(orders.qty).to(torch.float32).clamp_min(0.0)[:, None]
    onehot = torch.arange(L, device=device)[None, :] == tick
    return (torch.where(onehot & side, lots, 0.0),
            torch.where(onehot & ~side, lots, 0.0))
