"""Pluggable reward functions for :class:`repro_torch.env.MarketEnv`.

The counterpart of ``repro.env.rewards``. A :class:`RewardFn` is a frozen
dataclass mapping one transition to a float32 ``[M]`` reward, one scalar
per market (each market's external-order slot is one acting agent). Its
inputs arrive in a :class:`RewardContext`, built by the env from the step's
clearing outputs and the carried portfolio:

  * :class:`PnLReward`        — mark-to-market equity delta;
  * :class:`SpreadCapture`    — ``fill · |mid − fill price|`` earned by buys
    below and sells above the mid;
  * :class:`InventoryPenalty` — ``−weight · inventory²``;
  * :class:`Sum`              — weighted sum of child rewards.

Fills follow the JAX package's price-priority, no-rationing model: when a
step clears at ``p*``, an external buy at a tick ``>= p*`` (an ask at a
tick ``<= p*``) fills in full at ``p*``. Every expression keeps the JAX
package's float32 operation order, so rewards are equal bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Tuple

import torch


class RewardContext(NamedTuple):
    """Everything a reward function may read about one transition."""

    fill_buy: torch.Tensor    # f32[M, 1] externally-bought lots filled
    fill_ask: torch.Tensor    # f32[M, 1] externally-sold lots filled
    fill_price: torch.Tensor  # f32[M, 1] clearing price p* (last if none)
    out: Any                  # StepOutput (price / volume / mid columns)
    prev: Any                 # Portfolio before the transition
    portfolio: Any            # Portfolio after the transition


@dataclasses.dataclass(frozen=True)
class RewardFn:
    """Base reward: subclasses implement ``__call__(ctx) -> f32[M]``."""

    def __call__(self, ctx: RewardContext) -> torch.Tensor:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PnLReward(RewardFn):
    """Mark-to-market profit this step: ``equity_t − equity_{t−1}``, with
    equity ``cash + inventory · mid`` at the step's pre-clearing mid."""

    def __call__(self, ctx: RewardContext) -> torch.Tensor:
        return (ctx.portfolio.equity - ctx.prev.equity)[:, 0]


@dataclasses.dataclass(frozen=True)
class SpreadCapture(RewardFn):
    """Edge versus the prevailing mid: buys earn ``fill · (mid − p*)``,
    sells earn ``fill · (p* − mid)`` — the market-making objective."""

    def __call__(self, ctx: RewardContext) -> torch.Tensor:
        mid, p = ctx.out.mid, ctx.fill_price
        edge = ctx.fill_buy * (mid - p) + ctx.fill_ask * (p - mid)
        return edge[:, 0]


@dataclasses.dataclass(frozen=True)
class InventoryPenalty(RewardFn):
    """Quadratic inventory-risk shaping: ``−weight · inventory²``."""

    weight: float = 0.01

    def __call__(self, ctx: RewardContext) -> torch.Tensor:
        inv = ctx.portfolio.inventory
        return -float(self.weight) * (inv * inv)[:, 0]


@dataclasses.dataclass(frozen=True)
class Sum(RewardFn):
    """Weighted sum of child rewards (default weight 1.0 each)."""

    children: Tuple[RewardFn, ...] = ()
    weights: Tuple[float, ...] = ()

    def __post_init__(self):
        if not self.children:
            raise ValueError("Sum needs at least one child reward")
        object.__setattr__(self, "children", tuple(self.children))
        weights = tuple(self.weights) or (1.0,) * len(self.children)
        if len(weights) != len(self.children):
            raise ValueError(
                f"got {len(weights)} weights for {len(self.children)} "
                "child rewards")
        object.__setattr__(self, "weights", weights)

    def __call__(self, ctx: RewardContext) -> torch.Tensor:
        total = None
        for w, child in zip(self.weights, self.children):
            term = float(w) * child(ctx)
            total = term if total is None else total + term
        return total
