"""Pluggable observation specs for :class:`repro_torch.env.MarketEnv`.

The counterpart of ``repro.env.obs``. An :class:`ObservationSpec` is a
frozen dataclass mapping the current environment state to a float32
``[M, D]`` feature block on the env's device:

  * :class:`MarketFeatures`    — mid / spread / book imbalance / last trade
    / cleared volume (D = 5), the default;
  * :class:`BookWindow`        — bid and ask depth on ``2·depth`` ticks
    around the rounded mid (D = 4·depth);
  * :class:`PortfolioFeatures` — the acting agent's cash / inventory /
    mark-to-market equity (D = 3);
  * :class:`StatsFeatures`     — running :class:`MarketStats` moments
    (D = 6); a spec with ``needs_stats`` makes the env carry the
    accumulators and update them every step;
  * :class:`Composite`         — concatenation of child specs along D.

Each feature repeats the JAX package's float32 expression, so observations
are equal bit for bit wherever the engine outputs are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

from repro_torch.core import auction
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.stats import MarketStats
from repro_torch.core.step import MarketState, StepOutput


@dataclasses.dataclass(frozen=True)
class ObservationSpec:
    """Base observation spec: subclasses implement :meth:`observe`."""

    #: When True the env carries (and updates every step) per-market
    #: ``MarketStats`` accumulators for this spec to read.
    needs_stats = False

    def size(self, spec: EnsembleSpec) -> int:
        """Feature dimension D for a given ensemble spec."""
        raise NotImplementedError

    def observe(self, spec: EnsembleSpec, market: MarketState,
                out: StepOutput, portfolio: Any,
                stats: Optional[MarketStats]) -> torch.Tensor:
        """float32[M, D] features of the current state. ``out`` is the step
        that produced ``market`` (at reset: a zero-volume output whose mid
        is the opening mid)."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class MarketFeatures(ObservationSpec):
    """[mid, spread, book imbalance, last trade price, cleared volume]."""

    def size(self, spec: EnsembleSpec) -> int:
        return 5

    def observe(self, spec, market, out, portfolio, stats):
        bb, ba, _ = auction.best_quotes(market.bid, market.ask,
                                        market.last_price)
        # The empty-side sentinels (bb=-1, ba=L) make the spread wide.
        spread = (ba - bb).to(torch.float32)
        depth_b = market.bid.sum(dim=-1, keepdim=True)
        depth_a = market.ask.sum(dim=-1, keepdim=True)
        denom = torch.clamp_min(depth_b + depth_a, 1.0)
        imbalance = (depth_b - depth_a) / denom
        return torch.cat([out.mid, spread, imbalance, market.last_price,
                          out.volume], dim=-1)


@dataclasses.dataclass(frozen=True)
class BookWindow(ObservationSpec):
    """Book-depth window: bid and ask quantities on ``2·depth`` ticks
    around the rounded mid (edge ticks repeat at the grid boundary)."""

    depth: int = 4

    def size(self, spec: EnsembleSpec) -> int:
        return 4 * self.depth

    def observe(self, spec, market, out, portfolio, stats):
        L, d = spec.num_levels, self.depth
        centre = torch.clamp(torch.round(out.mid), 0.0,
                             float(L - 1)).to(torch.int64)       # [M, 1]
        offsets = torch.arange(2 * d, device=centre.device)[None, :] - d
        idx = torch.clamp(centre + offsets, 0, L - 1)            # [M, 2d]
        return torch.cat([market.bid.gather(-1, idx),
                          market.ask.gather(-1, idx)], dim=-1)


@dataclasses.dataclass(frozen=True)
class PortfolioFeatures(ObservationSpec):
    """The acting agent's [cash, inventory, mark-to-market equity]."""

    def size(self, spec: EnsembleSpec) -> int:
        return 3

    def observe(self, spec, market, out, portfolio, stats):
        return torch.cat([portfolio.cash, portfolio.inventory,
                          portfolio.equity], dim=-1)


@dataclasses.dataclass(frozen=True)
class StatsFeatures(ObservationSpec):
    """Running moments from the carried ``MarketStats``: [count, mean mid,
    variance of the mid, min mid, max mid, total volume]. A count of 0
    reads as mean 0 and variance 0; min and max read 0 until the first
    accumulated step."""

    needs_stats = True

    def size(self, spec: EnsembleSpec) -> int:
        return 6

    def observe(self, spec, market, out, portfolio, stats):
        if stats is None:
            raise ValueError(
                "StatsFeatures needs the env to carry MarketStats "
                "accumulators (MarketEnv enables them automatically)")
        count = stats.count
        seen = count > 0.0
        denom = torch.clamp_min(count, 1.0)
        mean = stats.sum_mid / denom
        var = torch.clamp_min(stats.sumsq_mid / denom - mean * mean, 0.0)
        zero = torch.zeros_like(count)
        mn = torch.where(seen, stats.min_mid, zero)
        mx = torch.where(seen, stats.max_mid, zero)
        return torch.cat([count, mean, var, mn, mx, stats.sum_volume],
                         dim=-1)


@dataclasses.dataclass(frozen=True)
class Composite(ObservationSpec):
    """Concatenation of child observation specs along the feature axis."""

    children: Tuple[ObservationSpec, ...] = ()

    def __post_init__(self):
        if not self.children:
            raise ValueError("Composite needs at least one child spec")
        object.__setattr__(self, "children", tuple(self.children))

    @property
    def needs_stats(self) -> bool:
        return any(c.needs_stats for c in self.children)

    def size(self, spec: EnsembleSpec) -> int:
        return sum(c.size(spec) for c in self.children)

    def observe(self, spec, market, out, portfolio, stats):
        return torch.cat([c.observe(spec, market, out, portfolio, stats)
                          for c in self.children], dim=-1)
