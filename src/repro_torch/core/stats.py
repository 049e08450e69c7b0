"""In-stream ensemble statistics — the Θ(M) output-traffic regime.

``stats_only`` mode replaces the per-step paths with per-market running
aggregates carried through every chunk: moments and extremes of the
pre-clearing mid, and total cleared volume. The CUDA kernel and the plain
version accumulate with the same float32 op sequence as :func:`accumulate`,
so any chunking of S steps gives the same bits as one S-step call.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.result import to_host


class MarketStats(NamedTuple):
    """Per-market running aggregates; every field is float32[M, 1]."""

    count: Any      # steps accumulated (exact integer in f32)
    sum_mid: Any    # Σ mid
    sumsq_mid: Any  # Σ mid²
    min_mid: Any
    max_mid: Any
    sum_volume: Any # total cleared volume

    def to_numpy(self) -> "MarketStats":
        return MarketStats(*(to_host(x) for x in self))


def init_stats(num_markets: int, device=DEFAULT_DEVICE) -> MarketStats:
    """Fresh accumulators (distinct buffers) for ``num_markets`` markets."""
    device = resolve_device(device)

    def full(v):
        return torch.full((num_markets, 1), v, dtype=torch.float32,
                          device=device)

    return MarketStats(count=full(0.0), sum_mid=full(0.0),
                       sumsq_mid=full(0.0), min_mid=full(float("inf")),
                       max_mid=full(float("-inf")), sum_volume=full(0.0))


def accumulate(stats: MarketStats, mid, volume, active=True) -> MarketStats:
    """One masked accumulation step; inactive steps leave every field
    bitwise untouched."""
    if not active:
        return stats
    return MarketStats(
        count=stats.count + 1.0,
        sum_mid=stats.sum_mid + mid,
        sumsq_mid=stats.sumsq_mid + mid * mid,
        min_mid=torch.minimum(stats.min_mid, mid),
        max_mid=torch.maximum(stats.max_mid, mid),
        sum_volume=stats.sum_volume + volume,
    )
