"""In-stream ensemble statistics (``stats_only``) in NumPy.

Per-market running moments and extremes of the pre-clearing mid and the
total cleared volume, accumulated with the float32 op sequence every
backend uses, so any chunking of S steps gives the bits of one S-step run.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np


class MarketStats(NamedTuple):
    """Per-market running aggregates; every field is float32[M, 1]."""

    count: Any      # steps accumulated (exact integer in f32)
    sum_mid: Any    # Σ mid
    sumsq_mid: Any  # Σ mid²
    min_mid: Any
    max_mid: Any
    sum_volume: Any # total cleared volume


def init_stats(num_markets: int) -> MarketStats:
    """Fresh accumulators (distinct buffers) for ``num_markets`` markets;
    ``min_mid``/``max_mid`` start at ±inf."""
    def zeros():
        return np.zeros((num_markets, 1), dtype=np.float32)

    return MarketStats(count=zeros(), sum_mid=zeros(), sumsq_mid=zeros(),
                       min_mid=zeros() + np.float32(np.inf),
                       max_mid=zeros() - np.float32(np.inf),
                       sum_volume=zeros())


def accumulate(stats: MarketStats, mid, volume, active) -> MarketStats:
    """One masked, branch-free accumulation step: inactive steps leave
    every accumulator bitwise untouched."""
    f32 = np.float32
    act = np.asarray(active)
    one = np.where(act, f32(1.0), f32(0.0))
    mid = np.asarray(mid, dtype=np.float32)
    vol = np.asarray(volume, dtype=np.float32)
    return MarketStats(
        count=stats.count + one,
        sum_mid=stats.sum_mid + np.where(act, mid, f32(0.0)),
        sumsq_mid=stats.sumsq_mid + np.where(act, mid * mid, f32(0.0)),
        min_mid=np.where(act, np.minimum(stats.min_mid, mid), stats.min_mid),
        max_mid=np.where(act, np.maximum(stats.max_mid, mid), stats.max_mid),
        sum_volume=stats.sum_volume + np.where(act, vol, f32(0.0)),
    )
