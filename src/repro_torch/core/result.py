"""Simulation result container + aggregate statistics (paper Table II/Fig 7).

Every statistic is computed on the host copy (:meth:`SimResult.to_numpy`)
with the JAX package's numpy expressions: a torch reduction sums float32 in
another order and would differ in the last bits.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch


def to_host(x) -> np.ndarray:
    """Host numpy copy of a tensor (any device) or array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SimResult(NamedTuple):
    bid: Any            # float32[M, L] final resting bids
    ask: Any            # float32[M, L] final resting asks
    last_price: Any     # float32[M, 1]
    prev_mid: Any       # float32[M, 1]
    price_path: Any     # float32[M, S] clearing-price path
    volume_path: Any    # float32[M, S] per-step transacted volume

    def to_numpy(self) -> "SimResult":
        return SimResult(*(to_host(x) for x in self))

    # ---- aggregate market statistics (Table II) ----
    def mean_clearing_price(self) -> float:
        r = self.to_numpy()
        w = r.volume_path > 0
        tot = w.sum()
        if tot == 0:
            return float("nan")
        return float((r.price_path * w).sum() / tot)

    def volume_per_market(self) -> float:
        r = self.to_numpy()
        return float(r.volume_path.sum(axis=1).mean())

    def trade_count(self) -> float:
        r = self.to_numpy()
        return float((r.volume_path > 0).sum(axis=1).mean())

    # ---- stylized-fact statistics (Fig 7) ----
    def returns(self) -> np.ndarray:
        return np.diff(to_host(self.price_path), axis=1)

    def volatility(self) -> float:
        return float(self.returns().std())

    def excess_kurtosis(self) -> float:
        r = self.returns().ravel()
        r = r - r.mean()
        v = (r ** 2).mean()
        if v == 0:
            return 0.0
        return float((r ** 4).mean() / v ** 2 - 3.0)

    def volume_volatility_corr(self) -> float:
        """Mean-over-markets Pearson correlation of |returns| with volume
        (at the step the return realizes). Markets with a degenerate
        series are excluded; NaN if every market is degenerate."""
        r = np.abs(self.returns())                       # [M, S-1]
        v = to_host(self.volume_path)[:, 1:]             # [M, S-1]
        rc = r - r.mean(axis=1, keepdims=True)
        vc = v - v.mean(axis=1, keepdims=True)
        num = (rc * vc).sum(axis=1)
        denom = np.sqrt((rc * rc).sum(axis=1) * (vc * vc).sum(axis=1))
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = num / denom
        return float(np.nanmean(corr))

    def autocorrelation(self, lags: int = 20,
                        absolute: bool = False) -> np.ndarray:
        """Mean-over-markets ACF of returns (or |returns|) up to ``lags``."""
        r = self.returns()
        if absolute:
            r = np.abs(r)
        r = r - r.mean(axis=1, keepdims=True)
        denom = (r * r).sum(axis=1)
        out = np.zeros(lags + 1)
        out[0] = 1.0
        for k in range(1, lags + 1):
            num = (r[:, k:] * r[:, :-k]).sum(axis=1)
            with np.errstate(invalid="ignore", divide="ignore"):
                vals = num / denom
            out[k] = float(np.nanmean(vals))
        return out
