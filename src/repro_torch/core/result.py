"""Simulation result container + aggregate statistics."""
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
