"""Mechanism-gap reporting: parallel call auction vs sequential clearing.

The engine's uniform-price call auction is what makes a step
embarrassingly parallel; the classical ABM literature clears order by
order (Steinbacher et al.), and the choice of mechanism itself shifts the
emergent dynamics. :mod:`repro_torch.core.sequential` implements the
sequential reference with the identical agent decisions; this module runs
both mechanisms on one configuration and reports the gap.

Both runs use a backend of the ``numpy`` reference family on the host (no
kernel has a sequential mode), so every decision draw is shared between the
two mechanisms and the deltas are the clearing rule's alone.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core import engine
from repro_torch.core.sequential import match_order, simulate_step_sequential
from repro_torch.kernels.ref import simulate_reference_sequential

__all__ = ["match_order", "simulate_step_sequential",
           "simulate_reference_sequential", "mechanism_gap"]

#: The metrics both mechanisms report; the gap row carries one
#: ``<metric>_parallel`` / ``<metric>_sequential`` / ``<metric>_delta``
#: triple per entry.
GAP_METRICS = ("mean_clearing_price", "volume_per_market", "trade_count",
               "volatility", "excess_kurtosis")


def _metrics(result) -> Dict[str, float]:
    r = result.to_numpy()
    return {m: float(getattr(r, m)()) for m in GAP_METRICS}


def mechanism_gap(cfg, backend: str = "numpy") -> Dict[str, float]:
    """Run ``cfg`` under both clearing mechanisms; return the flat gap row.

    ``backend`` is one of the host-only ``numpy`` family (``numpy``,
    ``numpy-splitmix64``, ``numpy-pcg64``), opened with ``device="cpu"``.
    Keys: ``<metric>_parallel``, ``<metric>_sequential`` and
    ``<metric>_delta`` (sequential minus parallel, NaN where not finite) for
    every :data:`GAP_METRICS` entry.
    """
    par = _metrics(engine.simulate(cfg, backend=backend, device="cpu"))
    seq = _metrics(engine.simulate(cfg, backend=backend, device="cpu",
                                   clearing="sequential"))
    row: Dict[str, float] = {}
    for m in GAP_METRICS:
        row[f"{m}_parallel"] = par[m]
        row[f"{m}_sequential"] = seq[m]
        d = seq[m] - par[m]
        row[f"{m}_delta"] = float(d if np.isfinite(d) else np.nan)
    return row
