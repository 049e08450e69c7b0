"""Market-axis placement rules for simulation ensembles.

The counterpart of ``repro.launch.sharding``. Every per-market tensor
(books ``[M, L]``, scalars and statistics ``[M, 1]``, the packed params
``[M, 11]``) is row-major over the market axis, so one cut of the rows
serves the whole session state: :func:`market_sharding` gives each mesh
device its contiguous rows, near-equal as ``torch.tensor_split`` cuts
them. State that is not cut (a session's canonical ``[M, ...]`` layout,
a trainer's parameters) lives on :func:`replicated_sharding`'s device, the
mesh's first.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.launch.mesh import MarketsMesh


def _markets_axis(mesh: MarketsMesh) -> None:
    if "markets" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh} has no 'markets' axis")


def market_sharding(mesh: MarketsMesh, num_markets: int
                    ) -> Tuple[slice, ...]:
    """Each mesh device's rows of an ``[M, ...]`` tensor: contiguous slices,
    the first ``M % n`` one row longer (``torch.tensor_split``'s cut); a
    device past ``M`` rows gets an empty slice."""
    _markets_axis(mesh)
    n, M = mesh.size, int(num_markets)
    base, extra = divmod(M, n)
    bounds = [0]
    for i in range(n):
        bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    return tuple(slice(a, b) for a, b in zip(bounds, bounds[1:]))


def replicated_sharding(mesh: MarketsMesh) -> torch.device:
    """Where state that is not cut lives: the mesh's first device."""
    _markets_axis(mesh)
    return mesh.devices[0]


def replicate_tree(tree, mesh: MarketsMesh):
    """Every tensor of a nested dict/list/tuple ``tree`` on
    :func:`replicated_sharding`'s device (other leaves as they are).

    A trainer's parameter and optimizer trees ride through the sharded
    rollout path unsharded, so the trainer places them here once at init,
    as ``repro``'s does with its replicated sharding."""
    device = replicated_sharding(mesh)

    def place(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(place(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        return x

    return place(tree)
