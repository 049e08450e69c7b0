"""Carry scenario data and market state across into the port.

This system has no model weights: the data that defines a run is the
ensemble spec (per-market params and opening books) and the market state.
These functions take plain numpy arrays — for example
``EnsembleSpec.params.to_numpy()._asdict()`` and the books of a JAX-package
session — and return the port's own objects, so a run can be replayed here.
A coupling graph comes across as its peer map (:func:`coupling_from_numpy`).
A snapshot or checkpoint needs no conversion: ``Session.restore`` takes the
JAX package's snapshot dict as it is, its ``rng`` payload (the
``numpy-pcg64`` generator state) included. ``MarketEnv.restore`` likewise
takes the JAX package's env snapshot dict as it is, and
``repro_torch.env.state_from_tree`` its env checkpoint tree. The learned
actor-critic's weights come across as its params tree
(:func:`actor_critic_from_numpy`, and back with
:func:`actor_critic_to_numpy`); a trainer checkpoint needs no conversion:
``repro_torch.train.restore_train_checkpoint`` takes the JAX package's tree
as it is, its ``key`` leaf reinterpreted (so the draws after a
cross-package restore differ).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.params import EnsembleSpec, params_from_dict
from repro_torch.core.result import to_host
from repro_torch.core.step import MarketState


#: Host :class:`MarketParams` from ``{field: array}`` (missing fields take
#: their inert values).
params_from_numpy = params_from_dict


def state_from_numpy(bid, ask, last_price, prev_mid,
                     device="cuda") -> MarketState:
    """A :class:`MarketState` of float32 tensors on ``device``."""
    dev = resolve_device(device)
    return MarketState(*(torch.as_tensor(np.asarray(x, np.float32)).to(dev)
                         for x in (bid, ask, last_price, prev_mid)))


def spec_from_numpy(num_markets: int, num_agents: int, num_levels: int,
                    num_steps: int, seed: int, params: Dict[str, Any],
                    initial_quote_qty, initial_spread,
                    scenarios: Optional[Sequence[str]] = None) -> EnsembleSpec:
    """An :class:`EnsembleSpec` from the static fields and numpy data."""
    M = int(num_markets)
    return EnsembleSpec(
        num_markets=M, num_agents=int(num_agents),
        num_levels=int(num_levels), num_steps=int(num_steps), seed=int(seed),
        params=params_from_numpy(params, M, num_levels),
        initial_quote_qty=np.asarray(initial_quote_qty, np.float32).reshape(M),
        initial_spread=np.asarray(initial_spread, np.int32).reshape(M),
        scenarios=tuple(scenarios) if scenarios is not None else ("?",) * M)


def coupling_from_numpy(peer):
    """A :class:`~repro_torch.scenario.coupling.CouplingSpec` from a peer
    map (``int32[M]``, ``-1`` for self), such as the JAX package's
    ``CouplingSpec.peer``."""
    from repro_torch.scenario.coupling import CouplingSpec

    return CouplingSpec(np.asarray(peer, np.int32))


def actor_critic_from_numpy(tree, device="cuda"):
    """The port's actor-critic params (float32 tensors on ``device``) from
    the JAX package's params tree as numpy arrays: ``{"torso": ((W, b),
    ...), "pi": (W, b), "v": (W, b)}``, ``W`` of shape ``[n_in, n_out]`` in
    both packages."""
    from repro_torch.train.buffers import tree_map

    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(
        np.array(a, dtype=np.float32)).to(dev), tree)


def actor_critic_to_numpy(params):
    """Inverse of :func:`actor_critic_from_numpy`: the params tree as
    float32 numpy arrays, which ``repro``'s ``apply_actor_critic`` takes."""
    from repro_torch.train.buffers import tree_map

    return tree_map(lambda t: np.array(to_host(t), dtype=np.float32), params)
