"""Experience handling on the device: transitions, GAE, minibatches (the
counterpart of ``repro.train.buffers``).

Nothing here owns memory: a "buffer" is the transitions tree the rollout
already produced (the stacked :class:`ActorExtras` plus reward and done),
kept on the device and reshaped. GAE is a reverse Python loop over the time
axis; minibatching is a permutation and a row gather. Trees are nested
dicts, tuples and named tuples of tensors, walked with dict keys in sorted
order (the JAX package's leaf order), so a tree restored from a checkpoint
walks like a freshly built one.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple

import torch

from repro_torch.core import rng


class ActorExtras(NamedTuple):
    """Per-step policy outputs a carried actor stacks into the rollout."""

    obs: Any       # f32[..., M, D]: the pre-step obs the action saw
    action: Any    # i32[..., M]
    log_prob: Any  # f32[..., M]
    value: Any     # f32[..., M]


class TrainBatch(NamedTuple):
    """Flattened training set for one update: leaves [N, ...]."""

    obs: Any
    action: Any
    log_prob: Any
    value: Any
    adv: Any
    ret: Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of equally shaped trees (dict keys sorted)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in :func:`tree_map`'s order."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def gae(rewards, values, dones, last_value, gamma: float, lam: float):
    """Generalized advantage estimation as one reverse loop over time.

    ``rewards``/``values``/``dones`` are [T, ...] (dones broadcastable),
    ``last_value`` is [...]: the bootstrap V(s_T). Returns (adv, returns),
    both [T, ...]. Episode boundaries (done) zero the bootstrap, matching
    the env's auto-reset. Each step evaluates the JAX package's expressions
    in its order.
    """
    acc = torch.zeros_like(last_value)
    next_value = last_value
    adv = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        r, v = rewards[t], values[t]
        nonterm = 1.0 - dones[t]
        delta = r + gamma * next_value * nonterm - v
        acc = delta + gamma * lam * nonterm * acc
        adv[t] = acc
        next_value = v
    adv = torch.stack(adv)
    return adv, adv + values


def flatten_leading(tree, n_dims: int):
    """Collapse the first ``n_dims`` axes of every leaf into one N axis."""
    return tree_map(lambda x: x.reshape((-1,) + tuple(x.shape[n_dims:])),
                    tree)


def take(tree, idx):
    """Gather rows ``idx`` from every [N, ...] leaf."""
    return tree_map(lambda x: x.index_select(0, idx), tree)


def minibatch_indices(key: int, n: int, num_minibatches: int, *,
                      update: int = 0, epoch: int = 0, device=None):
    """A permutation of [0, n) split into equal minibatches.

    A stable argsort of the counter hash ``kinetic_hash32(key, row, update,
    epoch)`` (whose top 24 bits are ``uniform32``'s draw): a pure function
    of its arguments, the same on the CPU and the card, with no host RNG.
    ``update`` is a Python int or a 0-dim int64 tensor (the same
    permutation; a CUDA graph of the update reads the tensor at every
    replay). Returns int64[num_minibatches, n // num_minibatches].
    """
    rows = torch.arange(n, dtype=torch.int64, device=device)
    bits = rng.kinetic_hash32(key, rows, update, epoch)
    perm = torch.sort(bits, stable=True).indices
    return perm.reshape(num_minibatches, -1)
