"""Policy zoo for the market env: scripted baselines and a learned trader
(the counterpart of ``repro.train.policies``).

Two families live here:

* **Scripted archetypes** (:func:`make_market_maker`,
  :func:`make_random_policy`): stateless ``policy(obs, t)`` functions of
  torch tensors and the env's integer step cursor, equal to the JAX
  package's on equal inputs.
* **A learned actor-critic**: a small MLP over a discrete quote grid
  (:class:`QuoteGrid`). Its parameters are a tree of nested dicts and tuples
  of float32 tensors in the JAX package's layout (``{"torso": ((W, b), ...),
  "pi": (W, b), "v": (W, b)}`` with ``W`` of shape ``[n_in, n_out]``), so a
  JAX checkpoint's policy tree loads with no transpose;
  :func:`apply_actor_critic` is a plain function of that tree, and
  :class:`ActorCritic` holds it as an ``nn.Module``.

The discrete action space is market-maker shaped: action 0 holds; actions
``1..k_max`` quote a buy ``k`` ticks below mid; actions
``k_max+1..2*k_max`` quote a sell ``k - k_max`` ticks above mid. Lowering
goes through the same :class:`ExternalOrders` path as every scripted
policy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core import rng
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.session import ExternalOrders


# ---------------------------------------------------------------------------
# Scripted archetypes.
# ---------------------------------------------------------------------------

def make_market_maker(num_levels: int):
    """Quote one lot one tick inside the spread, alternating sides.

    The scripted maker archetype: earns the spread, carries inventory, no
    risk control; the baseline the learned maker has to beat. ``t`` is the
    env's integer step cursor.
    """

    def market_maker(obs, t):
        mid = obs[:, 0]
        buy = t % 2 == 0
        tick = torch.clamp(torch.round(mid + (-1.0 if buy else 1.0))
                           .to(torch.int32), 0, num_levels - 1)
        return ExternalOrders(
            side_buy=torch.full(mid.shape, buy, device=mid.device),
            price=tick, qty=torch.ones_like(mid))

    return market_maker


def make_random_policy(num_levels: int, stream: int = 101):
    """Uniform random orders from the stateless counter RNG: a pure function
    of (stream, market, step), so it replays bit for bit on every backend."""

    def random_policy(obs, t):
        gid = torch.arange(obs.shape[0], dtype=torch.int64,
                           device=obs.device)
        u_side = rng.uniform32(stream, gid, t, 0)
        u_tick = rng.uniform32(stream, gid, t, 1)
        mid = obs[:, 0]
        tick = torch.clamp(torch.round(mid + (u_tick * 8.0 - 4.0))
                           .to(torch.int32), 0, num_levels - 1)
        return ExternalOrders(side_buy=u_side < 0.5, price=tick,
                              qty=torch.ones_like(mid))

    return random_policy


# ---------------------------------------------------------------------------
# Discrete quote grid: action index -> ExternalOrders.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuoteGrid:
    """Discrete market-making action space around the mid.

    ``num_actions = 2 * k_max + 1``: index 0 holds, ``1..k_max`` buys ``k``
    ticks below mid, ``k_max+1..2*k_max`` sells ``k - k_max`` ticks above.
    """

    k_max: int = 3
    qty: float = 1.0

    @property
    def num_actions(self) -> int:
        return 2 * self.k_max + 1

    def to_orders(self, action, mid, num_levels: int) -> ExternalOrders:
        a = action.to(torch.int32)
        buy = (a >= 1) & (a <= self.k_max)
        off = torch.where(buy, -a, a - self.k_max).to(torch.float32)
        price = torch.clamp(torch.round(mid + off).to(torch.int32),
                            0, num_levels - 1)
        q = torch.where(a > 0, self.qty, 0.0).to(torch.float32)
        return ExternalOrders(side_buy=buy, price=price, qty=q)


# ---------------------------------------------------------------------------
# The actor-critic MLP.
# ---------------------------------------------------------------------------

def init_actor_critic(seed: int, obs_dim: int, num_actions: int,
                      hidden: Tuple[int, ...] = (32, 32),
                      device=DEFAULT_DEVICE) -> Dict[str, Any]:
    """A ``{torso, pi, v}`` parameter tree with orthogonal weights and zero
    biases, on ``device``.

    The weights are drawn on the CPU from a ``torch.Generator`` seeded with
    ``seed`` (gains sqrt(2) for the torso, 0.01 for the policy head, 1 for
    the value head, as in the JAX package) and then moved, so the CPU and
    the card start from the same params. They cannot equal ``jax.random``'s
    draws bit for bit: the same seed gives other (equally orthogonal)
    matrices than ``repro``'s; carry those across with
    :func:`repro_torch.convert.actor_critic_from_numpy`.
    """
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu").manual_seed(int(seed))

    def dense(n_in, n_out, scale):
        w = torch.empty((n_in, n_out), dtype=torch.float32)
        nn.init.orthogonal_(w, gain=scale, generator=gen)
        return (w.to(dev), torch.zeros((n_out,), dtype=torch.float32,
                                       device=dev))

    torso, n_in = [], obs_dim
    for n_out in hidden:
        torso.append(dense(n_in, n_out, float(np.sqrt(2.0))))
        n_in = n_out
    return {"torso": tuple(torso),
            "pi": dense(n_in, num_actions, 0.01),
            "v": dense(n_in, 1, 1.0)}


def apply_actor_critic(params, obs):
    """(logits[..., A], value[...]) from obs[..., D]; any leading dims."""
    x = obs
    for w, b in params["torso"]:
        x = torch.tanh(x @ w + b)
    wp, bp = params["pi"]
    wv, bv = params["v"]
    return x @ wp + bp, (x @ wv + bv)[..., 0]


def logits_log_prob(logits, action):
    """log pi(action | obs) from raw logits.

    Selected with a one-hot mask rather than ``gather``: on the card the
    backward of ``gather`` is an atomic scatter, whose sums vary run to run;
    the mask's backward is elementwise, so gradients are deterministic.
    """
    logp = torch.log_softmax(logits, dim=-1)
    arange = torch.arange(logits.shape[-1], device=logits.device)
    onehot = action[..., None].to(torch.int64) == arange
    return torch.where(onehot, logp, 0.0).sum(dim=-1)


def logits_entropy(logits):
    """Per-row policy entropy from raw logits."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


class ActorCritic(nn.Module):
    """The actor-critic as an ``nn.Module`` over a params tree.

    The module's parameters share storage with the tree's tensors (no copy)
    and keep the ``[n_in, n_out]`` layout; :meth:`tree` returns them in the
    tree's structure, and :meth:`forward` is :func:`apply_actor_critic`.
    """

    def __init__(self, params):
        super().__init__()
        self.torso = nn.ParameterList(
            [p for layer in params["torso"] for p in layer])
        self.pi = nn.ParameterList(params["pi"])
        self.v = nn.ParameterList(params["v"])

    def tree(self) -> Dict[str, Any]:
        torso = list(self.torso)
        return {"torso": tuple(zip(torso[0::2], torso[1::2])),
                "pi": tuple(self.pi), "v": tuple(self.v)}

    def forward(self, obs):
        return apply_actor_critic(self.tree(), obs)

