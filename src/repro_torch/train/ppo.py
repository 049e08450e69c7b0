"""PPO over the market env (the counterpart of ``repro.train.ppo``).

The JAX package compiles rollout, GAE and every minibatched gradient step
into one executable. PyTorch has no ``jit`` or ``scan``, so here one update
is a host loop of device work with nothing read back::

    update  =  collect: rollout(env, actor, T)        # T env steps
               advantages: gae(...)                   # reverse loop over T
               optimize: epochs x minibatches of { autograd + adam }

  * The rollout goes through :func:`repro_torch.env.rollout` with a carried
    actor under ``torch.no_grad()``: on ``cuda-kinetic`` one launch of
    kernel 1 per env step, on ``cuda-naive`` one of kernel 2.
  * Actions are drawn by Gumbel-max over ``uniform32`` keyed by (key,
    update, rollout step, market, action), all T steps' noise in one hash
    per update: no ``torch.multinomial`` and no host RNG, so a draw is a
    pure function of the train state and nothing waits for the card.
  * The gradient steps run in torch autograd over an :class:`ActorCritic`
    module; the optimizer is a hand-written Adam with the JAX package's
    formula and global-norm clip (:func:`adam_apply`), a pure function of
    tensors, so the optimizer state is an explicit tree that checkpoints bit
    for bit.
  * Metrics stay device tensors of shape [U] until the caller reads them.

Experience batching follows the engine's axes: the market axis M is always
the batch; ``num_envs > 1`` adds whole rollouts over runtime seeds
``spec.seed + i`` (the backends whose step core takes one: ``torch-scan``
and ``torch-per-step``), rolled out in turn and stacked to [B, T, ...], the
counterpart of the JAX package's ``vmap``. The kernel backends take their
seed from the spec, as Pallas bakes it, so there M is the batch.

What equals the JAX package: the scripted policies, the quote grid, GAE
and the env state, bit for bit. What cannot: the parameter init
(``torch.Generator`` against ``jax.random``), the action draws and the
minibatch permutations (the counter hash against ``jax.random``), and
anything after a gradient (autodiff and reduction order); those are held
within a tolerance on equal inputs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import rng, session
from repro_torch.env.core import MarketEnv, rollout
from repro_torch.train import buffers
from repro_torch.train.buffers import tree_leaves, tree_map
from repro_torch.train.policies import (ActorCritic, QuoteGrid,
                                        apply_actor_critic,
                                        init_actor_critic, logits_entropy,
                                        logits_log_prob)

#: The metrics :meth:`PPOTrainer.train` returns, each f32[U].
METRICS = ("loss", "pg_loss", "v_loss", "entropy", "approx_kl", "reward",
           "value")
# Salts deriving the two draw streams from the train state's key.
_ACTIONS, _MINIBATCHES = 1, 2


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Trainer config: the JAX package's fields and defaults."""

    rollout_len: int = 64          # T: env steps collected per update
    num_updates: int = 16          # U: default updates per train() call
    num_envs: int = 1              # B: rollouts over runtime seeds
    num_epochs: int = 2            # passes over each update's transitions
    num_minibatches: int = 4       # gradient steps per epoch
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    lr: float = 3e-4
    max_grad_norm: float = 0.5
    hidden: Tuple[int, ...] = (32, 32)
    k_max: int = 3                 # quote grid half-width (A = 2*k_max + 1)
    qty: float = 1.0
    seed: int = 0


class AdamState(NamedTuple):
    mu: Any     # first-moment tree, mirrors params
    nu: Any     # second-moment tree, mirrors params
    count: Any  # i32 step counter (a 0-dim device tensor)


class TrainState(NamedTuple):
    """Everything one update reads and writes.

    ``key`` is a CPU ``uint32[2]`` tensor, the JAX package's key leaf; it
    seeds every draw together with ``update_idx`` (a Python int, the global
    update counter) and does not change between updates. ``env_state`` is
    one :class:`EnvState`, or a tuple of ``num_envs`` of them.
    """

    params: Any
    opt_state: Any
    key: Any
    env_state: Any
    update_idx: int


def adam_init(params) -> AdamState:
    count_device = tree_leaves(params)[0].device
    return AdamState(mu=tree_map(torch.zeros_like, params),
                     nu=tree_map(torch.zeros_like, params),
                     count=torch.zeros((), dtype=torch.int32,
                                       device=count_device))


def adam_apply(params, grads, state: AdamState, *, lr: float,
               b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
               max_grad_norm: Optional[float] = None):
    """One bias-corrected Adam step; optional global-norm gradient clip.

    The JAX package's formula in its order of operations. Every quantity
    stays a tensor, so nothing waits for the card.
    """
    if max_grad_norm is not None:
        sq = sum(torch.sum(torch.square(g)) for g in tree_leaves(grads))
        gnorm = torch.sqrt(sq)
        # max_grad_norm / x as a true division (a Python scalar over a
        # tensor would multiply by the reciprocal).
        scale = torch.clamp(torch.full_like(gnorm, max_grad_norm)
                            / torch.clamp(gnorm, min=1e-12), max=1.0)
        grads = tree_map(lambda g: g * scale, grads)
    count = state.count + 1
    mu = tree_map(lambda m, g: b1 * m + (1.0 - b1) * g, state.mu, grads)
    nu = tree_map(lambda v, g: b2 * v + (1.0 - b2) * g * g, state.nu, grads)
    c = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, c)
    bc2 = 1.0 - torch.pow(b2, c)
    new_params = tree_map(
        lambda p, m, v: p - lr * (m / bc1) / (torch.sqrt(v / bc2) + eps),
        params, mu, nu)
    return new_params, AdamState(mu=mu, nu=nu, count=count)


def ppo_loss(params, mb: buffers.TrainBatch, *, clip_eps: float,
             vf_coef: float, ent_coef: float):
    """Clipped PPO surrogate + clipped value loss + entropy bonus."""
    logits, value = apply_actor_critic(params, mb.obs)
    logp = logits_log_prob(logits, mb.action)
    ratio = torch.exp(logp - mb.log_prob)
    # The JAX package's std is the population std.
    adv = (mb.adv - mb.adv.mean()) / (mb.adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(ratio * adv,
                        torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps)
                        * adv)
    pg_loss = pg.mean()
    v_clip = mb.value + torch.clamp(value - mb.value, -clip_eps, clip_eps)
    v_loss = 0.5 * torch.maximum(torch.square(value - mb.ret),
                                 torch.square(v_clip - mb.ret)).mean()
    entropy = logits_entropy(logits).mean()
    total = pg_loss + vf_coef * v_loss - ent_coef * entropy
    approx_kl = ((ratio - 1.0) - torch.log(ratio)).mean()
    return total, {"loss": total, "pg_loss": pg_loss, "v_loss": v_loss,
                   "entropy": entropy, "approx_kl": approx_kl}


def loss_and_grads(params, mb: buffers.TrainBatch, **loss_kw):
    """``((total, metrics), grads)`` of :func:`ppo_loss`, the counterpart
    of ``jax.value_and_grad(ppo_loss, has_aux=True)``; ``grads`` mirrors
    ``params``."""
    tree = ActorCritic(params).tree()
    total, metrics = ppo_loss(tree, mb, **loss_kw)
    leaves = tree_leaves(tree)
    it = iter(torch.autograd.grad(total, leaves))
    grads = tree_map(lambda _: next(it), tree)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()}), \
        grads


def key_word(key, salt: int) -> int:
    """A 32-bit seed for one draw stream, from the ``uint32[2]`` key."""
    k0, k1 = (int(x) for x in key.tolist())
    return int(rng.kinetic_hash32(k0, k1, salt, 0))


class Rollouts(NamedTuple):
    """One update's experience, leaves [B, T, ...]."""

    extras: buffers.ActorExtras
    reward: torch.Tensor   # f32[B, T, M]
    done: torch.Tensor     # bool[B, T]
    last_obs: torch.Tensor  # f32[B, M, D]: the bootstrap observation


class PPOTrainer:
    """PPO over one :class:`MarketEnv` (see the module docstring).

    Obtain one from :meth:`Engine.trainer`, or construct it over an env. The
    trainer runs on the env's device; nothing is built after construction,
    so a warm engine's ``trace_count`` stays flat across ``train`` calls
    and trainers over other mixtures of the same shape.
    """

    def __init__(self, env: MarketEnv, config: PPOConfig = PPOConfig()):
        backend = env.backend
        if session.is_host_only(backend):
            raise ValueError(
                f"PPO needs a traceable backend (got {backend!r}); the "
                "numpy family is the host reference loop, which gradients "
                "do not flow through in the JAX package either")
        if config.num_envs > 1 and not env._runner.env_runtime_seed:
            raise ValueError(
                f"backend {backend!r} takes its RNG seed from the spec, so "
                "rollouts cannot run over runtime seeds; use num_envs=1 "
                "(the market axis is the batch) or torch-scan")
        n = config.num_envs * config.rollout_len * env.spec.num_markets
        if n % config.num_minibatches:
            raise ValueError(
                f"num_envs*rollout_len*num_markets = {n} transitions per "
                f"update must divide into num_minibatches="
                f"{config.num_minibatches}")
        self.env = env
        self.config = config
        self.quote = QuoteGrid(k_max=config.k_max, qty=config.qty)
        self.num_actions = self.quote.num_actions
        self.obs_dim = env.obs_size()

    @property
    def device(self) -> torch.device:
        return self.env.device

    # ---- lifecycle ----
    def init(self, seed: Optional[int] = None) -> TrainState:
        """Fresh TrainState: params, Adam state, key, env state(s)."""
        cfg = self.config
        seed = cfg.seed if seed is None else int(seed)
        params = init_actor_critic(seed, self.obs_dim, self.num_actions,
                                   cfg.hidden, device=self.device)
        # The JAX package's PRNGKey(seed) layout.
        key = torch.from_numpy(np.array([0, seed & 0xFFFFFFFF], np.uint32))
        if cfg.num_envs > 1:
            env_state = tuple(
                self.env.reset(seed=(self.env.spec.seed + i) & 0xFFFFFFFF)[0]
                for i in range(cfg.num_envs))
        else:
            env_state, _ = self.env.reset()
        return TrainState(params=params, opt_state=adam_init(params),
                          key=key, env_state=env_state, update_idx=0)

    def train(self, ts: TrainState, num_updates: Optional[int] = None):
        """Run ``num_updates`` PPO updates.

        Returns ``(ts, metrics)`` where metrics is a dict of f32[U] device
        tensors (:data:`METRICS`). Nothing inside waits for the card.
        """
        u = self.config.num_updates if num_updates is None \
            else int(num_updates)
        history: Dict[str, list] = {k: [] for k in METRICS}
        for _ in range(u):
            ts, metrics = self.update(ts)
            for k in METRICS:
                history[k].append(metrics[k])
        return ts, {k: (torch.stack(v) if v else
                        torch.zeros((0,), device=self.device))
                    for k, v in history.items()}

    def update(self, ts: TrainState):
        """One PPO update: :meth:`collect`, :meth:`advantages`,
        :meth:`optimize`. Returns ``(ts, metrics)`` of 0-dim tensors."""
        env_state, batch = self.collect(ts)
        flat = self.advantages(ts, batch)
        params, opt_state, metrics = self.optimize(ts, flat)
        metrics["reward"] = batch.reward.mean()
        metrics["value"] = batch.extras.value.mean()
        return TrainState(params=params, opt_state=opt_state, key=ts.key,
                          env_state=env_state,
                          update_idx=ts.update_idx + 1), metrics

    def evaluate(self, params, env: Optional[MarketEnv] = None,
                 n_steps: Optional[int] = None):
        """Greedy (argmax) rollout of the learned policy; returns the
        RolloutBatch. A held-out env of the same shape builds nothing."""
        env = self.env if env is None else env
        with torch.no_grad():
            _, batch, _ = rollout(env, self._eval_step, n_steps,
                                  policy_carry=params)
        return batch

    # ---- the three phases of an update ----
    def collect(self, ts: TrainState):
        """One rollout per env: ``(env_state, Rollouts)``."""
        cfg = self.config
        B, T, M = cfg.num_envs, cfg.rollout_len, self.env.num_markets
        with torch.no_grad():
            noise = self._gumbel(ts)
            states = [ts.env_state] if B == 1 else list(ts.env_state)
            finals, parts = [], []
            for b, state in enumerate(states):
                final, batch, _ = rollout(
                    self.env, self._actor_step, T, state=state,
                    policy_carry=(ts.params, noise[:, b * M:(b + 1) * M], 0))
                finals.append(final)
                parts.append((batch.extras, batch.reward, batch.done,
                              batch.obs[-1]))
        extras, reward, done, last_obs = (
            buffers.tree_map(lambda *xs: torch.stack(xs), *leaf)
            for leaf in zip(*parts))
        env_state = finals[0] if B == 1 else tuple(finals)
        return env_state, Rollouts(extras, reward, done, last_obs)

    def advantages(self, ts: TrainState, batch: Rollouts):
        """GAE over [B, T, M] and the flattened :class:`TrainBatch`."""
        cfg = self.config
        with torch.no_grad():
            _, last_value = apply_actor_critic(ts.params, batch.last_obs)
            done_f = batch.done[..., None].to(torch.float32) \
                .expand(batch.reward.shape)
            adv, ret = buffers.gae(
                batch.reward.transpose(0, 1),
                batch.extras.value.transpose(0, 1),
                done_f.transpose(0, 1), last_value, cfg.gamma,
                cfg.gae_lambda)
            ex = batch.extras
            return buffers.TrainBatch(
                obs=ex.obs.reshape(-1, self.obs_dim),
                action=ex.action.reshape(-1),
                log_prob=ex.log_prob.reshape(-1),
                value=ex.value.reshape(-1),
                adv=adv.transpose(0, 1).reshape(-1),
                ret=ret.transpose(0, 1).reshape(-1))

    def optimize(self, ts: TrainState, flat: buffers.TrainBatch):
        """``num_epochs`` x ``num_minibatches`` autograd + Adam steps:
        ``(params, opt_state, metrics)``, the loss metrics averaged."""
        cfg = self.config
        params, opt_state = ts.params, ts.opt_state
        word = key_word(ts.key, _MINIBATCHES)
        steps = []
        for epoch in range(cfg.num_epochs):
            idx = buffers.minibatch_indices(
                word, flat.obs.shape[0], cfg.num_minibatches,
                update=ts.update_idx, epoch=epoch, device=self.device)
            for mb_idx in idx:
                (_, metrics), grads = loss_and_grads(
                    params, buffers.take(flat, mb_idx),
                    clip_eps=cfg.clip_eps, vf_coef=cfg.vf_coef,
                    ent_coef=cfg.ent_coef)
                with torch.no_grad():
                    params, opt_state = adam_apply(
                        params, grads, opt_state, lr=cfg.lr,
                        max_grad_norm=cfg.max_grad_norm)
                steps.append(metrics)
        return params, opt_state, {
            k: torch.stack([m[k] for m in steps]).mean() for k in steps[0]}

    # ---- the policies the rollouts run ----
    def _gumbel(self, ts: TrainState):
        """Gumbel noise f32[T, B*M, A] for every draw of one update."""
        cfg = self.config
        B, T, A = cfg.num_envs, cfg.rollout_len, self.num_actions
        n = B * self.env.num_markets * A
        gid = torch.arange(n, dtype=torch.int64, device=self.device)
        step = torch.arange(T, dtype=torch.int64, device=self.device)
        u = rng.uniform32(key_word(ts.key, _ACTIONS), gid[None, :],
                          ts.update_idx, step[:, None])
        # u == 0 gives -inf: that action is never drawn.
        return (-torch.log(-torch.log(u))).reshape(T, -1, A)

    def _actor_step(self, carry, obs, t):
        params, noise, k = carry
        logits, value = apply_actor_critic(params, obs)
        action = torch.argmax(logits + noise[k], dim=-1).to(torch.int32)
        log_prob = logits_log_prob(logits, action)
        orders = self.quote.to_orders(action, obs[:, 0],
                                      self.env.spec.num_levels)
        extras = buffers.ActorExtras(obs=obs, action=action,
                                     log_prob=log_prob, value=value)
        return (params, noise, k + 1), orders, extras

    def _eval_step(self, params, obs, t):
        logits, value = apply_actor_critic(params, obs)
        action = torch.argmax(logits, dim=-1).to(torch.int32)
        orders = self.quote.to_orders(action, obs[:, 0],
                                      self.env.spec.num_levels)
        return params, orders, {"action": action, "value": value}
