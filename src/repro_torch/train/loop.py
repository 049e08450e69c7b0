"""Host-side training loop: checkpointed spans of updates (the
counterpart of ``repro.train.loop``).

:func:`fit` calls the trainer's ``train()`` in equal spans, reads the
metrics back *between* spans, and threads the whole :class:`TrainState`
through ``CheckpointManager`` in the JAX package's wire format: policy and
optimizer trees beside the env states, under the COMMIT-marker protocol.
A restore continues the learning curve bit for bit: params, Adam moments,
key, update counter and every env leaf round-trip exactly. Either package
restores the other's trainer checkpoints; the ``key`` leaf is then
reinterpreted (the port derives its counter-hash draws from it, ``repro``
its ``jax.random`` splits), so the draws after a cross-package restore
differ.
"""
from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            meta_leaf, read_meta)
from repro_torch.convert import actor_critic_from_numpy, actor_critic_to_numpy
from repro_torch.core.result import to_host
from repro_torch.env.core import state_from_tree, state_tree
from repro_torch.train.ppo import AdamState, PPOTrainer, TrainState

#: format tag of the trainer wire format (versioning rides in meta_leaf).
TRAIN_FORMAT = "ppo-train"


# ---------------------------------------------------------------------------
# Checkpoint wire format.
# ---------------------------------------------------------------------------

def train_state_tree(trainer: PPOTrainer, ts: TrainState) -> Dict[str, Any]:
    """Pack a :class:`TrainState` into a checkpointable tree.

    Policy params and Adam moments go in as their nested dict/tuple
    structure; each env of the batch is packed through the env's own wire
    format under ``envs/<i>``.
    """
    B = trainer.config.num_envs
    states = [ts.env_state] if B == 1 else list(ts.env_state)
    envs = {f"{i:04d}": state_tree(trainer.env.snapshot(s))
            for i, s in enumerate(states)}
    opt = {"mu": actor_critic_to_numpy(ts.opt_state.mu),
           "nu": actor_critic_to_numpy(ts.opt_state.nu),
           "count": np.asarray(to_host(ts.opt_state.count), np.int32)}
    meta = {"format": TRAIN_FORMAT, "num_envs": B,
            "update_idx": int(ts.update_idx)}
    return {"train_meta": meta_leaf(meta),
            "policy": actor_critic_to_numpy(ts.params), "opt": opt,
            "key": np.asarray(to_host(ts.key), np.uint32), "envs": envs}


def train_state_from_tree(trainer: PPOTrainer,
                          tree: Dict[str, Any]) -> TrainState:
    """Inverse of :func:`train_state_tree`: a bit-exact TrainState on the
    trainer's device (from either package's tree)."""
    meta = read_meta(tree["train_meta"], what="trainer checkpoint")
    if meta.get("format") != TRAIN_FORMAT:
        raise CheckpointCorruptError(
            f"not a trainer checkpoint (format={meta.get('format')!r})")
    B = int(meta["num_envs"])
    if B != trainer.config.num_envs:
        raise CheckpointCorruptError(
            f"checkpoint was written with num_envs={B}; trainer config "
            f"has num_envs={trainer.config.num_envs}")
    device = trainer.device
    opt_state = AdamState(
        mu=actor_critic_from_numpy(tree["opt"]["mu"], device),
        nu=actor_critic_from_numpy(tree["opt"]["nu"], device),
        count=torch.from_numpy(np.asarray(tree["opt"]["count"], np.int32)
                               .copy()).to(device))
    states = [trainer.env.restore(state_from_tree(tree["envs"][k]))
              for k in sorted(tree["envs"])]
    return TrainState(
        params=actor_critic_from_numpy(tree["policy"], device),
        opt_state=opt_state,
        key=torch.from_numpy(np.asarray(tree["key"], np.uint32).copy()),
        env_state=states[0] if B == 1 else tuple(states),
        update_idx=int(meta["update_idx"]))


def save_train_checkpoint(manager, trainer: PPOTrainer, ts: TrainState,
                          step: Optional[int] = None) -> int:
    """Persist a TrainState through a ``CheckpointManager`` (blocking)."""
    step = int(ts.update_idx) if step is None else int(step)
    manager.save(step, train_state_tree(trainer, ts))
    manager.wait()
    return step


def restore_train_checkpoint(manager, trainer: PPOTrainer,
                             step: Optional[int] = None) -> TrainState:
    """Load a TrainState from a ``CheckpointManager``."""
    tree = manager.restore(step)
    if tree is None:
        raise FileNotFoundError(f"no checkpoint found in {manager.dir}")
    return train_state_from_tree(trainer, tree)


# ---------------------------------------------------------------------------
# fit(): spans of updates with host-side bookkeeping between them.
# ---------------------------------------------------------------------------

def fit(trainer: PPOTrainer, ts: Optional[TrainState] = None, *,
        total_updates: Optional[int] = None,
        updates_per_call: Optional[int] = None,
        reward_threshold: Optional[float] = None,
        ckpt_manager=None, ckpt_every: int = 0,
        log_fn=None) -> Dict[str, Any]:
    """Train in equal spans; returns ``{ts, history, ...}``.

    ``total_updates`` defaults to the config's ``num_updates``;
    ``updates_per_call`` (default: one span) must divide it.
    ``reward_threshold`` stops early once a span's mean reward/step/market
    crosses it and records the wall-clock time to reach it; ``ckpt_every``
    > 0 checkpoints the TrainState every that-many updates (and at the
    end). The metrics are read back once a span, at its end.
    """
    cfg = trainer.config
    total = cfg.num_updates if total_updates is None else int(total_updates)
    span = total if updates_per_call is None else int(updates_per_call)
    if span <= 0 or total % span:
        raise ValueError(
            f"updates_per_call={span} must divide total_updates={total} "
            "(equal spans, as in the JAX package)")
    if ts is None:
        ts = trainer.init()
    history: Dict[str, list] = {}
    t0 = time.perf_counter()
    time_to_threshold = None
    done_updates = 0
    while done_updates < total:
        ts, metrics = trainer.train(ts, span)
        done_updates += span
        host = {k: to_host(v) for k, v in metrics.items()}
        for k, v in host.items():
            history.setdefault(k, []).extend(v.tolist())
        span_reward = float(host["reward"].mean())
        if log_fn is not None:
            log_fn(done_updates, host)
        if ckpt_manager is not None and ckpt_every > 0 \
                and done_updates % ckpt_every == 0:
            save_train_checkpoint(ckpt_manager, trainer, ts)
        if reward_threshold is not None and time_to_threshold is None \
                and span_reward >= reward_threshold:
            time_to_threshold = time.perf_counter() - t0
            break
    seconds = time.perf_counter() - t0
    if ckpt_manager is not None and ckpt_every > 0:
        save_train_checkpoint(ckpt_manager, trainer, ts)
    env_steps = (done_updates * cfg.rollout_len * cfg.num_envs
                 * trainer.env.spec.num_markets)
    return {"ts": ts, "history": {k: np.asarray(v)
                                  for k, v in history.items()},
            "updates": done_updates, "seconds": seconds,
            "env_steps": env_steps,
            "env_steps_per_s": env_steps / max(seconds, 1e-9),
            "time_to_threshold": time_to_threshold}
