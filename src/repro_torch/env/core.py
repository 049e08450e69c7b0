"""The RL environment over the engine: the counterpart of ``repro.env.core``.

    env = Engine("cuda-kinetic").env(spec)
    state, obs = env.reset()
    state, obs, reward, done, info = env.step(state, actions)
    final, batch = rollout(env, policy_fn, n_steps)

The JAX package compiles a whole rollout into one ``lax.scan``. PyTorch has
no ``jit``, ``vmap`` or ``scan``: here the env steps in Python, and
:func:`rollout` runs its body (:func:`_rollout_body`) as one captured CUDA
graph on one card, replayed with no host work per kernel, and as a host
loop on the CPU, the numpy family and a mesh:

  * :class:`EnvState` holds the engine's ``MarketState`` and
    ``PackedParams``, the portfolio accounting, the step cursor, optional
    ``MarketStats`` accumulators, a runtime seed and the stateful RNG.
    ``t`` is a Python int and ``done`` a Python bool, so the cursor never
    waits for the card; the auto-reset is a Python branch on ``done`` that
    gives the values of the JAX package's ``where`` selects.
  * The step core is the runner's :meth:`ChunkRunner.env_step_fn`, on the
    engine's one-step runner (the one :meth:`Session.step` uses): on
    ``cuda-kinetic`` one launch of kernel 1 per step, on ``cuda-naive`` one
    of kernel 2, on the eager and numpy backends one ``simulate_step``. A
    zero-action trajectory equals ``Session.run`` bit for bit, and nothing
    reaches the host inside the loop on the card. A second env of the same
    shape reuses the runner, so ``Engine.trace_count`` stays flat.
  * The state is placed through the runner's hooks (``init_state``,
    ``params_to_device``, ``place``, ``to_device``),
    as the JAX package's env is. On a mesh every ``[M, ...]`` leaf (books,
    scalars, params, the last output, the portfolio, the stats) is a
    :class:`~repro_torch.launch.sharding.RowShards`, each shard's rows on
    its device from reset to the end: the step core launches on them, and
    fill attribution, the portfolio, the reward, the stats and the
    auto-reset run shard by shard (``sharding.per_shard``). A step places
    only the ``[M]`` order triple and moves the ring of entry mids; only
    what the caller reads is joined on the first device: the observation,
    the reward and the :class:`StepInfo` columns. Unsharded, the same code
    is one call on plain tensors.
  * Actions are per-market external limit orders lowered onto the
    ``ext_buy``/``ext_ask`` slot (:mod:`repro_torch.env.actions`), on each
    shard for its rows; ``actions=None`` passes no operand, which adds
    nothing.
  * Observations and rewards are pluggable frozen specs
    (:mod:`repro_torch.env.obs`, :mod:`repro_torch.env.rewards`).
  * Snapshots use the JAX package's wire format (:func:`state_tree`), so an
    env state restores in either package, the ``numpy-pcg64`` RNG included.

Validation follows the JAX package backend by backend: :meth:`MarketEnv.step`
checks its actions' values eagerly; :func:`rollout` on the card and eager
backends (the JAX package's traced scan) checks only their shapes and
sanitizes them on the device, and on the numpy family (its host loop)
checks every step. Runtime seeds work where the step core takes one
(``torch-scan``, ``torch-per-step``, ``numpy``, ``numpy-splitmix64``).
"""
from __future__ import annotations

import json
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import auction, graphs
from repro_torch.core import session
from repro_torch.core.config import MarketConfig
from repro_torch.core.device import upload
from repro_torch.core.params import (EnsembleSpec, PackedParams,
                                     params_from_dict)
from repro_torch.core.result import to_host
from repro_torch.core.session import Engine, ExternalOrders
from repro_torch.core.stats import MarketStats, accumulate, init_stats
from repro_torch.core.step import MarketState, StepOutput
from repro_torch.env import actions as actions_mod
from repro_torch.env.obs import MarketFeatures, ObservationSpec
from repro_torch.env.rewards import PnLReward, RewardContext, RewardFn
from repro_torch.launch import sharding
from repro_torch.ops import trace


class Portfolio(NamedTuple):
    """Per-market accounting for the external-order agent; f32[M, 1] each."""

    cash: torch.Tensor       # cumulative signed fill cash flows
    inventory: torch.Tensor  # net lots held (buys - sells)
    equity: torch.Tensor     # cash + inventory * mid (mark-to-market)


class EnvState(NamedTuple):
    """The whole environment state.

    ``last_out`` is the :class:`StepOutput` that produced ``market`` (a
    zero-volume output at reset), so observations are a function of the
    state. ``reset_market`` holds the opening books, the auto-reset target.
    ``seed`` is None (the spec's seed) or a runtime uint32 seed; ``aux`` is
    the ``numpy-pcg64`` generator (None on every counter backend).
    """

    market: MarketState
    last_out: StepOutput
    reset_market: MarketState
    params: PackedParams
    t: int                    # step cursor in the episode
    portfolio: Portfolio
    stats: Optional[MarketStats]
    seed: Optional[int]
    aux: Any


class StepInfo(NamedTuple):
    """Diagnostics for one transition (values before an auto-reset)."""

    price: torch.Tensor     # f32[M, 1] clearing price (last if no cross)
    volume: torch.Tensor    # f32[M, 1] total transacted volume
    mid: torch.Tensor       # f32[M, 1] pre-clearing mid
    fill_buy: torch.Tensor  # f32[M, 1] external buy lots filled
    fill_ask: torch.Tensor  # f32[M, 1] external sell lots filled


class RolloutBatch(NamedTuple):
    """Stacked per-step outputs of a :func:`rollout`.

    ``price``/``volume``/``mid``/``fills`` are laid out ``[M, S]``, like a
    ``Session.run`` batch; ``extras`` stacks what a carried policy returns
    each step (None for a stateless policy).
    """

    obs: torch.Tensor       # f32[S, M, D]
    reward: torch.Tensor    # f32[S, M]
    done: torch.Tensor      # bool[S]
    price: torch.Tensor     # f32[M, S]
    volume: torch.Tensor    # f32[M, S]
    mid: torch.Tensor       # f32[M, S]
    fill_buy: torch.Tensor  # f32[M, S]
    fill_ask: torch.Tensor  # f32[M, S]
    extras: Any = None

    @property
    def num_steps(self) -> int:
        return int(self.reward.shape[0])

    def to_numpy(self) -> "RolloutBatch":
        return RolloutBatch(*(to_host(x) for x in self[:8]),
                            extras=_tree_map(to_host, self.extras))


class MarketEnv:
    """The RL environment (see the module docstring).

    Obtain one from :meth:`Engine.env`, or construct it with a backend name
    and the engine's options (``device=``, ``scan=``). The env object is
    immutable configuration; the simulation state lives in the
    :class:`EnvState` values that :meth:`reset` and :meth:`step` return.
    """

    def __init__(self, spec: Union[EnsembleSpec, MarketConfig],
                 backend: str = "cuda-kinetic", *,
                 obs: Optional[ObservationSpec] = None,
                 reward: Optional[RewardFn] = None,
                 horizon: Optional[int] = None,
                 auto_reset: bool = True,
                 engine: Optional[Engine] = None,
                 **backend_opts: Any):
        if engine is not None and backend_opts:
            raise ValueError(
                "pass backend options to the Engine when engine= is given")
        self.spec = EnsembleSpec.coerce(spec)
        self._engine = engine if engine is not None \
            else Engine(backend, **backend_opts)
        self._runner = self._engine._runner(self.spec, 1)
        if self._runner.stats_only:
            raise ValueError(
                "stats_only engines have no per-step outputs to observe; "
                "open the env on a default engine (StatsFeatures carries "
                "its own accumulators)")
        self._step_core = self._runner.env_step_fn()
        if self._step_core is None:
            raise ValueError(
                f"backend {self._engine.backend!r} exposes no functional "
                "env step core")
        self.obs_spec = obs if obs is not None else MarketFeatures()
        self.reward_fn = reward if reward is not None else PnLReward()
        self.horizon = int(horizon) if horizon is not None \
            else self.spec.num_steps
        if self.horizon <= 0:
            raise ValueError(f"horizon must be >= 1, got {self.horizon}")
        self.auto_reset = bool(auto_reset)
        # The numpy family checks rollout actions' values every step, as
        # the JAX package's host-loop rollout does.
        self._check_rollout_values = session.is_host_only(
            self._engine.backend)
        # Rollouts (and a trainer's updates) run as CUDA graphs on one
        # card; the CPU, the numpy family and a mesh keep the host loop.
        self._graphed = self._runner.graphable
        # The price grid, one copy on each device of the runner's mesh.
        mesh = getattr(self._runner, "mesh", None)
        levels = [torch.arange(self.spec.num_levels, dtype=torch.float32,
                               device=d)[None, :]
                  for d in dict.fromkeys(mesh.devices if mesh is not None
                                         else (self.device,))]
        self._levels = {t.device: t for t in levels}

    # ---- introspection ----
    @property
    def backend(self) -> str:
        return self._engine.backend

    @property
    def engine(self) -> Engine:
        return self._engine

    @property
    def device(self) -> torch.device:
        return self._runner.device

    @property
    def num_markets(self) -> int:
        return self.spec.num_markets

    def obs_size(self) -> int:
        """Feature dimension D of the observation block."""
        return self.obs_spec.size(self.spec)

    # ---- the environment ----
    def reset(self, seed: Any = None) -> Tuple[EnvState, torch.Tensor]:
        """A fresh :class:`EnvState` and its opening observation.

        ``seed`` overrides the RNG seed where the step core takes one
        (``env_runtime_seed``); the kernel backends and ``numpy-pcg64``
        reject it, as the JAX package's Pallas and PCG64 backends do.
        ``seed=None`` is the spec's seed.
        """
        runner = self._runner
        if seed is not None and not runner.env_runtime_seed:
            raise ValueError(
                f"backend {self._engine.backend!r} compiles the RNG seed "
                "into its executable; open the env on a spec with "
                f"seed={seed} instead of passing a runtime override")
        market = runner.init_state(self.spec)
        M = self.spec.num_markets
        zeros = runner.place(torch.zeros((M, 1), dtype=torch.float32,
                                         device=self.device))
        state = EnvState(
            market=market,
            last_out=sharding.per_shard(self._reset_out, market),
            reset_market=runner.init_state(self.spec),
            params=runner.params_to_device(self.spec.params), t=0,
            portfolio=Portfolio(cash=zeros, inventory=zeros, equity=zeros),
            stats=(MarketStats(*map(runner.place,
                                    init_stats(M, self.device)))
                   if self.obs_spec.needs_stats else None),
            seed=None if seed is None else int(seed) & 0xFFFFFFFF,
            aux=runner.init_aux(self.spec))
        return state, self.observe(state)

    def observe(self, state: EnvState) -> torch.Tensor:
        """float32[M, D] observation of ``state``, on the env's device
        (computed on each shard and joined, on a mesh)."""
        def features(market, last_out, portfolio, stats):
            return self.obs_spec.observe(self.spec, market, last_out,
                                         portfolio, stats)

        with trace.span("env.obs"):
            return sharding.join(sharding.per_shard(
                features, state.market, state.last_out, state.portfolio,
                state.stats), self.device)

    def step(self, state: EnvState, actions: Any = None,
             ) -> Tuple[EnvState, torch.Tensor, torch.Tensor, bool, StepInfo]:
        """Advance one step: ``(state, obs, reward, done, info)``.

        ``actions`` is an :class:`ExternalOrders` (or a triple or mapping:
        one external limit order per market), validated eagerly, values
        included; ``None`` advances the markets untouched, bit for bit as
        :meth:`Session.run` does.
        """
        return self._advance(state, actions, check_values=True)

    # ---- internals ----
    def _advance(self, state: EnvState, actions: Any, check_values: bool):
        """:meth:`_lower` and :meth:`_step_impl`, the span ``env.step``."""
        with trace.span("env.step"):
            with trace.span("env.actions"):
                eb, ea = self._lower(actions, check_values)
            return self._step_impl(state, eb, ea)

    def _lower(self, actions: Any, check_values: bool):
        """Validate ``actions`` where they are, place the ``[M]`` order
        triple as the runner holds its rows, and lower it to the
        ``(ext_buy, ext_ask)`` grids on each shard."""
        if actions is None:
            return None, None
        M, L = self.spec.num_markets, self.spec.num_levels
        orders = actions_mod.validate_actions(actions, M, L, check_values)
        placed = ExternalOrders(*(
            self._runner.place(self._on_device(x).reshape(-1).expand(M))
            for x in orders))
        return sharding.per_shard(
            lambda o: actions_mod.lower_actions(o, o.qty.shape[0], L,
                                                o.qty.device), placed)

    def _on_device(self, x: Any) -> torch.Tensor:
        """An action field off the host: a device tensor as it is, a host
        value staged on the env's device (:func:`graphs.stage`: baked into
        a CUDA graph under capture, as JAX bakes a host constant)."""
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            return x
        return graphs.stage(torch.as_tensor(x), self.device)

    def _reset_out(self, market: MarketState) -> StepOutput:
        """The zero-volume output describing a freshly reset state."""
        _, _, mid = auction.best_quotes(market.bid, market.ask,
                                        market.last_price)
        return StepOutput(price=market.last_price,
                          volume=torch.zeros_like(mid), mid=mid)

    def _transition(self, reset: bool, out: StepOutput, prev: Portfolio,
                    stats: Optional[MarketStats], eb, ea,
                    reset_market: MarketState):
        """The row-wise part of a step on one shard's rows (all rows
        unsharded): ``(portfolio, reward, stats, info, last_out)``."""
        # Fill attribution (price-priority, no rationing; rewards.py).
        pstar = out.price
        if eb is None:
            fill_buy = fill_ask = torch.zeros_like(pstar)
        else:
            levels = self._levels[pstar.device]
            executed = out.volume > 0.0
            fill_buy = torch.where(
                executed, torch.where(levels >= pstar, eb, 0.0)
                .sum(dim=-1, keepdim=True), 0.0)
            fill_ask = torch.where(
                executed, torch.where(levels <= pstar, ea, 0.0)
                .sum(dim=-1, keepdim=True), 0.0)

        cash = prev.cash - fill_buy * pstar + fill_ask * pstar
        inventory = prev.inventory + fill_buy - fill_ask
        equity = cash + inventory * out.mid
        portfolio = Portfolio(cash=cash, inventory=inventory, equity=equity)
        reward = self.reward_fn(RewardContext(
            fill_buy=fill_buy, fill_ask=fill_ask, fill_price=pstar, out=out,
            prev=prev, portfolio=portfolio))
        if stats is not None:
            stats = accumulate(stats, out.mid, out.volume)
        info = StepInfo(price=out.price, volume=out.volume, mid=out.mid,
                        fill_buy=fill_buy, fill_ask=fill_ask)
        last_out = out
        if reset:
            portfolio = Portfolio(*(torch.zeros_like(c) for c in portfolio))
            if stats is not None:
                stats = init_stats(pstar.shape[0], pstar.device)
            last_out = self._reset_out(reset_market)
        return portfolio, reward, stats, info, last_out

    def _step_impl(self, state: EnvState, eb, ea):
        """The transition shared by :meth:`step` and :func:`rollout`."""
        with trace.span("env.clear"):
            market, out, aux = self._step_core(
                state.market, state.params, state.t, eb, ea, state.seed,
                state.aux)
        t_next = state.t + 1
        done = t_next >= self.horizon
        reset = self.auto_reset and done
        with trace.span("env.transition"):
            portfolio, reward, stats, info, last_out = sharding.per_shard(
                lambda *rows: self._transition(reset, *rows), out,
                state.portfolio, state.stats, eb, ea, state.reset_market)
        if reset:
            market, t_next = state.reset_market, 0

        new_state = state._replace(market=market, last_out=last_out, t=t_next,
                                   portfolio=portfolio, stats=stats, aux=aux)
        device = self.device
        return (new_state, self.observe(new_state),
                sharding.join(reward, device), done,
                StepInfo(*(sharding.join(x, device) for x in info)))

    # ---- snapshot / checkpoint ----
    def snapshot(self, state: EnvState) -> Dict[str, Any]:
        """Host copy of an :class:`EnvState` in the JAX package's format
        (:meth:`restore` in either package takes it)."""
        snap: Dict[str, Any] = {
            "market": _tuple_to_dict(state.market),
            "last_out": _tuple_to_dict(state.last_out),
            "reset_market": _tuple_to_dict(state.reset_market),
            "params": _tuple_to_dict(PackedParams(*(
                torch.from_numpy(sharding.to_host(x))
                for x in state.params)).to_numpy()),
            "portfolio": _tuple_to_dict(state.portfolio),
            "t": int(state.t),
            "rng": self._runner.aux_state(state.aux),
            "static_seed": self.spec.seed,
            "num_agents": self.spec.num_agents,
            "horizon": self.horizon,
        }
        if state.stats is not None:
            snap["stats"] = _tuple_to_dict(state.stats)
        if state.seed is not None:
            snap["seed"] = int(state.seed)
        return snap

    def restore(self, snap: Dict[str, Any]) -> EnvState:
        """A live :class:`EnvState` from a snapshot of either package,
        placed through the runner's hooks (on a mesh of any shard count,
        each shard's rows on its device). A snapshot taken under another
        seed or agent count raises."""
        runner = self._runner
        for field, have in (("static_seed", self.spec.seed),
                            ("num_agents", self.spec.num_agents)):
            got = snap.get(field)
            if got is not None and int(got) != have:
                raise ValueError(
                    f"snapshot was taken under {field}={int(got)} but this "
                    f"env's executable is compiled for {field}={have}")

        def placed(cls, d):
            return runner.to_device(cls(*(np.asarray(d[f], np.float32)
                                          for f in cls._fields)))

        stats = None
        if snap.get("stats") is not None:
            stats = placed(MarketStats, snap["stats"])
        elif self.obs_spec.needs_stats:
            raise ValueError(
                "snapshot carries no MarketStats accumulators but this "
                "env's observation spec needs them")
        rng, seed = snap.get("rng"), snap.get("seed")
        return EnvState(
            market=placed(MarketState, snap["market"]),
            last_out=placed(StepOutput, snap["last_out"]),
            reset_market=placed(MarketState, snap["reset_market"]),
            params=runner.params_to_device(params_from_dict(
                snap["params"], self.spec.num_markets,
                self.spec.num_levels)),
            t=int(snap["t"]), portfolio=placed(Portfolio, snap["portfolio"]),
            stats=stats,
            seed=None if seed is None else int(seed) & 0xFFFFFFFF,
            aux=(runner.restore_aux(rng) if rng is not None
                 else runner.init_aux(self.spec)))

    def save_checkpoint(self, manager, state: EnvState,
                        step: Optional[int] = None) -> int:
        """Persist an :class:`EnvState` through a ``CheckpointManager``."""
        step = int(state.t) if step is None else int(step)
        manager.save(step, state_tree(self.snapshot(state)))
        manager.wait()
        return step

    def restore_checkpoint(self, manager,
                           step: Optional[int] = None) -> EnvState:
        """Load an :class:`EnvState` from a ``CheckpointManager``."""
        tree = manager.restore(step)
        if tree is None:
            raise FileNotFoundError(f"no checkpoint found in {manager.dir}")
        return self.restore(state_from_tree(tree))


# ---------------------------------------------------------------------------
# Rollouts: one body, run eagerly or captured into a CUDA graph.
# ---------------------------------------------------------------------------

#: sentinel: distinguishes "no carry" from a legitimate ``None`` carry.
_NO_CARRY = object()


def rollout(env: MarketEnv, policy_fn: Optional[Callable] = None,
            n_steps: Optional[int] = None, *, state: Optional[EnvState] = None,
            seed: Any = None, policy_carry: Any = _NO_CARRY):
    """Roll ``policy_fn`` through ``env`` for ``n_steps`` steps.

    ``policy_fn(obs, t) -> actions`` maps the float32[M, D] observation and
    the step cursor to per-market actions (or None to hold). A stateful
    policy passes ``policy_carry=<initial carry>`` and has the signature
    ``policy_fn(carry, obs, t) -> (carry, actions, extras)``: the carry
    threads through the steps, the per-step ``extras`` (a tree of tensors,
    or None) are stacked into ``batch.extras``, and the return value gains
    the final carry: ``(state, batch, carry)``.

    On one card the whole rollout, env and policy, runs as one CUDA graph,
    the counterpart of the JAX package's one jitted ``lax.scan``: captured
    at the first call of its key (the engine's cache, counted by
    ``Engine.trace_count``) and replayed with no host work per kernel and
    nothing read back. The key is ``(policy_fn, env, n_steps, carried)``
    and the signature of the state and the carry, whose Python leaves (the
    cursor ``state.t``, the runtime seed) are baked, as JAX bakes static
    arguments; so pass a *stable* ``policy_fn`` (a fresh lambda a call
    captures anew), and host values a policy returns are baked too. The
    graph carries no autograd graph. The CPU, the numpy family and a mesh
    run the same body as a host loop (:func:`_rollout_body`).

    ``n_steps`` defaults to the horizon; ``state`` resumes a rollout (else
    :meth:`MarketEnv.reset` with ``seed``) and is never written. Returns
    the final :class:`EnvState` and a :class:`RolloutBatch` whose paths
    are laid out ``[M, S]``, comparable bit for bit with ``Session.run``.
    """
    carried = policy_carry is not _NO_CARRY
    if carried and policy_fn is None:
        raise ValueError(
            "policy_carry requires a policy_fn with the carried signature "
            "policy_fn(carry, obs, t) -> (carry, actions, extras)")
    n = env.horizon if n_steps is None else int(n_steps)
    if n < 0:
        raise ValueError(f"n_steps must be >= 0, got {n}")
    if state is None:
        state, _ = env.reset(seed=seed)
    pc = policy_carry if carried else None
    if env._graphed and n:
        # A bound method compares equal to itself, so a trainer's actor
        # hits; the signature holds the cursor, the seed and the shapes.
        key = ("rollout", policy_fn, env, n, carried,
               graphs.signature((state, pc)))
        with torch.no_grad():
            state, batch, dones, pc = env.engine._graph(
                key, f"the rollout of policy {_name(policy_fn)} ({n} steps "
                f"from t={state.t})",
                lambda tree: _rollout_body(env, policy_fn, n, carried,
                                           *tree),
                (state, pc))
    else:
        state, batch, dones, pc = _rollout_body(env, policy_fn, n, carried,
                                                state, pc)
    batch = batch._replace(done=upload(torch.tensor(dones, dtype=torch.bool),
                                       env.device))
    if carried:
        return state, batch, pc
    return state, batch


def _name(fn) -> str:
    return getattr(fn, "__qualname__", None) or repr(fn)


def _rollout_body(env: MarketEnv, policy_fn: Optional[Callable], n: int,
                  carried: bool, state: EnvState, pc: Any):
    """The ``n``-step body of a rollout: policy, lowering, env step and
    stacking. Returns ``(state, batch, dones, carry)``: ``batch`` without
    its ``done`` tensor, ``dones`` the steps' Python done flags (a function
    of the cursor, known on the host). It writes none of its inputs."""
    obs = env.observe(state)
    obs_path, rewards, dones, infos, extras = [], [], [], [], []
    for _ in range(n):
        if carried:
            pc, actions, ex = policy_fn(pc, obs, state.t)
        else:
            actions = policy_fn(obs, state.t) if policy_fn is not None \
                else None
            ex = None
        state, obs, reward, done, info = env._advance(
            state, actions, env._check_rollout_values)
        obs_path.append(obs)
        rewards.append(reward)
        dones.append(done)
        infos.append(info)
        extras.append(ex)

    M, device = env.num_markets, env.device

    def stacked(parts, width):
        if parts:
            return torch.stack(parts)
        return torch.zeros((0,) + width, dtype=torch.float32, device=device)

    def path(field):
        if not infos:
            return torch.zeros((M, 0), dtype=torch.float32, device=device)
        return torch.cat([getattr(i, field) for i in infos], dim=-1)

    batch = RolloutBatch(
        obs=stacked(obs_path, (M, env.obs_size())),
        reward=stacked(rewards, (M,)), done=None,
        price=path("price"), volume=path("volume"), mid=path("mid"),
        fill_buy=path("fill_buy"), fill_ask=path("fill_ask"),
        extras=_stack_tree(extras) if extras and extras[0] is not None
        else None)
    return state, batch, dones, pc


def _tree_map(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _stack_tree(trees):
    """Stack the leaves of equally shaped trees along a new first axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_tree([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_stack_tree(list(parts))
                             for parts in zip(*trees)))
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_tree(list(parts)) for parts in zip(*trees))
    return torch.stack([torch.as_tensor(x) for x in trees])


# ---------------------------------------------------------------------------
# Checkpoint wire format (the JAX package's, for CheckpointManager trees).
# ---------------------------------------------------------------------------

#: snapshot keys holding dicts of arrays (saved as array subtrees).
_ARRAY_SUBTREES = ("market", "last_out", "reset_market", "params",
                   "portfolio", "stats")


def _tuple_to_dict(t) -> Dict[str, np.ndarray]:
    return {f: np.array(sharding.to_host(v))
            for f, v in zip(type(t)._fields, t)}


def state_tree(snap: Dict[str, Any]) -> Dict[str, Any]:
    """Pack a :meth:`MarketEnv.snapshot` dict into a checkpointable tree
    (array subtrees and one JSON meta leaf), as the JAX package does."""
    meta = {k: v for k, v in snap.items() if k not in _ARRAY_SUBTREES}
    tree: Dict[str, Any] = {"env_meta": np.asarray(json.dumps(meta))}
    for sub in _ARRAY_SUBTREES:
        if snap.get(sub) is not None:
            tree[sub] = {k: np.asarray(v) for k, v in snap[sub].items()}
    return tree


def state_from_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`state_tree` (for :meth:`MarketEnv.restore`)."""
    snap: Dict[str, Any] = dict(json.loads(str(tree["env_meta"])))
    for sub in _ARRAY_SUBTREES:
        if sub in tree:
            snap[sub] = dict(tree[sub])
    return snap
