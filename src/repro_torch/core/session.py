"""Stateful session API: open/run/stream/step on device-resident books.

    eng = Engine("cuda-kinetic")                 # device="cuda" by default
    with eng.open(spec) as sess:
        for batch in sess.stream(10_000):        # one StepBatch per chunk
            consume(batch)
        obs = sess.step(actions)                 # gym-style RL hook

  * :class:`Engine` opens sessions on an
    :class:`~repro_torch.core.params.EnsembleSpec` or a ``MarketConfig``
    (coerced to a homogeneous spec) and caches one :class:`ChunkRunner` per
    (static shape, chunk length), so any scenario mixture of a shape reuses
    one runner.
  * A runner advances ``n <= chunk`` steps from an absolute step cursor.
    The RNG and the scenario overlays key on the absolute step, so any
    chunking of S steps equals one S-step run, bit for bit.
  * The per-market params are packed once per session into two device
    tensors (:class:`~repro_torch.core.params.PackedParams`).
  * :meth:`Session.step` injects one external order per market at the
    chunk's first step; ``actions=None`` equals a one-step :meth:`run`.
  * :meth:`Session.snapshot` / :meth:`Session.restore` round-trip books,
    cursor, params, ``stats_only`` accumulators and a stateful RNG's state
    (``numpy-pcg64``) exactly, and
    :meth:`Session.save_checkpoint` / :meth:`Session.restore_checkpoint`
    carry them through a
    :class:`~repro_torch.checkpoint.manager.CheckpointManager`.
  * :meth:`Session.swap_markets` splices rows at a chunk boundary (the
    serving gateway's attach and detach) on the device, building nothing.
  * :meth:`Engine.env` opens the RL environment
    (:class:`repro_torch.env.MarketEnv`) over the engine's one-step runner,
    whose :meth:`ChunkRunner.env_step_fn` is its step core.
  * Every session carries a
    :class:`~repro_torch.ops.metrics.MetricsRegistry` unless opened with
    ``metrics=False``; ``Engine.trace_count`` counts the runners an engine
    built and the kernel libraries they compiled or loaded, so a warm
    engine that builds nothing more keeps it unchanged.

The horizon ``num_steps`` is the default run length; ``run()``/``stream()``
with no argument raise once the cursor has reached it.
"""
from __future__ import annotations

import dataclasses
import importlib
import itertools
import time
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import params as params_mod
from repro_torch.core.config import MarketConfig
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device, upload
from repro_torch.core.params import EnsembleSpec, MarketParams, PackedParams
from repro_torch.core.result import SimResult, to_host
from repro_torch.core.stats import MarketStats, init_stats
from repro_torch.core.step import MarketState, initial_state

#: Default chunk length (steps per kernel launch) for streaming runs.
DEFAULT_CHUNK = 64

# backend name -> factory(spec, chunk, device, **backend_opts) -> ChunkRunner
_FACTORIES: Dict[str, Callable[..., "ChunkRunner"]] = {}
# backend name -> reason string for backends that failed to register or build
_FAILED: Dict[str, str] = {}
# backends that run on the host only (the numpy reference family)
_HOST_ONLY: set = set()


class StepBatch(NamedTuple):
    """A contiguous slice of per-step outputs streamed from a session."""

    price: Any   # float32[M, n] clearing price (last price when no cross)
    volume: Any  # float32[M, n] transacted volume
    mid: Any     # float32[M, n] pre-clearing mid used for agent decisions

    @property
    def num_steps(self) -> int:
        return int(self.price.shape[-1])

    def to_numpy(self) -> "StepBatch":
        return StepBatch(*(to_host(x) for x in self))

    @staticmethod
    def concatenate(batches) -> "StepBatch":
        if len(batches) == 1:
            return batches[0]
        return StepBatch(*(torch.cat(parts, dim=-1) for parts in zip(*batches)))


class ExternalOrders(NamedTuple):
    """One external limit order per market: ``side_buy`` bool, ``price`` an
    integer tick on ``[0, L)``, ``qty`` lots ``>= 0``; each broadcastable
    to ``[M]``."""

    side_buy: Any
    price: Any
    qty: Any


class ChunkRunner:
    """Backend adapter: a fixed-chunk executor on one device.

    A runner is shared by every session opened with the same static shape;
    all per-session state, the packed params included, lives in
    :class:`Session`.
    """

    chunk: int = 1
    stats_only: bool = False
    #: True for the kernel backends: :meth:`Engine.warm` launches them once
    #: before serving. The eager baselines have nothing to build or warm.
    compiled: bool = False
    #: True when the env step core takes a runtime RNG seed; False where
    #: the seed is the kernel's launch argument from the spec (as Pallas
    #: bakes it into its trace) or a stateful stream (PCG64).
    env_runtime_seed: bool = False

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self._builds = 1          # this runner; kernel runners add libraries
        self.launched = False     # set by the first run()

    @property
    def trace_count(self) -> int:
        """This runner plus the kernel libraries compiled or loaded for it:
        the port's count of what a JAX trace would be."""
        return self._builds

    def init_state(self, spec: EnsembleSpec) -> MarketState:
        return initial_state(spec, self.device)

    def to_device(self, state: MarketState) -> MarketState:
        return MarketState(*(torch.as_tensor(to_host(x), dtype=torch.float32)
                             .to(self.device) for x in state))

    def params_to_device(self, params: MarketParams) -> PackedParams:
        """Pack the per-market params into the two device tensors."""
        return params_mod.pack_params(params, self.device)

    def init_stats(self, spec: EnsembleSpec) -> Optional[MarketStats]:
        return init_stats(spec.num_markets, self.device) \
            if self.stats_only else None

    def stats_to_device(self, stats: MarketStats) -> MarketStats:
        return MarketStats(*(torch.as_tensor(to_host(x), dtype=torch.float32)
                             .to(self.device) for x in stats))

    # ---- stateful-RNG hooks (identity for counter-based backends) ----
    def init_aux(self, spec: EnsembleSpec) -> Any:
        """A session's stateful RNG (``numpy-pcg64``), or None."""
        return None

    def aux_state(self, aux: Any) -> Any:
        """JSON-serializable payload capturing ``aux``, or None."""
        return None

    def restore_aux(self, payload: Any) -> Any:
        return None

    def env_step_fn(self) -> Optional[Callable]:
        """The per-step core of :class:`repro_torch.env.MarketEnv`, or None.

        The callable has the signature ``fn(market, params, t, ext_buy,
        ext_ask, seed, aux) -> (MarketState, StepOutput, aux)``: ``params``
        the :class:`PackedParams`, ``t`` the absolute step (an int),
        ``ext_buy``/``ext_ask`` float32[M, L] orders or None, ``seed`` a
        runtime RNG seed or None, and ``aux`` the stateful RNG. The peer
        column is resolved from ``market.prev_mid`` at every call. It runs
        the step the runner's :meth:`run` runs, so the two cannot drift.
        """
        return None

    def run(self, state: MarketState, params: PackedParams, step0: int,
            n: int, ext: Optional[Tuple[Any, Any]],
            stats: Optional[MarketStats] = None, aux: Any = None,
            ) -> Tuple[MarketState, StepBatch, Optional[MarketStats]]:
        """Advance ``n <= self.chunk`` steps from absolute step ``step0``.

        ``ext`` is an optional ``(ext_buy, ext_ask)`` float32[M, L] pair
        injected at the first step. ``aux`` is the session's stateful RNG
        from :meth:`init_aux`, advanced in place (counter-based backends
        ignore it). Returns the new state, a :class:`StepBatch` with exactly
        ``n`` columns (zero columns in ``stats_only`` mode), and the carried
        stats (``None`` otherwise).
        """
        raise NotImplementedError


def register_backend(name: str, host_only: bool = False):
    """Register a factory ``f(spec, chunk, device, **opts) -> ChunkRunner``;
    a ``host_only`` backend accepts only ``device="cpu"``."""
    def deco(fn):
        _FACTORIES[name] = fn
        _FAILED.pop(name, None)
        if host_only:
            _HOST_ONLY.add(name)
        return fn
    return deco


def record_failure(name: str, reason: str) -> None:
    """Record why ``name`` cannot run (reported by backend_available)."""
    _FAILED[name] = reason


#: The built-in backends, by the module whose import registers them.
_BUILTIN = {
    "repro_torch.kernels.ops": ("cuda-kinetic", "cuda-naive"),
    "repro_torch.core.torch_backend": ("torch-scan", "torch-per-step"),
    "repro_torch.core.numpy_backend": ("numpy", "numpy-splitmix64",
                                       "numpy-pcg64"),
}


def _ensure_builtin() -> None:
    for module, names in _BUILTIN.items():
        if all(n in _FACTORIES or n in _FAILED for n in names):
            continue
        try:
            importlib.import_module(module)
        except ImportError as exc:
            for name in names:
                record_failure(name, f"{type(exc).__name__}: {exc}")


def is_host_only(name: str) -> bool:
    """True for a backend that runs on the host only (the numpy family)."""
    _ensure_builtin()
    return name in _HOST_ONLY


def backends() -> "list[str]":
    _ensure_builtin()
    return sorted(_FACTORIES)


def backend_available(name: str) -> Union[bool, str]:
    """True if ``name`` is registered and nothing failed, the recorded
    failure reason if its import or kernel build failed, False if
    unknown."""
    _ensure_builtin()
    if name in _FAILED:
        return _FAILED[name]
    return name in _FACTORIES


def _unknown_backend_error(name: str) -> KeyError:
    if name in _FAILED:
        return KeyError(f"backend {name!r} failed: {_FAILED[name]}")
    return KeyError(f"unknown backend {name!r}; have {sorted(_FACTORIES)}")


def run_runner_to_result(runner: ChunkRunner, spec) -> SimResult:
    """One-session run over ``spec.num_steps`` on a bare runner."""
    if runner.stats_only:
        raise ValueError(
            "stats_only is a Session-API mode: open a session and read "
            "Session.stats instead of using the one-shot simulate() wrappers")
    spec = EnsembleSpec.coerce(spec)
    state = runner.init_state(spec)
    params = runner.params_to_device(spec.params)
    aux = runner.init_aux(spec)
    batches, t = [], 0
    while t < spec.num_steps:
        n = min(runner.chunk, spec.num_steps - t)
        state, batch, _ = runner.run(state, params, t, n, None, aux=aux)
        batches.append(batch)
        t += n
    batch = StepBatch.concatenate(batches) if batches else _empty_batch(
        spec.num_markets, runner.device)
    return SimResult(bid=state.bid, ask=state.ask,
                     last_price=state.last_price, prev_mid=state.prev_mid,
                     price_path=batch.price, volume_path=batch.volume)


def _empty_batch(num_markets: int, device) -> StepBatch:
    empty = torch.zeros((num_markets, 0), dtype=torch.float32, device=device)
    return StepBatch(empty, empty, empty)


class Engine:
    """Runner cache + session factory for one backend on one device.

    ``device`` defaults to ``"cuda"`` and raises when no card is present;
    pass ``device="cpu"`` for the plain PyTorch versions. The ``numpy``
    reference family runs on the host only and raises ``ValueError`` for
    any other device. ``backend_opts`` (``scan=``, ``stats_only=``, and
    ``clearing=`` for the numpy family) fold into every runner the engine
    builds.
    """

    def __init__(self, backend: str = "cuda-kinetic", *,
                 device=DEFAULT_DEVICE, chunk_size: Optional[int] = None,
                 metrics: bool = True, **backend_opts: Any):
        _ensure_builtin()
        if backend not in _FACTORIES:
            raise _unknown_backend_error(backend)
        if backend in _HOST_ONLY and \
                torch.device(DEFAULT_DEVICE if device is None
                             else device).type != "cpu":
            raise ValueError(
                f"backend {backend!r} runs on the host only: pass "
                f"device='cpu' (got device={str(device)!r})")
        self.backend = backend
        self.device = resolve_device(device)
        self.chunk_size = chunk_size
        self.metrics = bool(metrics)
        self.backend_opts = dict(backend_opts)
        self._runners: Dict[Tuple[Any, ...], ChunkRunner] = {}

    @property
    def trace_count(self) -> int:
        """Runners built plus kernel libraries compiled or loaded for them
        (the build detector: 0 more after :meth:`warm` while serving)."""
        return sum(r.trace_count for r in self._runners.values())

    def clear_cache(self) -> None:
        """Drop every cached runner."""
        self._runners.clear()

    def _runner(self, spec, chunk: int) -> ChunkRunner:
        spec = EnsembleSpec.coerce(spec)
        key = spec.static_key() + (chunk,)
        runner = self._runners.get(key)
        if runner is None:
            runner = _FACTORIES[self.backend](spec, chunk, self.device,
                                              **self.backend_opts)
            self._runners[key] = runner
        return runner

    def open(self, spec: Union[EnsembleSpec, MarketConfig], *,
             chunk_size: Optional[int] = None,
             metrics: Optional[bool] = None) -> "Session":
        """Open a live session with device-resident books. It carries a
        :class:`~repro_torch.ops.metrics.MetricsRegistry` unless ``metrics``
        (default: the engine's) is False."""
        spec = EnsembleSpec.coerce(spec)
        chunk = chunk_size or self.chunk_size \
            or min(DEFAULT_CHUNK, spec.num_steps)
        registry = None
        if self.metrics if metrics is None else metrics:
            from repro_torch.ops.metrics import MetricsRegistry

            registry = MetricsRegistry()
        return Session(self, spec, self._runner(spec, max(1, chunk)),
                       metrics=registry)

    def warm(self, specs, *, chunk_sizes=None, include_step: bool = True):
        """Build and launch once every runner ``specs`` will need (see
        :func:`repro_torch.ops.warmup.warm`); returns the readiness probe."""
        from repro_torch.ops import warmup

        return warmup.warm(self, specs, chunk_sizes=chunk_sizes,
                           include_step=include_step)

    def readiness(self):
        """Which cached ``(static_key, chunk)`` runners are built and
        launched (see :func:`repro_torch.ops.warmup.readiness`)."""
        from repro_torch.ops import warmup

        return warmup.readiness(self)

    def env(self, spec: Union[EnsembleSpec, MarketConfig], **env_opts: Any):
        """Open an RL environment (:class:`repro_torch.env.MarketEnv`) over
        this engine's one-step runner, the one :meth:`Session.step` uses, so
        envs of one shape share it and a warm engine builds nothing more.
        ``env_opts``: ``obs=``, ``reward=``, ``horizon=``, ``auto_reset=``."""
        from repro_torch.env.core import MarketEnv

        return MarketEnv(spec, engine=self, **env_opts)

    def trainer(self, spec: Union[EnsembleSpec, MarketConfig], config=None,
                **env_opts: Any):
        """Open a PPO trainer over this engine (see
        :mod:`repro_torch.train`): ``PPOTrainer(self.env(spec, **env_opts),
        config)``, on the engine's device. Trainers over mixtures of the
        same shape share the one-step runner."""
        from repro_torch.train.ppo import PPOConfig, PPOTrainer

        return PPOTrainer(self.env(spec, **env_opts), config or PPOConfig())


class Session:
    """A live simulation: device-resident books + an absolute step cursor.

    All advancement APIs (:meth:`run`, :meth:`stream`, :meth:`step`) move
    the same cursor and interleave freely.
    """

    def __init__(self, engine: Engine, spec: EnsembleSpec,
                 runner: ChunkRunner, metrics=None):
        self._engine = engine
        self.spec = spec
        self._runner = runner
        self._step_runner: Optional[ChunkRunner] = None
        self._state = runner.init_state(spec)
        self._params = runner.params_to_device(spec.params)
        self._aux = runner.init_aux(spec)
        self._stats = runner.init_stats(spec)
        self._t = 0
        self._closed = False
        self._active_streams = 0
        self.metrics = metrics
        if metrics is not None:
            metrics.gauge("chunk", runner.chunk)
            metrics.gauge("num_markets", spec.num_markets)

    @property
    def device(self) -> torch.device:
        return self._runner.device

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """Release the device-resident state (runners stay cached)."""
        self._state = self._params = self._stats = self._aux = None
        self._closed = True

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("session is closed")

    @property
    def state(self) -> MarketState:
        self._check_open()
        return self._state

    @property
    def params(self) -> PackedParams:
        """The device-resident packed per-market params."""
        self._check_open()
        return self._params

    @property
    def step_count(self) -> int:
        return self._t

    @property
    def horizon(self) -> int:
        """``spec.num_steps``: the default run length, and the bound every
        scenario event is validated against."""
        return self.spec.num_steps

    @property
    def stats(self) -> Optional[MarketStats]:
        """Host copy of the running statistics (``stats_only``; else None)."""
        self._check_open()
        return None if self._stats is None else self._stats.to_numpy()

    def _resolve_steps(self, n_steps: Optional[int]) -> int:
        if n_steps is not None:
            n = int(n_steps)
            if n < 0:
                raise ValueError(f"n_steps must be >= 0, got {n}")
            return n
        remaining = self.spec.num_steps - self._t
        if remaining <= 0:
            raise ValueError(
                f"session cursor is at step {self._t} with no steps "
                f"remaining of the horizon num_steps={self.spec.num_steps}: "
                "run()/stream() with no argument run the remaining horizon; "
                "pass an explicit n_steps to advance past it")
        return remaining

    def stream(self, n_steps: Optional[int] = None) -> Iterator[StepBatch]:
        """Advance ``n_steps`` (default: the rest of the horizon), yielding
        one :class:`StepBatch` per chunk."""
        self._check_open()
        return self._stream(self._resolve_steps(n_steps))

    def _dispatch(self, runner: ChunkRunner, n: int, ext,
                  kind: str) -> StepBatch:
        """One runner call, with host-side metrics sampled around it (a
        dispatch wall time: nothing waits for the card here)."""
        m = self.metrics
        if m is not None:
            builds0 = runner.trace_count
            t0 = time.perf_counter()
        self._state, batch, self._stats = runner.run(
            self._state, self._params, self._t, n, ext, self._stats,
            aux=self._aux)
        if m is not None:
            m.observe(f"{kind}_seconds", time.perf_counter() - t0)
            m.inc("steps_total", n)
            if kind == "chunk":
                m.inc("chunks_total")
            built = runner.trace_count - builds0
            if built:
                m.inc("traces", built)
        self._t += n
        return batch

    def _stream(self, remaining: int) -> Iterator[StepBatch]:
        self._active_streams += 1
        try:
            while remaining > 0:
                n = min(self._runner.chunk, remaining)
                yield self._dispatch(self._runner, n, None, "chunk")
                remaining -= n
        finally:
            self._active_streams -= 1

    def run(self, n_steps: Optional[int] = None) -> StepBatch:
        """Advance ``n_steps`` and return the concatenated batch."""
        self._check_open()
        batches = list(self._stream(self._resolve_steps(n_steps)))
        if not batches:
            return _empty_batch(self.spec.num_markets, self.device)
        return StepBatch.concatenate(batches)

    def step(self, actions: Optional[Any] = None) -> StepBatch:
        """Advance exactly one step, optionally injecting one external order
        per market (an :class:`ExternalOrders`, a triple or a mapping)."""
        self._check_open()
        if self._step_runner is None:
            self._step_runner = self._engine._runner(self.spec, 1)
        return self._dispatch(self._step_runner, 1, self._build_ext(actions),
                              "step")

    def _build_ext(self, actions: Any):
        if actions is None:
            return None
        from repro_torch.env import actions as actions_mod

        orders = actions_mod.validate_actions(
            actions, self.spec.num_markets, self.spec.num_levels)
        return actions_mod.lower_actions(
            orders, self.spec.num_markets, self.spec.num_levels, self.device)

    def to_result(self, batch: StepBatch) -> SimResult:
        """Terminal :class:`SimResult` from the books plus a batch."""
        self._check_open()
        if self._runner.stats_only:
            raise ValueError("stats_only sessions have no path outputs: read "
                             "Session.stats instead")
        s = self._state
        return SimResult(bid=s.bid, ask=s.ask, last_price=s.last_price,
                         prev_mid=s.prev_mid, price_path=batch.price,
                         volume_path=batch.volume)

    def run_to_result(self, n_steps: Optional[int] = None) -> SimResult:
        return self.to_result(self.run(n_steps))

    # ---- slot mutation (the serving gateway's attach/detach) ----
    def swap_markets(self, slots, sub: Union[EnsembleSpec, MarketConfig],
                     *, reset_books: bool = True) -> None:
        """Replace markets ``slots`` with the rows of ``sub`` (a
        ``len(slots)``-market spec or config) between chunks.

        The rows' params are re-packed into the session's
        :class:`PackedParams`, their books take ``sub``'s opening books
        (with ``reset_books``; else they keep their live books) and their
        ``stats_only`` accumulators start afresh, all by ``index_copy`` on
        the device: no runner is built and no other row changes (rows are
        independent and the RNG keys on the global market id). Detaching is
        the same call with :meth:`EnsembleSpec.parked` rows. ``sub`` must
        agree on every static field. Rejected during an active
        :meth:`stream`; a failed splice leaves the session untouched.
        """
        self._check_open()
        if self._active_streams:
            raise RuntimeError(
                "swap_markets() during an active stream(): slot mutations "
                "apply at chunk boundaries; exhaust or close() the iterator "
                "first")
        sub = EnsembleSpec.coerce(sub)
        t0 = time.perf_counter()
        new_spec = self.spec.replace_markets(slots, sub)  # validates slots
        idx = np.asarray(slots, dtype=np.int64).reshape(-1)
        rows = upload(torch.from_numpy(idx), self.device)

        def splice(leaves, fresh):
            return [leaf.index_copy(0, rows, upload(src, self.device))
                    for leaf, src in zip(leaves, fresh)]

        new_state = self._state
        if reset_books:
            new_state = MarketState(*splice(self._state,
                                            initial_state(sub, "cpu")))
        new_stats = self._stats
        if self._stats is not None:
            new_stats = MarketStats(*splice(self._stats,
                                            init_stats(idx.size, "cpu")))
        packed = params_mod.pack_params(sub.params, "cpu")
        new_params = PackedParams(*splice(self._params, packed))
        self._state, self._stats = new_state, new_stats
        self._params, self.spec = new_params, new_spec
        if self.metrics is not None:
            self.metrics.observe("swap_seconds", time.perf_counter() - t0)
            self.metrics.inc("swaps_total", int(idx.size))

    def snapshot(self) -> Dict[str, Any]:
        """Exact host-side capture: books, cursor, params, stats and a
        stateful RNG's state (``rng``, JSON, as in the JAX package). The
        copy from the card is synchronous, so the result is complete host
        memory."""
        self._check_open()
        t0 = time.perf_counter()
        snap: Dict[str, Any] = {f: to_host(v) for f, v in
                                zip(MarketState._fields, self._state)}
        snap["t"] = self._t
        snap["rng"] = self._runner.aux_state(self._aux)
        snap["seed"] = self.spec.seed
        snap["num_agents"] = self.spec.num_agents
        snap["num_steps"] = self.spec.num_steps
        snap["scenarios"] = [[name, len(list(group))] for name, group
                             in itertools.groupby(self.spec.scenarios)]
        snap["params"] = dict(zip(MarketParams._fields,
                                  self._params.to_numpy()))
        snap["init"] = {"quote_qty": np.asarray(self.spec.initial_quote_qty),
                        "spread": np.asarray(self.spec.initial_spread)}
        if self._stats is not None:
            snap["stats"] = dict(zip(MarketStats._fields,
                                     self._stats.to_numpy()))
        if self.metrics is not None:
            self.metrics.observe("snapshot_seconds", time.perf_counter() - t0)
            self.metrics.inc("snapshots_total")
        return snap

    def restore(self, snap: Dict[str, Any]) -> None:
        """Restore from :meth:`snapshot` (or a JAX-package snapshot of the
        same shape); a failed restore leaves the session untouched. Shape
        and ``num_agents`` mismatches raise
        :class:`~repro_torch.checkpoint.manager.CheckpointShapeError`."""
        self._check_open()
        if self._active_streams:
            raise RuntimeError("restore() during an active stream(): exhaust "
                               "or close() the iterator first")
        t_start = time.perf_counter()
        for field, have, cls in (
                ("seed", self.spec.seed, ValueError),
                ("num_agents", self.spec.num_agents,
                 ckpt.CheckpointShapeError)):
            got = snap.get(field)
            if got is not None and int(got) != have:
                raise cls(
                    f"snapshot was taken under {field}={int(got)} but this "
                    f"session runs {field}={have}")
        M, L = self.spec.num_markets, self.spec.num_levels
        for name, want, blame in (
                ("bid", (M, L), "num_levels"), ("ask", (M, L), "num_levels"),
                ("last_price", (M, 1), "num_markets"),
                ("prev_mid", (M, 1), "num_markets")):
            shape = tuple(np.shape(snap[name]))
            if shape != want:
                if len(shape) < 1 or shape[0] != M:
                    blame = "num_markets"
                raise ckpt.CheckpointShapeError(
                    f"snapshot field {name!r} has shape {shape} but this "
                    f"session expects {want}: mismatched {blame} (session "
                    f"has num_markets={M}, num_levels={L})")
        for pname, leaf in (snap.get("params") or {}).items():
            if pname in MarketParams._fields and np.shape(leaf) != (M, 1):
                raise ckpt.CheckpointShapeError(
                    f"snapshot params leaf {pname!r} has shape "
                    f"{tuple(np.shape(leaf))}, expected ({M}, 1): mismatched "
                    f"num_markets (session has num_markets={M})")
        new_state = self._runner.to_device(
            MarketState(*(snap[f] for f in MarketState._fields)))
        new_spec, new_params = self.spec, self._params
        if snap.get("params") is not None:
            host = params_mod.params_from_dict(snap["params"], M, L)
            labels = snap.get("scenarios")
            if labels is not None:
                labels = tuple(itertools.chain.from_iterable(
                    (name,) * int(count) for name, count in labels))
            init = snap.get("init")
            extra = {} if init is None else {
                "initial_quote_qty": np.asarray(init["quote_qty"], np.float32),
                "initial_spread": np.asarray(init["spread"], np.int32)}
            new_spec = dataclasses.replace(
                self.spec, params=host,
                num_steps=int(snap.get("num_steps", self.spec.num_steps)),
                scenarios=labels if labels is not None
                else ("<restored>",) * M, **extra)
            new_params = self._runner.params_to_device(host)
        rng = snap.get("rng")
        new_aux = (self._runner.restore_aux(rng) if rng is not None
                   else self._runner.init_aux(new_spec)
                   if self._aux is not None else None)
        new_stats = self._stats
        if self._runner.stats_only:
            stats = snap.get("stats")
            new_stats = (self._runner.stats_to_device(
                MarketStats(*(stats[f] for f in MarketStats._fields)))
                if stats is not None else self._runner.init_stats(new_spec))
        self._state, self._t = new_state, int(snap["t"])
        self.spec, self._params, self._stats = new_spec, new_params, new_stats
        self._aux = new_aux
        if self.metrics is not None:
            self.metrics.observe("restore_seconds",
                                 time.perf_counter() - t_start)
            self.metrics.inc("restores_total")

    def save_checkpoint(self, manager, step: Optional[int] = None,
                        *, wait: bool = True) -> int:
        """Persist the session through a ``CheckpointManager``; returns the
        checkpoint step (default: the cursor). ``wait=False`` returns once
        the host snapshot is handed to the manager's writer thread."""
        step = self._t if step is None else int(step)
        manager.save(step, ckpt.session_tree(self.snapshot()))
        if wait:
            manager.wait()
        return step

    def restore_checkpoint(self, manager, step: Optional[int] = None) -> int:
        """Restore from a ``CheckpointManager``; returns the restored step."""
        tree = manager.restore(step)
        if tree is None:
            raise FileNotFoundError(f"no checkpoint found in {manager.dir}")
        self.restore(ckpt.snapshot_from_tree(tree))
        return self._t
