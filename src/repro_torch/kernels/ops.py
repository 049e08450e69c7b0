"""The kernel session backends: ``cuda-kinetic`` and ``cuda-naive``.

:class:`ClearingChunkRunner` hands each session chunk to one chunk
function with the operands of
:func:`repro_torch.kernels.kinetic_clearing.kinetic_clearing_chunk`:

  * ``cuda-kinetic`` (:class:`KineticChunkRunner`) — the paper's engine: the
    persistent kernel, one launch per chunk;
  * ``cuda-naive`` (:class:`NaiveChunkRunner`) — the ablation: the per-step
    kernel, one launch per step (``naive_clearing_chunk``).

On the CPU both run the same plain PyTorch version. The coupling column is
frozen at chunk entry inside the wrappers, as on every backend of the JAX
package. The env step core (:meth:`ClearingChunkRunner.env_step_fn`) is one
``run`` of one step on the engine's chunk-1 runner: one launch of kernel 1
(or 2) per env step, its peer column resolved at every step.

Knobs (``Engine`` backend options, all composable; ``repro``'s names in
brackets):

  * ``tile=`` [``mb=``] — pin the launch shape
    (:class:`~repro_torch.kernels.autotune.TileChoice`); no sweep.
  * ``agents=`` [``agent_chunk=``] — pin the agent mode and sweep the rest.
  * ``autotune="auto"`` — ``"auto"`` sweeps when the runner's device is a
    card, ``True`` on any device (on the CPU it times the plain version),
    ``False`` keeps the rule (``autotune.auto_tile``). The sweep times one
    chunk call of each candidate on a shard's rows (the opening books, zero
    params) when the runner is built (on a card its device time, by CUDA
    events), through the counted wrappers, and caches the winner per
    ``autotune.tune_key`` for every runner of the process. It builds
    nothing: ``trace_count`` does not move.
  * ``devices=N`` / ``mesh=`` — cut the market axis over a
    :class:`~repro_torch.launch.MarketsMesh` (default: a mesh of the one
    device, a single shard). One controller drives it, as
    JAX drives a mesh: the state stays in the canonical ``[M, ...]``
    layout on the mesh's first device, and each chunk cuts the rows into
    the mesh's contiguous slices (``launch.market_sharding``), builds every
    row's peer mid from the whole chunk-entry mid column (what ``repro``'s
    ring gather assembles on each shard), sends each slice to its device
    with its global market ids, params, peers, external orders and stats,
    launches there (one launch per shard and chunk, per step for kernel 2)
    and brings the outputs back with ``torch.cat``. No padding is needed:
    the grid masks a ragged CTA and a row's stream keys on its global id,
    so a sharded run equals the unsharded one bit for bit, coupled runs
    included.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core import params as params_mod
from repro_torch.core import session
from repro_torch.core import stats as stats_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.params import (INT_FIELDS, EnsembleSpec, MarketParams,
                                     PackedParams)
from repro_torch.core.result import SimResult
from repro_torch.core.step import (MarketState, StepOutput, initial_state,
                                   resolve_peer_mids)
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.kernels import naive_clearing as nc
from repro_torch.launch import roofline
from repro_torch.launch.mesh import MarketsMesh, make_markets_mesh
from repro_torch.launch.sharding import market_sharding

BACKEND = "cuda-kinetic"
NAIVE_BACKEND = "cuda-naive"
_PEER = INT_FIELDS.index("coupling_peer")


def _resolve_mesh(mesh, devices, device: torch.device) -> MarketsMesh:
    """``mesh`` (of ``device``'s type), a mesh of ``devices`` local devices,
    or the one-device mesh of ``device`` (a single shard)."""
    if mesh is not None:
        if not isinstance(mesh, MarketsMesh):
            raise TypeError(f"mesh must be a MarketsMesh, got "
                            f"{type(mesh).__name__}")
        if any(d.type != device.type for d in mesh.devices):
            raise ValueError(f"mesh {[str(d) for d in mesh.devices]} is not "
                             f"on the engine's device type {device.type!r}")
        market_sharding(mesh, 1)          # raises without a 'markets' axis
        return mesh
    if devices is not None:
        return make_markets_mesh(devices, device=device)
    return MarketsMesh((device,))


def _cut_params(params: PackedParams, cut, rows: slice) -> PackedParams:
    """``params`` cut by ``cut``, with the rows of its host copy (if it has
    one: the roofline's kernel records read it)."""
    part = PackedParams(*map(cut, params))
    try:
        host = params_mod.host_ints(params)
    except LookupError:
        return part
    return params_mod.with_host_ints(part, host[rows])


class ClearingChunkRunner(session.ChunkRunner):
    """One ``chunk_fn`` call per chunk of up to ``chunk`` steps (per shard
    and chunk on a mesh)."""

    compiled = True
    #: True for a persistent kernel, which keeps the agents' keys on chip
    #: (its launch shapes sweep the agent mode).
    hoisted = True

    def __init__(self, chunk_fn: Callable, backend: str,
                 load_library: Callable, spec: EnsembleSpec, chunk: int,
                 device: torch.device, scan: str = "cumsum",
                 stats_only: bool = False, *,
                 tile: Optional[autotune.TileChoice] = None,
                 agents: Optional[str] = None, autotune_mode="auto",
                 devices: Optional[int] = None, mesh=None):
        #: The market-axis mesh; the canonical state lives on its first
        #: device.
        self.mesh = _resolve_mesh(mesh, devices, device)
        super().__init__(self.mesh.devices[0])
        device = self.device
        if scan not in ("cumsum", "hillis-steele"):
            raise ValueError(f"unknown scan {scan!r}")
        if autotune_mode not in (True, False, "auto"):
            raise ValueError(f"autotune must be True, False or 'auto', got "
                             f"{autotune_mode!r}")
        self.spec = spec
        self.chunk = int(chunk)
        self.scan = scan
        self.stats_only = bool(stats_only)
        self._chunk_fn = chunk_fn
        self._rows = market_sharding(self.mesh, spec.num_markets)
        if device.type == "cuda":
            # Build (or load) the kernel now, and record why it failed.
            loads = _build.load_count()
            try:
                load_library()
            except (OSError, RuntimeError) as exc:
                session.record_failure(backend, f"{type(exc).__name__}: {exc}")
                raise
            self._builds += _build.load_count() - loads
        self._market_ids = torch.arange(spec.num_markets, dtype=torch.int32,
                                        device=device)
        self.tile = self._resolve_tile(tile, agents, autotune_mode)

    # ---- launch shape ----
    def _resolve_tile(self, tile, agents, autotune_mode
                      ) -> autotune.TileChoice:
        L, A = self.spec.num_levels, self.spec.num_agents
        if tile is not None:
            return autotune.check_tile(tile, L, A, self.hoisted)
        rule = autotune.auto_tile(L, A)
        if agents is not None:
            rule = rule._replace(agents=agents)
        sweep = autotune_mode is True or (autotune_mode == "auto"
                                          and self.device.type == "cuda")
        if not sweep:
            return autotune.check_tile(rule, L, A, self.hoisted)
        cands = autotune.candidate_tiles(
            L, A, hoisted=self.hoisted,
            agents=agents if agents is not None else ...)
        if not cands:
            raise ValueError(f"no launch shape holds agents={agents!r} at "
                             f"L={L}, A={A}")
        # A shard's launch shape is the tile: time the largest shard's rows.
        rows = -(-self.spec.num_markets // self.mesh.size)
        key = autotune.tune_key(
            L, A, self.chunk, device=self.device,
            kernel=self._chunk_fn.__name__, scan=self.scan,
            stats_only=self.stats_only, agents=agents)
        return autotune.autotune_tile(
            key, self._timer(rows), cands,
            fallback=rule if rule in cands else cands[0])

    def _timer(self, rows: int) -> Callable[[autotune.TileChoice], float]:
        """``time_candidate``: one chunk call of a candidate on ``rows``
        markets, from the opening books with zero params; on a card its
        device time between two CUDA events, else the wall."""
        device, spec = self.device, self.spec
        state = tuple(x[:rows] for x in initial_state(spec, device))
        params = params_mod.pack_params(MarketParams.zeros(rows, "cpu"),
                                        device)
        stats = stats_mod.init_stats(rows, device) if self.stats_only \
            else None
        on_card = device.type == "cuda"
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))

        def block(_) -> Optional[float]:
            if on_card:
                end.synchronize()
                return start.elapsed_time(end) * 1e-3
            return None

        def time_candidate(cand: autotune.TileChoice) -> float:
            def call():
                if on_card:
                    start.record()
                out = self._chunk_fn(
                    *state, 0, self.chunk, cfg=spec, chunk=self.chunk,
                    scan=self.scan, params=params, stats=stats,
                    stats_only=self.stats_only, tile=cand)
                if on_card:
                    end.record()
                return out

            return autotune.time_call(call, block)

        return time_candidate

    # ---- execution ----
    def _call(self, state: MarketState, params: PackedParams, step0: int,
              n: int, ext, stats, market_ids, peer_mid) -> Tuple:
        eb, ea = (None, None) if ext is None else ext
        return self._chunk_fn(
            state.bid, state.ask, state.last_price, state.prev_mid, step0, n,
            eb, ea, cfg=self.spec, chunk=self.chunk, scan=self.scan,
            market_ids=market_ids, params=params, peer_mid=peer_mid,
            stats=stats, stats_only=self.stats_only, tile=self.tile)

    def _launch_shards(self, state: MarketState, params: PackedParams,
                      step0: int, n: int, ext, stats) -> Tuple:
        """One call per shard on its rows, the outputs joined on the first
        device (a single shard's outputs as they are). The peer column is
        gathered from every row's entry mid before the cut, as ``repro``'s
        ring gather assembles it."""
        peer = resolve_peer_mids(state.prev_mid, params.ints[:, _PEER])
        home = self.device
        outs = []
        for pos, (dev, rows) in enumerate(zip(self.mesh.devices,
                                              self._rows)):
            if rows.start == rows.stop:
                continue          # a shard with no rows launches nothing
            sent = []

            def cut(t):
                if t is None:
                    return None
                sent.append(t[rows].to(dev))
                return sent[-1]

            with roofline.uncounted():
                args = (MarketState(*map(cut, state)),
                        _cut_params(params, cut, rows), step0, n,
                        None if ext is None else tuple(map(cut, ext)),
                        None if stats is None else stats_mod.MarketStats(
                            *map(cut, stats)),
                        cut(self._market_ids), cut(peer))
            if pos:               # the first shard's rows stay home
                roofline.transfer("scatter", pos, home, sent)
            with roofline.shard(pos, dev):
                outs.append(self._call(*args))
        if len(outs) == 1:
            return outs[0]

        def join(parts):
            # Only trailing shards can have no rows (market_sharding), so
            # part k is shard k's.
            for pos, part in enumerate(parts[1:], 1):
                roofline.transfer("gather", pos, home, [part])
            with roofline.uncounted():
                return torch.cat([p.to(home) for p in parts], dim=0)

        joined = [join(parts) for parts in zip(*(o[:4] for o in outs))]
        if self.stats_only:
            return tuple(joined) + (stats_mod.MarketStats(
                *(join(parts) for parts in zip(*(o[4] for o in outs)))),)
        return tuple(joined) + tuple(
            join(parts) for parts in zip(*(o[4:] for o in outs)))

    def run(self, state: MarketState, params, step0: int, n: int, ext,
            stats=None, aux=None
            ) -> Tuple[MarketState, session.StepBatch, Any]:
        loads = _build.load_count()
        out = self._launch_shards(state, params, step0, n, ext, stats)
        self._builds += _build.load_count() - loads
        self.launched = True
        new_state = MarketState(*out[:4])
        if self.stats_only:
            return new_state, session._empty_batch(
                self.spec.num_markets, self.device), out[4]
        pp, vp, mp = out[4:]
        return new_state, session.StepBatch(
            price=pp[:, :n], volume=vp[:, :n], mid=mp[:, :n]), None

    def env_step_fn(self) -> Callable:
        """One :meth:`run` of one step from ``t`` (sharded when the runner
        is), the env's orders as the chunk's external orders (None: no
        operand at all, which adds nothing). The seed is the spec's: the env
        rejects a runtime one."""
        def step_core(market, params, t, ext_buy, ext_ask, seed, aux):
            ext = None if ext_buy is None else (ext_buy, ext_ask)
            state, batch, _ = self.run(market, params, t, 1, ext)
            return state, StepOutput(*batch), aux

        return step_core


class KineticChunkRunner(ClearingChunkRunner):
    """The persistent kernel: one ``kinetic_clearing_chunk`` launch per
    chunk (per shard and chunk)."""

    def __init__(self, spec: EnsembleSpec, chunk: int, device: torch.device,
                 scan: str = "cumsum", stats_only: bool = False,
                 **knobs: Any):
        super().__init__(kc.kinetic_clearing_chunk, BACKEND,
                         kc._load_library, spec, chunk, device, scan=scan,
                         stats_only=stats_only, **knobs)


class NaiveChunkRunner(ClearingChunkRunner):
    """The per-step kernel: ``naive_clearing_chunk``, one launch per step
    (per shard and step)."""

    hoisted = False

    def __init__(self, spec: EnsembleSpec, chunk: int, device: torch.device,
                 scan: str = "cumsum", stats_only: bool = False,
                 **knobs: Any):
        super().__init__(nc.naive_clearing_chunk, NAIVE_BACKEND,
                         nc._load_library, spec, chunk, device, scan=scan,
                         stats_only=stats_only, **knobs)


def _knobs(tile, agents, autotune_mode, devices, mesh) -> dict:
    return dict(tile=tile, agents=agents, autotune_mode=autotune_mode,
                devices=devices, mesh=mesh)


@session.register_backend(BACKEND)
def open_kinetic_runner(spec, chunk: int, device, scan: str = "cumsum",
                        stats_only: bool = False, tile=None, agents=None,
                        autotune="auto", devices=None,
                        mesh=None) -> KineticChunkRunner:
    """The paper's engine: persistent, books on chip, one launch per chunk."""
    return KineticChunkRunner(EnsembleSpec.coerce(spec), chunk,
                              resolve_device(device), scan=scan,
                              stats_only=stats_only,
                              **_knobs(tile, agents, autotune, devices, mesh))


@session.register_backend(NAIVE_BACKEND)
def open_naive_runner(spec, chunk: int, device, scan: str = "cumsum",
                      stats_only: bool = False, tile=None, agents=None,
                      autotune="auto", devices=None,
                      mesh=None) -> NaiveChunkRunner:
    """The ablation: one launch per step, books through device memory."""
    return NaiveChunkRunner(EnsembleSpec.coerce(spec), chunk,
                            resolve_device(device), scan=scan,
                            stats_only=stats_only,
                            **_knobs(tile, agents, autotune, devices, mesh))


def _simulate_with(factory, cfg, device, scan: str, **knobs) -> SimResult:
    spec = EnsembleSpec.coerce(cfg)
    runner = factory(spec, min(session.DEFAULT_CHUNK, spec.num_steps), device,
                     scan=scan, **knobs)
    return session.run_runner_to_result(runner, spec)


def simulate_kinetic(cfg, device="cuda", scan: str = "cumsum",
                     **knobs: Any) -> SimResult:
    """One-session run of the persistent engine over ``num_steps``
    (``knobs``: ``tile``, ``agents``, ``autotune``, ``devices``, ``mesh``)."""
    return _simulate_with(open_kinetic_runner, cfg, device, scan, **knobs)


def simulate_naive(cfg, device="cuda", scan: str = "cumsum",
                   **knobs: Any) -> SimResult:
    """One-session run of the per-step ablation over ``num_steps``."""
    return _simulate_with(open_naive_runner, cfg, device, scan, **knobs)
