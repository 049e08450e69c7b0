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
package; each chunk-entry gather is the span ``dispatch.peer`` and counts in
:attr:`~repro_torch.core.session.ChunkRunner.peer_resolves`. The env step
core (:meth:`ClearingChunkRunner.env_step_fn`) is one step of ``run``'s path
on the engine's chunk-1 runner: one launch of kernel 1 (or 2) per env step
(per shard and step on a mesh, on the env's row-sharded state as it is), its
peer column resolved at every step. On one card a rollout's or an update's
CUDA graph holds those launches (the wrappers launch on the current stream,
the capture's); the tile sweep below runs when a runner is built, before
any capture, and a mesh keeps the host loop
(:attr:`ClearingChunkRunner.graphable`).

Knobs (``Engine`` backend options, all composable; ``repro``'s names in
brackets):

  * ``tile=`` [``mb=``] — pin the launch shape
    (:class:`~repro_torch.kernels.autotune.TileChoice`); no sweep. Without
    it, the rule's shape for the shard's rows (``autotune.auto_tile(L, A,
    rows)``, the per-step kernel's with ``hoisted=False``: past the
    registers mode each shard's rows pick their own market cluster) or the
    sweep's winner.
  * ``agents=`` [``agent_chunk=``] — pin the agent mode and sweep the rest.
  * ``autotune="auto"`` — ``"auto"`` sweeps when the runner's device is a
    card, ``True`` on any device (on the CPU it times the plain version),
    ``False`` keeps the rule (``autotune.auto_tile``). The sweep times one
    chunk call of each candidate on the largest shard's rows (the opening
    books, zero params) when the runner is built (on a card its device
    time, by CUDA events), through the counted wrappers, and caches the
    winner per ``autotune.tune_key`` (with the rule's cluster size for
    those rows) for every runner of the process; every shard launches the
    winner. It builds nothing: ``trace_count`` does not move.
  * ``devices=N`` / ``mesh=`` — cut the market axis over a
    :class:`~repro_torch.launch.MarketsMesh` (default: a mesh of the one
    device, a single shard). One controller drives it, as JAX drives a
    mesh, and the placement is ``repro``'s: on more than one shard the
    placement hooks (``init_state``, ``params_to_device``, ``init_stats``,
    and ``place``, through which ``to_device`` goes) return
    :class:`~repro_torch.launch.sharding.RowShards`, each shard's rows of
    the books, scalars, packed params (with their host copy) and
    ``stats_only`` accumulators on its device
    (``launch.market_sharding``'s contiguous slices) from open to close,
    and the runner holds each shard's global market ids there too. A chunk
    moves only the chunk-entry mid column round the ring (n-1 hops, each
    shard's part to the next, ``repro``'s ``ppermute``); each shard then
    assembles the whole ``[M, 1]`` column on its device, resolves its own
    rows' peers, and launches on its resident rows (one launch per shard
    and chunk, per step for kernel 2). New books, scalars and stats stay
    where they are; only the paths a ``run`` returns are joined, sliced to
    the steps taken, on the first device. No padding is needed: the grid
    masks a ragged CTA and a row's stream keys on its global id, so a
    sharded run equals the unsharded one bit for bit, coupled runs
    included. A one-shard mesh keeps plain tensors and launches on them
    as they are.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

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
from repro_torch.kernels import open_fill
from repro_torch.launch import roofline
from repro_torch.launch.mesh import MarketsMesh, make_markets_mesh
from repro_torch.launch.sharding import (RowShards, market_sharding,
                                         place_params, shard_params)
from repro_torch.ops import trace

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
        #: The market-axis mesh. On more than one shard each shard's rows
        #: live on its device; the joined copies the API returns, on the
        #: first.
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
        self._load_library = load_library
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
        self._sharded = self.mesh.size > 1
        self._market_ids = self.place(torch.arange(
            spec.num_markets, dtype=torch.int32,
            device="cpu" if self._sharded else device))
        #: The launch shape of the largest shard's rows, and each shard's.
        self.tile, self.shard_tiles = self._resolve_tile(
            tile, agents, autotune_mode)

    @property
    def graphable(self) -> bool:
        """On one card only: a mesh's rollouts and updates keep the host
        loop (a CUDA graph belongs to one device)."""
        return super().graphable and not self._sharded

    # ---- launch shape ----
    def _rule(self, rows: int, agents) -> autotune.TileChoice:
        """The rule's shape for ``rows`` markets (which may be a market
        cluster), in a pinned agent mode if one is given."""
        L, A = self.spec.num_levels, self.spec.num_agents
        rule = autotune.auto_tile(L, A, rows, hoisted=self.hoisted)
        if agents is not None and agents != rule.agents:
            rule = autotune.auto_tile(L, A)._replace(agents=agents)
        return rule

    def _resolve_tile(self, tile, agents, autotune_mode
                      ) -> Tuple[autotune.TileChoice, tuple]:
        L, A = self.spec.num_levels, self.spec.num_agents
        shard_rows = [max(1, r.stop - r.start) for r in self._rows]
        # A shard's launch shape is the tile: the largest shard's rows.
        rows = max(shard_rows)
        if tile is not None:
            tile = autotune.check_tile(tile, L, A, self.hoisted)
            return tile, (tile,) * len(shard_rows)
        sweep = autotune_mode is True or (autotune_mode == "auto"
                                          and self.device.type == "cuda")
        if not sweep:
            tiles = tuple(autotune.check_tile(self._rule(n, agents), L, A,
                                              self.hoisted)
                          for n in shard_rows)
            return tiles[shard_rows.index(rows)], tiles
        rule = self._rule(rows, agents)
        cands = autotune.candidate_tiles(
            L, A, rows, hoisted=self.hoisted,
            agents=agents if agents is not None else ...)
        if not cands:
            raise ValueError(f"no launch shape holds agents={agents!r} at "
                             f"L={L}, A={A}")
        key = autotune.tune_key(
            L, A, self.chunk, device=self.device,
            kernel=self._chunk_fn.__name__, scan=self.scan,
            stats_only=self.stats_only, agents=agents,
            ctas_per_market=rule.ctas_per_market)
        tile, self.sweep = autotune.sweep_tile(
            key, self._timer(rows), cands,
            fallback=rule if rule in cands else cands[0])
        return tile, (tile,) * len(shard_rows)

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

    # ---- placement hooks (sharded state stays sharded between chunks) ----
    def place(self, t: torch.Tensor):
        """A canonical ``[M, ...]`` tensor (host or device) as the runner
        holds it: on its device, or row-sharded over its mesh."""
        return RowShards.place(t, self.mesh) if self._sharded \
            else t.to(self.device)

    def init_state(self, spec: EnsembleSpec) -> MarketState:
        if not self._sharded:
            return super().init_state(spec)
        return MarketState(*map(self.place, initial_state(spec, "cpu")))

    def params_to_device(self, params: MarketParams) -> PackedParams:
        if not self._sharded:
            return super().params_to_device(params)
        return place_params(params_mod.pack_params(params, "cpu"), self.mesh)

    def init_stats(self, spec: EnsembleSpec):
        if not (self._sharded and self.stats_only):
            return super().init_stats(spec)
        return stats_mod.MarketStats(*map(self.place, stats_mod.init_stats(
            spec.num_markets, "cpu")))

    def open_leaves(self, spec: EnsembleSpec) -> Tuple:
        """On one device, the open fill: the spec's B distinct rows cross
        in one upload and one launch writes the state, the packed params
        and the stats (:func:`repro_torch.kernels.open_fill.open_fill`),
        all under ``open.params``. On a mesh, the placement hooks."""
        if self._sharded:
            return super().open_leaves(spec)
        rows = spec.num_blocks
        with trace.span("open.params") as sp:
            if sp.on:
                sp.set(**session.open_params_attrs(spec, rows))
            opened = open_fill.open_fill(
                spec.blocks, spec.num_levels, self.stats_only, self.device,
                self._load_library)
        return opened + (rows,)

    # ---- execution ----
    def _call(self, state: MarketState, params: PackedParams, step0: int,
              n: int, ext, stats, market_ids, peer_mid, pos: int = 0
              ) -> Tuple:
        eb, ea = (None, None) if ext is None else ext
        return self._chunk_fn(
            state.bid, state.ask, state.last_price, state.prev_mid, step0, n,
            eb, ea, cfg=self.spec, chunk=self.chunk, scan=self.scan,
            market_ids=market_ids, params=params, peer_mid=peer_mid,
            stats=stats, stats_only=self.stats_only,
            tile=self.shard_tiles[pos])

    def _ring(self, prev_mid: RowShards) -> List[torch.Tensor]:
        """Each shard's whole ``[M, 1]`` chunk-entry mid column, on its
        device: ``repro``'s ring. In each of n-1 hops every shard sends the
        part it holds to the next shard and keeps the one it receives (one
        ``collective-permute`` each)."""
        devices, n = self.mesh.devices, self.mesh.size
        held = list(prev_mid.parts)
        seen = [{k: held[k]} for k in range(n)]
        for hop in range(1, n):
            for k in range(n):
                if held[k].numel():
                    roofline.transfer("collective-permute", k,
                                      devices[(k + 1) % n], [held[k]],
                                      to=(k + 1) % n)
            with roofline.uncounted():
                held = [held[k - 1].to(devices[k], non_blocking=True)
                        for k in range(n)]
            for k in range(n):
                seen[k][(k - hop) % n] = held[k]
        with roofline.uncounted():
            return [torch.cat([seen[k][j] for j in range(n)], dim=0)
                    for k in range(n)]

    def _peer_mids(self, mids: torch.Tensor, params: PackedParams,
                   own: Optional[torch.Tensor] = None,
                   first: int = 0) -> torch.Tensor:
        """The chunk-entry gather of each row's peer mid from ``mids``
        (rows ``first, first + 1, ...`` of the whole column), in the span
        ``dispatch.peer``: ``rows`` and ``coupled``, the rows with a real
        peer, read from the params' host copy (None without one) before
        the span opens, so that its duration is the gather's alone."""
        coupled = None
        if trace.enabled():
            try:
                coupled = params_mod.coupled_count(
                    params_mod.host_ints(params)[:, _PEER], first)
            except LookupError:
                pass
        with trace.span("dispatch.peer", rows=params.ints.shape[0],
                        coupled=coupled):
            peer = resolve_peer_mids(mids, params.ints[:, _PEER], own)
        self.peer_resolves += 1
        return peer

    def _launch_shards(self, state: MarketState, params: PackedParams,
                       step0: int, n: int, ext, stats, join: bool) -> Tuple:
        """One call per shard on its resident rows, after the ring; the new
        books, scalars and stats stay on their shards (a shard with no rows
        keeps its empty parts), and the paths, sliced to the ``n`` steps
        taken, are joined on the first device (``join``) or left on their
        shards as :class:`RowShards` (a shard with no rows: empty parts)."""
        mids = self._ring(state.prev_mid)
        outs = []
        for pos, (dev, rows) in enumerate(zip(self.mesh.devices,
                                              self._rows)):
            if rows.start == rows.stop:
                outs.append(None)   # a shard with no rows launches nothing
                continue

            def part(x):
                return x.parts[pos]

            with roofline.shard(pos, dev):
                own = torch.arange(rows.start, rows.stop, device=dev)[:, None]
                p = shard_params(params, pos)
                peer = self._peer_mids(mids[pos], p, own, rows.start)
                outs.append(self._call(
                    MarketState(*map(part, state)), p, step0, n,
                    None if ext is None else tuple(map(part, ext)),
                    None if stats is None else stats_mod.MarketStats(
                        *map(part, stats)),
                    part(self._market_ids), peer, pos))

        # Each shard's outputs, flat: four state leaves, then six stats
        # (which stay with the state) or three paths (which are joined).
        flat = [None if o is None else
                o[:4] + tuple(o[4]) if self.stats_only else o for o in outs]
        held = list(state) + (list(stats) if self.stats_only else [])
        kept = [RowShards([old.parts[pos] if f is None else f[k]
                           for pos, f in enumerate(flat)], self._rows)
                for k, old in enumerate(held)]
        if self.stats_only:
            return MarketState(*kept[:4]), stats_mod.MarketStats(*kept[4:])
        if not join:
            return MarketState(*kept), tuple(
                RowShards([torch.empty((0, n), device=dev) if f is None
                           else f[k][:, :n]
                           for f, dev in zip(flat, self.mesh.devices)],
                          self._rows)
                for k in range(4, 7))
        ran = [f for f in flat if f is not None]   # the leading shards
        paths = tuple(RowShards([f[k][:, :n] for f in ran],
                                self._rows[:len(ran)]).join(self.device)
                      for k in range(4, 7))
        return MarketState(*kept), paths

    def _advance(self, state: MarketState, params, step0: int, n: int, ext,
                 stats, join: bool) -> Tuple:
        """``(new state, paths sliced to n steps | stats)`` of one chunk
        call (one per shard on a mesh; ``join`` as in
        :meth:`_launch_shards`)."""
        loads = _build.load_count()
        if self._sharded:
            new_state, out = self._launch_shards(state, params, step0, n,
                                                 ext, stats, join)
        else:
            peer = self._peer_mids(state.prev_mid, params)
            res = self._call(state, params, step0, n, ext, stats,
                             self._market_ids, peer)
            new_state, out = MarketState(*res[:4]), (
                res[4] if self.stats_only else
                tuple(p[:, :n] for p in res[4:]))
        self._builds += _build.load_count() - loads
        self.launched = True
        return new_state, out

    def run(self, state: MarketState, params, step0: int, n: int, ext,
            stats=None, aux=None
            ) -> Tuple[MarketState, session.StepBatch, Any]:
        new_state, out = self._advance(state, params, step0, n, ext, stats,
                                       join=True)
        if self.stats_only:
            return new_state, session._empty_batch(
                self.spec.num_markets, self.device), out
        return new_state, session.StepBatch(*out), None

    def env_step_fn(self) -> Callable:
        """One step of :meth:`run`'s path from ``t``, the env's orders as
        the chunk's external orders (None: no operand at all, which adds
        nothing). On a mesh the env's state, params and order grids arrive
        row-sharded and stay so: the new state and the one-step
        :class:`StepOutput` are returned as each shard's rows on its
        device, and only the ring of entry mids moves. The seed is the
        spec's: the env rejects a runtime one."""
        def step_core(market, params, t, ext_buy, ext_ask, seed, aux):
            ext = None if ext_buy is None else (ext_buy, ext_ask)
            state, paths = self._advance(market, params, t, 1, ext, None,
                                         join=False)
            return state, StepOutput(*paths), aux

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
