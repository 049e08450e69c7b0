"""The streaming serving gateway: many client sessions, one warm engine.

``Gateway`` multiplexes N concurrent client sessions onto ONE persistent
ensemble session (the paper's build-once, device-resident regime) so the
marginal cost of a client is a slot assignment, never a build:

  * admission   — :class:`~repro_torch.serve.slots.SlotScheduler` maps
    each client onto an ensemble row; attach/detach land as ONE coalesced
    ``Session.swap_markets`` splice per chunk boundary, on the device,
    building nothing (``traces_delta`` stays 0 after warm);
  * the hot loop — a dedicated single engine thread makes every launch,
    copy and event of the session (the current CUDA stream is per thread),
    chunk after chunk; each chunk's outputs start for the host in a
    :class:`~repro_torch.serve.pipeline.HostCopy` right after its launch,
    and a lag-one :class:`~repro_torch.serve.pipeline.DoubleBuffer` reads
    chunk ``k-1`` while chunk ``k`` computes, so streaming never blocks the
    next launch (``stats_only`` stats take the same copy);
  * fan-out     — per-chunk :class:`repro_torch.serve.frames.Frame` slices go
    through :class:`repro_torch.serve.bus.FrameBus` with bounded per-client
    queues and non-blocking delivery (drop-oldest or disconnect), so a
    stalled consumer can never stall the simulation or other clients;
  * durability  — with ``ckpt_dir`` set, periodic checkpoints go through
    the :class:`~repro_torch.checkpoint.manager.CheckpointManager` **async
    writer**: the engine thread only copies the state to the host
    (synchronously, so the writer gets complete host memory);
    serialization, fsync, and the atomic ``COMMIT`` rename happen on a
    background thread with a lag-bounded latest-wins mailbox (skipped
    saves are counted, never queued). Every applied slot splice is
    appended to a durable :class:`~repro_torch.serve.journal.SpliceJournal`
    *before* it is applied (write-ahead), so both in-process recovery and
    a full **process crash + restart** resume every client stream bitwise:
    restore the newest committed checkpoint, replay journaled splices at
    their original boundaries, keep streaming (clients re-subscribe via
    :meth:`resume_session`).
  * resilience  — recovery is a supervised state machine
    (``serving → recovering → serving`` or ``→ degraded``): queued faults
    coalesce into ONE recovery, each attempt retries with exponential
    backoff + jitter up to ``max_recovery_attempts``, admission is paused
    (typed :class:`~repro_torch.serve.slots.GatewayRecovering`) while
    recovering, and an exhausted retry budget degrades the gateway to a
    read-only health endpoint (503;
    :class:`~repro_torch.serve.slots.GatewayDegraded` on admission) instead
    of crashing.

In-process transport (tests, benchmarks, and same-process consumers)::

    gw = Gateway(parked_template(slots=32, num_agents=64, num_levels=64,
                                 num_steps=10_000))  # cuda-kinetic, the card
    await gw.start()
    cs = gw.open_session("flash-crash")      # attach -> next chunk boundary
    async for frame in cs.subscription:       # Frames + control Events
        ...
    await gw.stop()

Real sockets are one layer up in :mod:`repro_torch.serve.transport` (HTTP
health endpoint; WebSocket fan-out when the ``websockets`` package is present).
"""
from __future__ import annotations

import asyncio
import itertools
import random
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.core.config import MarketConfig, scenario_config
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine, Session, StepBatch
from repro_torch.core.stats import MarketStats
from repro_torch.serve.bus import FrameBus, Subscription
from repro_torch.serve.frames import Event, Frame, slice_frames
from repro_torch.serve.journal import SpliceEntry, SpliceJournal
from repro_torch.serve.pipeline import DoubleBuffer, HostCopy
from repro_torch.serve.slots import (GatewayDegraded,  # noqa: F401
                                     GatewayFull, GatewayRecovering,
                                     SlotScheduler)


def parked_template(slots: int, *, num_agents: int, num_levels: int,
                    num_steps: int, seed: int = 0) -> EnsembleSpec:
    """An all-parked ``slots``-market serving template.

    The template fixes the static shape — and therefore the one warm runner
    — every client session will share; clients vary only the per-market
    parameter rows. ``num_steps`` is the horizon scenario events are
    validated against (the gateway itself streams indefinitely).
    """
    like = EnsembleSpec.homogeneous(scenario_config(
        "baseline", num_markets=slots, num_agents=num_agents,
        num_levels=num_levels, num_steps=num_steps, seed=seed))
    return EnsembleSpec.parked(like, slots)


class ClientSession:
    """One client's handle: a slot assignment + a bounded frame queue."""

    def __init__(self, gateway: "Gateway", sub: Subscription) -> None:
        self._gateway = gateway
        self.subscription = sub
        self.events: List[Event] = []    # control events seen by frames()

    @property
    def client(self) -> str:
        return self.subscription.client

    @property
    def slot(self) -> int:
        return self.subscription.slot

    @property
    def closed(self) -> bool:
        return self.subscription.closed

    async def next_frame(self) -> Optional[Frame]:
        """Next data frame (control events are recorded on ``.events``);
        ``None`` once the subscription is closed and drained."""
        while True:
            item = await self.subscription.get()
            if item is None:
                return None
            if isinstance(item, Event):
                self.events.append(item)
                if item.kind == "closed":
                    return None
                continue
            return item

    async def frames(self, n: int) -> List[Frame]:
        """Collect the next ``n`` data frames."""
        out: List[Frame] = []
        while len(out) < n:
            frame = await self.next_frame()
            if frame is None:
                break
            out.append(frame)
        return out

    def close(self) -> None:
        self._gateway.close_session(self)


class Gateway:
    """Asyncio serving gateway over one warm :class:`Engine` session.

    ``template`` is the serving ensemble (see :func:`parked_template`);
    its market count is the session capacity. ``queue_maxsize``/``policy``
    set the default per-client backpressure bounds
    (:mod:`repro_torch.serve.bus`); ``ckpt_dir`` + ``checkpoint_every`` (in
    chunks) enable the durability/fault-recovery path (checkpoints are
    written asynchronously — see the module docstring). ``ckpt_keep``
    bounds the on-disk ladder; ``max_recovery_attempts`` and
    ``recovery_backoff=(base_s, cap_s)`` govern the supervised recovery
    retry loop. ``engine_opts`` go to every :class:`Engine` the gateway
    opens; ``device`` defaults to ``"cuda"``, so with no card the
    constructor raises (pass ``engine_opts={"device": "cpu"}`` for the
    plain versions). All public methods must be called from the event-loop
    thread; device work runs on a dedicated single-thread executor ("the
    engine thread") so the loop stays responsive — and consumers keep
    draining — while chunks compute.
    """

    def __init__(self, template: Union[EnsembleSpec, MarketConfig],
                 backend: str = "cuda-kinetic", *, chunk_size: int = 16,
                 queue_maxsize: int = 8, policy: str = "drop-oldest",
                 ckpt_dir: Optional[Any] = None, checkpoint_every: int = 0,
                 ckpt_keep: int = 64, max_recovery_attempts: int = 3,
                 recovery_backoff: Tuple[float, float] = (0.05, 1.0),
                 metrics: bool = True,
                 engine_opts: Optional[Dict[str, Any]] = None) -> None:
        self.template = EnsembleSpec.coerce(template)
        self.backend = backend
        self.chunk = int(chunk_size)
        self.queue_maxsize = int(queue_maxsize)
        self.policy = policy
        self.checkpoint_every = int(checkpoint_every)
        self._ckpt_dir = ckpt_dir
        self._ckpt = None
        self._ckpt_keep = int(ckpt_keep)
        self._journal: Optional[SpliceJournal] = None
        self._max_attempts = max(1, int(max_recovery_attempts))
        self._backoff = (float(recovery_backoff[0]),
                         float(recovery_backoff[1]))
        self._metrics_enabled = bool(metrics)
        self._engine_opts = dict(engine_opts or {})
        self.device = resolve_device(
            self._engine_opts.get("device", DEFAULT_DEVICE))
        self._copy_stream = None
        self.engine: Optional[Engine] = None
        self.session: Optional[Session] = None
        self.scheduler = SlotScheduler(self.template)
        self.bus: Optional[FrameBus] = None
        self.metrics = None
        self._buffer: Optional[DoubleBuffer] = None
        self._exec = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="engine")
        self._task: Optional[asyncio.Task] = None
        self._running = False
        self._state = "idle"     # idle|serving|recovering|degraded|stopped
        self._degraded_reason: Optional[str] = None
        self._seq = itertools.count()
        self._chunks_remaining: Optional[int] = None
        self._warm_traces = 0
        self._pending_faults: List[Any] = []
        self._sessions: Dict[str, ClientSession] = {}
        # Journaled splices scheduled for replay after a process restart
        # (entries at boundaries >= the restored step, applied when the
        # cursor reaches them; see _apply_replay).
        self._replay: List[SpliceEntry] = []
        self.resumed_from: Optional[int] = None   # set by a disk restart
        self.restart_errors: Tuple[str, ...] = ()

    # ---- lifecycle ----
    async def start(self, chunks: Optional[int] = None) -> None:
        """Warm the engine, open the serving session, start the step loop.

        ``Engine.warm`` runs *before* the first frame so no client request
        ever pays a build (``traces_delta`` stays 0 from here on: the
        serving invariant the tests assert). ``chunks`` bounds the run for
        tests/benchmarks; ``None`` streams until :meth:`stop`.

        With ``ckpt_dir`` pointing at a directory holding a committed
        checkpoint ladder (a previous gateway process died there), start
        becomes a **restart**: the newest committed checkpoint is
        restored, journaled splices replay at their original boundaries,
        and slot attachments are reconstructed — clients re-subscribe with
        :meth:`resume_session` and their streams continue bitwise.
        """
        if self._running:
            raise RuntimeError("gateway already started")
        loop = asyncio.get_running_loop()
        self._chunks_remaining = chunks
        await loop.run_in_executor(self._exec, self._open_engine,
                                   self._engine_opts)
        self.bus = FrameBus(metrics=self.metrics)
        self._running = True
        self._state = "serving"
        if self.metrics is not None:
            self.metrics.gauge("degraded", 0)
        self._task = asyncio.create_task(self._run_loop(), name="gateway")

    def _open_engine(self, engine_opts: Dict[str, Any]) -> None:
        """(engine thread) Build + warm the engine and open the session.

        On *first* open with ``ckpt_dir``: create the async checkpoint
        manager + durable splice journal, then either take the durable
        step-0 anchor (fresh directory) or run the process-restart path
        (committed ladder found). In-process recovery re-enters here with
        ``self._ckpt`` already set and keeps the existing ladder — the
        anchor must never be overwritten with a fresh template state.
        """
        self.engine = Engine(self.backend, chunk_size=self.chunk,
                             metrics=self._metrics_enabled, **engine_opts)
        ready = self.engine.warm(self.template, include_step=False)
        if not ready.ready:
            raise RuntimeError(f"warm() left cold keys: {ready.cold_keys()}")
        if self.device.type == "cuda" and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        self.session = self.engine.open(self.template)
        if self.metrics is None:
            self.metrics = self.session.metrics
        else:
            self.session.metrics = self.metrics   # lifetime series survive
        if self.bus is not None:
            self.bus.metrics = self.metrics
        self._warm_traces = self.engine.trace_count
        self._buffer = DoubleBuffer(self._to_host)
        if self._ckpt_dir is not None and self._ckpt is None:
            from repro_torch.checkpoint.manager import CheckpointManager

            self._journal = SpliceJournal(self._ckpt_dir)
            self._ckpt = CheckpointManager(
                self._ckpt_dir, keep=self._ckpt_keep, async_write=True,
                on_write=self._on_ckpt_write, on_gc=self._on_ckpt_gc)
            if self._ckpt.latest_step() is None:
                # Fresh ladder: drop any stale journal (a crash before the
                # anchor committed has nothing to replay onto), then write
                # the durable step-0 anchor before taking traffic.
                self._journal.reset()
                self.session.save_checkpoint(self._ckpt, wait=True)
            else:
                self._restart_from_disk()

    def _restart_from_disk(self) -> None:
        """(engine thread) Process-restart: restore the newest committed
        checkpoint, schedule journaled splice replay, rebuild slot
        bookkeeping, and resume seq/step continuity."""
        from repro_torch.ops.chaos import _restore_resilient

        errors: List[str] = []
        resumed = _restore_resilient(self.session, self._ckpt, errors)
        self.restart_errors = tuple(errors)
        self.resumed_from = resumed
        entries = self._journal.entries()
        self._replay = [e for e in entries if e.t >= resumed]
        # Attachment bookkeeping: the restored spec's labels cover the
        # checkpointed mixture; pending-replay entries claim their slots
        # NOW (so new admissions cannot steal them) and update labels as
        # they apply.
        for slot, label in enumerate(self.session.spec.scenarios):
            if label and label != "parked":
                self.scheduler.mark_attached(slot, label)
        final: Dict[int, Optional[str]] = {}
        for e in self._replay:
            for slot, label in zip(e.slots, e.labels):
                final[slot] = label
        for slot, label in final.items():
            if label is not None:
                self.scheduler.mark_attached(slot, label)
        self._seq = itertools.count(resumed // self.chunk)

    async def stop(self) -> None:
        """Stop the step loop, flush the pipeline tail **and the async
        checkpoint writer** (shutdown never abandons an in-flight
        checkpoint — a sticky writer failure is re-raised here), close
        every client."""
        self._running = False
        if self._task is not None:
            await self._task
            self._task = None
        try:
            if self._ckpt is not None:
                loop = asyncio.get_running_loop()
                await loop.run_in_executor(self._exec, self._ckpt.wait)
        finally:
            if self._ckpt is not None:
                self._ckpt.close()
            if self._journal is not None:
                self._journal.close()
            self._exec.shutdown(wait=True)
            if self.session is not None:
                self.session.close()
            if self._state != "degraded":
                self._state = "stopped"

    @property
    def traces_delta(self) -> int:
        """Traces since warm — 0 is the serving invariant."""
        return (self.engine.trace_count - self._warm_traces
                if self.engine is not None else 0)

    @property
    def step_count(self) -> int:
        return self.session.step_count if self.session is not None else 0

    @property
    def state(self) -> str:
        """Supervision state: idle|serving|recovering|degraded|stopped."""
        return self._state

    def health(self) -> Dict[str, Any]:
        """The health-endpoint payload, backed by ``Engine.readiness()``.

        ``ready`` is true only in the ``serving`` state — a recovering or
        degraded gateway answers 503 through
        :class:`repro_torch.serve.transport.HealthServer` while still reporting
        full diagnostics (recovery state, checkpoint-writer lag, journal
        size) in the body.
        """
        ready = self.engine is not None and self.engine.readiness().ready
        out = {
            "ready": bool(ready and self._running
                          and self._state == "serving"),
            "running": self._running,
            "state": self._state,
            "backend": self.backend,
            "slots": self.scheduler.num_slots,
            "slots_attached": len(self.scheduler.attached),
            "slots_free": self.scheduler.free,
            "clients": len(self._sessions),
            "step": self.step_count,
            "traces_delta": self.traces_delta,
        }
        if self._degraded_reason is not None:
            out["degraded_reason"] = self._degraded_reason
        if self._ckpt is not None:
            out["checkpoint"] = {
                "pending": self._ckpt.pending,
                "writes": self._ckpt.writes,
                "skipped": self._ckpt.skipped,
                "last_write_s": self._ckpt.last_write_seconds,
                "latest_step": self._ckpt.latest_step(),
            }
        if self._journal is not None:
            out["journal_entries"] = len(self._journal)
        return out

    # ---- client admission (in-process front door) ----
    def _check_admission(self) -> None:
        # degraded outranks "not running": the loop has exited, but the
        # typed refusal is the diagnosis callers need
        if self._state == "degraded":
            raise GatewayDegraded(
                f"gateway is degraded ({self._degraded_reason}); serving "
                "health only — restart the process to recover")
        if not self._running:
            raise RuntimeError("gateway is not running; await start() first")
        if self._state == "recovering":
            raise GatewayRecovering(
                "gateway is recovering from a fault; admission resumes "
                "after the reconnect broadcast — retry shortly")

    def open_session(self, spec: Union[str, MarketConfig, EnsembleSpec],
                     *, maxsize: Optional[int] = None,
                     policy: Optional[str] = None,
                     client: Optional[str] = None) -> ClientSession:
        """Attach a client's market; frames start at the next chunk
        boundary. Raises :class:`GatewayFull` when every slot is taken,
        :class:`GatewayRecovering`/:class:`GatewayDegraded` while admission
        is paused, and ``ValueError`` when the spec disagrees with the
        template's static fields."""
        self._check_admission()
        slot = self.scheduler.attach(spec)
        sub = self.bus.subscribe(
            slot, client=client,
            maxsize=self.queue_maxsize if maxsize is None else maxsize,
            policy=self.policy if policy is None else policy)
        sub._force(Event("attached", {
            "slot": slot, "client": sub.client,
            "scenario": self.scheduler.label(slot),
            "first_step": self.step_count}))
        cs = ClientSession(self, sub)
        self._sessions[sub.client] = cs
        if self.metrics is not None:
            self.metrics.gauge("slots_attached",
                               len(self.scheduler.attached))
        return cs

    def resume_session(self, slot: int, *, maxsize: Optional[int] = None,
                       policy: Optional[str] = None,
                       client: Optional[str] = None) -> ClientSession:
        """Re-subscribe to an *already attached* slot — the restart front
        door. After a process crash + restart the slot's market is already
        live (restored from the checkpoint + journal replay), so resuming
        costs no splice: frames continue from the restored cursor, and the
        overlap with anything the client saw pre-crash is bitwise-identical
        (dedupe by ``frame.step0``). Raises ``KeyError`` for a slot that is
        not attached."""
        self._check_admission()
        label = self.scheduler.label(slot)
        if label is None:
            raise KeyError(
                f"slot {slot} is not attached; open_session() admits new "
                "clients")
        sub = self.bus.subscribe(
            slot, client=client,
            maxsize=self.queue_maxsize if maxsize is None else maxsize,
            policy=self.policy if policy is None else policy)
        sub._force(Event("attached", {
            "slot": slot, "client": sub.client, "scenario": label,
            "first_step": self.step_count, "resumed": True}))
        cs = ClientSession(self, sub)
        self._sessions[sub.client] = cs
        if self.metrics is not None:
            self.metrics.gauge("slots_attached",
                               len(self.scheduler.attached))
        return cs

    def close_session(self, cs: ClientSession) -> None:
        """Detach the client's slot (parked at the next boundary) and close
        its queue."""
        self._sessions.pop(cs.client, None)
        if cs.slot in self.scheduler.attached:
            self.scheduler.detach(cs.slot)
        self.bus.close_subscription(cs.subscription, reason="detach")
        if self.metrics is not None:
            self.metrics.gauge("slots_attached",
                               len(self.scheduler.attached))

    # ---- fault injection (the chaos tier's entry point) ----
    def inject_fault(self, fault: Any) -> None:
        """Queue a :class:`repro_torch.ops.chaos.DeviceLoss` for the next chunk
        boundary; requires ``ckpt_dir`` (recovery restores the newest
        loadable checkpoint and replays quietly, so client streams resume
        bitwise). Faults queued while one is already pending **coalesce**
        into a single recovery pass."""
        if self._ckpt is None:
            raise RuntimeError(
                "fault recovery needs ckpt_dir= (no checkpoint to restore)")
        self._pending_faults.append(fault)

    # ---- the step loop ----
    async def _run_loop(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while self._running and self._chunks_remaining != 0:
                if self._pending_faults:
                    faults = self._pending_faults[:]
                    self._pending_faults.clear()
                    # The in-flight chunk completed pre-fault: deliver it
                    # before tearing the engine down, so no frame is lost.
                    tail = await loop.run_in_executor(self._exec,
                                                      self._buffer.flush)
                    if tail is not None:
                        self._complete(tail)
                    if not await self._recover_supervised(faults):
                        break        # degraded: loop exits, health goes 503
                # Coalesce on the LOOP thread: admission (open/close_session)
                # also runs here, so whether a client's splice makes this
                # boundary or the next is decided by asyncio callback order,
                # never by a loop-vs-engine-thread race — the determinism
                # the bitwise chaos comparisons rely on.
                pending = self.scheduler.coalesce()
                attached = self.scheduler.attached
                done = await loop.run_in_executor(
                    self._exec, self._advance_once, pending, attached)
                if done is not None:
                    self._complete(done)
                if self._chunks_remaining is not None:
                    self._chunks_remaining -= 1
            tail = None if self._buffer is None else self._buffer.flush()
            if tail is not None:
                self._complete(tail)
        finally:
            self._running = False
            if self.bus is not None:
                self.bus.close_all("degraded" if self._state == "degraded"
                                   else "shutdown")

    def _advance_once(self, pending, attached):
        """(engine thread) Apply due journal replays and the loop-frozen
        pending slot splice (journal-first: write-ahead), dispatch one
        chunk, and hand back the *previous* chunk still device-side (the
        lag-one pipeline; materialization happens in :meth:`_complete`).
        ``pending``/``attached`` were coalesced/captured on the loop thread
        so splice boundaries are ordered against admission, not raced.
        Periodic checkpoints cost only the device→host mirror here —
        serialization and fsync live on the manager's writer thread."""
        sess = self.session
        self._apply_replay(sess)
        if pending is not None:                # coalesced boundary swap
            slots, sub, labels = pending
            entry = SpliceEntry(t=sess.step_count, slots=slots,
                                labels=labels, spec=sub)
            if self._journal is not None:      # WAL: durable BEFORE applied
                self._journal.append(entry)
                if self.metrics is not None:
                    self.metrics.inc("journal_entries_total")
            sess.swap_markets(list(slots), sub)
        seq = next(self._seq)
        step0 = sess.step_count
        t0 = time.perf_counter()
        batch = sess.run(self.chunk)   # returns once the kernel is queued
        # The carried stats (stats_only), joined on the first device, take
        # the same non-blocking copy; Session.stats would wait for the card.
        stats = sess._joined_stats()
        copy = HostCopy(list(batch) + list(stats or ()), self._copy_stream)
        meta = (seq, step0, self.chunk, t0, attached)
        done = self._buffer.push(meta, (copy, stats is not None))
        if (self._ckpt is not None and self.checkpoint_every
                and (seq + 1) % self.checkpoint_every == 0):
            t0c = time.perf_counter()
            sess.save_checkpoint(self._ckpt, wait=False)
            if self.metrics is not None:
                self.metrics.observe_window("checkpoint_snapshot_seconds",
                                            time.perf_counter() - t0c)
                self.metrics.gauge("checkpoint_writer_pending",
                                   self._ckpt.pending)
                self.metrics.gauge("checkpoints_skipped",
                                   self._ckpt.skipped)
        return done

    def _apply_replay(self, sess) -> None:
        """(engine thread) Apply journaled splices whose boundary the
        restored cursor has reached — the process-restart replay. Applied
        entries are NOT re-journaled (they are already on disk)."""
        while self._replay and self._replay[0].t <= sess.step_count:
            e = self._replay.pop(0)
            if e.t < sess.step_count:
                continue   # already baked into the restored checkpoint
            sess.swap_markets(list(e.slots), e.spec)
            for slot, label in zip(e.slots, e.labels):
                if label is None:
                    self.scheduler.mark_parked(slot)
                else:
                    self.scheduler.mark_attached(slot, label)

    def _to_host(self, payload: Tuple[HostCopy, bool]):
        copy, has_stats = payload
        t0 = time.perf_counter()
        arrays = copy.result()
        if self.metrics is not None:
            self.metrics.observe("conversion_seconds",
                                 time.perf_counter() - t0)
        return (StepBatch(*arrays[:3]),
                MarketStats(*arrays[3:]) if has_stats else None)

    def _complete(self, done) -> None:
        """(event loop) Record a finished chunk's latency and fan it out;
        queue puts are non-blocking, so this never stalls the loop."""
        (seq, step0, n, t0, slots), payload = done
        if self.metrics is not None:
            self.metrics.observe_window("chunk_latency_seconds",
                                        time.perf_counter() - t0)
        host_batch, stats = payload
        self.bus.publish(slice_frames(host_batch, stats, slots, seq,
                                      step0, n))

    # ---- checkpoint-writer callbacks (writer thread; registry is
    # thread-safe) ----
    def _on_ckpt_write(self, step: int, seconds: float) -> None:
        if self.metrics is not None:
            self.metrics.observe_window("checkpoint_write_seconds", seconds)
            self.metrics.inc("checkpoints_saved_total")

    def _on_ckpt_gc(self, oldest_retained_step: int) -> None:
        if self._journal is not None:
            dropped = self._journal.compact(oldest_retained_step)
            if dropped and self.metrics is not None:
                self.metrics.inc("journal_compactions_total")
                self.metrics.inc("journal_entries_compacted_total", dropped)

    # ---- supervised recovery (the fault-storm state machine) ----
    async def _recover_supervised(self, faults: List[Any]) -> bool:
        """One coalesced recovery pass over every queued fault.

        Retries ``_recover`` up to ``max_recovery_attempts`` times with
        exponential backoff + jitter; success broadcasts ONE ``reconnect``
        (however many faults coalesced), exhaustion degrades the gateway
        (503 health, :class:`GatewayDegraded` admission) and broadcasts
        ``degraded``. Returns True when serving may resume.
        """
        loop = asyncio.get_running_loop()
        self._state = "recovering"
        if self.metrics is not None and len(faults) > 1:
            self.metrics.inc("faults_coalesced_total", len(faults) - 1)
        fault = faults[-1]
        target = self.step_count
        base, cap = self._backoff
        last_error: Optional[BaseException] = None
        for attempt in range(1, self._max_attempts + 1):
            if self.metrics is not None:
                self.metrics.inc("recovery_attempts_total")
            t0 = time.perf_counter()
            try:
                resume = await loop.run_in_executor(
                    self._exec, self._recover, fault, target)
            except Exception as exc:
                last_error = exc
                if attempt < self._max_attempts:
                    delay = min(cap, base * (2 ** (attempt - 1)))
                    await asyncio.sleep(delay * (1.0 + random.random()))
                continue
            self._state = "serving"
            if self.metrics is not None:
                self.metrics.observe_window("recovery_seconds",
                                            time.perf_counter() - t0)
            self.bus.broadcast(Event("reconnect", {
                "resume_step": resume, "step": self.step_count,
                "fault": type(fault).__name__,
                "faults_coalesced": len(faults),
                "attempts": attempt}))
            if self.metrics is not None:
                self.metrics.inc("reconnects_total")
                self.metrics.inc("recoveries_total")
            return True
        self._state = "degraded"
        self._degraded_reason = (
            f"recovery failed after {self._max_attempts} attempts: "
            f"{type(last_error).__name__}: {last_error}")
        if self.metrics is not None:
            self.metrics.gauge("degraded", 1)
        self.bus.broadcast(Event("degraded", {
            "reason": self._degraded_reason, "step": target,
            "fault": type(fault).__name__,
            "faults_coalesced": len(faults)}))
        return False

    def _recover(self, fault, target: int) -> int:
        """(engine thread) Device-fault recovery under live client load.

        Drop the session, the engine and its runners and the loaded kernel
        libraries, wait for the card (``torch.cuda.synchronize``), open a
        new engine on the surviving topology (``devices_after`` /
        ``lost_device``, as in :class:`repro_torch.ops.chaos.DeviceLoss`;
        with neither, on the same card; its libraries load again from the
        on-disk build, with no ``nvcc``) and re-warm it, restore the newest
        loadable checkpoint
        (walking the ladder past corrupt steps), then replay *quietly* back
        to ``target`` (the pre-fault cursor), re-applying splices read from
        the **durable journal** at their original boundaries, so published
        streams continue bitwise after the ``reconnect`` event. Idempotent
        across retry attempts. Returns the step the session resumed from.
        """
        from repro_torch.ops.chaos import (_restore_resilient, release_engine,
                                           surviving_opts)

        if self.session is not None:
            self.session.close()
        if self.engine is not None:
            release_engine(self.engine)
        self.engine = self.session = None
        self._engine_opts, _ = surviving_opts(self._engine_opts, fault,
                                              self.device)
        self._open_engine(self._engine_opts)
        errors: List[str] = []
        resumed = _restore_resilient(self.session, self._ckpt, errors)
        # Quiet replay: the checkpoint predates some splices — re-apply
        # each at its original boundary (from the durable journal, so the
        # same path covers in-process recovery and process restart) while
        # running the lost chunks.
        replay = [e for e in self._journal.entries()
                  if resumed <= e.t < target]
        for e in replay:
            while self.session.step_count < e.t:
                self.session.run(min(self.chunk,
                                     e.t - self.session.step_count))
            self.session.swap_markets(list(e.slots), e.spec)
        while self.session.step_count < target:
            self.session.run(min(self.chunk,
                                 target - self.session.step_count))
        return resumed
