"""Deterministic failure injection at chunk boundaries (the chaos harness).

A :class:`FaultPlan` schedules faults at exact step coordinates and
:func:`run_plan` drives a session through them, recovering after each one
from the last *loadable* checkpoint and replaying the lost steps. Because
the engine's RNG keys on the absolute step coordinate, recovery is
**bitwise**: every replayed chunk must equal the chunk originally streamed
before the fault. ``tests/test_torch_ops.py`` asserts exactly that for
every fault class; :func:`run_serve_plan` does the same under a serving
gateway's client load.

Fault classes:

  * :class:`DeviceLoss`     — tear the session and engine down, drop the
    loaded kernel libraries, wait for the card, rebuild the engine on the
    surviving devices (``devices_after=N``, or a mesh without
    ``lost_device``; with neither, on the same card: its libraries load
    again from the on-disk build) and restore the last checkpoint, which
    keeps the canonical layout on any mesh.
  * :class:`CheckpointCorruption` — damage the newest checkpoint on disk
    (truncate or bit-flip a shard / the manifest) before restarting. The
    restore path must raise a typed
    :class:`~repro_torch.checkpoint.manager.CheckpointCorruptError` — never
    load silently — and the harness falls back down the checkpoint ladder to
    the newest intact step.
  * :class:`TornCheckpointWrite` — crash the process at an exact durable
    write offset *inside* a checkpoint commit (via
    :func:`crash_during_write`, which patches the manager's ``_barrier``
    choke point), then restart. The commit protocol (tmp + fsync + atomic
    rename + terminal ``COMMIT`` marker) must leave either the previous
    committed checkpoint or a skipped uncommitted directory — a torn
    write must **never** restore loadable-but-wrong state. The chaos
    tests sweep every injection offset.
  * :class:`AutotuneOOM`    — restart with the tile sweep on while every
    timed candidate fails out-of-memory-shaped (:func:`force_autotune_oom`);
    the runner must fall back to the launch rule's tile.

Every fault is injected *between* chunk dispatches — the simulator's only
coherent preemption points (mid-chunk state never exists on the host) —
so plans validate fault coordinates against the chunk length.
"""
from __future__ import annotations

import contextlib
import dataclasses
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.checkpoint.manager import (CheckpointCorruptError,
                                            CheckpointError,
                                            CheckpointManager)
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.result import to_host
from repro_torch.core import session as session_mod
from repro_torch.kernels import _build


@dataclasses.dataclass(frozen=True)
class Fault:
    """Base fault: fires when the session cursor reaches ``at_step``."""

    at_step: int


@dataclasses.dataclass(frozen=True)
class DeviceLoss(Fault):
    """Simulated loss of a device: rebuild on the survivors and restore.

    ``devices_after`` pins the rebuilt mesh width (``devices=N``);
    ``lost_device`` instead names the lost local device index and spans
    every survivor (``make_markets_mesh(skip=(lost_device,))``). With
    neither, the session rebuilds on the engine's original options — a
    plain restart.
    """

    devices_after: Optional[int] = None
    lost_device: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class CheckpointCorruption(Fault):
    """Damage the newest checkpoint before restarting.

    ``kind``:   ``"truncate"`` (keep the first half of the bytes) or
                ``"bitflip"`` (XOR one mid-file byte).
    ``target``: ``"shard"`` (the first shard_*.npz) or ``"manifest"``.
    """

    kind: str = "truncate"
    target: str = "shard"

    def __post_init__(self):
        if self.kind not in ("truncate", "bitflip"):
            raise ValueError(f"unknown corruption kind {self.kind!r}")
        if self.target not in ("shard", "manifest"):
            raise ValueError(f"unknown corruption target {self.target!r}")


@dataclasses.dataclass(frozen=True)
class AutotuneOOM(Fault):
    """Restart with the autotune sweep enabled while every timed candidate
    fails with an OOM-shaped error; the runner must fall back to the
    conservative rule's tile."""


@dataclasses.dataclass(frozen=True)
class TornCheckpointWrite(Fault):
    """Crash mid-checkpoint-commit at durable-write op ``crash_at_op``,
    then restart and restore.

    The save attempt runs under :func:`crash_during_write`, which raises
    :class:`SimulatedCrash` after the ``crash_at_op``-th barrier inside
    the manager's commit sequence — simulating process death at that
    exact write offset. The restart must restore a committed checkpoint
    (the torn one is skipped by the ``COMMIT``-marker protocol; an
    explicit restore of it raises a typed
    :class:`~repro_torch.checkpoint.manager.CheckpointCorruptError`) and replay
    bitwise. Use ``count_write_ops`` to discover the sweep range.
    """

    crash_at_op: int = 0


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """What actually happened when one fault fired."""

    fault: Fault
    at_step: int
    recovered_from: int          # checkpoint step the session resumed at
    errors: Tuple[str, ...]      # typed errors hit on the way (corruption)
    detail: str = ""             # fault-specific notes


@dataclasses.dataclass(frozen=True)
class ChaosReport:
    """Result of :func:`run_plan`."""

    batch: session_mod.StepBatch  # the full recovered [M, n_steps] stream
    state: Tuple[np.ndarray, ...]  # final MarketState, host-side
    events: Tuple[FaultEvent, ...]
    replay_matched: bool         # every replayed chunk == original, bitwise
    checkpoints: Tuple[int, ...]  # intact checkpoint steps at exit


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of faults over one simulated run.

    ``checkpoint_every`` steps (0 disables periodic checkpoints beyond the
    mandatory one at step 0). Fault coordinates and the checkpoint cadence
    must be chunk-boundary-aligned — faults are injected between chunk
    dispatches, the engine's only coherent preemption points.
    """

    faults: Tuple[Fault, ...]
    checkpoint_every: int = 0

    def __init__(self, faults: Sequence[Fault], checkpoint_every: int = 0):
        object.__setattr__(self, "faults",
                           tuple(sorted(faults, key=lambda f: f.at_step)))
        object.__setattr__(self, "checkpoint_every", int(checkpoint_every))

    def validate(self, chunk: int, n_steps: int) -> None:
        if self.checkpoint_every and self.checkpoint_every % chunk:
            raise ValueError(
                f"checkpoint_every={self.checkpoint_every} is not a "
                f"multiple of the chunk length {chunk}: checkpoints are "
                "taken at chunk boundaries")
        for f in self.faults:
            if not (0 < f.at_step <= n_steps):
                raise ValueError(
                    f"fault {f} fires at step {f.at_step}, outside the "
                    f"run's (0, {n_steps}] window")
            if f.at_step % chunk:
                raise ValueError(
                    f"fault {f} fires at step {f.at_step}, which is not a "
                    f"chunk boundary (chunk={chunk}): faults inject at the "
                    "engine's coherent preemption points only")


# ---------------------------------------------------------------------------
# corruption injectors (used directly by tests as well)
# ---------------------------------------------------------------------------

def corrupt_checkpoint(directory, step: int, kind: str = "truncate",
                       target: str = "shard") -> Path:
    """Damage one file of checkpoint ``step`` in ``directory`` on disk.

    Returns the path that was damaged. ``kind="truncate"`` keeps the first
    half of the file's bytes; ``kind="bitflip"`` XORs one mid-file byte.
    """
    sdir = Path(directory) / f"step_{step:08d}"
    if target == "manifest":
        victim = sdir / "manifest.json"
    else:
        shards = sorted(sdir.glob("shard_*.npz"))
        if not shards:
            raise FileNotFoundError(f"no shards under {sdir}")
        victim = shards[0]
    data = victim.read_bytes()
    if kind == "truncate":
        data = data[:max(1, len(data) // 2)]
    elif kind == "bitflip":
        i = _payload_offset(victim, data)
        data = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    victim.write_bytes(data)
    return victim


def _payload_offset(victim: Path, data: bytes) -> int:
    """A byte offset inside actual *payload* (not container metadata).

    A flip in a zip archive's central directory (timestamps, attributes)
    can be semantically invisible — the member data still reads back
    intact, which is not a corruption at all. Aim at the first member's
    data region instead, so the archive's CRC deterministically trips.
    Non-zip files (the JSON manifest) just take a mid-file byte.
    """
    if victim.suffix == ".npz":
        with zipfile.ZipFile(victim) as z:
            info = z.infolist()[0]
        # local file header: 30 fixed bytes + filename + extra field
        name_len = int.from_bytes(
            data[info.header_offset + 26:info.header_offset + 28], "little")
        extra_len = int.from_bytes(
            data[info.header_offset + 28:info.header_offset + 30], "little")
        start = info.header_offset + 30 + name_len + extra_len
        return min(start + info.compress_size // 2, len(data) - 1)
    return len(data) // 2


class SimulatedCrash(RuntimeError):
    """Stands in for process death at an exact durable-write offset: the
    op that raised it — and everything after — never reached disk order.
    Only :func:`crash_during_write` raises it."""


@contextlib.contextmanager
def crash_during_write(after_ops: Optional[int]):
    """Simulate a process crash inside the checkpoint commit sequence.

    Patches :func:`repro_torch.checkpoint.manager._barrier` — the no-op
    hook the manager calls between every durable sub-operation (open, mid-write,
    pre-fsync, pre-rename, post-rename, per file) — to raise
    :class:`SimulatedCrash` on the ``after_ops``-th call. Everything the
    commit sequence did *before* that barrier is on disk exactly as a real
    crash would leave it (including torn ``.tmp`` files: the mid-write
    barrier fires with half the payload written).

    ``after_ops=None`` is count-only mode: nothing raises, and the yielded
    list's single element ends up holding the total number of barrier ops
    a full commit executes — the sweep range for torn-write enumeration::

        with crash_during_write(None) as ops:
            mgr.save(step, tree)            # sync manager: completes
        for k in range(ops[0]):
            with crash_during_write(k), pytest.raises(SimulatedCrash):
                mgr.save(step2, tree2)
            ...assert restore never loads torn state...
    """
    from repro_torch.checkpoint import manager as ckpt

    counter = [0]
    real = ckpt._barrier

    def crashing_barrier(label: str) -> None:
        if after_ops is not None and counter[0] == after_ops:
            raise SimulatedCrash(
                f"injected crash at durable-write op {after_ops} ({label})")
        counter[0] += 1

    ckpt._barrier = crashing_barrier
    try:
        yield counter
    finally:
        ckpt._barrier = real


def count_write_ops(mgr: CheckpointManager, step: int, tree) -> int:
    """Number of durable-write barrier ops one full commit of ``tree``
    executes (run against a scratch save of ``step``) — the enumeration
    bound for a torn-write sweep."""
    with crash_during_write(None) as ops:
        mgr.save(step, tree)
        mgr.wait()
    return ops[0]


@contextlib.contextmanager
def force_autotune_oom():
    """Make every tile-candidate timing call fail out-of-memory-shaped.

    Patches ``repro_torch.kernels.autotune.time_call`` for the duration, so
    any sweep started inside the context disqualifies every candidate and
    must fall back to the rule's tile. The injected error is a
    ``torch.cuda.OutOfMemoryError`` worded as the caching allocator words
    one, so ``autotune.is_oom_error`` recognises it.
    """
    from repro_torch.kernels import autotune

    real = autotune.time_call

    def exploding_time_call(fn, block, trials: int = 2) -> float:
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 2.00 GiB (injected chaos "
            "fault: tile candidate exceeded device memory while allocating "
            "scratch)")

    autotune.time_call = exploding_time_call
    try:
        yield
    finally:
        autotune.time_call = real


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

def release_engine(engine) -> None:
    """A :class:`DeviceLoss` teardown: drop the engine's runners and the
    loaded kernel libraries (the next engine loads them again from the
    on-disk build, without ``nvcc``), then wait for the card."""
    engine.clear_cache()
    _build.forget()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)


def surviving_opts(opts: Dict[str, Any], fault: Fault, device
                   ) -> Tuple[Dict[str, Any], str]:
    """Engine options after ``fault`` (on ``device``'s type) and the
    :class:`FaultEvent` detail: ``devices=devices_after``, a mesh over every
    survivor of ``lost_device``, or (neither, or not a
    :class:`DeviceLoss`) the original options."""
    devices_after = getattr(fault, "devices_after", None)
    lost_device = getattr(fault, "lost_device", None)
    if devices_after is None and lost_device is None:
        return dict(opts), "restarted on the same card"
    from repro_torch.launch.mesh import make_markets_mesh

    new_opts = dict(opts)
    new_opts.pop("devices", None)
    new_opts.pop("mesh", None)
    if devices_after is not None:
        new_opts["devices"] = devices_after
        return new_opts, f"rebuilt on devices={devices_after}"
    new_opts["mesh"] = make_markets_mesh(skip=(lost_device,), device=device)
    return new_opts, (f"lost device {lost_device}; mesh over "
                      f"{new_opts['mesh'].size} survivors")


def _restore_resilient(session, mgr: CheckpointManager,
                       errors: List[str]) -> int:
    """Restore the newest *loadable* checkpoint, walking the ladder down.

    Typed corruption errors are recorded in ``errors`` (the chaos tests
    assert they were raised — silent loads of damaged data are the bug this
    module exists to catch) and the next-older step is tried.
    """
    for step in sorted(mgr.steps(), reverse=True):
        try:
            return session.restore_checkpoint(mgr, step)
        except CheckpointError as exc:
            errors.append(f"step {step}: {type(exc).__name__}: {exc}")
    raise CheckpointCorruptError(
        "no loadable checkpoint survives in "
        f"{mgr.dir}; errors: {errors}")


def run_plan(plan: FaultPlan, spec, *, backend: str, ckpt_dir,
             chunk_size: int, engine_opts: Optional[Dict[str, Any]] = None,
             n_steps: Optional[int] = None, keep: int = 32) -> ChaosReport:
    """Drive ``spec`` for ``n_steps`` under ``plan``, recovering each fault.

    The harness checkpoints at step 0 and every ``plan.checkpoint_every``
    steps; when a fault fires it injects the failure, rebuilds the
    engine/session (dropping the loaded kernel libraries and, for a
    :class:`DeviceLoss` with ``devices_after`` or ``lost_device``, on a
    different device set), restores the newest loadable checkpoint, and
    replays the lost chunks.
    Replayed chunks are compared bitwise against the originally streamed
    ones (``ChaosReport.replay_matched``); the returned batch is the
    deduplicated full-horizon stream.
    """
    spec = EnsembleSpec.coerce(spec)
    opts = dict(engine_opts or {})
    steps = int(n_steps if n_steps is not None else spec.num_steps)
    plan.validate(chunk_size, steps)
    mgr = CheckpointManager(ckpt_dir, async_write=False, keep=keep)

    def open_session(engine_opts):
        eng = session_mod.Engine(backend, chunk_size=chunk_size,
                                 **engine_opts)
        return eng, eng.open(spec)

    eng, sess = open_session(opts)
    sess.save_checkpoint(mgr)                 # step 0: the mandatory anchor
    faults = list(plan.faults)
    events: List[FaultEvent] = []
    # chunk start step -> batch
    collected: Dict[int, session_mod.StepBatch] = {}
    replay_matched = True
    t = 0
    while t < steps:
        if faults and faults[0].at_step == t:
            fault = faults.pop(0)
            errors: List[str] = []
            detail = ""
            if isinstance(fault, CheckpointCorruption):
                latest = mgr.latest_step()
                victim = corrupt_checkpoint(mgr.dir, latest, fault.kind,
                                            fault.target)
                detail = f"corrupted {victim.name} of step {latest}"
                sess.close()
                eng, sess = open_session(opts)
            elif isinstance(fault, DeviceLoss):
                sess.close()
                release_engine(eng)
                new_opts, detail = surviving_opts(opts, fault, eng.device)
                eng, sess = open_session(new_opts)
            elif isinstance(fault, AutotuneOOM):
                from repro_torch.kernels import autotune

                sess.close()
                autotune.clear_tune_cache()
                with force_autotune_oom():
                    eng, sess = open_session({**opts, "autotune": True})
                report = autotune.last_sweep_report()
                if report is None or not report.fell_back:
                    raise RuntimeError(
                        f"AutotuneOOM at step {t}: the restart's sweep did "
                        f"not fall back to the rule's tile ({report})")
                detail = (f"sweep fell_back={report.fell_back} "
                          f"winner={report.winner} "
                          f"failures={len(report.failures)}")
                errors.extend(report.failures)
            elif isinstance(fault, TornCheckpointWrite):
                # A checkpoint save at this boundary dies mid-commit at the
                # requested durable-write offset; the "process" restarts
                # and must restore a committed checkpoint — never the torn
                # one (the ladder skips it; loading it explicitly raises).
                try:
                    with crash_during_write(fault.crash_at_op):
                        sess.save_checkpoint(mgr)
                except SimulatedCrash as exc:
                    errors.append(f"SimulatedCrash: {exc}")
                detail = (f"crashed at durable-write op "
                          f"{fault.crash_at_op} during save at step {t}")
                sess.close()
                eng, sess = open_session(opts)
            else:
                raise TypeError(f"unknown fault class {type(fault).__name__}")
            recovered = _restore_resilient(sess, mgr, errors)
            events.append(FaultEvent(fault=fault, at_step=t,
                                     recovered_from=recovered,
                                     errors=tuple(errors), detail=detail))
            t = recovered
            continue
        n = min(chunk_size, steps - t)
        batch = sess.run(n).to_numpy()
        prev = collected.get(t)
        if prev is not None:       # replaying steps lost to a fault
            for field, a, b in zip(batch._fields, prev, batch):
                if not (np.asarray(a) == np.asarray(b)).all():
                    replay_matched = False
        collected[t] = batch
        t += n
        if (plan.checkpoint_every and t < steps
                and t % plan.checkpoint_every == 0):
            sess.save_checkpoint(mgr)
    full = session_mod.StepBatch(*(np.concatenate(parts, axis=-1) for parts in
                       zip(*(collected[k] for k in sorted(collected)))))
    state = tuple(to_host(x) for x in sess.state)
    sess.close()
    return ChaosReport(batch=full, state=state, events=tuple(events),
                       replay_matched=replay_matched,
                       checkpoints=tuple(mgr.steps()))


# ---- serving-gateway chaos (faults under concurrent client load) ----

@dataclasses.dataclass(frozen=True)
class ServeChaosReport:
    """Outcome of :func:`run_serve_plan`: per-client streams + recovery.

    ``frames``/``events`` are keyed by client id in attach order. Compare
    two reports' frames bitwise (fault-free vs faulted run of the same
    scenario mixture) to prove recovery resumed every client's trajectory
    exactly; ``reconnects`` counts the ``reconnect`` control events each
    surviving client observed (all clients see every recovery).
    ``traces_delta`` is the gateway's post-(re)warm build delta — 0 means
    no client request ever paid a build, before or after the fault.
    """

    frames: Dict[str, Tuple[Any, ...]]
    events: Dict[str, Tuple[Any, ...]]
    reconnects: int
    traces_delta: int
    steps: int
    recoveries: int = 0          # supervised recovery passes that succeeded
    health: Optional[Dict[str, Any]] = None   # gateway health pre-shutdown

    def client_paths(self, client: str) -> Tuple[np.ndarray, np.ndarray]:
        """(mid, price) concatenated over the client's frames."""
        fs = self.frames[client]
        return (np.concatenate([f.mid for f in fs]),
                np.concatenate([f.price for f in fs]))


def run_serve_plan(scenarios: Sequence[str], *, backend: str, ckpt_dir,
                   chunk_size: int = 8, chunks: int = 12,
                   checkpoint_every: int = 2, slots: Optional[int] = None,
                   fault: Union[Fault, Sequence[Fault], None] = None,
                   fault_after: int = 2,
                   late_attach: Optional[str] = None, late_after: int = 4,
                   num_agents: int = 16, num_levels: int = 32,
                   ckpt_keep: int = 64,
                   engine_opts: Optional[Dict[str, Any]] = None,
                   ) -> ServeChaosReport:
    """Drive a serving gateway under concurrent client load, with a fault.

    One client session opens per entry of ``scenarios`` (preset names)
    before the first chunk; ``late_attach`` optionally adds one more after
    ``late_after`` chunks — *after* a checkpoint, so recovery must replay
    the attach from the gateway's durable splice journal. ``fault``
    (typically :class:`DeviceLoss`) is injected at the chunk boundary
    after the first client has received ``fault_after`` frames; recovery
    restores the newest checkpoint and replays quietly, and every client
    sees a ``reconnect`` event while its stream continues bitwise. A
    *sequence* of faults is injected back-to-back — a fault storm — and
    must coalesce into ONE supervised recovery pass (one ``reconnect``
    broadcast; ``ServeChaosReport.recoveries == 1``).

    ``ckpt_keep`` bounds the gateway's checkpoint ladder, so a small value
    under a long run forces GC + splice-journal compaction mid-flight (the
    compaction-never-breaks-replay test rides on this).

    Per-client queues are sized to hold the whole run (``chunks`` deep) so
    this harness measures recovery fidelity, not backpressure — the
    backpressure tests live in ``tests/test_torch_serve.py``.
    """
    import asyncio

    from repro_torch.serve import Gateway, parked_template

    n_clients = len(scenarios) + (1 if late_attach else 0)
    tpl = parked_template(
        slots=n_clients if slots is None else slots, num_agents=num_agents,
        num_levels=num_levels, num_steps=max(4096, chunks * chunk_size))
    faults = ([] if fault is None
              else list(fault) if isinstance(fault, (list, tuple))
              else [fault])

    async def drive():
        gw = Gateway(tpl, backend=backend, chunk_size=chunk_size,
                     queue_maxsize=chunks + 4,
                     ckpt_dir=ckpt_dir, checkpoint_every=checkpoint_every,
                     ckpt_keep=ckpt_keep, engine_opts=engine_opts)
        await gw.start(chunks=chunks)
        clients = [gw.open_session(s, client=f"c{i}")
                   for i, s in enumerate(scenarios)]
        collected = [list(await clients[0].frames(fault_after))]
        collected += [[] for _ in clients[1:]]
        if late_attach is not None:
            while len(collected[0]) < late_after:
                collected[0].append(await clients[0].next_frame())
            clients.append(gw.open_session(late_attach, client="late"))
            collected.append([])
        for f in faults:     # back-to-back: the loop must coalesce these
            gw.inject_fault(f)
        rest = await asyncio.gather(
            *(cs.frames(chunks) for cs in clients))
        for got, more in zip(collected, rest):
            got.extend(more)
        health = gw.health()
        recoveries = 0
        if gw.metrics is not None:
            recoveries = int(gw.metrics.counter("recoveries_total"))
        await gw.stop()
        return gw, clients, collected, health, recoveries

    gw, clients, collected, health, recoveries = asyncio.run(drive())
    events = {cs.client: tuple(cs.events) for cs in clients}
    return ServeChaosReport(
        frames={cs.client: tuple(fs)
                for cs, fs in zip(clients, collected)},
        events=events,
        reconnects=sum(1 for e in events[clients[0].client]
                       if e.kind == "reconnect"),
        traces_delta=gw.traces_delta,
        steps=gw.step_count,
        recoveries=recoveries,
        health=health)
