"""The port's serving gateway (``repro_torch.serve``) on the CPU.

Analogues of ``tests/test_serve.py`` on ``cuda-kinetic`` with
``device="cpu"`` (the kernel's plain version) and on ``torch-scan``: row
splices leave every other row unchanged and build nothing, the gateway
serves 32 clients with ``traces_delta == 0``, a stalled client delays no
one, the bus, scheduler, journal, supervision and transports behave as in
the JAX package. Splices are also held against a ``repro`` session with the
same splices, with ``==``.
"""
import asyncio
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.core.config import scenario_config as j_scenario_config
from repro.core.params import EnsembleSpec as JSpec
from repro.core.session import Engine as JEngine
from repro.serve import SpliceJournal as JJournal
from repro_torch.core.config import scenario_config
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine
from repro_torch.ops.metrics import QuantileWindow
from repro_torch.serve import (POLICIES, DoubleBuffer, Event, Frame, FrameBus,
                               Gateway, GatewayDegraded, GatewayFull,
                               GatewayRecovering, HostCopy, SlotScheduler,
                               SpliceEntry, SpliceJournal, decode,
                               parked_template)

BACKENDS = ["cuda-kinetic", "torch-scan"]
CPU = {"device": "cpu"}

KW = dict(num_agents=16, num_levels=32, num_steps=64, seed=11)
CHUNK = 16


def _spec(markets=6, scenario="baseline", **over):
    return EnsembleSpec.coerce(
        scenario_config(scenario, num_markets=markets, **{**KW, **over}))


def _jspec(markets=6, scenario="baseline", **over):
    return JSpec.coerce(
        j_scenario_config(scenario, num_markets=markets, **{**KW, **over}))


def _tpl(slots=6, **over):
    return parked_template(slots=slots, **{**KW, **over})


def _gateway(slots=6, backend="cuda-kinetic", num_steps=4096, **kw):
    return Gateway(_tpl(slots, num_steps=num_steps), backend=backend,
                   engine_opts=CPU, **kw)


def _host(batches):
    return [np.concatenate([np.asarray(getattr(b, f)) for b in batches],
                           axis=-1) for f in ("price", "volume", "mid")]


# ---------------------------------------------------------------------------
# swap_markets: the slot-splice invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_swap_leaves_other_markets_bitwise_unchanged(backend):
    """Splicing rows into a live session perturbs no other row, and the
    spliced run equals a ``repro`` session given the same splices."""
    spec = _spec()
    eng = Engine(backend, chunk_size=CHUNK, **CPU)
    with eng.open(spec) as s:
        base = _host([s.run(64).to_numpy()])
    sub = _spec(1, "flash-crash", shock_step=40)
    with eng.open(spec) as s:
        a = s.run(16).to_numpy()
        s.swap_markets([4], sub)
        b = s.run(16).to_numpy()
        s.swap_markets([2], EnsembleSpec.parked(spec, 1))
        c = s.run(32).to_numpy()
        assert s.spec.scenarios[2] == "parked"
        assert s.spec.scenarios[4] == "flash-crash"
        # the device rows were re-packed in place of the spec's host rows
        for have, want in zip(s.params.to_numpy(), s.spec.params):
            assert (np.asarray(have) == np.asarray(want)).all()
        assert s.horizon == KW["num_steps"]
    got = _host([a, b, c])
    untouched = [0, 1, 3, 5]
    for want, have in zip(base, got):
        assert (want[untouched] == have[untouched]).all()
        assert (want[2, :32] == have[2, :32]).all()
        assert (want[4, :16] == have[4, :16]).all()
    jspec = _jspec()
    with JEngine("numpy", chunk_size=CHUNK).open(jspec) as js:
        ja = js.run(16)
        js.swap_markets([4], _jspec(1, "flash-crash", shock_step=40))
        jb = js.run(16)
        js.swap_markets([2], JSpec.parked(jspec, 1))
        jc = js.run(32)
    for want, have in zip(_host([ja, jb, jc]), got):
        assert (want == have).all()


@pytest.mark.parametrize("backend", BACKENDS)
def test_swap_and_parked_slots_never_retrace(backend):
    """Attach, detach and parked rows are value mutations: the engine's
    trace_count (runners and libraries built) does not move."""
    spec = _spec()
    eng = Engine(backend, chunk_size=CHUNK, **CPU)
    with eng.open(spec) as s:
        s.run(CHUNK)
        warm = eng.trace_count
        assert warm == 1
        for i, scen in enumerate(("flash-crash", "high-vol", "thin-book")):
            s.swap_markets([i], _spec(1, scen))
            s.run(CHUNK)
        s.swap_markets([0, 1, 2], EnsembleSpec.parked(spec, 3))
        s.run(CHUNK)
        assert eng.trace_count == warm, \
            f"{backend}: slot churn built a runner or library"
        assert s.metrics.counter("traces") == 0
        assert s.metrics.counter("swaps_total") == 6


def test_swap_validates_slots_and_static_fields():
    spec = _spec()
    with Engine("torch-scan", **CPU).open(spec) as s:
        with pytest.raises(ValueError, match="slots"):
            s.swap_markets([1, 1], _spec(2))
        with pytest.raises(ValueError):
            s.swap_markets([99], _spec(1))
        with pytest.raises(ValueError, match="num_agents"):
            s.swap_markets([0], _spec(1, num_agents=8))
        assert s.spec.scenarios == spec.scenarios   # untouched


# ---------------------------------------------------------------------------
# SlotScheduler
# ---------------------------------------------------------------------------

def test_scheduler_admission_and_coalescing():
    tpl = _tpl(3)
    sched = SlotScheduler(tpl)
    s0 = sched.attach("baseline")
    s1 = sched.attach("flash-crash")
    s2 = sched.attach("high-vol")
    assert (s0, s1, s2) == (0, 1, 2) and sched.free == 0
    with pytest.raises(GatewayFull):
        sched.attach("baseline")
    sched.detach(s1)                      # park + free immediately...
    assert sched.attach("thin-book") == s1    # ...so the slot is reusable
    with pytest.raises(KeyError):
        sched.detach(99)
    # detach-then-attach between boundaries coalesces to ONE splice row
    with Engine("torch-scan", chunk_size=CHUNK, **CPU).open(tpl) as sess:
        applied = sched.drain(sess)
        assert applied is not None
        slots, sub = applied
        assert slots == (0, 1, 2) and sub.num_markets == 3
        assert sub.scenarios[1] == "thin-book"   # the attach won
        assert sched.drain(sess) is None         # queue fully drained


def test_scheduler_rejects_static_mismatch_at_admission():
    sched = SlotScheduler(_tpl(2))
    with pytest.raises(ValueError, match="static field"):
        sched.attach(_spec(1, num_agents=KW["num_agents"] * 2))
    with pytest.raises(ValueError, match="one market"):
        sched.attach(_spec(2))
    assert sched.free == 2                # failed admissions reserve nothing


# ---------------------------------------------------------------------------
# FrameBus: bounded backpressure
# ---------------------------------------------------------------------------

def _frame(slot, seq):
    z = np.zeros(2, np.float32)
    return Frame(slot=slot, seq=seq, step0=seq * 2, num_steps=2,
                 mid=z, price=z, volume=z)


def test_bus_drop_oldest_never_blocks():
    async def main():
        bus = FrameBus()
        sub = bus.subscribe(0, maxsize=2, policy="drop-oldest")
        for seq in range(5):
            bus.publish([(0, _frame(0, seq))])
        assert sub.qsize() == 2 and sub.dropped == 3
        got = [await sub.get(), await sub.get()]
        assert [f.seq for f in got] == [3, 4]     # newest survive
    asyncio.run(main())


def test_bus_disconnect_policy_sheds_slow_client():
    async def main():
        bus = FrameBus()
        slow = bus.subscribe(0, maxsize=1, policy="disconnect")
        fast = bus.subscribe(0, maxsize=8, policy="drop-oldest")
        for seq in range(3):
            bus.publish([(0, _frame(0, seq))])
        assert slow.closed and not fast.closed
        assert bus.clients == (fast.client,)
        items = []
        while (item := await slow.get()) is not None:
            items.append(item)
        events = [i for i in items if isinstance(i, Event)]
        assert events and events[-1].kind == "closed"
        assert events[-1].payload["reason"] == "backpressure"
    asyncio.run(main())


def test_bus_broadcast_and_policy_validation():
    async def main():
        bus = FrameBus()
        subs = [bus.subscribe(i, maxsize=1) for i in range(3)]
        bus.publish([(i, _frame(i, 0)) for i in range(3)])
        bus.broadcast(Event("reconnect", {"resume_step": 0}))
        for sub in subs:      # event forced through the full queues
            item = await sub.get()
            while not isinstance(item, Event):
                item = await sub.get()
            assert item.kind == "reconnect"
        with pytest.raises(ValueError, match="policy"):
            bus.subscribe(9, policy="warp-speed")
        assert "drop-oldest" in POLICIES and "disconnect" in POLICIES
    asyncio.run(main())


# ---------------------------------------------------------------------------
# DoubleBuffer / HostCopy + QuantileWindow + wire codecs
# ---------------------------------------------------------------------------

def test_double_buffer_is_lag_one():
    import torch

    buf = DoubleBuffer(lambda x: x * 10)
    assert buf.push("a", 1) is None and buf.depth == 1
    assert buf.push("b", 2) == ("a", 10)
    assert buf.push("c", 3) == ("b", 20)
    assert buf.flush() == ("c", 30) and buf.depth == 0
    assert buf.flush() is None
    assert buf.conversions == 3
    # On the CPU a HostCopy is the tensors themselves, None passing through.
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    got = HostCopy([t[:, :2], None]).result()
    assert got[1] is None and (got[0] == t[:, :2].numpy()).all()


def test_quantile_window_is_bounded_and_exact():
    w = QuantileWindow(size=8)
    for v in range(100):
        w.add(float(v))
    assert w.count == 100
    assert w.percentile(0) == 92.0 and w.percentile(100) == 99.0
    assert w.percentile(50) == 96.0
    s = w.summary()
    assert s["window"] == 8 and s["p99"] == 99.0


def test_frame_event_json_roundtrip():
    f = _frame(3, 7)._replace(stats={"n_trades": 4.0})
    f2 = decode(f.to_json())
    assert isinstance(f2, Frame) and f2.slot == 3 and f2.seq == 7
    assert np.array_equal(f2.mid, f.mid) and f2.stats["n_trades"] == 4.0
    e = decode(Event("attached", {"slot": 3}).to_json())
    assert isinstance(e, Event) and e.payload["slot"] == 3
    with pytest.raises(ValueError, match="unknown wire"):
        decode(json.dumps({"type": "gibberish"}))


# ---------------------------------------------------------------------------
# Gateway end-to-end (in-process transport)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_gateway_32_clients_zero_retraces(backend):
    """32 concurrent streaming clients over one warm engine, a mixture of
    scenarios, zero builds after warm."""
    async def main():
        gw = _gateway(32, backend, chunk_size=8, queue_maxsize=16)
        await gw.start(chunks=8)
        mix = ["baseline", "flash-crash", "high-vol", "thin-book"]
        clients = [gw.open_session(mix[i % len(mix)]) for i in range(32)]
        assert gw.health()["slots_free"] == 0
        with pytest.raises(GatewayFull):
            gw.open_session("baseline")
        streams = await asyncio.gather(*(c.frames(8) for c in clients))
        await gw.stop()
        assert all(len(fs) == 8 for fs in streams)
        for c, fs in zip(clients, streams):
            assert [f.seq for f in fs] == list(range(8))  # no gaps
            assert all(f.slot == c.slot for f in fs)
        assert gw.traces_delta == 0, \
            f"{gw.traces_delta} builds serving 32 clients"
        assert not np.array_equal(
            np.concatenate([f.mid for f in streams[0]]),
            np.concatenate([f.mid for f in streams[1]]))
        snap = gw.metrics.snapshot()
        assert snap["timings"]["conversion_seconds"]["count"] == 8
    asyncio.run(main())


def test_stalled_client_does_not_delay_others():
    """One consumer never reads its queue; every other client's per-frame
    delivery latency stays bounded (the stalled client's frames drop
    instead of stalling the step loop)."""
    async def run_once(stall: bool):
        gw = _gateway(8, num_steps=8192, chunk_size=8, queue_maxsize=4)
        await gw.start(chunks=30)
        live = [gw.open_session("baseline") for _ in range(4)]
        stalled = gw.open_session("flash-crash") if stall else None
        lat = []

        async def consume(cs):
            for _ in range(20):
                t0 = time.perf_counter()
                f = await asyncio.wait_for(cs.next_frame(), timeout=30)
                lat.append(time.perf_counter() - t0)
                if f is None:
                    break

        await asyncio.gather(*(consume(c) for c in live))
        sub = None if stalled is None else stalled.subscription
        await gw.stop()
        lat.sort()
        return lat[int(0.99 * (len(lat) - 1))], sub

    async def main():
        p99_clean, _ = await run_once(False)
        p99_stall, sub = await run_once(True)
        assert p99_stall <= max(10 * p99_clean, 0.5), \
            f"stalled client delayed others: {p99_stall:.3f}s " \
            f"vs clean {p99_clean:.3f}s"
        assert sub.qsize() <= 4
        assert sub.dropped > 0, "expected drop-oldest evictions"
    asyncio.run(main())


def test_gateway_detach_reuses_slot_and_metrics_series():
    async def main():
        gw = _gateway(4, "torch-scan", chunk_size=8, queue_maxsize=32)
        await gw.start(chunks=6)
        a = gw.open_session("baseline", client="alice")
        b = gw.open_session("flash-crash", client="bob")
        await asyncio.gather(a.frames(2), b.frames(1))
        b.close()
        await b.frames(10)   # drain leftovers until the closed event
        c = gw.open_session("thin-book", client="carol")
        assert c.slot == b.slot           # freed slot reused
        await c.frames(1)
        await gw.stop()
        snap = gw.metrics.snapshot()
        assert snap["counters"]["frames_published_total"] > 0
        assert snap["counters"]["sessions_opened_total"] == 3
        assert snap["counters"]["swaps_total"] >= 2
        assert snap["timings"]["swap_seconds"]["count"] >= 2
        assert "chunk_latency_seconds" in snap["windows"]
        assert snap["windows"]["chunk_latency_seconds"]["count"] >= 5
        kinds = [e.kind for e in b.events]
        assert kinds and kinds[-1] == "closed"
    asyncio.run(main())


def test_gateway_requires_running_and_warm_start():
    async def main():
        gw = _gateway(2, chunk_size=8)
        with pytest.raises(RuntimeError, match="start"):
            gw.open_session("baseline")
        await gw.start()
        with pytest.raises(RuntimeError, match="already started"):
            await gw.start()
        with pytest.raises(RuntimeError, match="ckpt_dir"):
            gw.inject_fault(object())
        assert gw.engine.readiness().ready
        assert gw.traces_delta == 0
        await gw.stop()
    asyncio.run(main())


# ---------------------------------------------------------------------------
# durability + supervision
# ---------------------------------------------------------------------------

def test_splice_journal_roundtrip_compaction_and_torn_tail(tmp_path):
    """The WAL round-trips specs bitwise (in the JAX package's wire format:
    ``repro`` reads it back), tolerates only a torn trailing line, raises
    typed corruption for anything else, and compaction drops exactly the
    entries no restore can need."""
    from repro_torch.serve.journal import JournalCorruptError

    j = SpliceJournal(tmp_path)
    e0 = SpliceEntry(t=0, slots=(0, 1), labels=("baseline", "high-vol"),
                     spec=_spec(2))
    e1 = SpliceEntry(t=16, slots=(2,), labels=(None,),
                     spec=_spec(1, scenario="thin-book"))
    j.append(e0)
    j.append(e1)
    j.close()
    back = SpliceJournal(tmp_path).entries()
    assert [(e.t, e.slots, e.labels) for e in back] == \
        [(0, (0, 1), ("baseline", "high-vol")), (16, (2,), (None,))]
    theirs = JJournal(tmp_path).entries()
    for got, jgot, want in zip(back, theirs, (e0, e1)):
        assert got.spec.static_key() == want.spec.static_key()
        for f, a, b, c in zip(got.spec.params._fields, got.spec.params,
                              jgot.spec.params, want.spec.params):
            assert np.array_equal(np.asarray(a), np.asarray(c)), f
            assert np.array_equal(np.asarray(b), np.asarray(c)), f
    path = tmp_path / "splices.journal"
    intact = path.read_bytes()
    path.write_bytes(intact + b'{"t": 24, "slots"')
    assert [e.t for e in SpliceJournal(tmp_path).entries()] == [0, 16]
    lines = intact.split(b"\n")
    path.write_bytes(b"\n".join([lines[0][: len(lines[0]) // 2]]
                                + lines[1:]))
    with pytest.raises(JournalCorruptError, match="line 1"):
        SpliceJournal(tmp_path).entries()
    path.write_bytes(intact)
    j2 = SpliceJournal(tmp_path)
    assert j2.compact(oldest_retained_step=8) == 1
    assert [e.t for e in j2.entries()] == [16]
    assert j2.compact(oldest_retained_step=8) == 0     # idempotent
    j2.append(e0)                      # appends reopen the new inode
    assert [e.t for e in j2.entries()] == [16, 0]
    j2.close()


def test_admission_paused_while_recovering(tmp_path):
    async def main():
        gw = _gateway(2, chunk_size=8, ckpt_dir=tmp_path, checkpoint_every=2)
        await gw.start()
        gw._state = "recovering"       # as _recover_supervised sets mid-pass
        with pytest.raises(GatewayRecovering, match="retry"):
            gw.open_session("baseline")
        with pytest.raises(GatewayRecovering):
            gw.resume_session(0)
        assert gw.health()["ready"] is False
        gw._state = "serving"
        cs = gw.open_session("baseline")    # admission resumes
        assert await cs.frames(1)
        await gw.stop()
    asyncio.run(main())


def test_exhausted_recovery_degrades_to_read_only(tmp_path):
    """When every recovery attempt fails the gateway degrades instead of
    crashing: a ``degraded`` broadcast and a typed close, GatewayDegraded
    on admission, 503-shape health — and stop() still shuts down."""
    from repro_torch.ops import DeviceLoss

    async def main():
        gw = _gateway(2, chunk_size=8, ckpt_dir=tmp_path, checkpoint_every=2,
                      max_recovery_attempts=2,
                      recovery_backoff=(0.001, 0.002))
        await gw.start()
        a = gw.open_session("baseline", client="a")
        assert await a.frames(2)

        def recovery_impossible(fault, target):
            raise RuntimeError("injected: recovery impossible")

        gw._recover = recovery_impossible
        gw.inject_fault(DeviceLoss(at_step=0))
        for _ in range(500):
            if gw.state == "degraded":
                break
            await asyncio.sleep(0.01)
        assert gw.state == "degraded"
        with pytest.raises(GatewayDegraded, match="degraded"):
            gw.open_session("baseline")
        with pytest.raises(GatewayDegraded):
            gw.resume_session(0)
        h = gw.health()
        assert h["ready"] is False and h["state"] == "degraded"
        assert "recovery impossible" in h["degraded_reason"]
        assert gw.metrics.counter("recovery_attempts_total") == 2
        assert gw.metrics.counter("recoveries_total") == 0
        assert gw.metrics.gauge_value("degraded") == 1
        while await a.next_frame() is not None:     # drain pre-fault frames
            pass
        kinds = [e.kind for e in a.events]
        assert "degraded" in kinds and kinds[-1] == "closed"
        closed = [e for e in a.events if e.kind == "closed"][-1]
        assert closed.payload["reason"] == "degraded"
        await gw.stop()
        assert gw.state == "degraded"
    asyncio.run(main())


def test_resume_session_reattaches_without_splice(tmp_path):
    async def main():
        gw = _gateway(2, chunk_size=8, ckpt_dir=tmp_path, checkpoint_every=2)
        await gw.start()
        with pytest.raises(KeyError, match="not attached"):
            gw.resume_session(0)
        a = gw.open_session("baseline", client="a")
        assert await a.frames(2)
        journal_before = gw.health()["journal_entries"]
        b = gw.resume_session(a.slot, client="b")
        fb = await b.frames(2)
        assert fb and all(f.slot == a.slot for f in fb)
        att = [e for e in b.events if e.kind == "attached"]
        assert att and att[0].payload["resumed"] is True
        assert gw.health()["journal_entries"] == journal_before  # no splice
        await gw.stop()
    asyncio.run(main())


def test_stop_flushes_async_checkpoint_writer(tmp_path):
    """Shutdown under load drains the async writer: the ladder on disk is
    fully committed and loadable by a fresh manager."""
    from repro_torch.checkpoint import COMMIT_NAME, CheckpointManager

    async def main():
        gw = _gateway(3, chunk_size=8, ckpt_dir=tmp_path, checkpoint_every=1)
        await gw.start()
        for i, s in enumerate(("baseline", "high-vol")):
            gw.open_session(s, client=f"c{i}")
        assert await gw._sessions["c0"].frames(4)
        await gw.stop()                # clients still attached + streaming
        h = gw.health()
        assert h["checkpoint"]["pending"] == 0
        assert h["checkpoint"]["writes"] >= 1
        mgr = CheckpointManager(tmp_path, async_write=False)
        steps = mgr.steps()
        assert steps and mgr.latest_step() == steps[-1]
        assert (mgr.dir / f"step_{steps[-1]:08d}" / COMMIT_NAME).exists()
        assert not list(mgr.dir.glob("*.tmp"))
        assert mgr.restore(steps[-1]) is not None
        assert gw.metrics.window("checkpoint_snapshot_seconds").count >= 1
    asyncio.run(main())


def test_stats_only_frames_carry_the_sessions_stats():
    """A ``stats_only`` gateway sends each slot's running stats through the
    same pipelined copy; they equal a bare session's stats at each chunk."""
    async def main():
        gw = Gateway(_tpl(3, num_steps=4096), chunk_size=8, queue_maxsize=16,
                     engine_opts={"device": "cpu", "stats_only": True})
        await gw.start(chunks=4)
        cs = gw.open_session("flash-crash", client="a")
        frames = await cs.frames(4)
        await gw.stop()
        return cs.slot, frames

    slot, frames = asyncio.run(main())
    tpl = _tpl(3, num_steps=4096)
    spec = tpl.replace_markets([slot], EnsembleSpec.coerce(scenario_config(
        "flash-crash", num_markets=1, **{**KW, "num_steps": 4096})))
    sess = Engine("cuda-kinetic", stats_only=True, **CPU).open(
        spec, chunk_size=8)
    for f in frames:
        assert f.num_steps == 8 and f.mid.size == 0
        sess.run(8)
        want = sess.stats
        for field, leaf in zip(want._fields, want):
            assert f.stats[field] == float(leaf[slot, 0]), field


# ---------------------------------------------------------------------------
# transports
# ---------------------------------------------------------------------------

def test_health_endpoint_over_http():
    from repro_torch.serve.transport import HealthServer

    async def main():
        gw = _gateway(2, "torch-scan", chunk_size=8)
        server = HealthServer(gw)
        port = await server.start()

        def get(path):
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}{path}", timeout=5) as r:
                    return r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read())

        loop = asyncio.get_running_loop()
        status, body = await loop.run_in_executor(None, get, "/healthz")
        assert status == 503 and body["ready"] is False   # not started yet
        await gw.start()
        status, body = await loop.run_in_executor(None, get, "/healthz")
        assert status == 200 and body["ready"] is True
        assert body["traces_delta"] == 0 and body["slots"] == 2
        status, _ = await loop.run_in_executor(None, get, "/nope")
        assert status == 404
        await server.stop()
        await gw.stop()
    asyncio.run(main())


def test_websocket_transport_gated_on_optional_dep():
    from repro_torch.serve import transport

    gw = _gateway(2)
    if transport._websockets is None:
        with pytest.raises(RuntimeError, match="websockets"):
            transport.WebSocketServer(gw)
    else:   # pragma: no cover - env-dependent
        assert transport.WebSocketServer(gw) is not None

