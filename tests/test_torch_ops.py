"""The port's ops subsystem on the CPU: metrics, warm start, the single-card
chaos harness and the serving gateway's recovery.

Analogues of ``tests/test_ops.py`` (metrics cost no build and change no
bit; ``warm`` builds and launches the whole runner set) and of the
single-device cases of ``tests/test_chaos.py``: device loss, checkpoint
corruption, several faults in one plan, torn writes, plan validation,
device loss under client load, a fault storm, journal compaction and a
kill -9 restart, each recovering bit for bit. The serving schedule is also
driven through both packages and every frame compared with ``==``. These
run in tier-1; only the every-offset torn-write sweep carries ``chaos``.
"""
import dataclasses
import os
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro.ops import DeviceLoss as JDeviceLoss
from repro.ops import run_serve_plan as j_run_serve_plan
from repro_torch.checkpoint.manager import CheckpointManager, session_tree
from repro_torch.core.config import MarketConfig, scenario_config
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import DEFAULT_CHUNK, Engine
from repro_torch.kernels import _build, ops
from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.ops import (CheckpointCorruption, DeviceLoss, FaultPlan,
                             TornCheckpointWrite, count_write_ops, run_plan,
                             run_serve_plan)
from repro_torch.ops.metrics import MetricsRegistry

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CPU = {"device": "cpu"}
BACKENDS = ["cuda-kinetic", "torch-scan"]

CFG = MarketConfig(num_markets=4, num_agents=16, num_levels=16, num_steps=12,
                   seed=3)


def _batches_equal(a, b):
    a, b = a.to_numpy(), b.to_numpy()
    return all((np.asarray(x) == np.asarray(y)).all() for x, y in zip(a, b))


# ---------------------------------------------------------------------------
# metrics: nothing built, same bits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_metrics_zero_traces_and_bitwise(backend):
    eng = Engine(backend, **CPU)
    off = eng.open(CFG, metrics=False)
    batch_off = off.run(12)
    traces_before = eng.trace_count

    on = eng.open(CFG)  # metrics on by default
    assert isinstance(on.metrics, MetricsRegistry)
    batch_on = on.run(12)
    assert eng.trace_count - traces_before == 0, "metrics built a runner"
    assert _batches_equal(batch_off, batch_on)
    snap = on.metrics.snapshot()
    assert snap["counters"]["steps_total"] == 12
    assert snap["counters"]["chunks_total"] == 1
    assert snap["counters"].get("traces", 0) == 0
    assert snap["timings"]["chunk_seconds"]["count"] == 1
    assert on.metrics.steps_per_s() > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_metrics_recorded_series(backend):
    eng = Engine(backend, **CPU)
    with eng.open(CFG) as sess:
        sess.run(8)
        sess.step()
        snap_dict = sess.snapshot()
        sess.restore(snap_dict)
        m = sess.metrics.snapshot()
    assert m["counters"]["steps_total"] == 9
    assert m["counters"]["snapshots_total"] == 1
    assert m["counters"]["restores_total"] == 1
    assert m["gauges"]["num_markets"] == CFG.num_markets
    assert m["gauges"]["chunk"] == CFG.num_steps
    for series in ("chunk_seconds", "step_seconds", "snapshot_seconds",
                   "restore_seconds"):
        assert m["timings"][series]["count"] >= 1, series


def test_metrics_disabled_engine_wide_and_per_open():
    eng = Engine("torch-scan", metrics=False, **CPU)
    assert eng.open(CFG).metrics is None
    assert eng.open(CFG, metrics=True).metrics is not None
    eng2 = Engine("torch-scan", **CPU)
    assert eng2.open(CFG, metrics=False).metrics is None
    assert eng2.open(CFG).metrics is not None


def test_metrics_registry_aggregates():
    m = MetricsRegistry()
    m.inc("c")
    m.inc("c", 4)
    for v in (0.5, 1.5, 1.0):
        m.observe("t", v)
    m.gauge("g", 7)
    snap = m.snapshot()
    assert m.counter("c") == 5 and m.counter("missing") == 0
    agg = snap["timings"]["t"]
    assert agg["count"] == 3 and agg["min"] == 0.5 and agg["max"] == 1.5
    assert agg["total"] == pytest.approx(3.0)
    assert agg["mean"] == pytest.approx(1.0)
    assert snap["gauges"]["g"] == 7
    assert m.steps_per_s() == 0.0


# ---------------------------------------------------------------------------
# warm start
# ---------------------------------------------------------------------------

def test_warm_builds_whole_runner_set():
    """After warm(), the first open/run/step builds nothing more."""
    eng = Engine("cuda-kinetic", **CPU)
    ready = eng.warm(CFG)
    assert ready.ready
    traces = eng.trace_count
    assert traces >= 2  # the chunk runner + the single-step runner
    with eng.open(CFG) as sess:
        sess.run(12)
        sess.run(5)
        sess.step()
    assert eng.trace_count == traces, "first request built a runner"


def test_warm_eager_is_a_ready_noop():
    eng = Engine("torch-scan", **CPU)
    ready = eng.warm(CFG)
    assert ready.ready
    for entry in ready.entries:
        assert entry.warm and entry.traces == 1
        assert not eng._runners[entry.static_key + (entry.chunk,)].launched


def test_readiness_cold_to_warm_transition():
    eng = Engine("cuda-kinetic", **CPU)
    assert eng.readiness().ready  # vacuously: no cached runners yet
    runner = eng._runner(CFG, 12)  # build without launching
    probe = eng.readiness()
    assert not probe.ready
    assert probe.cold_keys() and not probe.warm_keys()
    eng.warm(CFG, include_step=False)
    probe = eng.readiness()
    assert probe.ready and not probe.cold_keys()
    entry = probe.entries[0]
    assert entry.chunk == 12 and entry.static_key[-1] == CFG.seed
    assert runner.trace_count == 1 and runner.launched


def test_warm_multiple_specs_and_chunk_sizes():
    eng = Engine("cuda-kinetic", **CPU)
    other = dataclasses.replace(CFG, num_steps=24, seed=4)
    ready = eng.warm([CFG, other], chunk_sizes=[6], include_step=False)
    assert ready.ready
    chunks = sorted(e.chunk for e in ready.entries)
    assert chunks == [6, 6, 12, 24]
    traces = eng.trace_count
    eng.warm([CFG, other], chunk_sizes=[6], include_step=False)  # idempotent
    assert eng.trace_count == traces


def test_warm_default_chunk_matches_open():
    big = dataclasses.replace(CFG, num_steps=10 * DEFAULT_CHUNK)
    eng = Engine("cuda-kinetic", **CPU)
    eng.warm(big, include_step=False)
    traces = eng.trace_count
    with eng.open(big) as sess:
        sess.run(DEFAULT_CHUNK)
    assert eng.trace_count == traces


def test_trace_count_adds_library_loads():
    """A kernel library compiled or loaded for a runner counts in its
    trace_count (the plain version stands in for the launch here)."""
    def loading_chunk(*args, **kw):
        _build._LOADS[0] += 1           # as _build.load on a cache miss
        return kc.kinetic_clearing_chunk_plain(*args, **kw)

    spec = EnsembleSpec.coerce(CFG)
    runner = ops.ClearingChunkRunner(loading_chunk, "cuda-kinetic",
                                     kc._load_library, spec, 4,
                                     torch.device("cpu"))
    assert runner.trace_count == 1 and not runner.launched
    state = runner.init_state(spec)
    params = runner.params_to_device(spec.params)
    runner.run(state, params, 0, 4, None)
    assert runner.trace_count == 2 and runner.launched


# ---------------------------------------------------------------------------
# the single-card chaos harness
# ---------------------------------------------------------------------------

# Flash-crash so the recovery window replays a shock (shock_step=11 sits
# between the step-6 checkpoint and the step-18 faults).
CHAOS_KW = dict(num_markets=6, num_agents=16, num_levels=32, num_steps=24,
                shock_step=11, seed=7)
CHUNK = 6


def _cfg():
    return scenario_config("flash-crash", **CHAOS_KW)


def _baseline(backend):
    with Engine(backend, chunk_size=CHUNK, **CPU).open(_cfg()) as s:
        return s.run(CHAOS_KW["num_steps"]).to_numpy()


def _assert_bitwise(report, want, ctx):
    assert report.replay_matched, f"{ctx}: replayed chunks diverged"
    for f, a, b in zip(want._fields, want, report.batch):
        assert (np.asarray(a) == np.asarray(b)).all(), \
            f"{ctx}: stream field {f} differs after recovery"


@pytest.mark.parametrize("backend", BACKENDS)
def test_device_loss_restores_from_last_snapshot(backend, tmp_path,
                                                 monkeypatch):
    """Plain restart on the same card: the loaded libraries are dropped,
    the engine rebuilt, the newest checkpoint restored — bitwise."""
    forgets = []
    real_forget = _build.forget
    monkeypatch.setattr(_build, "forget",
                        lambda: forgets.append(1) or real_forget())
    want = _baseline(backend)
    plan = FaultPlan([DeviceLoss(at_step=18)], checkpoint_every=CHUNK)
    rep = run_plan(plan, _cfg(), backend=backend, ckpt_dir=tmp_path,
                   chunk_size=CHUNK, engine_opts=CPU)
    _assert_bitwise(rep, want, f"{backend} device-loss")
    ev = rep.events[0]
    assert ev.at_step == 18 and ev.recovered_from == 18
    assert not ev.errors and forgets == [1]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind,target", [("truncate", "shard"),
                                         ("bitflip", "shard"),
                                         ("truncate", "manifest"),
                                         ("bitflip", "manifest")])
def test_checkpoint_corruption_falls_back_typed(backend, kind, target,
                                                tmp_path):
    want = _baseline(backend)
    plan = FaultPlan([CheckpointCorruption(at_step=18, kind=kind,
                                           target=target)],
                     checkpoint_every=CHUNK)
    rep = run_plan(plan, _cfg(), backend=backend, ckpt_dir=tmp_path,
                   chunk_size=CHUNK, engine_opts=CPU)
    _assert_bitwise(rep, want, f"{backend} corruption {kind}/{target}")
    ev = rep.events[0]
    assert ev.recovered_from == 12
    assert any("CheckpointCorruptError" in e or "CheckpointError" in e
               for e in ev.errors), ev.errors


def test_multiple_faults_in_one_plan(tmp_path):
    want = _baseline("cuda-kinetic")
    plan = FaultPlan([CheckpointCorruption(at_step=12, kind="bitflip"),
                      DeviceLoss(at_step=18)], checkpoint_every=CHUNK)
    rep = run_plan(plan, _cfg(), backend="cuda-kinetic", ckpt_dir=tmp_path,
                   chunk_size=CHUNK, engine_opts=CPU)
    _assert_bitwise(rep, want, "cuda-kinetic multi-fault")
    assert [e.at_step for e in rep.events] == [12, 18]
    assert rep.events[0].recovered_from == 6
    assert rep.events[1].recovered_from == 18


def _torn_write_ops():
    with Engine("torch-scan", chunk_size=CHUNK, **CPU).open(_cfg()) as s:
        s.run(12)
        tree = session_tree(s.snapshot())
    with tempfile.TemporaryDirectory() as d:
        return count_write_ops(CheckpointManager(d, async_write=False), 12,
                               tree)


def _check_torn_write(tmp_path, k, want):
    plan = FaultPlan([TornCheckpointWrite(at_step=12, crash_at_op=k)],
                     checkpoint_every=CHUNK)
    rep = run_plan(plan, _cfg(), backend="torch-scan",
                   ckpt_dir=tmp_path / f"op{k}", chunk_size=CHUNK,
                   engine_opts=CPU)
    _assert_bitwise(rep, want, f"torn write at op {k}")
    ev = rep.events[0]
    assert any("SimulatedCrash" in e for e in ev.errors), (k, ev.errors)
    assert ev.recovered_from in (6, 12), (k, ev)
    return ev.recovered_from


def test_torn_checkpoint_write_recovers(tmp_path):
    """A crash inside a checkpoint commit — before the COMMIT marker's
    rename (falls back to 6) and after it (keeps 12) — restores a
    committed checkpoint and replays bitwise."""
    want = _baseline("torch-scan")
    ops_n = _torn_write_ops()
    assert ops_n >= 15
    got = {k: _check_torn_write(tmp_path, k, want)
           for k in (0, ops_n // 2, ops_n - 1)}
    assert got[0] == 6 and got[ops_n - 1] == 12, got


@pytest.mark.chaos
def test_torn_checkpoint_write_every_offset(tmp_path):
    """The same at EVERY durable-write offset of the commit."""
    want = _baseline("torch-scan")
    for k in range(_torn_write_ops()):
        _check_torn_write(tmp_path, k, want)


def test_plan_validates_chunk_alignment(tmp_path):
    kw = dict(backend="torch-scan", ckpt_dir=tmp_path, chunk_size=6,
              engine_opts=CPU)
    with pytest.raises(ValueError, match="chunk boundary"):
        run_plan(FaultPlan([DeviceLoss(at_step=7)]), _cfg(), **kw)
    with pytest.raises(ValueError, match="checkpoint_every"):
        run_plan(FaultPlan([DeviceLoss(at_step=6)], checkpoint_every=5),
                 _cfg(), **kw)
    with pytest.raises(ValueError, match="window"):
        run_plan(FaultPlan([DeviceLoss(at_step=600)]), _cfg(), **kw)


# ---------------------------------------------------------------------------
# serving gateway: device loss under concurrent client load
# ---------------------------------------------------------------------------

SCENARIOS = ["baseline", "flash-crash", "high-vol"]


def _assert_serve_bitwise(rep, want, ctx, stats=False):
    assert set(rep.frames) == set(want.frames), ctx
    for client in want.frames:
        fs0, fs1 = want.frames[client], rep.frames[client]
        assert len(fs0) == len(fs1), \
            f"{ctx}: client {client} got {len(fs1)} frames, want {len(fs0)}"
        for f0, f1 in zip(fs0, fs1):
            assert f0.step0 == f1.step0 and f0.seq == f1.seq, \
                f"{ctx}: client {client} frame misaligned at seq {f0.seq}"
            for field in ("mid", "price", "volume"):
                assert (np.asarray(getattr(f0, field))
                        == np.asarray(getattr(f1, field))).all(), \
                    f"{ctx}: client {client} {field} diverged at {f0.step0}"
            if stats:
                assert f0.stats == f1.stats and f0.stats is not None, \
                    f"{ctx}: client {client} stats diverged at {f0.step0}"


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_device_loss_under_client_load(backend, tmp_path):
    """Kill the engine under streaming clients (one attached after the
    newest checkpoint, so recovery replays the splice journal): every
    client sees one ``reconnect`` and its stream equals a fault-free run;
    nothing is built after the re-warm."""
    kw = dict(scenarios=SCENARIOS, backend=backend, chunk_size=8,
              chunks=10, checkpoint_every=2, late_attach="thin-book",
              late_after=5, engine_opts=CPU)
    want = run_serve_plan(ckpt_dir=tmp_path / "ff", **kw)
    rep = run_serve_plan(ckpt_dir=tmp_path / "f1",
                         fault=DeviceLoss(at_step=0), fault_after=3, **kw)
    assert want.reconnects == 0 and rep.reconnects == 1
    for client, events in rep.events.items():
        assert any(e.kind == "reconnect" for e in events), client
    _assert_serve_bitwise(rep, want, f"{backend} serve device-loss")
    assert rep.traces_delta == 0


def test_serve_plan_matches_jax_package(tmp_path):
    """The same schedule (attach, a late attach after a checkpoint, a
    DeviceLoss) through ``repro`` on ``jax-scan`` and through the port on
    ``cuda-kinetic`` (plain version): every frame at each (client, step0)
    is equal."""
    kw = dict(scenarios=SCENARIOS, chunk_size=8, chunks=10,
              checkpoint_every=2, late_attach="thin-book", late_after=5,
              fault_after=3)
    want = j_run_serve_plan(ckpt_dir=tmp_path / "jax", backend="jax-scan",
                            fault=JDeviceLoss(at_step=0), **kw)
    rep = run_serve_plan(ckpt_dir=tmp_path / "port", backend="cuda-kinetic",
                         engine_opts=CPU, fault=DeviceLoss(at_step=0), **kw)
    assert want.reconnects == rep.reconnects == 1
    assert rep.traces_delta == 0 and rep.steps == want.steps
    _assert_serve_bitwise(rep, want, "port vs jax-scan")


def test_serve_plan_stats_only_matches_jax_package(tmp_path):
    """Under ``stats_only`` the frames' stats equal the JAX package's."""
    kw = dict(scenarios=SCENARIOS, chunk_size=8, chunks=6,
              checkpoint_every=2, late_attach="thin-book", late_after=3,
              fault_after=4)
    want = j_run_serve_plan(ckpt_dir=tmp_path / "jax", backend="numpy",
                            fault=JDeviceLoss(at_step=0),
                            engine_opts={"stats_only": True}, **kw)
    rep = run_serve_plan(ckpt_dir=tmp_path / "port", backend="cuda-kinetic",
                         engine_opts={"device": "cpu", "stats_only": True},
                         fault=DeviceLoss(at_step=0), **kw)
    _assert_serve_bitwise(rep, want, "port vs repro stats", stats=True)


def test_serve_fault_storm_coalesces_into_one_recovery(tmp_path):
    """16 clients, four back-to-back device losses: ONE recovery pass,
    one ``reconnect`` per client, every stream bitwise."""
    scen = (SCENARIOS * 6)[:16]
    kw = dict(scenarios=scen, backend="cuda-kinetic", chunk_size=8,
              chunks=10, checkpoint_every=2, slots=16, engine_opts=CPU)
    want = run_serve_plan(ckpt_dir=tmp_path / "ff", **kw)
    storm = [DeviceLoss(at_step=0)] * 4
    rep = run_serve_plan(ckpt_dir=tmp_path / "f1", fault=storm,
                         fault_after=3, **kw)
    assert rep.recoveries == 1, rep.recoveries
    assert rep.reconnects == 1
    for client, events in rep.events.items():
        recs = [e for e in events if e.kind == "reconnect"]
        assert len(recs) == 1, (client, [e.kind for e in events])
        assert recs[0].payload["faults_coalesced"] == 4, recs[0].payload
    _assert_serve_bitwise(rep, want, "serve fault-storm")
    assert rep.traces_delta == 0
    assert rep.health is not None and rep.health["state"] == "serving"


def test_serve_journal_compaction_never_breaks_replay(tmp_path):
    """A 2-deep ladder under checkpoint_every=1 forces GC and journal
    compaction repeatedly; a late fault still recovers bitwise."""
    from repro_torch.serve import SpliceJournal

    kw = dict(scenarios=SCENARIOS, backend="cuda-kinetic", chunk_size=8,
              chunks=12, checkpoint_every=1, ckpt_keep=2,
              late_attach="thin-book", late_after=3, fault_after=8,
              engine_opts=CPU)
    want = run_serve_plan(ckpt_dir=tmp_path / "ff", **kw)
    rep = run_serve_plan(ckpt_dir=tmp_path / "f1",
                         fault=DeviceLoss(at_step=0), **kw)
    assert rep.recoveries == 1
    _assert_serve_bitwise(rep, want, "serve compaction")
    assert rep.traces_delta == 0
    entries = SpliceJournal(tmp_path / "f1").entries()
    assert all(e.t > 0 for e in entries), [e.t for e in entries]


# ---------------------------------------------------------------------------
# full process crash (kill -9) + restart
# ---------------------------------------------------------------------------

_CRASH_PHASE1 = textwrap.dedent("""
    import asyncio, json, os, sys
    import numpy as np
    from repro_torch.serve import Gateway, parked_template

    d, out = sys.argv[1], sys.argv[2]
    tpl = parked_template(slots=3, num_agents=16, num_levels=32,
                          num_steps=4096)

    async def main():
        gw = Gateway(tpl, chunk_size=8, queue_maxsize=64, ckpt_dir=d,
                     checkpoint_every=1, engine_opts={"device": "cpu"})
        await gw.start(chunks=10)
        scen = ["baseline", "flash-crash", "high-vol"]
        clients = [gw.open_session(s, client=f"c{i}")
                   for i, s in enumerate(scen)]
        f = open(out, "a")
        written = 0

        async def pump(cs):
            nonlocal written
            while True:
                fr = await cs.next_frame()
                if fr is None:
                    return
                f.write(json.dumps({
                    "client": cs.client, "step0": fr.step0,
                    "mid": np.asarray(fr.mid).tolist(),
                    "price": np.asarray(fr.price).tolist()}) + "\\n")
                f.flush()
                os.fsync(f.fileno())
                written += 1
                if written >= 9:
                    os.kill(os.getpid(), 9)   # kill -9, mid-stream

        await asyncio.gather(*(pump(c) for c in clients))

    asyncio.run(main())
""")

_CRASH_PHASE2 = textwrap.dedent("""
    import asyncio, json, sys
    import numpy as np
    from repro_torch.serve import Gateway, parked_template

    d, out = sys.argv[1], sys.argv[2]
    tpl = parked_template(slots=3, num_agents=16, num_levels=32,
                          num_steps=4096)

    async def main():
        gw = Gateway(tpl, chunk_size=8, queue_maxsize=64, ckpt_dir=d,
                     checkpoint_every=1, engine_opts={"device": "cpu"})
        await gw.start(chunks=12)          # restart path: committed ladder
        assert gw.resumed_from is not None, "no committed ladder found"
        assert not gw.restart_errors, gw.restart_errors
        slots = sorted(gw.scheduler.attached)
        assert slots == [0, 1, 2], slots   # attachments rebuilt from disk
        clients = [gw.resume_session(s, client=f"r{s}") for s in slots]
        rest = await asyncio.gather(*(c.frames(12) for c in clients))
        with open(out, "w") as f:
            for slot, frames in zip(slots, rest):
                for fr in frames:
                    f.write(json.dumps({
                        "client": f"c{slot}", "step0": fr.step0,
                        "mid": np.asarray(fr.mid).tolist(),
                        "price": np.asarray(fr.price).tolist()}) + "\\n")
        for c in clients:
            att = [e for e in c.events if e.kind == "attached"]
            assert att and att[0].payload.get("resumed") is True, c.events
        assert gw.traces_delta == 0, gw.traces_delta
        await gw.stop()
        print("RESUMED", gw.resumed_from)

    asyncio.run(main())
""")


def test_serve_crash_restart_resumes_bitwise(tmp_path):
    """kill -9 a streaming gateway process (``cuda-kinetic`` on the CPU)
    mid-delivery, restart a fresh process over the same ckpt_dir: every
    frame either phase produced equals a crash-free reference at the same
    step."""
    import json as _json

    want = run_serve_plan(scenarios=SCENARIOS, backend="cuda-kinetic",
                          chunk_size=8, chunks=18, checkpoint_every=1,
                          ckpt_dir=tmp_path / "ref", engine_opts=CPU)
    ref = {}
    for client, frames in want.frames.items():
        for fr in frames:
            ref[(client, fr.step0)] = (np.asarray(fr.mid).tolist(),
                                       np.asarray(fr.price).tolist())
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    d = str(tmp_path / "crash")
    out1, out2 = str(tmp_path / "phase1.jsonl"), str(tmp_path / "p2.jsonl")
    p1 = subprocess.run([sys.executable, "-c", _CRASH_PHASE1, d, out1],
                        env=env, capture_output=True, text=True, timeout=300)
    assert p1.returncode == -9, (p1.returncode, p1.stderr[-3000:])
    p2 = subprocess.run([sys.executable, "-c", _CRASH_PHASE2, d, out2],
                        env=env, capture_output=True, text=True, timeout=300)
    assert p2.returncode == 0, p2.stderr[-3000:]
    resumed = int(p2.stdout.split("RESUMED")[1].split()[0])
    assert resumed % 8 == 0
    with open(out1) as f:
        phase1 = [_json.loads(ln) for ln in f]
    with open(out2) as f:
        phase2 = [_json.loads(ln) for ln in f]
    assert len(phase1) == 9
    matched = 0
    for r in phase1 + phase2:
        key = (r["client"], r["step0"])
        if key not in ref:
            continue
        m, p = ref[key]
        assert r["mid"] == m and r["price"] == p, \
            f"frame {key} diverged from the crash-free reference"
        matched += 1
    assert matched >= 18, matched
    steps2 = sorted({r["step0"] for r in phase2})
    assert steps2[0] == resumed
    assert steps2 == list(range(resumed, resumed + 8 * len(steps2), 8))
