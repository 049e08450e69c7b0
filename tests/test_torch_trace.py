"""The port's spans (:mod:`repro_torch.ops.trace`) and the engine's
counters, on the CPU.

A span records only while a ``torch.profiler`` profile runs: it is then a
``record_function`` range named ``repro_torch.<name>`` in the profiler's
trace and a record in the span buffer, with its parent and request id.
With the profiler off nothing is recorded, and on or off the outputs and
the build count are the same bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import graphs
from repro_torch.core.config import MarketConfig
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine
from repro_torch.env import (InventoryPenalty, MarketFeatures, SpreadCapture,
                             Sum)
from repro_torch.kernels import autotune
from repro_torch.launch import roofline
from repro_torch.ops import trace
from repro_torch.ops.metrics import MetricsRegistry
from repro_torch.train import PPOConfig, PPOTrainer

BACKENDS = ["cuda-kinetic", "torch-scan"]
CFG = MarketConfig(num_markets=4, num_agents=16, num_levels=16, num_steps=12,
                   seed=3)
SESSION_SPANS = {"open", "open.runner", "open.runner.build", "open.state",
                 "open.params", "open.stats", "dispatch", "to_host",
                 "to_host.wait", "to_host.copy", "close"}
#: Each span and the span it runs inside (None: the outermost).
PARENTS = {"open": None, "open.runner": "open",
           "open.runner.build": "open.runner", "open.state": "open",
           "open.params": "open", "open.stats": "open", "dispatch": None,
           "to_host": None, "to_host.wait": "to_host",
           "to_host.copy": "to_host", "close": None,
           "dispatch.peer": "dispatch"}
#: The spans of a kernel runner's session besides: its chunk-entry peer
#: gathers.
KERNEL_SPANS = {"dispatch.peer"}
#: The spans a kernel runner on one device does not open: its open fill
#: writes the books and the stats under ``open.params``.
FILLED_SPANS = {"open.state", "open.stats"}


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def profiled(fn):
    """``fn()`` under a CPU profile: ``(its value, the profile)``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def session_run(eng, cfg=CFG, steps=12):
    sess = eng.open(cfg)
    batch = sess.run(steps)
    host = batch.to_numpy()
    sess.close()
    return sess, batch, host


@pytest.mark.parametrize("backend", BACKENDS)
def test_a_profiled_session_emits_its_ranges_nested(backend):
    eng = Engine(backend, device="cpu", chunk_size=4)
    (sess, batch, host), prof = profiled(lambda: session_run(eng))
    records = trace.spans()
    want = (SESSION_SPANS - FILLED_SPANS) | KERNEL_SPANS \
        if backend == "cuda-kinetic" else SESSION_SPANS
    assert {r.name for r in records} == want
    for r in records:
        assert r.parent == PARENTS[r.name], r
        assert r.rid == sess.session_id, r
        assert r.start_ns <= r.end_ns
    # three chunks of four steps, each of M·A·4 agent-steps, and the
    # kernel runner's tile's C
    dispatches = [r for r in records if r.name == "dispatch"]
    kernel = backend == "cuda-kinetic"
    tile = sess._runner.tile if kernel else None
    assert [r.attrs for r in dispatches] == [
        dict(kind="chunk", steps=4, chunk=4,
             agents="registers" if kernel else None,
             ctas_per_market=tile.ctas_per_market if kernel else None,
             agent_steps=CFG.num_markets * CFG.num_agents * 4)] * 3
    (lookup,) = [r for r in records if r.name == "open.runner"]
    assert lookup.attrs == {"hit": False}
    # a child lies inside its parent
    by_name = {r.name: r for r in records
               if r.name not in ("dispatch", "dispatch.peer")}
    for r in by_name.values():
        if r.parent is not None:
            p = by_name[r.parent]
            assert p.start_ns <= r.start_ns <= r.end_ns <= p.end_ns
    # the profiler's own trace holds the same ranges, nested the same way
    events = [e for e in prof.events() if e.name.startswith(trace.PREFIX)]
    assert {e.name[len(trace.PREFIX):] for e in events} == want
    for e in events:
        want = PARENTS[e.name[len(trace.PREFIX):]]
        parent = e.cpu_parent
        got = None if parent is None or not parent.name.startswith(
            trace.PREFIX) else parent.name[len(trace.PREFIX):]
        assert got == want, e.name


@pytest.mark.parametrize("backend", BACKENDS)
def test_the_copy_counts_the_host_bytes(backend):
    eng = Engine(backend, device="cpu")
    (_, _, host), _ = profiled(lambda: session_run(eng))
    (copy,) = [r for r in trace.spans() if r.name == "to_host.copy"]
    assert copy.attrs["bytes"] == sum(x.nbytes for x in host) \
        == 3 * CFG.num_markets * CFG.num_steps * 4


def test_the_stats_copy_counts_its_bytes_and_session():
    eng = Engine("cuda-kinetic", device="cpu", stats_only=True)
    sess = eng.open(CFG)
    sess.run(12)
    stats, _ = profiled(lambda: sess.stats)
    records = trace.spans()
    assert [r.name for r in records] == ["to_host.wait", "to_host.copy",
                                         "to_host"]
    assert all(r.rid == sess.session_id for r in records)
    assert records[1].attrs["bytes"] == sum(x.nbytes for x in stats) \
        == 6 * CFG.num_markets * 4


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("stats_only", [False, True])
def test_a_host_session_copies_nothing_into_pinned_memory(backend,
                                                          stats_only):
    """On the CPU ``StepBatch.to_numpy`` and ``Session.stats`` keep their
    host path: the copy span counts its bytes and none of them pinned."""
    eng = Engine(backend, device="cpu", stats_only=stats_only)
    sess = eng.open(CFG)
    batch = sess.run(12)
    host, _ = profiled(lambda: sess.stats if stats_only
                       else batch.to_numpy())
    (copy,) = [r for r in trace.spans() if r.name == "to_host.copy"]
    assert copy.attrs["bytes"] == sum(x.nbytes for x in host) > 0
    assert copy.attrs["pinned_bytes"] == 0
    assert not any(torch.from_numpy(x).is_pinned() for x in host)


def test_a_build_shows_on_a_new_seed_only():
    eng = Engine("torch-scan", device="cpu")

    def opens():
        for seed in (1, 2, 2, 1):
            eng.open(dataclasses.replace(CFG, seed=seed))

    profiled(opens)
    records = trace.spans()
    hits = [r.attrs["hit"] for r in records if r.name == "open.runner"]
    assert hits == [False, False, True, True]
    builds = [r for r in records if r.name == "open.runner.build"]
    assert [r.rid for r in builds] == [r.rid for r in records
                                       if r.name == "open"][:2]
    assert eng.metrics.counter("runners_built_total") == 2
    assert eng.metrics.gauge_value("runners_cached") == 2


@pytest.mark.parametrize("backend", BACKENDS)
def test_nothing_is_recorded_with_the_profiler_off(backend):
    eng = Engine(backend, device="cpu")
    session_run(eng)
    assert trace.spans() == []
    assert not trace.enabled()
    # the shared no-op, whatever the name or attributes
    assert trace.span("a") is trace.span("b", rid=3, x=1)
    with trace.span("a") as sp:
        sp.set(x=1)
    assert not sp.on and trace.spans() == []


@pytest.mark.parametrize("backend", BACKENDS)
def test_outputs_and_builds_are_the_same_on_and_off(backend):
    off = Engine(backend, device="cpu", chunk_size=5)
    _, _, want = session_run(off)
    on = Engine(backend, device="cpu", chunk_size=5)
    (_, _, got), _ = profiled(lambda: session_run(on))
    assert trace.spans()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert on.trace_count == off.trace_count
    # and once more on each, from the cache
    _, _, want2 = session_run(off)
    (_, _, got2), _ = profiled(lambda: session_run(on))
    assert on.trace_count == off.trace_count
    for a, b in zip(got2, want2):
        np.testing.assert_array_equal(a, b)


def test_the_registry_timings_come_from_the_spans():
    eng = Engine("torch-scan", device="cpu")

    def calls():
        with eng.open(CFG) as sess:
            sess.run(8)
            sess.step()
            sess.restore(sess.snapshot())
            sess.swap_markets([0], EnsembleSpec.homogeneous(
                MarketConfig(num_markets=1, num_agents=16, num_levels=16,
                             num_steps=12, seed=3)))
            return sess.metrics.snapshot()["timings"]

    timings, _ = profiled(calls)
    spans = {r.name: r for r in trace.spans()}
    for name, series in (("snapshot", "snapshot_seconds"),
                         ("restore", "restore_seconds"),
                         ("swap", "swap_seconds")):
        assert timings[series]["count"] == 1
        assert timings[series]["total"] == pytest.approx(
            spans[name].seconds)
    assert timings["chunk_seconds"]["count"] == 1
    assert timings["step_seconds"]["count"] == 1
    assert [r.attrs["kind"] for r in trace.spans()
            if r.name == "dispatch"] == ["chunk", "step"]


def test_a_failed_restore_times_nothing():
    eng = Engine("torch-scan", device="cpu")
    sess = eng.open(CFG)
    snap = sess.snapshot()
    snap["seed"] = 99
    with pytest.raises(ValueError):
        sess.restore(snap)
    assert "restore_seconds" not in sess.metrics.snapshot()["timings"]
    assert sess.metrics.counter("restores_total") == 0


def test_an_off_span_with_a_registry_times_alone():
    m = MetricsRegistry()
    with trace.span("x", metrics=m, timing="x_seconds") as sp:
        pass
    assert not sp.on and trace.spans() == []
    assert m.snapshot()["timings"]["x_seconds"]["count"] == 1


def test_request_ids_nest_and_default_to_the_parent():
    def nested():
        with trace.span("outer", rid=7):
            with trace.span("inner") as sp:
                sp.set(k=1)
                with trace.span("own", rid=8):
                    pass
        with trace.span("alone"):
            pass

    profiled(nested)
    got = [(r.name, r.parent, r.rid, r.attrs) for r in trace.spans()]
    assert got == [("own", "inner", 8, {}), ("inner", "outer", 7, {"k": 1}),
                   ("outer", None, 7, {}), ("alone", None, None, {})]


def test_the_buffer_is_bounded():
    def many():
        for _ in range(trace.CAPACITY + 10):
            with trace.span("x"):
                pass

    profiled(many)
    assert len(trace.spans()) == trace.CAPACITY


def test_the_tile_sweep_is_a_span_and_counted():
    autotune.clear_tune_cache()
    try:
        eng = Engine("cuda-kinetic", device="cpu", autotune=True)
        sess, _ = profiled(lambda: eng.open(CFG))
        (sweep,) = [r for r in trace.spans()
                    if r.name == "open.runner.autotune"]
        report = autotune.last_sweep_report()
        assert sweep.parent == "open.runner.build"
        assert sweep.rid == sess.session_id
        assert sweep.attrs == {"candidates": len(report.tried),
                               "pick": repr(report.winner),
                               "seconds": report.seconds}
        assert 0 < report.seconds <= sweep.seconds
        m = eng.metrics
        assert m.counter("autotune_sweeps_total") == 1
        assert m.snapshot()["timings"]["autotune_seconds"]["total"] \
            == report.seconds
        # a cached tile sweeps nothing more
        Engine("cuda-kinetic", device="cpu", autotune=True).open(CFG)
        assert len(autotune.sweep_reports()) == 1
    finally:
        autotune.clear_tune_cache()


def test_engine_counters_off_with_metrics_off():
    eng = Engine("torch-scan", device="cpu", metrics=False)
    assert eng.metrics is None
    assert eng.open(CFG).metrics is None
    assert eng.open(CFG, metrics=True).metrics is not None
    assert isinstance(Engine("torch-scan", device="cpu").metrics,
                      MetricsRegistry)


SMOKE = PPOConfig(rollout_len=4, num_updates=2, num_envs=1, num_epochs=1,
                  num_minibatches=2, hidden=(8,), seed=0)


class _CpuGraph:
    """A CPU stand-in for a captured graph: the body run again on static
    copies of the inputs."""

    def __init__(self, body, tree):
        leaves, self.structure = graphs.flatten(tree)
        self.static = [x.clone() for x in leaves]
        self.body = body

    def __call__(self, tree):
        for dst, src in zip(self.static, graphs.flatten(tree)[0]):
            dst.copy_(src)
        out, structure = graphs.flatten(
            self.body(graphs.unflatten(self.structure, self.static)))
        return graphs.unflatten(structure, [x.clone() for x in out])


def trainer(monkeypatch):
    def capture(what, body, tree, device):
        return body(tree), _CpuGraph(body, tree)

    monkeypatch.setattr(graphs, "capture", capture)
    eng = Engine("torch-scan", device="cpu")
    spec = EnsembleSpec.from_scenarios(["flash-crash", "high-vol"],
                                       num_markets=2, num_agents=16,
                                       num_levels=16, num_steps=4, seed=3)
    tr = PPOTrainer(eng.env(spec, obs=MarketFeatures(), reward=Sum((
        SpreadCapture(), InventoryPenalty(0.001)))), SMOKE)
    tr.env._graphed = True
    return eng, tr


def test_the_trainer_spans_and_graph_counters(monkeypatch):
    eng, tr = trainer(monkeypatch)
    ts = tr.init()
    ts, _ = tr.train(ts, 1)                         # captures, unprofiled
    assert trace.spans() == []
    assert eng.metrics.counter("graph_captures_total") == 1
    (ts, metrics), _ = profiled(lambda: tr.train(ts, 2))
    assert eng.metrics.counter("graph_captures_total") == 1
    assert eng.metrics.counter("graph_replays_total") == 2
    # (the stand-in reruns the body, whose env spans a replay on the card
    # does not run)
    mine = ("train", "update", "graph.replay", "train.stack")
    got = [(r.name, r.parent, r.rid) for r in trace.spans()
           if r.name in mine]
    assert got == [("graph.replay", "update", 1), ("update", "train", 1),
                   ("graph.replay", "update", 2), ("update", "train", 2),
                   ("train.stack", "train", 1), ("train", None, 1)]
    assert trace.spans()[-1].attrs == {"updates": 2}
    assert metrics["loss"].shape == (2,)


def test_the_env_step_spans(monkeypatch):
    _, tr = trainer(monkeypatch)
    env = tr.env
    state, _ = env.reset()
    orders = (torch.ones(4, dtype=torch.bool), torch.full((4,), 8),
              torch.ones(4))
    profiled(lambda: env.step(state, orders))
    got = [(r.name, r.parent) for r in trace.spans()]
    assert got == [("env.actions", "env.step"), ("env.clear", "env.step"),
                   ("env.transition", "env.step"), ("env.obs", "env.step"),
                   ("env.step", None)]


def test_the_replay_spans(monkeypatch):
    """A graph's replay: its input copies, the launch and the output
    clones, each a span (the card's graph replaced by a counter)."""
    class Replays:
        n = 0

        def replay(self):
            Replays.n += 1

    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    x = torch.arange(4.0)
    static_out, structure = graphs.flatten((x * 2,))
    g = graphs.Graph("t", torch.device("cpu"), Replays(), [x.clone()],
                     structure, static_out, [], roofline.Roofline(), [])
    (out,), _ = profiled(lambda: g((x + 1,)))
    assert Replays.n == 1 and torch.equal(out, x * 2)
    assert [(r.name, r.parent) for r in trace.spans()] == [
        ("graph.copy_in", None), ("graph.launch", None),
        ("graph.copy_out", None)]


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None
