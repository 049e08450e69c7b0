"""The coupling's span and counters, on the CPU.

A kernel runner's chunk-entry peer gather is the span ``dispatch.peer``
(``rows``; ``coupled``: the rows with a real peer, from the params' host
copy), one a chunk, one a shard and chunk on a mesh; ``open.params`` names
the spec's scenarios. The engine counts the gathers
(``peer_resolves_total``) and the coupled markets of the spec last opened
(``coupled_markets``) with the profiler on or off. The benchmark's reader
``peer_ms_per_ensemble.stress_mix`` sums the span's durations an ensemble.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.params import EnsembleSpec, coupled_count
from repro_torch.core.session import Engine
from repro_torch.launch import set_host_device_count
from repro_torch.ops import trace
from repro_torch.ops.trace import Record
from repro_torch.scenario import CouplingSpec

PRESETS = ["baseline", "flash-crash", "whale"]
PER_BLOCK, A, L, S, CHUNK = 4, 16, 16, 20, 8
READER = (Path(__file__).resolve().parents[1] / "kbench" / "layers"
          / "peer_ms_per_ensemble.stress_mix.py")


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def spec(coupling=None, seed=3):
    s = EnsembleSpec.from_scenarios(PRESETS, num_markets=PER_BLOCK,
                                    num_agents=A, num_levels=L, num_steps=S,
                                    seed=seed, alpha_arbitrageur=0.25)
    return s if coupling is None else coupling.apply(s)


def run(eng, sp):
    with eng.open(sp) as sess:
        sess.run(S)
        return sess.stats


def profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def reader():
    module_spec = importlib.util.spec_from_file_location(
        "kbench_layers_peer_ms", READER)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


def test_coupled_count():
    assert coupled_count(np.array([[1], [0], [-1], [3]])) == 2
    # rows 4..7 of a larger column: a peer equal to the row's own index
    # is no peer
    assert coupled_count(np.array([5, 5, -1, 0]), first=4) == 2
    ring = CouplingSpec.ring(12, 5)
    assert coupled_count(ring.peer) == len(ring.coupled_markets) == 12


@pytest.mark.parametrize("coupling", ["ring", "pairs", "none"])
def test_one_peer_span_a_chunk(coupling):
    M = PER_BLOCK * len(PRESETS)
    cs = {"ring": CouplingSpec.ring(M),
          "pairs": CouplingSpec.pairs(M, [(0, 5), (7, 11)]),
          "none": CouplingSpec.none(M)}[coupling]
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 stats_only=True)
    profiled(lambda: run(eng, spec(cs)))
    peers = [r for r in trace.spans() if r.name == "dispatch.peer"]
    assert len(peers) == -(-S // CHUNK)
    assert all(r.parent == "dispatch" for r in peers)
    assert [r.attrs for r in peers] == [
        {"rows": M, "coupled": len(cs.coupled_markets)}] * len(peers)
    (params,) = [r for r in trace.spans() if r.name == "open.params"]
    assert params.attrs == {"scenarios": tuple(n + "*" for n in PRESETS),
                            "rows": M, "markets": M}
    assert eng.metrics.counter("peer_resolves_total") == len(peers)
    assert eng.metrics.gauge_value("coupled_markets") == \
        len(cs.coupled_markets)


def test_off_no_records_and_the_counters_count():
    M = PER_BLOCK * len(PRESETS)
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 stats_only=True)
    off = run(eng, spec(CouplingSpec.ring(M)))
    assert trace.spans() == []
    assert eng.metrics.counter("peer_resolves_total") == -(-S // CHUNK)
    assert eng.metrics.gauge_value("coupled_markets") == M
    run(eng, spec())
    assert eng.metrics.counter("peer_resolves_total") == 2 * -(-S // CHUNK)
    assert eng.metrics.gauge_value("coupled_markets") == 0
    # the span changes nothing the session computes
    on = profiled(lambda: run(eng, spec(CouplingSpec.ring(M))))
    assert all(np.array_equal(a, b) for a, b in zip(off, on))


def test_a_step_runner_counts_its_gather():
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK)
    with eng.open(spec()) as sess:
        sess.step()
        sess.run(CHUNK)
    assert eng.metrics.counter("peer_resolves_total") == 2


def test_an_eager_backend_resolves_no_kernel_peer():
    eng = Engine("torch-scan", device="cpu", chunk_size=CHUNK)
    profiled(lambda: run(eng, spec(CouplingSpec.ring(12))))
    assert not [r for r in trace.spans() if r.name == "dispatch.peer"]
    assert eng.metrics.counter("peer_resolves_total") == 0
    assert eng.metrics.gauge_value("coupled_markets") == 12


@pytest.fixture
def two_host_devices():
    prev = set_host_device_count(2)
    yield
    set_host_device_count(prev)


def test_one_peer_span_a_shard_and_chunk(two_host_devices):
    M = PER_BLOCK * len(PRESETS)
    cs = CouplingSpec.pairs(M, [(0, 1), (2, 9), (10, 11)])
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 stats_only=True, devices=2)
    sharded = profiled(lambda: run(eng, spec(cs)))
    peers = [r for r in trace.spans() if r.name == "dispatch.peer"]
    chunks = -(-S // CHUNK)
    assert len(peers) == 2 * chunks
    # rows 0..5 hold 0-1 and 2 (peer 9); rows 6..11 hold 9 and 10-11
    assert [(r.attrs["rows"], r.attrs["coupled"]) for r in peers] == \
        [(6, 3), (6, 3)] * chunks
    assert eng.metrics.counter("peer_resolves_total") == 2 * chunks
    one = run(Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                     stats_only=True), spec(cs))
    assert all(np.array_equal(a, b) for a, b in zip(sharded, one))


def rec(name, start_us, end_us, parent=None, **attrs):
    return Record(name, parent, 1, int(start_us * 1e3), int(end_us * 1e3),
                  attrs)


def test_the_reader_sums_the_gathers_an_ensemble():
    value = reader().value
    spans = [rec("open", 0, 1000), rec("dispatch.peer", 1100, 1130,
                                       "dispatch", rows=8, coupled=8),
             rec("dispatch.peer", 1200, 1250, "dispatch", rows=8, coupled=8),
             rec("open", 2000, 2500),
             rec("dispatch.peer", 2600, 2620, "dispatch", rows=8, coupled=8)]
    assert value(spans) == pytest.approx((30 + 50 + 20) * 1e-3 / 2)


def test_the_reader_gives_nothing_without_its_spans():
    module = reader()
    assert module.value([]) is None
    assert module.value([rec("open", 0, 10)]) is None
    assert module.value([rec("dispatch.peer", 0, 10)]) is None
    assert module.read(None, None) is None
    # a traced slice of a program that records no such span
    profiled(lambda: run(Engine("torch-scan", device="cpu"), spec()))
    assert module.read(object(), None) is None


def test_the_reader_on_a_profiled_session():
    M = PER_BLOCK * len(PRESETS)
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 stats_only=True)
    profiled(lambda: [run(eng, spec(CouplingSpec.ring(M), seed=s))
                      for s in (1, 2)])
    peers = [r for r in trace.spans() if r.name == "dispatch.peer"]
    want = sum(r.end_ns - r.start_ns for r in peers) * 1e-6 / 2
    assert reader().read(object(), None) == pytest.approx(want)
    assert want > 0
