"""One stock's ABIDES-sized crowd (``sweep.few_assets``) on the CPU.

The configuration holds RMSC03's population exactly (1 market maker, 25
momentum, 100 value agents as fundamentalists, 5,000 noise) in the program
and in the reference, inside the exactness contract; its shape takes a
market cluster by the launch rule; the cell is listed by every sweep
metric it reports and is the only cell of its new one; a Session at
the configuration's mix, past the registers mode's agents, equals the
plain reference bit for bit (the kernel wrappers run their plain versions
here), and the reference in bfloat16 does not; the shrunk cell runs
correct, and a planted fault does not; and the new reader, on hand-made
records and kernel intervals and on a profiled session's own spans."""
import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kbench import harness, trace
from kbench.manifest import Bench
from kbench.reference import market as rm
from kbench.tests import tiny
from kbench.tests.test_kbench_faults import broken_chunk
from kbench.tests.test_kbench_program_spans import rec, reader_module

from repro_torch.core.config import (FUNDAMENTALIST, MAKER, MOMENTUM, NOISE,
                                     MarketConfig, assign_agent_types)
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine
from repro_torch.kernels import autotune
from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.ops import trace as program_trace

ROOT = tiny.ROOT
CELL = "sweep.few_assets"
STEP_METRIC = "cluster_step_us.few_assets"
CONFIG = json.loads((ROOT / "kbench/configs/few_assets.json").read_text())
TABLE4 = json.loads((ROOT / "kbench/configs/table4.json").read_text())
KERNEL = "void kinetic_chunk_kernel<2, true, 4>(ChunkArgs)"
#: RMSC03's population: the market maker, momentum, value and noise agents.
CROWD = {MAKER: 1, MOMENTUM: 25, FUNDAMENTALIST: 100, NOISE: 5000}
#: Past the registers mode's 8·32 agents of one warp at L = 64, with the
#: configuration's mix rounding to one maker, 13 momentum agents and 51
#: fundamentalists.
M, A, L, S, CHUNK = 4, 2600, 64, 24, 8
#: The rule's tile there, and the cell's own mode on the same cluster.
FRESH = autotune.TileChoice(L, A, 8, 1, "fresh", 16)


@pytest.fixture(autouse=True)
def empty_buffer():
    program_trace.clear()
    yield
    program_trace.clear()


def test_the_config_is_rmsc03s_crowd_at_table4s_market():
    assert (CONFIG["num_markets"], CONFIG["num_agents"],
            CONFIG["num_levels"], CONFIG["num_steps"]) == (16, 5126, 1024,
                                                           400)
    assert CONFIG["scenario"] == "baseline"
    assert CONFIG["stats_only"] is False and CONFIG["reduced"] == []
    alphas = ("alpha_maker", "alpha_momentum", "alpha_fundamentalist")
    assert {k: v for k, v in CONFIG["market"].items() if k not in alphas} \
        == {k: v for k, v in TABLE4["market"].items() if k not in alphas}
    assert (CONFIG["market"]["fundamental_price"],
            CONFIG["market"]["fundamentalist_kappa"]) == (-1.0, 0.5)


def test_the_counts_are_exact_in_the_program_and_the_reference():
    cfg = MarketConfig(num_markets=1, num_agents=5126, num_levels=1024,
                       num_steps=400, **CONFIG["market"])
    assert (cfg.num_makers, cfg.num_momentum, cfg.num_fundamentalists,
            cfg.num_whales, cfg.num_hft, cfg.num_informed,
            cfg.num_arbitrageurs) == (1, 25, 100, 0, 0, 0, 0)
    types = assign_agent_types(5126, cfg.num_makers, cfg.num_momentum,
                               cfg.num_fundamentalists, device="cpu")
    assert {t: int((types == t).sum()) for t in CROWD} == CROWD
    assert rm.agent_counts(CONFIG["market"], 5126) == {
        MAKER: 1, MOMENTUM: 25, FUNDAMENTALIST: 100, rm.WHALE: 0,
        rm.HFT: 0, rm.INFORMED: 0, rm.ARBITRAGEUR: 0}
    rows = rm.Rows(torch.zeros((1, 1), dtype=torch.int64),
                   torch.zeros((1, 1), dtype=torch.int64),
                   rm.columns(CONFIG["market"], 5126, 1024, 1, "cpu"))
    want = rm.agent_types(rows, 5126)
    assert {t: int((want == t).sum()) for t in CROWD} == CROWD
    assert torch.equal(want[0], types[0].long())


def test_the_horizon_keeps_the_bins_exact():
    A_, S_ = CONFIG["num_agents"], CONFIG["num_steps"]
    q_max = CONFIG["market"]["q_max"]
    assert A_ * q_max * S_ == 16_403_200 < 2 ** 24
    # the longest horizon in whole hundreds of steps that stays exact
    assert A_ * q_max * (S_ + 100) >= 2 ** 24


def test_the_rule_takes_a_market_cluster():
    tile = autotune.auto_tile(CONFIG["num_levels"], CONFIG["num_agents"],
                              CONFIG["num_markets"], sms=132,
                              holds=autotune.h100_holds)
    assert tile.ctas_per_market > 1


def test_the_cell_is_listed_by_the_sweep_metrics():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    (w,) = [w for w in b["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("few_assets",
                                                       "sweep_crowd", 1)
    for name in ("agent_events_per_s", "ensemble_ms_p95",
                 "kinetic_chunk_roofline", "device_idle_pct.sweep",
                 "host_ms_per_ensemble.sweep",
                 "runners_built_per_ensemble.sweep",
                 "open_ms_per_ensemble.sweep", "to_host_gb_per_s.sweep"):
        (m,) = [m for m in b["end_to_end"] + b["per_layer"]
                if m["name"] == name]
        assert CELL in m["workloads"], name
    (m,) = [m for m in b["per_layer"] if m["name"] == STEP_METRIC]
    assert m["workloads"] == [CELL] and m["layer"] == "kernel"
    names = {m["name"] for m in Bench(ROOT).per_layer(CELL)}
    assert {"kinetic_chunk_roofline", "to_host_gb_per_s.sweep",
            STEP_METRIC} <= names
    traffic = Bench(ROOT).traffic("sweep_crowd")
    assert (traffic["kind"], traffic["rows_checked"],
            traffic["check_block_rows"]) == ("sweep", 4, 8192)


def program(seed, tile):
    cfg = MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                       num_steps=S, seed=seed, **CONFIG["market"])
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 autotune=False, tile=tile)
    with eng.open(EnsembleSpec.homogeneous(cfg)) as sess:
        assert sess._runner.tile.ctas_per_market > 1
        return sess.run(S).to_numpy()


def reference(seed, ids, fdt=torch.float32):
    n = len(ids)
    rows = rm.Rows(torch.full((n, 1), seed), torch.tensor(ids)[:, None],
                   rm.columns(CONFIG["market"], A, L, n, "cpu"))
    return [x.float().numpy() for x in rm.simulate(rows, A, L, S, fdt=fdt)]


@pytest.mark.parametrize("seed", [11, 2**31 + 5, 2**32 - 3])
@pytest.mark.parametrize("tile", [None, FRESH], ids=["rule", "fresh"])
def test_a_session_at_the_crowds_mix_equals_the_reference(seed, tile):
    got = program(seed, tile)
    for g, w in zip(got, reference(seed, list(range(M)))):
        assert np.array_equal(g, w)
    # rows drawn from the seed, as the sweep keeps them, alone
    ids = sorted(np.random.default_rng(seed).choice(M, 2, replace=False))
    for g, w in zip(got, reference(seed, [int(i) for i in ids])):
        assert np.array_equal(g[ids], w)
    control = reference(seed, list(range(M)), torch.bfloat16)
    assert sum(int((g != w).sum()) for g, w in zip(got, control)) > 0


@pytest.fixture
def shrunk(tmp_path, monkeypatch):
    """The benchmark's tiny copy with this cell at the shrunk shape."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    root = tiny.make(tmp_path)
    path = root / "kbench/configs/few_assets.json"
    cfg = json.loads(path.read_text())
    cfg.update(num_markets=M, num_agents=A, num_levels=L, num_steps=S)
    path.write_text(json.dumps(cfg))
    return Bench(root)


def test_the_shrunk_cell_runs_correct(shrunk):
    r = harness.run_cell(shrunk, CELL, 2**31 + 17, 0.1, False,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"agent_events_per_s", "ensemble_ms_p95",
                                 "setup_s"}
    # traced on the CPU: the spans are there, the card's kernels are not
    r = harness.run_cell(shrunk, CELL, 2**31 + 17, 0.1, True,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"]
    assert STEP_METRIC not in r["metrics"]
    spans = [s for s in program_trace.spans() if s.name == "dispatch"]
    assert spans and all(s.attrs["ctas_per_market"] > 1 for s in spans)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer"])
def test_a_broken_kernel_is_caught(shrunk, fault, monkeypatch):
    monkeypatch.setattr(kc, "kinetic_clearing_chunk", broken_chunk(fault))
    r = harness.run_cell(shrunk, CELL, 2**31 + 19, 0.1, False,
                         torch.device("cpu"), time.perf_counter())
    assert not r["correct"] and r["checks"]["mismatched_values"]["value"] > 0


def kernel(start, end, name=KERNEL):
    return trace.Interval(name, start, end, "kernel")


def dispatch(steps, C, **attrs):
    return rec("dispatch", 0, 10, kind="chunk", steps=steps, chunk=64,
               ctas_per_market=C, **attrs)


@pytest.mark.parametrize("records,kernels,want", [
    # 6 × 64 + 16 steps on 16-CTA clusters in 4 ms of kernel 1
    ([dispatch(64, 16)] * 6 + [dispatch(16, 16), rec("open", 0, 1)],
     [kernel(0.0, 0.0015), kernel(0.002, 0.0045)], 1e6 * 0.004 / 400),
    # one-CTA dispatches beside the clusters: kernel 1's time is not
    # the clusters' alone
    ([dispatch(64, 16), dispatch(64, 1)], [kernel(0.0, 0.001)], None),
    ([dispatch(64, 16), dispatch(8, None)], [kernel(0.0, 0.001)], None),
    ([dispatch(64, 1), dispatch(64, 16), rec("open", 0, 1)],
     [kernel(0.0, 0.001), kernel(0.002, 0.003)], None),
    # no dispatch on a cluster
    ([dispatch(64, 1), dispatch(64, None)], [kernel(0.0, 0.01)], None),
    # a program without the attribute (the parent of this metric)
    ([rec("dispatch", 0, 10, kind="chunk", steps=64, chunk=64,
          agent_steps=5)], [kernel(0.0, 0.01)], None),
    ([rec("open", 0, 1)], [kernel(0.0, 0.01)], None),
    # no kernel, or no device time
    ([dispatch(64, 16)], [], None),
    ([dispatch(64, 16)], [kernel(0.5, 0.5)], None),
])
def test_the_step_reader_on_hand_made_records(records, kernels, want):
    got = reader_module(STEP_METRIC).value(records, kernels)
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("tile", [FRESH, autotune.auto_tile(L, A)],
                         ids=["cluster", "one_cta"])
def test_the_reader_reads_the_program_spans(tile):
    """``read`` takes the program's own dispatch spans from its buffer and
    kernel 1's launches from the slice, by the traffic's kernel name."""
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 autotune=False, tile=tile)
    cfg = MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                       num_steps=S, seed=3, **CONFIG["market"])
    with profile(activities=[ProfilerActivity.CPU]):
        with eng.open(EnsembleSpec.homogeneous(cfg)) as sess:
            sess.run(S)
    sl = trace.Slice(0.0, 1.0, [kernel(0.1, 0.3), kernel(0.4, 0.6),
                                kernel(0.6, 0.9, "Memcpy DtoH")], [])
    ctx = SimpleNamespace(kernel="kinetic_chunk_kernel")
    bench = Bench(ROOT)
    step = bench.reader(STEP_METRIC)
    if tile.ctas_per_market > 1:
        assert step(sl, ctx) == pytest.approx(1e6 * 0.4 / S)
    else:
        assert step(sl, ctx) is None
    assert step(None, ctx) is None
    program_trace.clear()
    assert step(sl, ctx) is None
