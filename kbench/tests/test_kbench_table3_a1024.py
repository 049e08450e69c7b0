"""The agent sweep's top cell (``sweep.table3_a1024``) on the CPU.

The configuration's shape takes kernel 1's shared agent mode by the launch
rule; the cell is listed by every metric that lists ``sweep.table4`` and
is the only cell of ``kernel_agent_events_per_s.table3_a1024``; a Session
past the registers mode's agents, at the configuration's mix, equals the
plain reference bit for bit (the kernel wrappers run their plain versions
here), and the reference in bfloat16 does not; the cell runs correct on
its shrunk copy; and the new reader, on hand-made records and kernel
intervals and on a profiled session's own spans."""
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
from kbench.tests.test_kbench_program_spans import rec, reader_module

from repro_torch.core.config import MarketConfig
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine
from repro_torch.kernels import autotune
from repro_torch.ops import trace as program_trace

ROOT = tiny.ROOT
CELL = "sweep.table3_a1024"
METRIC = "kernel_agent_events_per_s.table3_a1024"
CONFIG = json.loads((ROOT / "kbench/configs/table3_a1024.json").read_text())
TABLE4 = json.loads((ROOT / "kbench/configs/table4.json").read_text())
KERNEL = "void kinetic_chunk_kernel<0, false, 4>(ChunkArgs)"
#: Past 8·32 agents, the registers mode's bound of one warp at L = 16.
M, A, L, S, CHUNK = 6, 300, 16, 24, 8


@pytest.fixture(autouse=True)
def empty_buffer():
    program_trace.clear()
    yield
    program_trace.clear()


def test_the_config_is_table4_at_1024_agents():
    assert CONFIG["market"] == TABLE4["market"]
    assert (CONFIG["num_markets"], CONFIG["num_agents"],
            CONFIG["num_levels"], CONFIG["num_steps"]) == (8192, 1024, 128,
                                                           500)
    assert CONFIG["scenario"] == TABLE4["scenario"]
    assert CONFIG["stats_only"] is False and CONFIG["reduced"] == []
    # the bins stay exact: A · q_max · S below 2**24
    assert CONFIG["num_agents"] * CONFIG["market"]["q_max"] \
        * CONFIG["num_steps"] == 4_096_000 < 2 ** 24


def test_the_rule_takes_the_shared_mode():
    tile = autotune.auto_tile(CONFIG["num_levels"], CONFIG["num_agents"],
                              CONFIG["num_markets"])
    assert tile == autotune.TileChoice(128, 1024, 1, 4, "shared", 1)
    # Table IV's shape keeps the registers mode
    assert autotune.auto_tile(128, 256, 8192).agents == "registers"


def test_the_cell_is_listed_with_table4():
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    (w,) = [w for w in b["workloads"] if w["name"] == CELL]
    assert (w["config"], w["traffic"], w["chips"]) == ("table3_a1024",
                                                       "sweep", 1)
    for m in b["end_to_end"] + b["per_layer"]:
        if "sweep.table4" in m.get("workloads", []):
            assert CELL in m["workloads"], m["name"]
    (new,) = [m for m in b["per_layer"] if m["name"] == METRIC]
    assert new["workloads"] == [CELL]
    assert [m["name"] for m in b["per_layer"]
            if CELL in m.get("workloads", [])][-1] == METRIC
    names = {m["name"] for m in Bench(ROOT).per_layer(CELL)}
    assert {"kinetic_chunk_roofline", METRIC} <= names


def program(seed, agents):
    cfg = MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                       num_steps=S, seed=seed, **CONFIG["market"])
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 autotune=False, agents=agents)
    with eng.open(EnsembleSpec.homogeneous(cfg)) as sess:
        return sess.run(S).to_numpy()


def reference(seed, ids, fdt=torch.float32):
    n = len(ids)
    rows = rm.Rows(torch.full((n, 1), seed), torch.tensor(ids)[:, None],
                   rm.columns(CONFIG["market"], A, L, n, "cpu"))
    return [x.float().numpy() for x in rm.simulate(rows, A, L, S, fdt=fdt)]


@pytest.mark.parametrize("seed", [5, 2**32 - 7])
@pytest.mark.parametrize("agents", [None, "shared"])
def test_a_session_past_registers_equals_the_reference(seed, agents):
    got = program(seed, agents)
    for g, w in zip(got, reference(seed, list(range(M)))):
        assert np.array_equal(g, w)
    # rows drawn from the seed, as the sweep keeps them, alone
    ids = sorted(np.random.default_rng(seed).choice(M, 3, replace=False))
    for g, w in zip(got, reference(seed, [int(i) for i in ids])):
        assert np.array_equal(g[ids], w)
    control = reference(seed, list(range(M)), torch.bfloat16)
    assert sum(int((g != w).sum()) for g, w in zip(got, control)) > 0


def test_the_shrunk_cell_runs_correct(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    bench = Bench(tiny.make(tmp_path))
    r = harness.run_cell(bench, CELL, 2**31 + 13, 0.1, False,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"agent_events_per_s", "ensemble_ms_p95",
                                 "setup_s"}
    # traced on the CPU: the spans are there, the card's kernels are not
    r = harness.run_cell(bench, CELL, 2**31 + 13, 0.1, True,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"] and METRIC not in r["metrics"]
    assert any(s.name == "dispatch" and "agent_steps" in s.attrs
               for s in program_trace.spans())


def kernel(start, end, name=KERNEL):
    return trace.Interval(name, start, end, "kernel")


@pytest.mark.parametrize("records,kernels,want", [
    # 2 × 64 steps of 8192 × 1024 agents in 10 ms of kernel 1
    ([rec("dispatch", 0, 10, agent_steps=8192 * 1024 * 64)] * 2
     + [rec("open", 0, 1), rec("dispatch.peer", 0, 1, rows=3)],
     [kernel(0.0, 0.004), kernel(0.005, 0.011)],
     2 * 8192 * 1024 * 64 / 0.010),
    # no dispatch span
    ([rec("open", 0, 1)], [kernel(0.0, 0.01)], None),
    # a program without the attribute (the parent of this metric)
    ([rec("dispatch", 0, 10, kind="chunk", steps=64, chunk=64)],
     [kernel(0.0, 0.01)], None),
    # one dispatch without it among others
    ([rec("dispatch", 0, 10, agent_steps=5), rec("dispatch", 0, 1)],
     [kernel(0.0, 0.01)], None),
    # no kernel, or no device time
    ([rec("dispatch", 0, 10, agent_steps=5)], [], None),
    ([rec("dispatch", 0, 10, agent_steps=5)], [kernel(0.5, 0.5)], None),
])
def test_the_reader_on_hand_made_records(records, kernels, want):
    got = reader_module(METRIC).value(records, kernels)
    assert got == (None if want is None else pytest.approx(want))


def test_the_reader_reads_the_program_spans():
    """``read`` takes the program's own dispatch spans from its buffer and
    kernel 1's launches from the slice, by the traffic's kernel name."""
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 agents="shared")
    cfg = MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                       num_steps=S, seed=3, **CONFIG["market"])
    with profile(activities=[ProfilerActivity.CPU]):
        with eng.open(EnsembleSpec.homogeneous(cfg)) as sess:
            sess.run(S)
    sl = trace.Slice(0.0, 1.0, [kernel(0.1, 0.3), kernel(0.4, 0.6),
                                kernel(0.6, 0.9, "Memcpy DtoH")], [])
    ctx = SimpleNamespace(kernel="kinetic_chunk_kernel")
    read = Bench(ROOT).reader(METRIC)
    assert read(sl, ctx) == pytest.approx(M * A * S / 0.4)
    assert read(None, ctx) is None
    program_trace.clear()
    assert read(sl, ctx) is None
