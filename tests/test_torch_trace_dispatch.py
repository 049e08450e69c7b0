"""The ``dispatch`` span's agent work, on the CPU.

Under a ``torch.profiler`` profile every runner call's ``dispatch`` span
carries ``agents`` (the kernel runner's agent mode, None for a runner
without a tile) and ``agent_steps`` (markets × agents × steps of the call,
the markets of every shard on a mesh). With no profile nothing is
recorded.
"""
import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.config import MarketConfig
from repro_torch.core.session import Engine
from repro_torch.launch import set_host_device_count
from repro_torch.ops import trace

#: Past 8·32 agents, the registers mode's bound of one warp at L = 16.
CFG = MarketConfig(num_markets=6, num_agents=300, num_levels=16,
                   num_steps=10, seed=7)


@pytest.fixture(autouse=True)
def empty_buffer():
    trace.clear()
    yield
    trace.clear()


def dispatches(eng, steps=(10,), step=False):
    with profile(activities=[ProfilerActivity.CPU]):
        with eng.open(CFG) as sess:
            for n in steps:
                sess.run(n)
            if step:
                sess.step()
    return [r.attrs for r in trace.spans() if r.name == "dispatch"]


@pytest.mark.parametrize("backend,opts,agents", [
    # six markets: the rule spreads each over a cluster, in registers
    ("cuda-kinetic", {}, "registers"),
    ("cuda-kinetic", {"agents": "shared"}, "shared"),
    ("cuda-kinetic", {"agents": "fresh"}, "fresh"),
    # the per-step kernels keep the label of auto_tile(L, A)
    ("cuda-naive", {}, "shared"),
    ("torch-scan", {}, None),
    ("numpy", {}, None),
])
def test_a_chunk_dispatch_carries_its_agent_steps(backend, opts, agents):
    eng = Engine(backend, device="cpu", chunk_size=4, autotune=False,
                 **opts) if backend.startswith("cuda") else \
        Engine(backend, device="cpu", chunk_size=4)
    got = dispatches(eng, step=True)
    M, A = CFG.num_markets, CFG.num_agents
    # run(10) in chunks of 4, 4 and 2, then one env-style step
    assert [(r["kind"], r["steps"]) for r in got] == [
        ("chunk", 4), ("chunk", 4), ("chunk", 2), ("step", 1)]
    assert [r["agent_steps"] for r in got] == [M * A * n for n in
                                               (4, 4, 2, 1)]
    assert {r["agents"] for r in got} == {agents}


def test_a_mesh_counts_the_rows_of_every_shard():
    prev = set_host_device_count(2)
    try:
        eng = Engine("cuda-kinetic", device="cpu", chunk_size=5,
                     autotune=False, devices=2)
        got = dispatches(eng, steps=(5, 5))
    finally:
        set_host_device_count(prev)
    assert [r["agent_steps"] for r in got] == \
        [CFG.num_markets * CFG.num_agents * 5] * 2


def test_no_profile_records_nothing():
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=4)
    with eng.open(CFG) as sess:
        sess.run(10)
        sess.step()
    assert trace.spans() == []
