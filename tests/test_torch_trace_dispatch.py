"""The ``dispatch`` span's agent work and launch shape, on the CPU.

Under a ``torch.profiler`` profile every runner call's ``dispatch`` span
carries ``agents`` (the kernel runner's agent mode, None for a runner
without a tile), ``ctas_per_market`` (its tile's C, None without a tile)
and ``agent_steps`` (markets × agents × steps of the call, the markets of
every shard on a mesh). With no profile nothing is recorded.
"""
import dataclasses

import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.config import MarketConfig
from repro_torch.core.session import Engine
from repro_torch.kernels import autotune
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


def dispatches(eng, steps=(10,), step=False, cfg=CFG):
    with profile(activities=[ProfilerActivity.CPU]):
        with eng.open(cfg) as sess:
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


def engine(backend, **opts):
    if backend.startswith("cuda"):
        return Engine(backend, device="cpu", chunk_size=4, autotune=False,
                      **opts)
    return Engine(backend, device="cpu", chunk_size=4, **opts)


@pytest.mark.parametrize("backend,opts,C", [
    # six markets: the rule spreads each over a cluster of 16 CTAs
    ("cuda-kinetic", {}, 16),
    ("cuda-naive", {}, 16),
    # a pinned mode takes auto_tile(L, A)'s one-CTA shape
    ("cuda-kinetic", {"agents": "shared"}, 1),
    # a pinned one-CTA tile
    ("cuda-kinetic", {"tile": autotune.auto_tile(16, 300)}, 1),
    ("torch-scan", {}, None),
    ("numpy", {}, None),
])
def test_a_dispatch_carries_its_tiles_c(backend, opts, C):
    eng = engine(backend, **opts)
    got = dispatches(eng, step=True)
    assert [r["ctas_per_market"] for r in got] == [C] * 4
    # the chunk runner and the single step's runner, each its own tile
    for runner in eng._runners.values():
        tile = getattr(runner, "tile", None)
        assert (None if tile is None else tile.ctas_per_market) == C


def test_a_pinned_cluster_is_carried_past_one_wave():
    """A pinned cluster over more markets than the card holds clusters."""
    tile = autotune.auto_tile(16, 300, 6)
    assert tile.ctas_per_market == 16
    cfg = dataclasses.replace(CFG, num_markets=100)
    got = dispatches(engine("cuda-kinetic", tile=tile), cfg=cfg)
    assert autotune.h100_holds(tile) < 100
    assert [r["ctas_per_market"] for r in got] == [16] * 3
    assert [r["agent_steps"] for r in got] == [
        100 * CFG.num_agents * n for n in (4, 4, 2)]


def test_a_mesh_carries_the_tile_of_its_shards():
    prev = set_host_device_count(2)
    try:
        eng = Engine("cuda-kinetic", device="cpu", chunk_size=5,
                     autotune=False, devices=2)
        cfg = dataclasses.replace(CFG, num_markets=7)
        got = dispatches(eng, steps=(5,), cfg=cfg)
        (runner,) = eng._runners.values()
    finally:
        set_host_device_count(prev)
    # seven markets on two shards: the tile of four
    assert runner.tile == autotune.auto_tile(16, 300, 4)
    assert [r["ctas_per_market"] for r in got] == [
        runner.tile.ctas_per_market]
