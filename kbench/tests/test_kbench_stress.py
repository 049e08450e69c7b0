"""The coupled stress cell (``sweep.stress_mix``) on the CPU.

The port against ``kbench/reference/coupled.py`` bit for bit at a small
size (9 preset blocks of 4 markets, A=24, L=32, S=40, chunk 8, ring
coupling), paths and ``stats_only``; the configuration's blocks against the
presets they name; the reference over the kept markets' cones against the
reference over every market; the cell through ``harness.run_cell`` on its
own shrunk copy, correct; and the bfloat16 control, the three planted
faults of the reference and three faults planted in the program, not
correct."""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from kbench import harness
from kbench.loops import stress
from kbench.manifest import Bench
from kbench.reference import coupled as rc
from kbench.reference import market as rm
from kbench.tests import tiny

from repro_torch.core.config import scenario_config, scenario_names
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine
from repro_torch.kernels import ops
from repro_torch.scenario import CouplingSpec

ROOT = tiny.ROOT
CONFIG = json.loads((ROOT / "kbench/configs/stress_mix.json").read_text())
PER_BLOCK, A, L, S, CHUNK = 4, 24, 32, 40, 8
OVERRIDES = CONFIG["overrides"]
NAMES = scenario_names()
M = PER_BLOCK * len(NAMES)
CELL = "sweep.stress_mix"


def market_of(name, num_steps):
    c = scenario_config(name, num_steps=num_steps, **OVERRIDES)
    return {k: getattr(c, k) for k in CONFIG["blocks"][0]["market"]}


def all_rows(seed):
    parts = [rm.columns(market_of(n, S), A, L, PER_BLOCK, "cpu")
             for n in NAMES]
    return rm.Rows(torch.full((M, 1), seed), torch.arange(M)[:, None],
                   rm.stack_columns(parts))


def ring(m):
    return (m + 1) % M


def port(seed, stats_only):
    spec = CouplingSpec.ring(M).apply(EnsembleSpec.from_scenarios(
        list(NAMES), num_markets=PER_BLOCK, num_agents=A, num_levels=L,
        num_steps=S, seed=seed, **OVERRIDES))
    eng = Engine("cuda-kinetic", device="cpu", stats_only=stats_only,
                 chunk_size=CHUNK)
    with eng.open(spec) as sess:
        batch = sess.run(S)
        return sess.stats if stats_only else batch.to_numpy()


def whole(seed, stats_only, **kw):
    return rc.simulate(all_rows(seed), torch.tensor([ring(m)
                                                    for m in range(M)]),
                       torch.full((M,), S), A, L, S, CHUNK,
                       stats_only=stats_only, **kw)


@pytest.mark.parametrize("seed", [5, 2**32 - 7])
@pytest.mark.parametrize("stats_only", [False, True])
def test_the_port_equals_the_coupled_reference(seed, stats_only):
    # the last market of each block trades toward the next block's first
    assert all(ring(b * PER_BLOCK - 1) // PER_BLOCK == b % len(NAMES)
               for b in range(1, len(NAMES) + 1))
    got = port(seed, stats_only)
    want = whole(seed, stats_only)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), w.numpy())


def test_the_coupling_moves_the_outputs():
    """Dropping the ring changes the outputs, so the test above is no
    test of uncoupled markets."""
    want = whole(5, True)
    alone = rc.simulate(all_rows(5), torch.arange(M), torch.full((M,), S),
                        A, L, S, CHUNK, stats_only=True)
    assert not all(torch.equal(a, b) for a, b in zip(want, alone))


def test_the_config_blocks_are_the_presets():
    assert [b["scenario"] for b in CONFIG["blocks"]] == list(NAMES)
    assert OVERRIDES == {"alpha_arbitrageur": 0.1, "arb_kappa": 0.5}
    for b in CONFIG["blocks"]:
        c = scenario_config(b["scenario"], num_steps=500, **OVERRIDES)
        assert b["market"] == {k: getattr(c, k) for k in b["market"]}
        assert set(b["market"]) == set(json.loads(
            (ROOT / "kbench/configs/table4.json").read_text())["market"])
    assert (CONFIG["num_markets"], CONFIG["num_agents"],
            CONFIG["num_levels"], CONFIG["num_steps"]) == (9216, 256, 128,
                                                           500)
    assert CONFIG["markets_per_block"] * len(NAMES) == CONFIG["num_markets"]
    assert CONFIG["coupling"] == {"kind": "ring", "offset": 1}
    assert CONFIG["stats_only"] is True and CONFIG["reduced"] == []


def test_the_cone_at_the_cell_size():
    need = rc.cone([9215], lambda m: (m + 1) % 9216, 500, 64)
    assert need == {9215: 500, 0: 448, 1: 384, 2: 320, 3: 256, 4: 192,
                    5: 128, 6: 64}
    # overlapping cones share rows, each as deep as its deepest reader
    need = rc.cone([10, 12], lambda m: m + 1, 500, 64)
    assert need[12] == 500 and need[13] == 448 and len(need) == 10


@pytest.mark.parametrize("stats_only", [False, True])
def test_the_cone_reference_equals_every_row(stats_only):
    seed, kept = 2**31 + 9, [0, 3, 17, 18, 35]
    want = whole(seed, stats_only)
    markets, peer, steps = rc.rows_of(rc.cone(kept, ring, S, CHUNK), ring)
    assert len(markets) < M
    idx = torch.tensor(markets)
    rows = all_rows(seed)
    got = rc.simulate(
        rm.Rows(rows.seed[idx], rows.market_id[idx],
                {k: v[idx] for k, v in rows.cols.items()}),
        torch.tensor(peer), torch.tensor(steps), A, L, S, CHUNK,
        stats_only=stats_only)
    pos = [markets.index(m) for m in kept]
    for g, w in zip(got, want):
        assert torch.equal(g[pos], w[kept])


def shrink(root):
    """The cell at the size above, over ``tiny``'s copy."""
    cfg = dict(CONFIG, num_markets=M, markets_per_block=PER_BLOCK,
               num_agents=A, num_levels=L, num_steps=S,
               blocks=[dict(b, market=market_of(b["scenario"], S))
                       for b in CONFIG["blocks"]])
    (root / "kbench/configs/stress_mix.json").write_text(json.dumps(cfg))
    t = json.loads((ROOT / "kbench/traffic/stress.json").read_text())
    t.update(chunk=CHUNK, slice_seconds=0.1)
    (root / "kbench/traffic/stress.json").write_text(json.dumps(t))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return shrink(tiny.make(tmp_path_factory.mktemp("kbench")))


def run(root, seed=2**31 + 3):
    return harness.run_cell(Bench(root), CELL, seed, 0.2, False,
                            torch.device("cpu"), time.perf_counter())


def test_the_shrunk_cell_is_correct(root):
    r = run(root)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"] == {"mismatched_values": {"value": 0.0,
                                                 "limit": 0.0}}
    assert set(r["metrics"]) == {"agent_events_per_s", "ensemble_ms_p95",
                                 "setup_s"}


def test_the_spec_is_the_users():
    loop = harness.loop_for(Bench(ROOT), Bench(ROOT).cell(CELL), 7,
                            torch.device("cpu"))
    spec = loop.spec(3)
    assert spec.num_markets == 9216 and spec.seed == loop.ensemble_seed(3)
    assert spec.scenarios[::1024] == tuple(n + "*" for n in NAMES)
    peer = np.asarray(spec.params.coupling_peer)[:, 0]
    assert np.array_equal(peer, (np.arange(9216) + 1) % 9216)
    arbs = np.asarray(spec.params.num_arbitrageurs)[:, 0]
    assert (arbs == 26).all()
    rows = loop.kept_rows(3)
    assert len(rows) == 18 and (np.bincount(rows // 1024) == 2).all()
    assert np.array_equal(rows, loop.kept_rows(3))


@pytest.fixture(scope="module")
def readings(root):
    bench = Bench(root)
    loop = harness.loop_for(bench, bench.cell(CELL), 2**31 + 21,
                            torch.device("cpu"))
    loop.setup()
    loop.window(0.2)
    loop.release()
    return loop.readings()


@pytest.mark.parametrize("name", ["control_bfloat16"] + [
    f"fault_{f}" for f in stress.FAULTS])
def test_controls_and_reference_faults_are_not_correct(readings, name):
    assert readings["program"]["mismatched_values"] == 0.0
    assert readings[name]["mismatched_values"] > 0.0


def every_step(monkeypatch):
    real = Engine.open
    monkeypatch.setattr(Engine, "open", lambda self, spec, **kw: real(
        self, spec, **dict(kw, chunk_size=1)))


def uncoupled(monkeypatch):
    monkeypatch.setattr(ops.ClearingChunkRunner, "_peer_mids",
                        lambda self, mids, params, own=None, first=0: mids)


def shifted_block(monkeypatch):
    real = stress.Loop.build

    def build(self):
        spec = real(self)
        lo = self.per_block * stress.SHIFTED_BLOCK
        hi = lo + self.per_block
        rows = np.r_[0:lo, lo - 1:hi, hi + 1:spec.num_markets]
        return dataclasses.replace(
            spec, params=type(spec.params)(*(np.asarray(x)[rows]
                                             for x in spec.params)),
            initial_quote_qty=spec.initial_quote_qty[rows],
            initial_spread=spec.initial_spread[rows])

    monkeypatch.setattr(stress.Loop, "build", build)


@pytest.mark.parametrize("fault", [every_step, uncoupled, shifted_block])
def test_a_faulty_program_is_not_correct(root, fault, monkeypatch):
    fault(monkeypatch)
    r = run(root)
    assert not r["correct"], r["checks"]


def test_a_traced_slice_reads_the_sweep_metrics_and_the_peer(root,
                                                             monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    r = harness.run_cell(Bench(root), CELL, 11, 0.1, True,
                         torch.device("cpu"), time.perf_counter())
    assert r["correct"]
    # no device trace on the CPU: the roofline and the idle share are the
    # card's
    assert {"host_ms_per_ensemble.sweep", "open_ms_per_ensemble.sweep",
            "runners_built_per_ensemble.sweep",
            "peer_ms_per_ensemble.stress_mix"} <= set(r["metrics"])
    assert r["metrics"]["peer_ms_per_ensemble.stress_mix"]["value"] > 0


def test_the_reference_loads_nothing_of_the_program():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    code = ("import sys, json, kbench.reference.coupled\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}
