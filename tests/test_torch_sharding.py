"""Market-axis sharding of the port (``repro_torch.launch``, ``devices=`` and
``mesh=`` on the kernel backends).

Counterparts of ``tests/test_distributed.py`` and of the sharded cases of
``tests/test_chaos.py``. On the CPU a mesh spans
``set_host_device_count(N)`` host devices (the counterpart of
``--xla_force_host_platform_device_count``), restored after each test. On
2 and 3 shards every path equals the unsharded run and ``repro``'s run of
the same configuration with ``==`` (``repro``'s host ``numpy`` backend
over the same chunks, the reference its own backends equal): runs with a
flash crash straddling a chunk, a ring coupling whose peers cross shard
boundaries, ``stats_only``, a mixed ensemble, snapshots across shard
counts, env rollouts (auto-reset, ``StatsFeatures``, a shard with no rows,
snapshots across shard counts, with every ``EnvState`` leaf on its shard
after every step), the chaos harness's and the gateway's device losses.
Trainers on a mesh equal the port's unsharded trainer with ``==``, and
their checkpoints restore across shard counts. One
subprocess probe holds a 2-shard coupled run against ``repro``'s
``devices=2`` run under forced host devices.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro.core.config import MarketConfig as JConfig
from repro.core.config import scenario_config as j_scenario_config
from repro.core.params import EnsembleSpec as JSpec
from repro.core.session import Engine as JEngine
from repro.core.session import ExternalOrders as JOrders
from repro.env import Composite as JComposite
from repro.env import MarketFeatures as JMarketFeatures
from repro.env import PortfolioFeatures as JPortfolioFeatures
from repro.env import StatsFeatures as JStatsFeatures
from repro.env import rollout as j_rollout
from repro.ops import run_serve_plan as j_run_serve_plan
from repro.scenario import CouplingSpec as JCoupling
from repro.train.policies import make_market_maker as j_make_market_maker
from repro_torch.core.config import MarketConfig, scenario_config
from repro_torch.core.params import EnsembleSpec
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.session import Engine, ExternalOrders
from repro_torch.env import (Composite, MarketFeatures, PortfolioFeatures,
                             StatsFeatures, rollout)
from repro_torch.launch import (MarketsMesh, Roofline, make_markets_mesh,
                                market_sharding, replicate_tree,
                                replicated_sharding, set_host_device_count)
from repro_torch.launch import sharding
from repro_torch.launch.sharding import RowShards
from repro_torch.ops import DeviceLoss, FaultPlan, run_plan, run_serve_plan
from repro_torch.scenario import CouplingSpec
from repro_torch.train import PPOConfig, PPOTrainer
from repro_torch.train import make_market_maker
from repro_torch.train.loop import (restore_train_checkpoint,
                                    save_train_checkpoint)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
CHUNK = 6

#: ``tests/test_distributed.py``'s ``_SHARD_CFG``: M=10 (uneven over 3
#: shards), the flash crash at step 9 straddling the chunk [6, 12).
SHARD_KW = dict(num_markets=10, num_agents=16, num_levels=32, num_steps=20,
                shock_step=9, seed=7)
#: Ten ring-coupled markets with arbitrageurs: market m trades against
#: m + 1, so the peers of rows 3/4 and 6/7 (3 shards) or 4/5 (2 shards)
#: live on the next shard, and 9's on the first.
COUPLED_KW = dict(num_markets=10, num_agents=32, num_levels=16,
                  num_steps=18, seed=3, alpha_maker=0.15,
                  alpha_arbitrageur=0.25, noise_delta=4.0, p_marketable=0.25)
MIX = ["baseline", "flash-crash", "high-vol", "whale", "hft", "informed",
       "thin-book"]
MIX_KW = dict(num_markets=11, num_agents=24, num_levels=32, num_steps=16,
              seed=11)


def _cases(config, spec_cls, coupling, scenario):
    return {
        "flash-crash": scenario("flash-crash", **SHARD_KW),
        "ring": coupling.ring(10).apply(spec_cls.coerce(config(
            **COUPLED_KW))),
        "mixed": spec_cls.from_scenarios(MIX, **MIX_KW),
    }


CASES = _cases(MarketConfig, EnsembleSpec, CouplingSpec, scenario_config)
J_CASES = _cases(JConfig, JSpec, JCoupling, j_scenario_config)


@pytest.fixture(autouse=True)
def host_devices():
    prev = set_host_device_count(3)
    yield
    set_host_device_count(prev)


def _same(got, want, ctx=""):
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, (ctx, k, g.shape, w.shape)
        bad = np.argwhere(g != w)
        assert bad.size == 0, f"{ctx}[{k}]: first difference at {bad[0]}"


def _port_run(spec, backend="cuda-kinetic", stats_only=False, **opts):
    eng = Engine(backend, device="cpu", chunk_size=CHUNK,
                 stats_only=stats_only, **opts)
    with eng.open(spec) as s:
        batch = s.run(spec.num_steps).to_numpy()
        return (batch, s.stats if stats_only else None, s.snapshot(),
                s._runner)


_J_RUNS = {}


def _repro_run(case, stats_only=False):
    """``repro``'s single-device run of a case (host ``numpy``, the same
    chunks), computed once."""
    key = (case, stats_only)
    if key not in _J_RUNS:
        spec = J_CASES[case]
        eng = JEngine("numpy", chunk_size=CHUNK, stats_only=stats_only)
        with eng.open(spec) as s:
            _J_RUNS[key] = (s.run(spec.num_steps).to_numpy(),
                            s.stats if stats_only else None, s.snapshot())
    return _J_RUNS[key]


def _snap_state(snap):
    return [snap[f] for f in ("bid", "ask", "last_price", "prev_mid")]


# ---------------------------------------------------------------------------
# The mesh and its placement rules.
# ---------------------------------------------------------------------------

def test_markets_mesh_validation():
    mesh = make_markets_mesh(1, device="cpu")
    assert mesh.axis_names == ("markets",) and mesh.size == 1
    assert make_markets_mesh(device="cpu").size == 3
    with pytest.raises(ValueError, match="devices"):
        make_markets_mesh(4, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        make_markets_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="excludes every"):
        make_markets_mesh(skip=(0, 1, 2), device="cpu")
    assert make_markets_mesh(skip=(1,), device="cpu").size == 2
    set_host_device_count(1)
    with pytest.raises(ValueError, match="set_host_device_count"):
        make_markets_mesh(2, device="cpu")
    with pytest.raises(ValueError):
        set_host_device_count(0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_markets_mesh(1)


def test_market_sharding_requires_markets_axis():
    mesh = MarketsMesh.of(["cpu"] * 3)
    assert replicated_sharding(mesh) == torch.device("cpu")
    for M in (1, 2, 3, 10, 11, 64):
        rows = market_sharding(mesh, M)
        sizes = [len(range(M)[r]) for r in rows]
        assert sizes == [t.numel() for t in
                         torch.tensor_split(torch.arange(M), 3)]
        assert [i for r in rows for i in range(M)[r]] == list(range(M))
    other = MarketsMesh.of(["cpu"], axis_names=("data",))
    with pytest.raises(ValueError, match="markets"):
        market_sharding(other, 4)
    with pytest.raises(ValueError, match="markets"):
        replicated_sharding(other)
    with pytest.raises(ValueError, match="markets"):
        Engine("cuda-kinetic", device="cpu", mesh=other).open(
            CASES["flash-crash"])
    with pytest.raises(ValueError):
        MarketsMesh.of([])


def test_replicate_tree_places_every_tensor():
    mesh = MarketsMesh.of(["cpu", "cpu"])
    tree = {"torso": ((torch.ones(2, 3), torch.zeros(3)),),
            "pi": [torch.ones(1)], "n": 3}
    out = replicate_tree(tree, mesh)
    assert out["n"] == 3 and isinstance(out["pi"], list)
    assert torch.equal(out["torso"][0][0], tree["torso"][0][0])


def test_an_explicit_mesh_may_repeat_a_device():
    spec = CASES["ring"]
    want = _port_run(spec)
    mesh = MarketsMesh.of(["cpu", "cpu"])
    got = _port_run(spec, mesh=mesh)
    assert got[3].mesh.size == 2
    _same(got[0], want[0], "mesh of cpu twice")
    got = _port_run(spec, mesh=MarketsMesh.of([torch.device("cpu")] * 3))
    assert got[3].mesh.size == 3
    _same(got[0], want[0], "device list")
    with pytest.raises(TypeError, match="MarketsMesh"):
        _port_run(spec, mesh=[torch.device("cpu")] * 2)


# ---------------------------------------------------------------------------
# Sharded runs equal the unsharded run and repro's.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("stats_only", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_runs_equal_repro(case, stats_only, shards):
    spec = CASES[case]
    batch, stats, snap, runner = _port_run(spec, stats_only=stats_only,
                                           devices=shards)
    assert runner.mesh.size == shards and runner.device.type == "cpu"
    ubatch, ustats, usnap, _ = _port_run(spec, stats_only=stats_only)
    jbatch, jstats, jsnap = _repro_run(case, stats_only)
    for want, ctx in ((ubatch, "unsharded"), (jbatch, "repro")):
        _same(batch, want, f"{case} {shards} shards vs {ctx}")
    _same(_snap_state(snap), _snap_state(usnap), "books vs unsharded")
    _same(_snap_state(snap), _snap_state(jsnap), "books vs repro")
    if stats_only:
        _same(stats, ustats, "stats vs unsharded")
        _same(stats, jstats, "stats vs repro")


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_naive_equals_repro(shards):
    for case in ("flash-crash", "ring"):
        batch, _, _, runner = _port_run(CASES[case], backend="cuda-naive",
                                        devices=shards)
        assert runner.mesh.size == shards
        _same(batch, _repro_run(case)[0], f"cuda-naive {case}")


@pytest.mark.parametrize("shards", [2, 3])
def test_one_shot_simulate_on_a_mesh(shards):
    """``simulate_kinetic``/``simulate_naive`` with ``devices=`` return the
    books joined on the first device, equal to the unsharded result."""
    from repro_torch.kernels import ops

    cfg = MarketConfig(**dict(COUPLED_KW, alpha_whale=0.1, whale_period=3))
    want = ops.simulate_kinetic(cfg, device="cpu").to_numpy()
    for fn in (ops.simulate_kinetic, ops.simulate_naive):
        got = fn(cfg, device="cpu", devices=shards)
        assert all(isinstance(x, torch.Tensor) for x in got)
        _same(got.to_numpy(), want, fn.__name__)


def test_ring_peers_cross_shards_and_couple():
    """The ring's peers do cross the cut, and the coupling moves prices."""
    spec = CASES["ring"]
    peer = np.asarray(spec.params.coupling_peer).reshape(-1)
    for shards in (2, 3):
        rows = market_sharding(make_markets_mesh(shards, device="cpu"), 10)
        owner = {i: k for k, r in enumerate(rows) for i in range(10)[r]}
        assert any(owner[m] != owner[int(p)] for m, p in enumerate(peer))
    alone = CouplingSpec.none(10).apply(spec)
    assert not (_port_run(alone, devices=3)[0].price
                == _port_run(spec, devices=3)[0].price).all()


@pytest.mark.parametrize("shards", [2, 3])
def test_more_shards_than_markets(shards):
    spec = scenario_config("flash-crash", **dict(SHARD_KW, num_markets=1))
    batch, _, _, runner = _port_run(spec, devices=shards)
    assert [r.stop - r.start for r in runner._rows][1:] == [0] * (shards - 1)
    _same(batch, _port_run(spec)[0], "one market on a mesh")


def test_snapshot_across_shard_counts():
    """A snapshot taken on 2 shards restores onto 1 and onto 3 shards (and
    an unsharded one onto 2) and continues the exact stream."""
    spec = CASES["ring"]
    want = _repro_run("ring")[0]
    two = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK, devices=2)
    with two.open(spec) as s:
        s.run(12)
        snap = s.snapshot()
    for opts in ({}, {"devices": 3}, {"devices": 2}):
        eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK, **opts)
        with eng.open(spec) as s:
            s.restore(snap)
            got = s.run(6).to_numpy()
        _same([x[:, 12:] for x in want], got, f"restore onto {opts}")
    with Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK).open(spec) \
            as s:
        s.run(6)
        snap1 = s.snapshot()
    with two.open(spec) as s:
        s.restore(snap1)
        _same([x[:, 6:] for x in want], s.run(12).to_numpy(), "1 onto 2")


# ---------------------------------------------------------------------------
# Each shard's rows live on its shard, from open to close.
# ---------------------------------------------------------------------------

def _resident(leaf, mesh, M):
    """``leaf`` is a RowShards whose part k holds exactly shard k's rows on
    shard k's device, in storage of its own (no view of a canonical
    tensor)."""
    assert isinstance(leaf, RowShards), type(leaf)
    rows = market_sharding(mesh, M)
    assert leaf.rows == rows
    for part, r, dev in zip(leaf.parts, rows, mesh.devices):
        n = r.stop - r.start
        assert part.shape[0] == n and part.device == dev
        if n:
            assert part.untyped_storage().nbytes() == \
                n * part.stride(0) * part.element_size()


def _check_residency(sess):
    runner, M = sess._runner, sess.spec.num_markets
    leaves = list(sess._state) + list(sess._params) + [runner._market_ids]
    if sess._stats is not None:
        leaves += list(sess._stats)
    for leaf in leaves:
        _resident(leaf, runner.mesh, M)


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("stats_only", [False, True])
def test_rows_stay_on_their_shards(shards, stats_only, tmp_path):
    """After ``open``, every ``run``/``step``, ``swap_markets`` and
    ``restore``, the state, params, market ids and stats are held only as
    each shard's rows; the accessors' joined copies equal the unsharded
    session's."""
    spec = CASES["ring"]
    sub = scenario_config("whale", **dict(COUPLED_KW, num_markets=2))
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 stats_only=stats_only, devices=shards)
    ref = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 stats_only=stats_only)
    with eng.open(spec) as s, ref.open(spec) as u:
        _check_residency(s)
        for sess in (s, u):
            sess.run(6)
            sess.step()
            sess.swap_markets([4, 7], sub)
            sess.run(5)
        _check_residency(s)
        s.restore(u.snapshot())
        _check_residency(s)
        _same(s.state, u.state, "state")
        _same(s.params, u.params, "params")
        if stats_only:
            _same(s.stats, u.stats, "stats")
        assert (params_host(s.params) == params_host(u.params)).all()
        for sess in (s, u):
            sess.run(7)
        _check_residency(s)
        _same(s.state, u.state, "state after restore")


def params_host(packed):
    from repro_torch.core.params import host_ints
    return host_ints(packed)


@pytest.mark.parametrize("shards", [2, 3])
def test_swap_across_a_shard_boundary_equals_repro(shards):
    """Slots on both sides of every shard boundary are spliced into the
    shards that own them, with their params and host copies, equal to
    ``repro``'s ``jax-scan`` swap and to the unsharded port with ``==``;
    the kernel records count the new rows' archetypes."""
    slots = [3, 4, 6, 7]
    kw = dict(COUPLED_KW, num_markets=1)
    sub = EnsembleSpec.from_scenarios(["whale", "hft", "informed",
                                       "thin-book"], **kw)
    jsub = JSpec.from_scenarios(["whale", "hft", "informed", "thin-book"],
                                **kw)
    owners = {k for k, r in enumerate(market_sharding(
        make_markets_mesh(shards, device="cpu"), 10))
              for i in slots if r.start <= i < r.stop}
    assert len(owners) >= 2
    outs = {}
    for label, opts in (("unsharded", {}), ("sharded", {"devices": shards})):
        eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK, **opts)
        with eng.open(CASES["ring"]) as s:
            s.run(6)
            before = s._params
            s.swap_markets(slots, sub)
            if opts:
                _check_residency(s)
                for pos, r in enumerate(s._runner._rows):
                    touched = any(r.start <= i < r.stop for i in slots)
                    same = s._params.ints.parts[pos] is before.ints.parts[pos]
                    assert same != touched, pos
            with Roofline() as rf:
                batch = s.run(12).to_numpy()
            outs[label] = (batch, s.snapshot(), rf.summarize()["kernels"])
    with JEngine("jax-scan", chunk_size=CHUNK).open(J_CASES["ring"]) as j:
        j.run(6)
        j.swap_markets(slots, jsub)
        jbatch, jsnap = j.run(12).to_numpy(), j.snapshot()
    for label, (batch, snap, _) in outs.items():
        _same(batch, jbatch, f"{label} vs repro")
        _same(_snap_state(snap), _snap_state(jsnap), f"{label} books")
        for f, want in jsnap["params"].items():
            _same([snap["params"][f]], [want], f"{label} params {f}")
    ops = {label: k["kinetic_clearing_chunk"]["operations"]
           for label, (_, _, k) in outs.items()}
    assert ops["sharded"] == ops["unsharded"]


@pytest.mark.parametrize("shards", [2, 3])
def test_step_actions_on_a_mesh_equal_repro(shards):
    """``Session.step(actions)`` places the orders row-wise: runs, steps
    with orders and a stream interleaved equal ``repro``'s with ``==``."""
    spec, jspec = CASES["ring"], J_CASES["ring"]
    M, L = spec.num_markets, spec.num_levels
    r = np.random.default_rng(4)
    orders = [(r.random(M) < 0.5, r.integers(0, L, M),
               r.integers(0, 6, M).astype(np.float32)) for _ in range(3)]

    def drive(sess, cls):
        out = [sess.run(5).to_numpy()]
        for side, price, qty in orders:
            out.append(sess.step(cls(side, price, qty)).to_numpy())
        out += [b.to_numpy() for b in sess.stream(10)]
        return out

    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 devices=shards)
    with eng.open(spec) as s:
        got = drive(s, ExternalOrders)
        _check_residency(s)
        state = s.state
    with JEngine("numpy", chunk_size=CHUNK).open(jspec) as j:
        want = drive(j, JOrders)
        jstate = j.snapshot()
    for k, (g, w) in enumerate(zip(got, want)):
        _same(g, w, f"call {k}")
    _same(state, _snap_state(jstate), "books")


def test_snapshot_inside_an_open_stream():
    """A snapshot taken while a ``stream()`` is open on 3 shards reads the
    rows as of the chunks yielded so far; restored onto 2 shards it
    continues the straight run."""
    spec = CASES["ring"]
    want = _repro_run("ring")[0]
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK, devices=3)
    with eng.open(spec) as s:
        stream = s.stream(18)
        next(stream)
        next(stream)
        snap = s.snapshot()
        rest = [b.to_numpy() for b in stream]
    _same([np.concatenate([b[k] for b in rest], axis=1) for k in range(3)],
          [x[:, 12:] for x in want], "stream after the snapshot")
    two = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK, devices=2)
    with two.open(spec) as s:
        s.restore(snap)
        assert s.step_count == 12
        _same(s.run(6).to_numpy(), [x[:, 12:] for x in want], "restored")


def test_checkpoint_one_shard_into_three_and_back(tmp_path):
    """A 1-shard checkpoint restores into 3 shards, runs on, checkpoints,
    and restores into 1 shard again, bit for bit against the straight
    run; checkpoints keep the canonical layout."""
    spec = CASES["ring"]
    want = _repro_run("ring")
    mgr = CheckpointManager(tmp_path, async_write=False)
    one = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK)
    three = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK, devices=3)
    with one.open(spec) as s:
        s.run(6)
        s.save_checkpoint(mgr)
    with three.open(spec) as s:
        assert s.restore_checkpoint(mgr, 6) == 6
        _check_residency(s)
        _same(s.run(6).to_numpy(), [x[:, 6:12] for x in want[0]], "on 3")
        s.save_checkpoint(mgr)
    with one.open(spec) as s:
        assert s.restore_checkpoint(mgr, 12) == 12
        _same(s.run(6).to_numpy(), [x[:, 12:] for x in want[0]], "back")
        _same(s.state, _snap_state(want[2]), "books")


@pytest.mark.parametrize("shards", [2, 3])
def test_restore_onto_more_shards_than_markets(shards):
    """Trailing shards with no rows keep empty parts through a restore and
    a run."""
    spec = scenario_config("flash-crash", **dict(SHARD_KW, num_markets=1))
    with Engine("cuda-kinetic", device="cpu",
                chunk_size=CHUNK).open(spec) as s:
        s.run(6)
        snap = s.snapshot()
        want = s.run(14).to_numpy()
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK,
                 devices=shards)
    with eng.open(spec) as s:
        s.restore(snap)
        _check_residency(s)
        _same(s.run(14).to_numpy(), want, "1 market on a mesh")
        _check_residency(s)


def test_no_new_build_on_a_warm_sharded_session():
    spec = CASES["flash-crash"]
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK, devices=3)
    ready = eng.warm(spec)
    assert ready.ready
    warm = eng.trace_count
    assert warm == 2           # the chunk runner and the one-step runner
    with eng.open(spec) as s:
        s.run(6)
        s.run(6)
        s.run(4)               # a partial tail: n_valid gating
        s.step()
        assert eng.trace_count == warm
        assert s.metrics.counter("traces") == 0


# ---------------------------------------------------------------------------
# The env and the trainer keep their state on the mesh's shards.
# ---------------------------------------------------------------------------

ENV_STEPS = 10


def test_sharded_env_rollout_equals_repro():
    """A ring-coupled scripted-maker rollout on 2 and 3 shards equals the
    unsharded one and ``repro``'s env (its host ``numpy`` loop)."""
    spec = CASES["ring"]
    L = spec.num_levels
    jenv = JEngine("numpy").env(J_CASES["ring"], obs=JMarketFeatures(),
                                auto_reset=False)
    jfinal, jbatch = j_rollout(jenv, j_make_market_maker(L), ENV_STEPS)
    jbatch = jbatch.to_numpy()
    runs = {}
    for shards in (None, 2, 3):
        opts = {} if shards is None else {"devices": shards}
        env = Engine("cuda-kinetic", device="cpu", **opts).env(
            spec, obs=MarketFeatures(), auto_reset=False)
        assert env._runner.mesh.size == (shards or 1)
        final, batch = rollout(env, make_market_maker(L), ENV_STEPS)
        runs[shards] = (final, batch.to_numpy())
    for shards, (final, batch) in runs.items():
        for f in ("obs", "reward", "done", "price", "volume", "mid",
                  "fill_buy", "fill_ask"):
            _same([getattr(batch, f)], [getattr(jbatch, f)],
                  f"{shards} shards {f}")
        _same([sharding.to_host(x) for x in final.market],
              list(jfinal.market), f"{shards} shards market")


def test_sharded_trainer_equals_unsharded():
    """Two PPO updates on 2 and 3 shards equal the unsharded trainer with
    ``==`` (params, Adam state, metrics, the env state); the params sit on
    the mesh's first device, the env state on its shards."""
    _check_sharded_trainers("cuda-kinetic")


def _env_leaves(state):
    """Every ``[M, ...]`` leaf of an EnvState."""
    leaves = (list(state.market) + list(state.last_out)
              + list(state.reset_market) + list(state.params)
              + list(state.portfolio))
    return leaves + list(state.stats or ())


def _check_env_residency(env, state):
    """Every leaf of ``state`` is held as each shard's rows on its device:
    nothing of the env's state is canonical on the first device."""
    mesh, M = env._runner.mesh, env.num_markets
    for leaf in _env_leaves(state):
        _resident(leaf, mesh, M)


#: The observation that reads every part of the state: the book and last
#: output, the portfolio and the carried MarketStats.
ALL_OBS = (MarketFeatures(), PortfolioFeatures(), StatsFeatures())


def _stepped(env, n, state=None):
    """``n`` ``env.step`` calls of the scripted maker (values checked
    eagerly), with the residency of a sharded state after every step:
    the final state and the stacked (obs, reward, done, five info
    columns) on the host."""
    maker = make_market_maker(env.spec.num_levels)
    if state is None:
        state, obs = env.reset()
    else:
        obs = env.observe(state)
    sharded = env._runner.mesh.size > 1
    if sharded:
        _check_env_residency(env, state)
    rows = []
    for _ in range(n):
        state, obs, reward, done, info = env.step(state,
                                                  maker(obs, state.t))
        if sharded:
            _check_env_residency(env, state)
        rows.append([obs.numpy(), reward.numpy(), np.asarray(done)]
                    + [x.numpy() for x in info])
    return state, [np.stack(parts) for parts in zip(*rows)]


@pytest.mark.parametrize("backend", ["cuda-kinetic", "cuda-naive"])
@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_env_auto_reset_and_stats_equal_repro(backend, shards):
    """Ten maker steps over a horizon of four (two auto-resets) with the
    book, portfolio and ``StatsFeatures`` observation, on 2 and 3 shards:
    every step's observation, reward, done and info, and the final state,
    equal the unsharded port and ``repro``'s ``numpy`` env, with every
    leaf of the state on its shard after every step."""
    spec, jspec = CASES["ring"], J_CASES["ring"]
    L, n = spec.num_levels, ENV_STEPS
    jenv = JEngine("numpy").env(jspec, obs=JComposite((
        JMarketFeatures(), JPortfolioFeatures(), JStatsFeatures())),
        horizon=4)
    jmaker = j_make_market_maker(L)
    jstate, jobs = jenv.reset()
    jrows = []
    for _ in range(n):
        jstate, jobs, jr, jd, jinfo = jenv.step(jstate, jmaker(
            jobs, jstate.t))
        jrows.append([np.asarray(jobs), np.asarray(jr), np.asarray(jd)]
                     + [np.asarray(x) for x in jinfo])
    want = [np.stack(parts) for parts in zip(*jrows)]
    jsnap = jenv.snapshot(jstate)
    runs = {}
    for mesh in (1, shards):
        env = Engine(backend, device="cpu", devices=mesh).env(
            spec, obs=Composite(ALL_OBS), horizon=4)
        final, got = _stepped(env, n)
        runs[mesh] = got
        _same(got, want, f"{backend} {mesh} shards")
        snap = env.snapshot(final)
        for sub in ("market", "last_out", "portfolio", "stats", "params"):
            _same([snap[sub][f] for f in sorted(snap[sub])],
                  [np.asarray(jsnap[sub][f]) for f in sorted(snap[sub])],
                  f"{backend} {mesh} shards final {sub}")
        assert snap["t"] == int(np.asarray(jsnap["t"]))
    _same(runs[shards], runs[1], "sharded vs unsharded")


@pytest.mark.parametrize("shards", [4, 5])
def test_sharded_env_with_shards_without_rows(shards):
    """Three markets on 4 and 5 shards: the shards past the last row hold
    empty parts of every leaf and launch nothing; the rollout, auto-reset
    included, equals the unsharded one and ``repro``'s env."""
    kw = dict(SHARD_KW, num_markets=3)
    spec, jspec = (scenario_config("flash-crash", **kw),
                   j_scenario_config("flash-crash", **kw))
    L = spec.num_levels
    jenv = JEngine("numpy").env(jspec, obs=JComposite((
        JMarketFeatures(), JStatsFeatures())), horizon=5)
    _, jbatch = j_rollout(jenv, j_make_market_maker(L), ENV_STEPS)
    jbatch = jbatch.to_numpy()
    mesh = MarketsMesh.of(["cpu"] * shards)
    env = Engine("cuda-kinetic", device="cpu", mesh=mesh).env(
        spec, obs=Composite((MarketFeatures(), StatsFeatures())), horizon=5)
    final, got = _stepped(env, ENV_STEPS)
    for leaf in _env_leaves(final):
        assert [p.shape[0] for p in leaf.parts] == [1, 1, 1] + \
            [0] * (shards - 3)
    _same(got[:3], [jbatch.obs, jbatch.reward, jbatch.done], "obs")
    _same(got[3:], [x.T[:, :, None] for x in (
        jbatch.price, jbatch.volume, jbatch.mid, jbatch.fill_buy,
        jbatch.fill_ask)], "info")


def test_env_snapshot_one_shard_into_three_and_back(tmp_path):
    """An env checkpoint taken on 1 shard restores onto 3, steps on with
    every leaf on its shard, checkpoints again, and restores onto 1: both
    continue the straight rollout bit for bit, auto-reset and stats
    included."""
    spec = CASES["ring"]
    opts = dict(obs=Composite(ALL_OBS), horizon=7)
    envs = {n: Engine("cuda-kinetic", device="cpu", devices=n).env(
        spec, **opts) for n in (1, 3)}
    _, want = _stepped(envs[1], 15)
    mgr = CheckpointManager(tmp_path, async_write=False)
    state, first = _stepped(envs[1], 5)
    envs[1].save_checkpoint(mgr, state, step=5)
    state = envs[3].restore_checkpoint(mgr, 5)
    _check_env_residency(envs[3], state)
    state, second = _stepped(envs[3], 5, state)
    envs[3].save_checkpoint(mgr, state, step=10)
    state, third = _stepped(envs[1], 5, envs[1].restore_checkpoint(mgr, 10))
    _same([np.concatenate(parts) for parts in zip(first, second, third)],
          want, "1 -> 3 -> 1")


def _check_sharded_trainers(backend):
    """Two PPO updates on ``backend`` over 2 and 3 shards equal the
    unsharded trainer (params, Adam state, metrics, the env state read
    through ``sharding.to_host``); the params sit on the mesh's first
    device, and the env state the trainer carries stays on its shards."""
    from repro_torch.train.buffers import tree_leaves

    spec = EnsembleSpec.from_scenarios(["flash-crash", "high-vol"],
                                       num_markets=3, num_agents=16,
                                       num_levels=16, num_steps=12, seed=3)
    cfg = PPOConfig(rollout_len=8, num_updates=2, num_envs=1, num_epochs=2,
                    num_minibatches=4, hidden=(16,), seed=0)
    runs = {}
    for shards in (1, 2, 3):
        tr = Engine(backend, device="cpu", devices=shards).trainer(
            spec, cfg, obs=MarketFeatures())
        assert isinstance(tr, PPOTrainer)
        ts, metrics = tr.train(tr.init(), 2)
        if shards > 1:
            _check_env_residency(tr.env, ts.env_state)
        runs[shards] = (ts, metrics)
    ts0, m0 = runs[1]
    for shards in (2, 3):
        ts, m = runs[shards]
        home = replicated_sharding(MarketsMesh.of(["cpu"] * shards))
        assert all(p.device == home for p in tree_leaves(ts.params))
        for a, b in zip(tree_leaves(ts.params) + tree_leaves(ts.opt_state),
                        tree_leaves(ts0.params) + tree_leaves(ts0.opt_state)):
            assert torch.equal(a, b), shards
        for k in m0:
            assert torch.equal(m[k], m0[k]), (shards, k)
        _same([sharding.to_host(x) for x in _env_leaves(ts.env_state)],
              [sharding.to_host(x) for x in _env_leaves(ts0.env_state)],
              f"{backend} {shards} shards env state")


def test_sharded_naive_trainer_equals_unsharded():
    """The same on ``cuda-naive``."""
    _check_sharded_trainers("cuda-naive")


def test_sharded_trainer_checkpoint_into_one_shard(tmp_path):
    """A 2-shard trainer's checkpoint after one update restores into a
    1-shard trainer, whose second update equals two straight updates on 2
    shards; the 1-shard checkpoint restores into 2 shards again."""
    spec = EnsembleSpec.from_scenarios(["flash-crash", "high-vol"],
                                       num_markets=5, num_agents=16,
                                       num_levels=16, num_steps=12, seed=3)
    cfg = PPOConfig(rollout_len=6, num_updates=1, num_envs=1, num_epochs=1,
                    num_minibatches=2, hidden=(8,), seed=1)
    trainers = {n: Engine("cuda-kinetic", device="cpu", devices=n).trainer(
        spec, cfg, obs=Composite((MarketFeatures(), StatsFeatures())))
        for n in (1, 2)}
    straight, _ = trainers[2].train(trainers[2].init(), 2)
    mgr = CheckpointManager(tmp_path, async_write=False)
    ts, _ = trainers[2].train(trainers[2].init(), 1)
    save_train_checkpoint(mgr, trainers[2], ts)
    ts = restore_train_checkpoint(mgr, trainers[1], 1)
    ts, _ = trainers[1].train(ts, 1)
    from repro_torch.train.buffers import tree_leaves
    for a, b in zip(tree_leaves(ts.params), tree_leaves(straight.params)):
        assert torch.equal(a, b)
    _same([sharding.to_host(x) for x in _env_leaves(ts.env_state)],
          [sharding.to_host(x) for x in _env_leaves(straight.env_state)],
          "2 -> 1 env state")
    save_train_checkpoint(mgr, trainers[1], ts)
    back = restore_train_checkpoint(mgr, trainers[2], 2)
    _check_env_residency(trainers[2].env, back.env_state)
    _same([sharding.to_host(x) for x in _env_leaves(back.env_state)],
          [sharding.to_host(x) for x in _env_leaves(straight.env_state)],
          "1 -> 2 env state")


# ---------------------------------------------------------------------------
# Device loss on a mesh: the chaos harness and the gateway.
# ---------------------------------------------------------------------------

FAULTS = [DeviceLoss(at_step=12, devices_after=1),
          DeviceLoss(at_step=12, lost_device=1)]


@pytest.mark.parametrize("fault", FAULTS, ids=["devices_after", "lost"])
def test_device_loss_rebuilds_on_the_survivors(fault, tmp_path, monkeypatch):
    spec = CASES["ring"]
    built = []
    real = Engine.__init__

    def spy(self, *args, **kw):
        built.append(kw.get("devices") or kw.get("mesh"))
        real(self, *args, **kw)

    monkeypatch.setattr(Engine, "__init__", spy)
    rep = run_plan(FaultPlan([fault], checkpoint_every=CHUNK), spec,
                   backend="cuda-kinetic", ckpt_dir=tmp_path,
                   chunk_size=CHUNK,
                   engine_opts={"device": "cpu", "devices": 3})
    assert rep.replay_matched
    _same(rep.batch, _repro_run("ring")[0], "recovered vs repro")
    _same(rep.state, _snap_state(_repro_run("ring")[2]), "final books")
    ev = rep.events[0]
    assert ev.recovered_from == 12 and not ev.errors
    if fault.devices_after is not None:
        assert ev.detail == "rebuilt on devices=1" and built == [3, 1]
    else:
        assert ev.detail == "lost device 1; mesh over 2 survivors"
        assert built[0] == 3 and built[1].size == 2


SCENARIOS = ["baseline", "flash-crash", "high-vol"]
SERVE_KW = dict(scenarios=SCENARIOS, chunk_size=8, chunks=8,
                checkpoint_every=2, late_attach="thin-book", late_after=4,
                fault_after=3)


@pytest.fixture(scope="module")
def repro_serve(tmp_path_factory):
    """``repro``'s fault-free serving run of the schedule (host numpy)."""
    return j_run_serve_plan(ckpt_dir=tmp_path_factory.mktemp("j"),
                            backend="numpy", **SERVE_KW)


@pytest.mark.parametrize("fault", [DeviceLoss(at_step=0, devices_after=1),
                                   DeviceLoss(at_step=0, lost_device=1)],
                         ids=["devices_after", "lost"])
def test_gateway_device_loss_on_the_survivors(fault, tmp_path, repro_serve):
    """Under streaming clients on a 3-shard mesh, a device loss rebuilds the
    gateway's engine on the survivors; every client's frames equal
    ``repro``'s fault-free run and nothing is built after the re-warm."""
    rep = run_serve_plan(ckpt_dir=tmp_path, backend="cuda-kinetic",
                         engine_opts={"device": "cpu", "devices": 3},
                         fault=fault, **SERVE_KW)
    assert rep.reconnects == 1 and rep.traces_delta == 0
    assert set(rep.frames) == set(repro_serve.frames)
    for client, want in repro_serve.frames.items():
        got = rep.frames[client]
        assert len(got) == len(want), client
        for f0, f1 in zip(want, got):
            assert f0.step0 == f1.step0 and f0.seq == f1.seq
            for field in ("mid", "price", "volume"):
                _same([getattr(f1, field)], [getattr(f0, field)],
                      f"{client} {field} at {f0.step0}")


# ---------------------------------------------------------------------------
# Against repro's own sharded run, in a forced-2-device subprocess.
# ---------------------------------------------------------------------------

_PROBE = textwrap.dedent("""
    import numpy as np, jax
    assert len(jax.devices()) >= 2, jax.devices()
    from repro.core.config import MarketConfig as JConfig
    from repro.core.params import EnsembleSpec as JSpec
    from repro.core.session import Engine as JEngine
    from repro.scenario import CouplingSpec as JCoupling
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec
    from repro_torch.core.session import Engine
    from repro_torch.launch import set_host_device_count
    from repro_torch.scenario import CouplingSpec
    KW = {kw!r}
    set_host_device_count(2)
    jspec = JCoupling.ring(10).apply(JSpec.coerce(JConfig(**KW)))
    spec = CouplingSpec.ring(10).apply(EnsembleSpec.coerce(MarketConfig(**KW)))
    with JEngine("pallas-kinetic", chunk_size=6, devices=2).open(jspec) as s:
        want = s.run(KW["num_steps"]).to_numpy()
        jsnap = s.snapshot()
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=6, devices=2)
    with eng.open(spec) as s:
        assert s._runner.mesh.size == 2
        got = s.run(KW["num_steps"]).to_numpy()
        snap = s.snapshot()
    for f, a, b in zip(want._fields, want, got):
        assert (np.asarray(a) == np.asarray(b)).all(), f
    for f in ("bid", "ask", "last_price", "prev_mid"):
        assert (np.asarray(jsnap[f]) == np.asarray(snap[f])).all(), f
    print("OK")
""").format(kw=COUPLED_KW)


def test_two_shard_coupled_run_equals_repro_devices_2_subprocess():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = SRC
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=560)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "OK"


def test_a_card_mesh_needs_the_cards():
    """``devices=N`` counts distinct cards and never repeats one; without a
    card a CUDA mesh raises as every CUDA request does."""
    if torch.cuda.is_available():
        n = torch.cuda.device_count()
        with pytest.raises(ValueError, match="devices"):
            make_markets_mesh(n + 1)
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            Engine("cuda-kinetic", devices=2)
