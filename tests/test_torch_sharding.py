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
counts, env rollouts, the chaos harness's and the gateway's device losses.
Trainers on a mesh equal the port's unsharded trainer with ``==``. One
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
from repro.env import MarketFeatures as JMarketFeatures
from repro.env import rollout as j_rollout
from repro.ops import run_serve_plan as j_run_serve_plan
from repro.scenario import CouplingSpec as JCoupling
from repro.train.policies import make_market_maker as j_make_market_maker
from repro_torch.core.config import MarketConfig, scenario_config
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine
from repro_torch.env import MarketFeatures, rollout
from repro_torch.launch import (MarketsMesh, make_markets_mesh,
                                market_sharding, replicate_tree,
                                replicated_sharding, set_host_device_count)
from repro_torch.ops import DeviceLoss, FaultPlan, run_plan, run_serve_plan
from repro_torch.scenario import CouplingSpec
from repro_torch.train import PPOConfig, PPOTrainer
from repro_torch.train import make_market_maker

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
# The env and the trainer shard unchanged.
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
        _same([x.numpy() for x in final.market], list(jfinal.market),
              f"{shards} shards market")


def test_sharded_trainer_equals_unsharded():
    """Two PPO updates on 2 and 3 shards equal the unsharded trainer with
    ``==`` (params, Adam state, metrics, the env state); the params sit on
    the mesh's first device."""
    spec = EnsembleSpec.from_scenarios(["flash-crash", "high-vol"],
                                       num_markets=3, num_agents=16,
                                       num_levels=16, num_steps=12, seed=3)
    cfg = PPOConfig(rollout_len=8, num_updates=2, num_envs=1, num_epochs=2,
                    num_minibatches=4, hidden=(16,), seed=0)
    runs = {}
    for shards in (None, 2, 3):
        opts = {} if shards is None else {"devices": shards}
        tr = Engine("cuda-kinetic", device="cpu", **opts).trainer(
            spec, cfg, obs=MarketFeatures())
        assert isinstance(tr, PPOTrainer)
        ts = tr.init()
        ts, metrics = tr.train(ts, 2)
        runs[shards] = (ts, metrics, tr.env.snapshot(ts.env_state))
    ts0, m0, snap0 = runs[None]
    from repro_torch.train.buffers import tree_leaves
    for shards in (2, 3):
        ts, m, snap = runs[shards]
        home = replicated_sharding(MarketsMesh.of(["cpu"] * shards))
        assert all(p.device == home for p in tree_leaves(ts.params))
        for a, b in zip(tree_leaves(ts.params) + tree_leaves(ts.opt_state),
                        tree_leaves(ts0.params) + tree_leaves(ts0.opt_state)):
            assert torch.equal(a, b), shards
        for k in m0:
            assert torch.equal(m[k], m0[k]), (shards, k)
        _same([np.asarray(snap["market"][f]) for f in sorted(snap["market"])],
              [np.asarray(snap0["market"][f])
               for f in sorted(snap0["market"])], f"{shards} env state")


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
