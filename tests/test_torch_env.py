"""The port's RL environment (``repro_torch.env``) against the JAX package's
``repro.env``, field by field with ``==``, on the CPU.

Every port backend runs here: ``cuda-kinetic`` and ``cuda-naive`` through
their kernels' plain versions, the eager ``torch-scan`` and
``torch-per-step``, and the host ``numpy`` family. The counter-RNG backends
are held against ``repro``'s ``jax-scan`` env (its traced rollout) and its
``numpy`` env (its host loop); ``numpy-splitmix64`` and ``numpy-pcg64``
against their ``repro`` namesakes.

One ulp is known to part the two ``repro`` references: ``StatsFeatures``'
variance ``sumsq/denom - mean*mean`` differs in the last bit between
``repro``'s ``jax-scan`` (XLA fuses it on the CPU) and its ``numpy`` env
(ROADMAP Queue 3). The port equals the unfused ``numpy`` env, so the tests
with ``StatsFeatures`` hold it against that one.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.config import MarketConfig as JConfig
from repro.core.config import scenario_names as j_scenario_names
from repro.core.params import EnsembleSpec as JSpec
from repro.core.session import Engine as JEngine
from repro.core.session import ExternalOrders as JOrders
from repro.env import BookWindow as JBookWindow
from repro.env import Composite as JComposite
from repro.env import InventoryPenalty as JInventoryPenalty
from repro.env import MarketFeatures as JMarketFeatures
from repro.env import PnLReward as JPnLReward
from repro.env import PortfolioFeatures as JPortfolioFeatures
from repro.env import SpreadCapture as JSpreadCapture
from repro.env import StatsFeatures as JStatsFeatures
from repro.env import Sum as JSum
from repro.env import rollout as j_rollout
from repro.env.actions import lower_actions as j_lower_actions
from repro.scenario import CouplingSpec as JCoupling
from repro.train.policies import make_market_maker
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.config import MarketConfig, scenario_names
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine, ExternalOrders
from repro_torch.env import (BookWindow, Composite, InventoryPenalty,
                             MarketEnv, MarketFeatures, PnLReward,
                             PortfolioFeatures, SpreadCapture, StatsFeatures,
                             Sum, lower_actions, rollout)
from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.kernels import naive_clearing as nc
from repro_torch.scenario import CouplingSpec
from repro_torch.train import make_market_maker as t_make_market_maker

KW = dict(num_markets=4, num_agents=16, num_levels=16, num_steps=12, seed=3)
CFG, JCFG = MarketConfig(**KW), JConfig(**KW)
M, L, S = CFG.num_markets, CFG.num_levels, CFG.num_steps

#: Every port backend, with the ``repro`` env it is held against (its
#: traced rollout for the counter stream, its namesake for the others).
BACKENDS = {"cuda-kinetic": "jax-scan", "cuda-naive": "jax-scan",
            "torch-scan": "jax-scan", "torch-per-step": "jax-scan",
            "numpy": "jax-scan", "numpy-splitmix64": "numpy-splitmix64",
            "numpy-pcg64": "numpy-pcg64"}
#: The same, with ``repro``'s host ``numpy`` env for the counter stream.
UNFUSED = dict(BACKENDS, **{b: "numpy" for b, r in BACKENDS.items()
                           if r == "jax-scan"})
COUNTER = [b for b, r in BACKENDS.items() if r == "jax-scan"]

_ENGINES, _JENGINES = {}, {}


def _engine(backend):
    if backend not in _ENGINES:
        _ENGINES[backend] = Engine(backend, device="cpu")
    return _ENGINES[backend]


def _jengine(backend):
    if backend not in _JENGINES:
        _JENGINES[backend] = JEngine(backend)
    return _JENGINES[backend]


def _same(got, want, ctx=""):
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (ctx, g.shape, w.shape)
    bad = np.argwhere(g != w)
    assert bad.size == 0, f"{ctx}: first difference at {bad[0].tolist()}"


def _same_tuple(got, want, ctx=""):
    for f, g, w in zip(type(want)._fields, got, want):
        _same(g.numpy() if isinstance(g, torch.Tensor) else g, w,
              f"{ctx} {f}")


def _same_batch(got, want, ctx=""):
    got = got.to_numpy()
    for f in ("obs", "reward", "done", "price", "volume", "mid", "fill_buy",
              "fill_ask"):
        _same(getattr(got, f), getattr(want, f), f"{ctx} {f}")


def _fixed_actions(t, orders=ExternalOrders):
    """A deterministic, step-varying nonzero action sequence."""
    return orders(side_buy=np.arange(M) % 2 == 0,
                  price=np.full(M, 5 + (t % 4)),
                  qty=np.full(M, 2.0 + (t % 2)))


#: The scripted maker, in ``repro_torch.train.policies`` and in
#: ``repro.train.policies``.
MAKER, J_MAKER = t_make_market_maker(L), make_market_maker(L)
OBS = Composite((MarketFeatures(), BookWindow(3), PortfolioFeatures(),
                 StatsFeatures()))
J_OBS = JComposite((JMarketFeatures(), JBookWindow(3), JPortfolioFeatures(),
                    JStatsFeatures()))
REWARD = Sum((PnLReward(), SpreadCapture(), InventoryPenalty(0.01)))
J_REWARD = JSum((JPnLReward(), JSpreadCapture(), JInventoryPenalty(0.01)))

_REFS = {}


def _jref(kind, jbackend):
    """``repro``'s rollout of one kind on one backend, computed once."""
    key = (kind, jbackend)
    if key not in _REFS:
        eng = _jengine(jbackend)
        if kind == "zero":
            env = eng.env(JCFG, auto_reset=False)
            out = j_rollout(env, None, S)
        elif kind == "maker":
            out = j_rollout(eng.env(JCFG), J_MAKER, 20)
        else:  # composite obs and rewards, horizon 7
            env = eng.env(JCFG, obs=J_OBS, reward=J_REWARD, horizon=7)
            out = j_rollout(env, J_MAKER, 20)
        _REFS[key] = (out[0], out[1].to_numpy())
    return _REFS[key]


# ---------------------------------------------------------------------------
# Zero actions: the env equals Session.run and repro, on every backend.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", list(BACKENDS))
def test_zero_action_rollout_matches_session(backend):
    eng = _engine(backend)
    final, batch = rollout(eng.env(CFG, auto_reset=False), None, S)
    with eng.open(CFG) as sess:
        ref = sess.run(S)
        for f in ("price", "volume", "mid"):
            assert torch.equal(getattr(batch, f), getattr(ref, f)), f
        for got, want in zip(final.market, sess.state):
            assert torch.equal(got, want)
    for leaf in final.portfolio:
        assert (leaf == 0.0).all()
    jfinal, jbatch = _jref("zero", BACKENDS[backend])
    _same_batch(batch, jbatch, backend)
    _same_tuple(final.market, jfinal.market, backend)


# ---------------------------------------------------------------------------
# With actions: the scripted maker, across an auto-reset.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", list(BACKENDS))
def test_maker_rollout_matches_repro(backend):
    final, batch = rollout(_engine(backend).env(CFG), MAKER, 20)
    jfinal, jbatch = _jref("maker", BACKENDS[backend])
    _same_batch(batch, jbatch, backend)
    assert batch.to_numpy().fill_buy.sum() > 0, "the maker never filled"
    _same_tuple(final.market, jfinal.market, backend)
    _same_tuple(final.portfolio, jfinal.portfolio, backend)
    assert final.t == int(np.asarray(jfinal.t)) == 20 - S


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_composite_obs_and_rewards_match_repro(backend):
    env = _engine(backend).env(CFG, obs=OBS, reward=REWARD, horizon=7)
    final, batch = rollout(env, MAKER, 20)
    jfinal, jbatch = _jref("composite", UNFUSED[backend])
    _same_batch(batch, jbatch, backend)
    _same_tuple(final.stats, jfinal.stats, backend)
    _same_tuple(final.last_out, jfinal.last_out, backend)


def test_maker_rollouts_of_every_backend_agree():
    """The counter-stream backends give one trajectory among themselves."""
    ref = rollout(_engine("cuda-kinetic").env(CFG), MAKER, 20)[1]
    for backend in COUNTER[1:]:
        got = rollout(_engine(backend).env(CFG), MAKER, 20)[1]
        _same_batch(got, ref.to_numpy(), backend)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_env_step_matches_session_step_with_actions(backend):
    eng = _engine(backend)
    env = eng.env(CFG, auto_reset=False)
    jenv = _jengine(BACKENDS[backend]).env(JCFG, auto_reset=False)
    state, _ = env.reset()
    jstate, _ = jenv.reset()
    with eng.open(CFG) as sess:
        for t in range(6):
            state, obs, reward, done, info = env.step(state,
                                                      _fixed_actions(t))
            jstate, jobs, jreward, _, jinfo = jenv.step(
                jstate, _fixed_actions(t, JOrders))
            batch = sess.step(_fixed_actions(t))
            for f in ("price", "volume", "mid"):
                assert torch.equal(getattr(info, f), getattr(batch, f))
            _same_tuple(info, jinfo, f"{backend} t={t}")
            _same(obs.numpy(), jobs, f"{backend} obs t={t}")
            _same(reward.numpy(), jreward, f"{backend} reward t={t}")
            assert done is False
        for got, want in zip(state.market, sess.state):
            assert torch.equal(got, want)
    _same_tuple(state.portfolio, jstate.portfolio, backend)


@pytest.mark.parametrize("backend", COUNTER)
def test_step_loop_equals_rollout(backend):
    env = _engine(backend).env(CFG)  # auto-reset: the loop crosses it
    final, batch = rollout(env, MAKER, S + 3)
    state, obs = env.reset()
    for t in range(S + 3):
        state, obs, reward, done, info = env.step(state, MAKER(obs, state.t))
        assert torch.equal(reward, batch.reward[t]), t
        assert torch.equal(obs, batch.obs[t]), t
        assert torch.equal(info.price, batch.price[:, t:t + 1]), t
        assert done == bool(batch.done[t]), t
    for got, want in zip(final.market + final.portfolio,
                         state.market + state.portfolio):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# Coupled markets: the peer column is read from prev_mid at every step.
# ---------------------------------------------------------------------------

#: Six ring-coupled markets with arbitrageurs, at the env's widths.
COUPLED_KW = dict(KW, num_markets=6, num_agents=32, alpha_maker=0.15,
                  alpha_arbitrageur=0.25, noise_delta=4.0,
                  p_marketable=0.25)
COUPLED_STEPS = 10


def _coupled(coupling, spec_cls, config_cls):
    return coupling.ring(6).apply(spec_cls.coerce(config_cls(**COUPLED_KW)))


@pytest.fixture(scope="module")
def coupled_jax_env():
    env = _jengine("jax-scan").env(_coupled(JCoupling, JSpec, JConfig),
                                   auto_reset=False)
    final, batch = j_rollout(env, J_MAKER, COUPLED_STEPS)
    return final, batch.to_numpy()


@pytest.mark.parametrize("backend", ["cuda-kinetic", "cuda-naive",
                                     "torch-scan", "numpy"])
def test_coupled_rollout_matches_repro_and_session_steps(backend,
                                                         coupled_jax_env):
    """A ring-coupled maker rollout equals ``repro``'s env and a loop of
    ``Session.step`` calls with the same orders: each env step sees its
    peer's mid of the step before, not one frozen at a chunk's entry."""
    spec = _coupled(CouplingSpec, EnsembleSpec, MarketConfig)
    eng = _engine(backend)
    env = eng.env(spec, auto_reset=False)
    final, batch = rollout(env, MAKER, COUPLED_STEPS)
    jfinal, jbatch = coupled_jax_env
    _same_batch(batch, jbatch, backend)
    _same_tuple(final.market, jfinal.market, backend)
    _same_tuple(final.portfolio, jfinal.portfolio, backend)
    state, obs = env.reset()
    with eng.open(spec) as sess:
        for t in range(COUPLED_STEPS):
            orders = MAKER(obs, state.t)
            state, obs, reward, done, info = env.step(state, orders)
            stepped = sess.step(orders)
            for f in ("price", "volume", "mid"):
                col = getattr(batch, f)[:, t:t + 1]
                assert torch.equal(getattr(stepped, f), col), (f, t)
                assert torch.equal(getattr(info, f), col), (f, t)
        for got, want in zip(final.market, sess.state):
            assert torch.equal(got, want)
    uncoupled = eng.env(CouplingSpec.none(6).apply(spec), auto_reset=False)
    _, base = rollout(uncoupled, MAKER, COUPLED_STEPS)
    assert not torch.equal(base.price, batch.price), "coupling was inert"


# ---------------------------------------------------------------------------
# Carried policies.
# ---------------------------------------------------------------------------

def _carried(np_like):
    """A stateful quoting policy in the carried signature, written once for
    numpy (the ``repro`` side) and once for torch."""
    def policy(carry, obs, t):
        count, ref_mid = carry
        mid = obs[:, 0]
        side_buy = int(count) % 2 == 0
        if np_like:
            off = np.where(mid >= ref_mid, 1.0, 2.0)
            price = np.clip(np.round(mid + (-off if side_buy else off))
                            .astype(np.int32), 0, L - 1)
            side = np.full(mid.shape, side_buy)
            qty, orders = np.ones_like(mid), JOrders
        else:
            off = torch.where(mid >= ref_mid, 1.0, 2.0)
            price = torch.clamp(torch.round(mid + (-off if side_buy else off))
                                .to(torch.int32), 0, L - 1)
            side = torch.full(mid.shape, side_buy)
            qty, orders = torch.ones_like(mid), ExternalOrders
        extras = {"mid": mid, "count": count}
        return (count + 1, ref_mid), orders(side, price, qty), extras
    return policy


@pytest.mark.parametrize("backend", ["numpy", "torch-scan", "cuda-kinetic"])
def test_policy_carry_matches_repro(backend):
    carry0 = (0, np.float32(L / 2))
    jf, jb, jc = j_rollout(_jengine("numpy").env(JCFG), _carried(True), S,
                           policy_carry=(np.int32(0), np.float32(L / 2)))
    final, batch, carry = rollout(_engine(backend).env(CFG), _carried(False),
                                  S, policy_carry=carry0)
    _same_batch(batch, jb.to_numpy(), backend)
    host = batch.to_numpy()
    for k in ("mid", "count"):
        _same(host.extras[k], np.asarray(jb.extras[k]), k)
    assert host.extras["count"].shape == (S,)
    assert host.extras["mid"].shape == (S, M)
    assert carry[0] == int(np.asarray(jc[0])) == S


def test_policy_carry_requires_policy():
    with pytest.raises(ValueError, match="policy_carry"):
        rollout(_engine("torch-scan").env(CFG), None, 4, policy_carry=0)


def test_stateless_rollout_has_no_extras_and_empty_rollouts_have_shapes():
    env = _engine("torch-scan").env(CFG)
    _, batch = rollout(env, MAKER, 4)
    assert batch.extras is None and batch.num_steps == 4
    _, empty = rollout(env, MAKER, 0)
    assert empty.obs.shape == (0, M, env.obs_size())
    assert empty.reward.shape == (0, M) and empty.done.shape == (0,)
    assert empty.price.shape == (M, 0)
    with pytest.raises(ValueError, match="n_steps"):
        rollout(env, MAKER, -1)


# ---------------------------------------------------------------------------
# Episodes: auto-reset, no reset, a custom horizon.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["numpy", "torch-scan", "cuda-kinetic",
                                     "cuda-naive"])
def test_auto_reset_at_horizon(backend):
    env = _engine(backend).env(CFG)
    jenv = _jengine(BACKENDS[backend]).env(JCFG)
    state, obs = env.reset()
    jstate, _ = jenv.reset()
    ref0, _ = env.reset()
    for t in range(S):
        state, obs, reward, done, info = env.step(state)
        jstate, jobs, _, jdone, _ = jenv.step(jstate)
        assert done == (t == S - 1) == bool(jdone), t
        _same(obs.numpy(), jobs, f"t={t}")
    assert state.t == 0
    for got, want in zip(state.market, ref0.market):
        assert torch.equal(got, want)
    for leaf in state.portfolio:
        assert (leaf == 0.0).all()
    assert torch.equal(obs, env.observe(ref0))
    # The second episode replays the first bit for bit.
    state, _, _, _, info = env.step(state)
    _, _, _, _, info0 = env.step(ref0)
    assert torch.equal(info.price, info0.price)


def test_no_auto_reset_keeps_counting():
    env = _engine("torch-scan").env(CFG, auto_reset=False)
    state, _ = env.reset()
    for _ in range(S + 2):
        state, obs, reward, done, info = env.step(state)
    assert state.t == S + 2 and done


def test_custom_horizon():
    env = _engine("cuda-kinetic").env(CFG, horizon=5)
    state, _ = env.reset()
    for _ in range(5):
        state, obs, reward, done, info = env.step(state)
    assert done and state.t == 0
    with pytest.raises(ValueError, match="horizon"):
        _engine("cuda-kinetic").env(CFG, horizon=0)


# ---------------------------------------------------------------------------
# Runtime seeds.
# ---------------------------------------------------------------------------

SEEDS = (3, 11, 42)


@pytest.fixture(scope="module")
def vmapped_seed_rows():
    """``repro``'s ``jax.vmap(env.reset)(seeds)`` and four vmapped steps."""
    import jax

    env = _jengine("jax-scan").env(JCFG, auto_reset=False)
    states, obs = jax.vmap(env.reset)(np.array(SEEDS, np.uint32))
    for _ in range(4):
        states, obs, _, _, _ = jax.vmap(lambda s: env.step(s))(states)
    return states, np.asarray(obs)


@pytest.mark.parametrize("backend", ["torch-scan", "torch-per-step",
                                     "numpy"])
def test_runtime_seeds_match_repro_vmap(backend, vmapped_seed_rows):
    """A Python loop over seeds equals ``repro``'s vmapped rows, and a
    runtime seed equals an env on a spec carrying that seed."""
    states, obs = vmapped_seed_rows
    env = _engine(backend).env(CFG, auto_reset=False)
    for i, seed in enumerate(SEEDS):
        state, ob = env.reset(seed=seed)
        solo, _ = _engine(backend).env(
            dataclasses.replace(CFG, seed=seed), auto_reset=False).reset()
        solo_env = _engine(backend).env(dataclasses.replace(CFG, seed=seed),
                                        auto_reset=False)
        for _ in range(4):
            state, ob, _, _, _ = env.step(state)
            solo, solo_ob, _, _, _ = solo_env.step(solo)
        _same(ob.numpy(), obs[i], f"seed {seed}")
        assert torch.equal(ob, solo_ob)
        for f, got in zip(state.market._fields, state.market):
            _same(got.numpy(), np.asarray(getattr(states.market, f))[i], f)


def test_runtime_seed_on_splitmix64_matches_repro():
    jf, jb = j_rollout(_jengine("numpy-splitmix64").env(JCFG), J_MAKER, 8,
                       seed=11)
    final, batch = rollout(_engine("numpy-splitmix64").env(CFG), MAKER, 8,
                           seed=11)
    _same_batch(batch, jb.to_numpy(), "splitmix64 seed=11")
    assert final.seed == 11


@pytest.mark.parametrize("backend", ["cuda-kinetic", "cuda-naive",
                                     "numpy-pcg64"])
def test_runtime_seed_rejected_where_baked(backend):
    with pytest.raises(ValueError, match="seed=7"):
        _engine(backend).env(CFG).reset(seed=7)


# ---------------------------------------------------------------------------
# Mixed ensembles and the build count.
# ---------------------------------------------------------------------------

def _mixture(blocks, spec_cls=EnsembleSpec):
    return spec_cls.from_scenarios(blocks, num_markets=2, num_agents=16,
                                   num_levels=16, num_steps=10, seed=0)


@pytest.mark.parametrize("backend", ["cuda-kinetic", "torch-scan"])
def test_mixed_ensemble_builds_once_and_matches_repro(backend):
    eng = Engine(backend, device="cpu")  # fresh: exact build accounting
    names = list(scenario_names())
    assert names == list(j_scenario_names())
    env = eng.env(_mixture(names), auto_reset=False)
    final, batch = rollout(env, None, 10)
    assert eng.trace_count == 1, "the env built more than one runner"
    env2 = eng.env(_mixture(["baseline"] * len(names)), auto_reset=False)
    rollout(env2, MAKER, 10)
    assert eng.trace_count == 1, "a second mixture of one shape rebuilt"
    assert env2._runner is env._runner
    jenv = _jengine("jax-scan").env(_mixture(names, JSpec), auto_reset=False)
    jfinal, jbatch = j_rollout(jenv, None, 10)
    _same_batch(batch, jbatch.to_numpy(), backend)
    _same_tuple(final.market, jfinal.market, backend)


def test_mixed_rollout_rows_match_solo_scenarios():
    eng = _engine("cuda-kinetic")
    names = sorted(scenario_names())
    final, batch = rollout(eng.env(_mixture(names), auto_reset=False),
                           None, 10)
    for k, name in enumerate(names):
        sfinal, sbatch = rollout(
            eng.env(_mixture([name] * len(names)), auto_reset=False),
            None, 10)
        rows = slice(2 * k, 2 * k + 2)
        assert torch.equal(batch.price[rows], sbatch.price[rows]), name
        assert torch.equal(final.market.bid[rows],
                           sfinal.market.bid[rows]), name


def test_kernel_backends_launch_nothing_on_the_cpu():
    kc.kinetic_clearing_chunk.launches = nc.naive_clearing_chunk.launches = 0
    for backend in ("cuda-kinetic", "cuda-naive"):
        rollout(_engine(backend).env(CFG), MAKER, 4)
    assert kc.kinetic_clearing_chunk.launches == 0
    assert nc.naive_clearing_chunk.launches == 0


# ---------------------------------------------------------------------------
# Snapshots and checkpoints, within the port and across packages.
# ---------------------------------------------------------------------------

CKPT_OBS = Composite((MarketFeatures(), StatsFeatures()))
J_CKPT_OBS = JComposite((JMarketFeatures(), JStatsFeatures()))
#: (port backend, repro backend) pairs whose states carry across.
CROSS = [("numpy-pcg64", "numpy-pcg64"), ("numpy-splitmix64",
                                          "numpy-splitmix64"),
         ("numpy", "numpy"), ("torch-scan", "numpy"),
         ("cuda-kinetic", "numpy")]


def _advance(env, state, steps, orders=ExternalOrders, t0=0):
    out = []
    for t in range(t0, t0 + steps):
        state, obs, reward, done, info = env.step(state,
                                                  _fixed_actions(t, orders))
        out.append((np.asarray(obs), np.asarray(reward)))
    return state, out


@pytest.mark.parametrize("backend", ["numpy-pcg64", "torch-scan",
                                     "cuda-kinetic", "cuda-naive"])
def test_env_checkpoint_roundtrip(backend, tmp_path):
    env = _engine(backend).env(CFG, auto_reset=False, obs=CKPT_OBS)
    state, _ = _advance(env, env.reset()[0], 4)
    manager = CheckpointManager(tmp_path, async_write=False)
    assert env.save_checkpoint(manager, state) == 4
    restored = env.restore_checkpoint(manager)
    assert restored.t == 4
    for a, b in ((state.market, restored.market),
                 (state.portfolio, restored.portfolio),
                 (state.stats, restored.stats)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # Both continuations advance alike, the PCG64 stream included.
    _, want = _advance(env, state, 4, t0=4)
    _, got = _advance(env, restored, 4, t0=4)
    for (o1, r1), (o2, r2) in zip(got, want):
        _same(o1, o2, backend)
        _same(r1, r2, backend)


@pytest.mark.parametrize("backend,jbackend", CROSS)
def test_repro_checkpoint_restores_in_the_port(backend, jbackend, tmp_path):
    jenv = _jengine(jbackend).env(JCFG, auto_reset=False, obs=J_CKPT_OBS)
    jstate, _ = _advance(jenv, jenv.reset()[0], 4, JOrders)
    jenv.save_checkpoint(JManager(tmp_path, async_write=False), jstate)
    env = _engine(backend).env(CFG, auto_reset=False, obs=CKPT_OBS)
    state = env.restore_checkpoint(CheckpointManager(tmp_path,
                                                     async_write=False))
    _same_tuple(state.market, jstate.market)
    _same_tuple(state.stats, jstate.stats)
    _, want = _advance(jenv, jstate, 4, JOrders, t0=4)
    _, got = _advance(env, state, 4, t0=4)
    for (o1, r1), (o2, r2) in zip(got, want):
        _same(o1, o2, f"{backend} obs")
        _same(r1, r2, f"{backend} reward")


@pytest.mark.parametrize("backend,jbackend", CROSS)
def test_port_checkpoint_restores_in_repro(backend, jbackend, tmp_path):
    env = _engine(backend).env(CFG, auto_reset=False, obs=CKPT_OBS)
    state, _ = _advance(env, env.reset()[0], 4)
    env.save_checkpoint(CheckpointManager(tmp_path, async_write=False), state)
    jenv = _jengine(jbackend).env(JCFG, auto_reset=False, obs=J_CKPT_OBS)
    jstate = jenv.restore_checkpoint(JManager(tmp_path, async_write=False))
    _same_tuple(state.market, jstate.market)
    assert int(np.asarray(jstate.t)) == 4
    _, want = _advance(env, state, 4, t0=4)
    _, got = _advance(jenv, jstate, 4, JOrders, t0=4)
    for (o1, r1), (o2, r2) in zip(got, want):
        _same(o1, o2, f"{backend} obs")
        _same(r1, r2, f"{backend} reward")


def test_repro_snapshot_with_runtime_seed_restores_in_the_port():
    jenv = _jengine("numpy").env(JCFG, auto_reset=False)
    jstate, _ = _advance(jenv, jenv.reset(seed=9)[0], 3, JOrders)
    env = _engine("torch-scan").env(CFG, auto_reset=False)
    state = env.restore(jenv.snapshot(jstate))
    assert state.seed == 9
    _, want = _advance(jenv, jstate, 3, JOrders, t0=3)
    _, got = _advance(env, state, 3, t0=3)
    for (o1, r1), (o2, r2) in zip(got, want):
        _same(o1, o2, "obs")
        _same(r1, r2, "reward")


def test_env_restore_rejects_static_mismatch():
    env = _engine("torch-scan").env(CFG, auto_reset=False)
    snap = env.snapshot(env.reset()[0])
    other = _engine("torch-scan").env(dataclasses.replace(CFG, seed=9),
                                      auto_reset=False)
    with pytest.raises(ValueError, match="static_seed"):
        other.restore(snap)
    with pytest.raises(ValueError, match="MarketStats"):
        _engine("torch-scan").env(CFG, obs=StatsFeatures()).restore(snap)


# ---------------------------------------------------------------------------
# Action validation and the device lowering.
# ---------------------------------------------------------------------------

_BAD_ACTIONS = [
    (ExternalOrders(True, L, 1.0), "grid"),
    (ExternalOrders(True, -1, 1.0), "grid"),
    (ExternalOrders(True, 5, -2.0), "negative"),
    (ExternalOrders(np.ones(3, bool), 5, 1.0), "market mismatch"),
    (ExternalOrders(True, np.full(7, 5), 1.0), "market mismatch"),
    (ExternalOrders(True, 5.5, 1.0), "fractional"),
    ({"side_buy": True, "price": 5}, "missing key"),
    (object(), "must be an ExternalOrders"),
]


@pytest.mark.parametrize("backend", ["numpy", "cuda-kinetic"])
@pytest.mark.parametrize("bad,match", _BAD_ACTIONS,
                         ids=[m for _, m in _BAD_ACTIONS])
def test_env_step_validates_actions_eagerly(backend, bad, match):
    env = _engine(backend).env(CFG)
    state, _ = env.reset()
    with pytest.raises(ValueError, match=match):
        env.step(state, bad)


def test_validation_covers_tensors():
    env = _engine("cuda-kinetic").env(CFG)
    state, _ = env.reset()
    side = torch.ones(M, dtype=torch.bool)
    with pytest.raises(ValueError, match="grid"):
        env.step(state, ExternalOrders(side, torch.full((M,), L),
                                       torch.ones(M)))
    with pytest.raises(ValueError, match="negative"):
        env.step(state, ExternalOrders(side, torch.full((M,), 5),
                                       torch.full((M,), -1.0)))
    with pytest.raises(ValueError, match="market mismatch"):
        env.step(state, ExternalOrders(side[:3], 5, 1.0))
    env.step(state, ExternalOrders(side, torch.full((M,), 5), torch.ones(M)))


def test_valid_action_shapes_accepted():
    env = _engine("numpy").env(CFG)
    state, _ = env.reset()
    for actions in (ExternalOrders(True, 5, 1.0),
                    ExternalOrders(np.ones(M, bool), np.full(M, 5),
                                   np.full(M, 2.0)),
                    ExternalOrders(np.ones((M, 1), bool),
                                   np.full((M, 1), 5), np.full((M, 1), 0.0)),
                    (True, 5, 1.0),
                    {"side_buy": True, "price": 5, "qty": 1.0}):
        env.step(state, actions)


def _neg_qty(obs, t):
    z = obs[:, 0] * 0.0
    return ExternalOrders(side_buy=z == 0.0, price=z + 5.0, qty=z - 5.0)


def _frac_price(obs, t):
    z = obs[:, 0] * 0.0
    return ExternalOrders(side_buy=z == 0.0, price=z + 10.6, qty=z + 1.0)


def _tick11(obs, t):
    return ExternalOrders(side_buy=True, price=11, qty=1.0)


#: Prices a policy may emit that no valid action has: each saturates.
WILD = [1e30, -np.inf, np.nan, np.inf]


def _wild_price(obs, t):
    z = obs[:, 0] * 0.0
    return ExternalOrders(side_buy=z == 0.0, price=z + torch.tensor(WILD),
                          qty=z + 1.0)


@pytest.mark.parametrize("backend", ["torch-scan", "cuda-kinetic",
                                     "cuda-naive"])
def test_rollout_sanitizes_policy_outputs(backend):
    """A rollout's policy outputs pass only the shape checks, as a traced
    rollout's do in ``repro``: a negative quantity is a no-op and a
    fractional price rounds to the nearest tick (10.6 -> 11), and a huge
    or non-finite price saturates to the grid as XLA's conversion does."""
    env = _engine(backend).env(CFG, auto_reset=False)
    f1, b1 = rollout(env, _neg_qty, 6)
    f2, b2 = rollout(env, None, 6)
    assert torch.equal(b1.price, b2.price)
    assert torch.equal(b1.volume, b2.volume)
    for leaf in f1.portfolio:
        assert (leaf == 0.0).all()
    _, b3 = rollout(env, _frac_price, 6)
    _, b4 = rollout(env, _tick11, 6)
    assert torch.equal(b3.price, b4.price)
    assert torch.equal(b3.fill_buy, b4.fill_buy)
    jenv = _jengine("jax-scan").env(JCFG, auto_reset=False)

    def j_frac(obs, t):
        z = obs[:, 0] * 0.0
        return JOrders(side_buy=z == 0.0, price=z + 10.6, qty=z + 1.0)

    _same_batch(b3, j_rollout(jenv, j_frac, 6)[1].to_numpy(), backend)

    def j_wild(obs, t):
        z = obs[:, 0] * 0.0
        return JOrders(side_buy=z == 0.0, price=z + jnp.asarray(WILD,
                                                                jnp.float32),
                       qty=z + 1.0)

    _, b5 = rollout(env, _wild_price, 6)
    assert b5.fill_buy.sum() > 0, "no saturated order filled"
    _same_batch(b5, j_rollout(jenv, j_wild, 6)[1].to_numpy(), backend)


def test_numpy_rollout_validates_every_step():
    """On the numpy family a rollout checks values as ``repro``'s host loop
    does, so an off-grid policy output raises."""
    with pytest.raises(ValueError, match="fractional"):
        rollout(_engine("numpy").env(CFG), _frac_price, 3)


@pytest.mark.parametrize("seed", range(4))
def test_device_lowering_equals_host_lowering(seed):
    """Host operands (as ``validate_actions`` returns them) and tensor
    operands lower to the same bits as ``repro``'s lowering under XLA:
    round half to even, clip (a huge or non-finite price saturates, NaN to
    tick 0), clamp the lots at 0."""
    rng = np.random.default_rng(seed)
    n = 64
    side = rng.random(n) < 0.5
    price = np.round(rng.uniform(-3, L + 3, n) * 2) / 2  # halves included
    price[:6] = [1e30, -1e30, np.inf, -np.inf, np.nan, 3e9]
    price = rng.permutation(price)
    qty = np.round(rng.uniform(-2, 6, n)).astype(np.float32)
    want = j_lower_actions(JOrders(side, price, qty), n, L, jnp)
    host = lower_actions(ExternalOrders(side, price, qty), n, L, "cpu")
    dev = lower_actions(ExternalOrders(torch.from_numpy(side),
                                       torch.from_numpy(price),
                                       torch.from_numpy(qty)), n, L, "cpu")
    for w, h, d in zip(want, host, dev):
        assert torch.equal(h, d) and d.dtype == torch.float32
        _same(d.numpy(), np.asarray(w))
    finite = np.where(np.isfinite(price), np.clip(price, -9, L + 9), 0.0)
    int_dev = lower_actions(ExternalOrders(
        torch.from_numpy(side), torch.from_numpy(np.rint(finite))
        .to(torch.int32), torch.from_numpy(qty)), n, L, "cpu")
    for w, d in zip(j_lower_actions(JOrders(side, finite, qty), n, L, jnp),
                    int_dev):
        _same(d.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# Observations, rewards and what the env refuses.
# ---------------------------------------------------------------------------

def test_observation_specs_shapes_and_composition():
    obs_spec = Composite((MarketFeatures(), BookWindow(depth=3),
                          PortfolioFeatures(), StatsFeatures()))
    env = _engine("cuda-kinetic").env(CFG, obs=obs_spec)
    assert env.obs_size() == 5 + 12 + 3 + 6
    state, obs = env.reset()
    assert obs.shape == (M, env.obs_size()) and obs.dtype == torch.float32
    assert state.stats is not None
    state, obs, reward, done, info = env.step(state)
    assert obs.shape == (M, env.obs_size()) and reward.shape == (M,)
    assert (state.stats.count == 1.0).all()
    state, _ = _engine("cuda-kinetic").env(CFG, obs=MarketFeatures()).reset()
    assert state.stats is None


def test_fills_and_rewards_account_consistently():
    env = _engine("numpy").env(
        CFG, auto_reset=False,
        reward=Sum((PnLReward(), SpreadCapture(), InventoryPenalty(0.5)),
                   (1.0, 0.0, 0.0)))
    state, _ = env.reset()
    for _ in range(6):
        state, obs, reward, done, info = env.step(
            state, ExternalOrders(True, L - 1, 3.0))
    inv = state.portfolio.inventory
    assert (inv >= 0).all() and inv.sum() > 0, "marketable buys never filled"
    assert torch.equal(state.portfolio.equity,
                       state.portfolio.cash + inv * state.last_out.mid)
    with pytest.raises(ValueError, match="weights"):
        Sum((PnLReward(),), (1.0, 2.0))


def test_stats_only_engine_rejected():
    with pytest.raises(ValueError, match="stats_only"):
        Engine("torch-scan", device="cpu", stats_only=True).env(CFG)
    with pytest.raises(ValueError, match="stats_only"):
        JEngine("jax-scan", stats_only=True).env(JCFG)


def test_sequential_clearing_rejected():
    with pytest.raises(ValueError, match="env step core"):
        Engine("numpy", device="cpu", clearing="sequential").env(CFG)
    with pytest.raises(ValueError, match="env step core"):
        JEngine("numpy", clearing="sequential").env(JCFG)


def test_env_of_a_card_backend_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        Engine("cuda-kinetic").env(CFG)
    with pytest.raises(RuntimeError, match="cuda"):
        MarketEnv(CFG)
    with pytest.raises(ValueError, match="engine="):
        MarketEnv(CFG, engine=_engine("torch-scan"), device="cpu")


# ---------------------------------------------------------------------------
# The rollout's body, which a CUDA graph captures on one card.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["cuda-kinetic", "cuda-naive",
                                     "torch-scan"])
def test_rollout_body_equals_repro_with_carry_and_auto_reset(backend):
    """The body a graph captures, run eagerly: a carried policy across two
    auto-resets (horizon 7, 20 steps) equals ``repro``'s env, its done
    flags included."""
    from repro_torch.env.core import _rollout_body

    env = _engine(backend).env(CFG, obs=OBS, reward=REWARD, horizon=7)
    jenv = _jengine("numpy").env(JCFG, obs=J_OBS, reward=J_REWARD, horizon=7)
    state, _ = env.reset()
    final, batch, dones, carry = _rollout_body(
        env, _carried(False), 20, True, state, (0, np.float32(L / 2)))
    jfinal, jbatch, jcarry = j_rollout(
        jenv, _carried(True), 20,
        policy_carry=(np.int32(0), np.float32(L / 2)))
    jb = jbatch.to_numpy()
    _same_batch(batch._replace(done=torch.tensor(dones)), jb, backend)
    assert dones == [bool(d) for d in jb.done]
    assert sum(dones) == 2 and final.t == int(jfinal.t) == 6
    _same_tuple(final.market, jfinal.market, "market")
    _same_tuple(final.portfolio, jfinal.portfolio, "portfolio")
    assert carry[0] == int(np.asarray(jcarry[0])) == 20
    _same(batch.extras["mid"].numpy(), np.asarray(jbatch.extras["mid"]))


@pytest.mark.parametrize("backend", ["cuda-kinetic", "cuda-naive",
                                     "torch-scan"])
def test_rollout_leaves_its_state_unchanged(backend):
    """A rollout never writes the state it starts from: several rollouts
    from one state give the same batch."""
    env = _engine(backend).env(CFG, obs=OBS, reward=REWARD, horizon=7)
    state0, _ = env.reset()
    before = [x.clone() for x in _tensor_leaves(state0)]
    _, first = rollout(env, MAKER, 10, state=state0)
    _, again = rollout(env, MAKER, 10, state=state0)
    for got, want in zip(_tensor_leaves(state0), before):
        assert torch.equal(got, want)
    _same_batch(again, first.to_numpy(), backend)


def _tensor_leaves(tree):
    from repro_torch.core import graphs

    return graphs.flatten(tree)[0]


class _CpuGraph:
    """A CPU stand-in for a captured graph, with the real one's contract:
    static input buffers filled by copy, the outputs' Python leaves those
    of the capture (checked against a rerun of the body on the buffers),
    clones returned."""

    def __init__(self, body, tree, out):
        from repro_torch.core import graphs

        leaves, self.structure = graphs.flatten(tree)
        self.static = [x.clone() for x in leaves]
        self.body = body
        self.out_structure = graphs.flatten(out)[1]
        self.replays = 0

    def __call__(self, tree):
        from repro_torch.core import graphs

        for dst, src in zip(self.static, graphs.flatten(tree)[0]):
            dst.copy_(src)
        out, structure = graphs.flatten(
            self.body(graphs.unflatten(self.structure, self.static)))
        assert structure == self.out_structure
        self.replays += 1
        return graphs.unflatten(structure, [x.clone() for x in out])


@pytest.fixture
def cpu_graphs(monkeypatch):
    """``graphs.capture`` replaced by :class:`_CpuGraph`: the engine's cache,
    keys and counts run on the CPU."""
    from repro_torch.core import graphs

    made = []

    def capture(what, body, tree, device):
        out = body(tree)
        made.append(_CpuGraph(body, tree, out))
        return out, made[-1]

    monkeypatch.setattr(graphs, "capture", capture)
    return made


@pytest.mark.parametrize("backend", ["cuda-kinetic", "cuda-naive",
                                     "torch-scan"])
def test_graph_path_keys_captures_and_replays(backend, cpu_graphs):
    """The graph path's wiring: a rollout's first call of a key captures
    (one ``trace_count``), a warm call replays and equals the host loop, a
    new cursor or length is a new key, the replays' outputs are fresh
    tensors, and ``clear_cache`` drops the graphs."""
    eng = Engine(backend, device="cpu")
    env = eng.env(CFG, obs=OBS, reward=REWARD, horizon=7)
    state0, _ = env.reset()
    _, want = rollout(env, MAKER, 10, state=state0)
    env._graphed = True
    builds = eng.trace_count
    first = rollout(env, MAKER, 10, state=state0)
    warm = rollout(env, MAKER, 10, state=state0)
    assert eng.trace_count == builds + 1 and len(cpu_graphs) == 1
    assert cpu_graphs[0].replays == 1
    for got in (first, warm):
        _same_batch(got[1], want.to_numpy(), backend)
        assert got[0].t == 3
    assert warm[1].obs.data_ptr() != first[1].obs.data_ptr()
    rollout(env, MAKER, 10, state=first[0])      # t0 = 3: another key
    rollout(env, MAKER, 11, state=state0)        # another length
    rollout(env, None, 10, state=state0)         # another policy
    assert eng.trace_count == builds + 4 == builds + len(eng.graph_keys())
    eng.clear_cache()
    assert eng.graph_keys() == []


def test_host_loop_where_the_runner_says_so():
    """The graph path is the runner's call: the CPU (the numpy family runs
    nowhere else) and a mesh keep the host loop; a card's runner of one
    shard takes graphs."""
    from repro_torch.launch import set_host_device_count

    for backend in ("torch-scan", "cuda-kinetic", "numpy"):
        assert not _engine(backend).env(CFG)._graphed
    runner = Engine("cuda-kinetic", device="cpu").env(CFG)._runner
    old = set_host_device_count(2)
    try:
        mesh_runner = Engine("cuda-kinetic", device="cpu",
                             devices=2).env(CFG)._runner
    finally:
        set_host_device_count(old)
    for r in (runner, mesh_runner):
        r.device = torch.device("cuda", 0)   # as on a card
    assert runner.graphable and not mesh_runner.graphable
