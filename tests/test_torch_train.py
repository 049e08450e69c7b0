"""The port's PPO trainer (``repro_torch.train``) against the JAX package's
``repro.train``, on the CPU.

What equals ``repro`` with ``==``: the scripted policies, the quote grid,
the env states a trainer carries, and a trainer checkpoint in either
direction. GAE equals ``repro``'s expressions evaluated one rounding at a
time; ``repro``'s ``jax-scan`` GAE differs from that only by XLA's fused
multiply-adds (ROADMAP Queue 3). What matches within a stated tolerance, on
params carried across by ``actor_critic_from_numpy``: the MLP, the loss,
its gradients (autodiff and reduction order differ) and Adam. The init and
the draws (``torch.Generator`` and the counter hash against
``jax.random``) cannot match; the tests check their properties instead and
hold the port's trainers against each other bit for bit.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.params import EnsembleSpec as JSpec
from repro.core.session import Engine as JEngine
from repro.env import InventoryPenalty as JInventoryPenalty
from repro.env import MarketFeatures as JMarketFeatures
from repro.env import SpreadCapture as JSpreadCapture
from repro.env import Sum as JSum
from repro.train import buffers as jbuffers
from repro.train import policies as jpolicies
from repro.train import ppo as jppo
from repro.train.loop import restore_train_checkpoint as j_restore
from repro.train.loop import save_train_checkpoint as j_save
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import actor_critic_from_numpy, actor_critic_to_numpy
from repro_torch.core.config import MarketConfig
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine
from repro_torch.env import (InventoryPenalty, MarketFeatures, SpreadCapture,
                             Sum, rollout)
from repro_torch.train import (ActorCritic, PPOConfig, PPOTrainer, QuoteGrid,
                               adam_apply, adam_init, apply_actor_critic,
                               fit, gae, init_actor_critic,
                               make_market_maker, make_random_policy,
                               ppo_loss, restore_train_checkpoint,
                               save_train_checkpoint)
from repro_torch.train import buffers
from repro_torch.train.policies import logits_entropy, logits_log_prob
from repro_torch.train.ppo import loss_and_grads

L = 16
SHAPE = dict(num_agents=16, num_levels=L, num_steps=12, seed=3)
#: tiny-but-real config of ``tests/test_train.py``: 2 seed-envs.
SMOKE = PPOConfig(rollout_len=8, num_updates=2, num_envs=2, num_epochs=2,
                  num_minibatches=4, hidden=(16,), seed=0)
ONE_ENV = dataclasses.replace(SMOKE, num_envs=1)
REWARD = Sum((SpreadCapture(), InventoryPenalty(0.001)))
J_REWARD = JSum((JSpreadCapture(), JInventoryPenalty(0.001)))
LOSS_KW = dict(clip_eps=0.2, vf_coef=0.5, ent_coef=0.01)


def _mixture(scenarios=("flash-crash", "high-vol"), cls=EnsembleSpec):
    return cls.from_scenarios(list(scenarios), num_markets=2, **SHAPE)


def _trainer(backend="torch-scan", cfg=SMOKE, spec=None, engine=None):
    eng = engine or Engine(backend, device="cpu")
    env = eng.env(spec if spec is not None else _mixture(), reward=REWARD,
                  obs=MarketFeatures())
    return eng, PPOTrainer(env, cfg)


def _j_trainer(cfg=SMOKE):
    env = JEngine("jax-scan").env(_mixture(cls=JSpec), reward=J_REWARD,
                                  obs=JMarketFeatures())
    return jppo.PPOTrainer(env, jppo.PPOConfig(**dataclasses.asdict(cfg)))


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _flat(tree, prefix=""):
    """{path: array} of a tree of dicts, tuples and arrays."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/#{i}"))
        return out
    return {prefix: _host(tree)}


def _same_tree(got, want, ctx=""):
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys(), (ctx, sorted(g), sorted(w))
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, \
            (ctx, k, g[k].dtype, w[k].dtype, g[k].shape, w[k].shape)
        bad = np.argwhere(g[k] != w[k])
        assert bad.size == 0, f"{ctx}{k}: first difference at {bad[0]}"


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale) \
        .astype(np.float32)


# ---------------------------------------------------------------------------
# Scripted policies and the quote grid: == repro.
# ---------------------------------------------------------------------------

def _obs(seed, M=64):
    obs = _rand(seed, M, 5)
    obs[:, 0] = np.random.default_rng(seed).uniform(-3.0, L + 3.0, M)
    obs[:8, 0] = [0.5, 1.5, 2.5, -0.5, L - 1.5, L - 0.5, 7.0, 7.5]
    return obs


def _same_orders(got, want):
    for f in ("side_buy", "price", "qty"):
        g, w = _host(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.shape == w.shape and (g == w).all(), f


@pytest.mark.parametrize("t", [0, 1, 2, 7])
@pytest.mark.parametrize("policy", ["maker", "random"])
def test_scripted_policies_equal_repro(policy, t):
    make, jmake = {"maker": (make_market_maker, jpolicies.make_market_maker),
                   "random": (make_random_policy,
                              jpolicies.make_random_policy)}[policy]
    obs = _obs(t)
    _same_orders(make(L)(torch.from_numpy(obs), t), jmake(L)(obs, t))
    # the traced path: jnp obs and a step array, as in repro's rollouts
    _same_orders(make(L)(torch.from_numpy(obs), t),
                 jmake(L)(jnp.asarray(obs), jnp.int32(t)))


@pytest.mark.parametrize("k_max,qty", [(1, 1.0), (3, 1.0), (5, 2.5)])
def test_quote_grid_equals_repro(k_max, qty):
    grid, jgrid = QuoteGrid(k_max, qty), jpolicies.QuoteGrid(k_max, qty)
    assert grid.num_actions == jgrid.num_actions
    mid = np.repeat(_obs(k_max)[:, 0], grid.num_actions)
    action = np.tile(np.arange(grid.num_actions, dtype=np.int32), 64)
    _same_orders(grid.to_orders(torch.from_numpy(action),
                                torch.from_numpy(mid), L),
                 jgrid.to_orders(action, mid, L))


# ---------------------------------------------------------------------------
# GAE.
# ---------------------------------------------------------------------------

def _gae_inputs(T, M, seed):
    rs = np.random.default_rng(seed)
    done = (rs.random((T, 1)) < 0.2).astype(np.float32)
    return (_rand(seed, T, M), _rand(seed + 1, T, M),
            np.broadcast_to(done, (T, M)).copy(), _rand(seed + 2, M))


def _gae_numpy(r, v, d, lv, gamma, lam, fused=False):
    """``repro``'s GAE step by step in numpy: one rounding per operation,
    or (``fused``) with XLA's two fused multiply-adds a step."""
    g, gl = np.float32(gamma), np.float32(gamma * lam)
    acc, next_value, adv = np.zeros_like(lv), lv, [None] * len(r)
    for t in reversed(range(len(r))):
        nonterm = np.float32(1.0) - d[t]
        if fused:  # exact product in float64, one rounding of the sum
            delta = (np.float64(g * next_value) * nonterm + r[t]) \
                .astype(np.float32) - v[t]
            acc = (np.float64(gl * nonterm) * acc + delta) \
                .astype(np.float32)
        else:
            delta = r[t] + g * next_value * nonterm - v[t]
            acc = delta + gl * nonterm * acc
        adv[t] = acc
        next_value = v[t]
    adv = np.stack(adv)
    return adv, adv + v


@pytest.mark.parametrize("T,M,seed", [(1, 3, 0), (16, 4, 1), (64, 33, 2)])
def test_gae_equals_repro_expressions(T, M, seed):
    r, v, d, lv = _gae_inputs(T, M, seed)
    adv, ret = gae(*(torch.from_numpy(x) for x in (r, v, d, lv)), 0.99, 0.95)
    want_adv, want_ret = _gae_numpy(r, v, d, lv, 0.99, 0.95)
    assert (adv.numpy() == want_adv).all() and (ret.numpy() == want_ret).all()
    # repro's jax-scan GAE is the same recursion with XLA's fused
    # multiply-adds, bit for bit; the port stays within float32 rounding.
    j_adv, j_ret = (np.asarray(x) for x in jbuffers.gae(
        *(jnp.asarray(x) for x in (r, v, d, lv)), 0.99, 0.95))
    fused_adv, fused_ret = _gae_numpy(r, v, d, lv, 0.99, 0.95, fused=True)
    assert (j_adv == fused_adv).all() and (j_ret == fused_ret).all()
    np.testing.assert_allclose(adv.numpy(), j_adv, rtol=1e-5, atol=1e-5)


def test_minibatch_indices_are_a_pure_permutation():
    idx = buffers.minibatch_indices(12345, 96, 4, update=3, epoch=1)
    assert idx.shape == (4, 24) and idx.dtype == torch.int64
    assert sorted(idx.flatten().tolist()) == list(range(96))
    assert torch.equal(idx, buffers.minibatch_indices(12345, 96, 4,
                                                      update=3, epoch=1))
    for other in (dict(update=4, epoch=1), dict(update=3, epoch=0)):
        assert not torch.equal(idx, buffers.minibatch_indices(
            12345, 96, 4, **other))


# ---------------------------------------------------------------------------
# The MLP, the loss, gradients and Adam on params carried from repro.
# ---------------------------------------------------------------------------

def _j_params(seed, hidden, obs_dim=5, num_actions=7, head_scale=1.0):
    """``repro``'s init, with the policy head scaled up so that logits
    (and the loss's ratio and clip terms) are far from 0."""
    p = jpolicies.init_actor_critic(seed, obs_dim, num_actions, hidden)
    p = jax.tree_util.tree_map(np.asarray, p)
    p["pi"] = (p["pi"][0] * np.float32(head_scale), p["pi"][1])
    return p


def _batch(seed, N, num_actions=7, obs_dim=5):
    rs = np.random.default_rng(seed)
    return dict(obs=_rand(seed, N, obs_dim),
                action=rs.integers(0, num_actions, N).astype(np.int32),
                log_prob=np.log(rs.uniform(0.05, 0.3, N)).astype(np.float32),
                value=_rand(seed + 1, N),
                adv=_rand(seed + 2, N, scale=2.0),
                ret=_rand(seed + 3, N))


def _close(got, want, rtol, atol, ctx=""):
    np.testing.assert_allclose(_host(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=ctx)


@pytest.mark.parametrize("hidden", [(16,), (32, 32)])
def test_actor_critic_matches_repro(hidden):
    jp = _j_params(1, hidden, head_scale=100.0)
    params = actor_critic_from_numpy(jp, "cpu")
    obs = _rand(2, 3, 10, 5)  # leading dims [3, 10]
    logits, value = apply_actor_critic(params, torch.from_numpy(obs))
    j_logits, j_value = jpolicies.apply_actor_critic(jp, jnp.asarray(obs))
    _close(logits, j_logits, 1e-5, 1e-6, "logits")
    _close(value, j_value, 1e-5, 1e-6, "value")
    m_logits, m_value = ActorCritic(params)(torch.from_numpy(obs))
    assert torch.equal(m_logits, logits) and torch.equal(m_value, value)
    action = np.random.default_rng(3).integers(0, 7, (3, 10)).astype(np.int32)
    _close(logits_log_prob(logits, torch.from_numpy(action)),
           jpolicies.logits_log_prob(j_logits, jnp.asarray(action)),
           1e-5, 1e-6, "log_prob")
    _close(logits_entropy(logits), jpolicies.logits_entropy(j_logits),
           1e-5, 1e-6, "entropy")


@pytest.mark.parametrize("seed", [0, 1])
def test_ppo_loss_and_gradients_match_repro(seed):
    jp = _j_params(seed, (16, 16), head_scale=30.0)
    mb = _batch(seed, 256)
    params = actor_critic_from_numpy(jp, "cpu")
    tmb = buffers.TrainBatch(**{k: torch.from_numpy(v) for k, v in mb.items()})
    jmb = jbuffers.TrainBatch(**{k: jnp.asarray(v) for k, v in mb.items()})
    total, aux = ppo_loss(params, tmb, **LOSS_KW)
    j_total, j_aux = jppo.ppo_loss(jp, jmb, **LOSS_KW)
    _close(total, j_total, 1e-5, 1e-6, "total")
    for k in j_aux:
        _close(aux[k], j_aux[k], 1e-5, 1e-6, k)
    assert 0.0 < float(aux["approx_kl"])  # the ratio is far from 1
    (g_total, g_aux), grads = loss_and_grads(params, tmb, **LOSS_KW)
    (jg_total, _), j_grads = jax.value_and_grad(
        lambda p: jppo.ppo_loss(p, jmb, **LOSS_KW), has_aux=True)(jp)
    assert torch.equal(g_total, total)
    _close(g_total, jg_total, 1e-5, 1e-6, "value_and_grad")
    g, w = _flat(grads), _flat(jax.tree_util.tree_map(np.asarray, j_grads))
    assert g.keys() == w.keys()
    for k in w:
        _close(g[k], w[k], 1e-4, 1e-6, f"grad {k}")


def _grads(like, seed, dyadic):
    """Gradients shaped like ``like``: normal draws, or multiples of 1/4 in
    [-2, 2], whose squares sum exactly in float32 in any order."""
    if not dyadic:
        return _rand(seed, *like.shape, scale=3.0)
    rs = np.random.default_rng(seed)
    return (rs.integers(-8, 9, like.shape) * 0.25).astype(np.float32)


@pytest.mark.parametrize("max_grad_norm,dyadic", [
    (None, False), (1e6, False), (None, True), (0.5, True), (1e-3, True)])
def test_adam_apply_matches_repro(max_grad_norm, dyadic):
    """Three Adam steps from zero moments, the clip inactive (None, 1e6)
    and active (0.5, 1e-3), at ``rtol=1e-6, atol=0``.

    The clipped cases take gradients whose global norm is exact in float32:
    the per-leaf sums of squares of normal draws can differ in the last bit
    between XLA's and torch's reduction orders, and a new moment or weight
    that is the difference of two near-equal terms then differs by more
    than 1e-6 of itself (ROADMAP Queue 3)."""
    jp = _j_params(4, (16,))
    params = actor_critic_from_numpy(jp, "cpu")
    state, j_state = adam_init(params), jppo.adam_init(jp)
    for step in range(3):
        jg = jax.tree_util.tree_map(
            lambda x: _grads(x, 10 * step + x.size, dyadic), jp)
        grads = actor_critic_from_numpy(jg, "cpu")
        params, state = adam_apply(params, grads, state, lr=1e-3,
                                   max_grad_norm=max_grad_norm)
        jp, j_state = jppo.adam_apply(jp, jg, j_state, lr=1e-3,
                                      max_grad_norm=max_grad_norm)
        for name, got, want in (("params", params, jp),
                                ("mu", state.mu, j_state.mu),
                                ("nu", state.nu, j_state.nu)):
            g = _flat(got)
            for k, w in _flat(jax.tree_util.tree_map(np.asarray,
                                                     want)).items():
                _close(g[k], w, 1e-6, 0, f"step {step} {name} {k}")
        assert int(state.count) == int(j_state.count) == step + 1
    if max_grad_norm is not None and max_grad_norm < 1e3:
        sq = sum(float(np.sum(np.square(x.astype(np.float64))))
                 for x in _flat(jg).values())
        assert np.sqrt(sq) > max_grad_norm  # the clip was active


@pytest.mark.parametrize("hidden", [(16,), (32, 32), (8, 64, 4)])
def test_init_structure_orthogonality_and_seed(hidden):
    params = init_actor_critic(7, 5, 7, hidden, device="cpu")
    want = jax.tree_util.tree_map(np.asarray, jpolicies.init_actor_critic(
        7, 5, 7, hidden))
    g, w = _flat(params), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, k
    layers = list(params["torso"]) + [params["pi"], params["v"]]
    scales = [np.sqrt(2.0)] * len(hidden) + [0.01, 1.0]
    for (wt, b), scale in zip(layers, scales):
        wt = wt.double()
        gram = wt.T @ wt if wt.shape[0] >= wt.shape[1] else wt @ wt.T
        eye = torch.eye(gram.shape[0], dtype=torch.float64)
        assert torch.allclose(gram, scale ** 2 * eye, atol=1e-5 * scale ** 2)
        assert not b.any()
    _same_tree(init_actor_critic(7, 5, 7, hidden, device="cpu"), params)
    assert not torch.equal(init_actor_critic(8, 5, 7, hidden,
                                             device="cpu")["pi"][0],
                           params["pi"][0])


def test_params_round_trip_through_numpy():
    jp = _j_params(5, (32, 32))
    _same_tree(actor_critic_to_numpy(actor_critic_from_numpy(jp, "cpu")),
               jp)


# ---------------------------------------------------------------------------
# Trainer checkpoints across the two packages.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def j_trained(tmp_path_factory):
    """A ``repro`` ``jax-scan`` trainer after 2 updates, saved."""
    jtr = _j_trainer()
    jts, _ = jtr.train(jtr.init(), 2)
    ckpt = tmp_path_factory.mktemp("j_train")
    j_save(JManager(ckpt, async_write=False), jtr, jts)
    return jtr, jts, ckpt


def _checkpoint(path):
    return CheckpointManager(path, async_write=False).restore()


def _same_checkpoints(got, want):
    """Every leaf equal; meta leaves equal as JSON."""
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        if w[k].dtype.kind == "U":
            assert json.loads(str(g[k])) == json.loads(str(w[k])), k
        else:
            assert g[k].dtype == w[k].dtype and (g[k] == w[k]).all(), k


def _logit_gap(params, obs):
    """The smallest top-2 logit gap over the rows of ``obs``."""
    logits, _ = jpolicies.apply_actor_critic(params, jnp.asarray(obs))
    top = np.sort(np.asarray(logits).reshape(-1, logits.shape[-1]), -1)
    return float((top[:, -1] - top[:, -2]).min())


def _same_greedy(tr, params, jtr, jparams):
    j_batch = jtr.evaluate(jparams, n_steps=8).to_numpy()
    assert _logit_gap(jparams, j_batch.obs) > 1e-4
    batch = tr.evaluate(params, n_steps=8).to_numpy()
    for f in ("obs", "reward", "done", "price", "volume"):
        assert (getattr(batch, f) == getattr(j_batch, f)).all(), f
    assert (batch.extras["action"] == j_batch.extras["action"]).all()


def test_repro_checkpoint_restores_in_the_port(j_trained, tmp_path):
    jtr, jts, ckpt = j_trained
    _, tr = _trainer()
    ts = restore_train_checkpoint(CheckpointManager(ckpt), tr)
    assert ts.update_idx == int(jts.update_idx) == 2
    _same_tree(ts.params, jax.tree_util.tree_map(np.asarray, jts.params))
    _same_tree(ts.opt_state, jax.tree_util.tree_map(np.asarray,
                                                    jts.opt_state))
    assert (ts.key.numpy() == np.asarray(jts.key)).all()
    # re-saved by the port, every leaf (each env's included) is repro's
    save_train_checkpoint(CheckpointManager(tmp_path, async_write=False),
                          tr, ts)
    _same_checkpoints(_checkpoint(tmp_path), _checkpoint(ckpt))
    _same_greedy(tr, ts.params, jtr, jts.params)
    ts, metrics = tr.train(ts, 1)  # and training continues from it
    assert ts.update_idx == 3 and np.isfinite(_host(metrics["loss"])).all()


def test_port_checkpoint_restores_in_repro(j_trained, tmp_path):
    jtr = j_trained[0]
    _, tr = _trainer()
    ts, _ = tr.train(tr.init(), 2)
    save_train_checkpoint(CheckpointManager(tmp_path / "port",
                                            async_write=False), tr, ts)
    jts = j_restore(JManager(tmp_path / "port"), jtr)
    assert int(jts.update_idx) == ts.update_idx == 2
    _same_tree(ts.params, jax.tree_util.tree_map(np.asarray, jts.params))
    _same_tree(ts.opt_state, jax.tree_util.tree_map(np.asarray,
                                                    jts.opt_state))
    j_save(JManager(tmp_path / "repro", async_write=False), jtr, jts)
    _same_checkpoints(_checkpoint(tmp_path / "repro"),
                      _checkpoint(tmp_path / "port"))
    _same_greedy(tr, ts.params, jtr, jts.params)


# ---------------------------------------------------------------------------
# The trainer (mirroring tests/test_train.py).
# ---------------------------------------------------------------------------

def test_train_builds_nothing_across_spans_and_mixtures():
    eng, tr = _trainer()
    ts, metrics = tr.train(tr.init(), 2)
    warm = eng.trace_count
    ts, _ = tr.train(ts, 2)
    ts, metrics = tr.train(ts, 2)
    _, tr_b = _trainer(spec=_mixture(("flash-crash", "flash-crash")),
                       engine=eng)
    tr_b.train(tr_b.init(), 2)
    assert eng.trace_count == warm, (eng.trace_count, warm)
    for k in ("reward", "loss", "pg_loss", "v_loss", "entropy",
              "approx_kl", "value"):
        v = _host(metrics[k])
        assert v.shape == (2,) and np.isfinite(v).all(), k
    assert ts.update_idx == 6 and int(ts.opt_state.count) == 6 * 2 * 4


def test_train_updates_move_params():
    _, tr = _trainer()
    ts0 = tr.init()
    ts1, _ = tr.train(ts0, 2)
    for a, b in zip(buffers.tree_leaves(ts0.params),
                    buffers.tree_leaves(ts1.params)):
        assert not torch.equal(a, b)


def test_engine_trainer_sugar():
    eng = Engine("torch-scan", device="cpu")
    tr = eng.trainer(_mixture(), SMOKE, reward=REWARD, obs=MarketFeatures())
    assert tr.device.type == "cpu" and tr.env.engine is eng
    _, metrics = tr.train(tr.init(), 2)
    assert metrics["reward"].shape == (2,)
    assert isinstance(Engine("torch-scan", device="cpu").trainer(_mixture())
                      .config, PPOConfig)


@pytest.mark.parametrize("backend", ["cuda-kinetic", "cuda-naive"])
def test_num_envs_rejected_on_spec_seeded_backend(backend):
    env = Engine(backend, device="cpu").env(_mixture(), reward=REWARD)
    with pytest.raises(ValueError, match="seed"):
        PPOTrainer(env, SMOKE)  # SMOKE has num_envs=2
    PPOTrainer(env, ONE_ENV)


@pytest.mark.parametrize("backend", ["numpy", "numpy-splitmix64",
                                     "numpy-pcg64"])
def test_host_backend_rejected(backend):
    cfg = MarketConfig(num_markets=4, **SHAPE)
    env = Engine(backend, device="cpu").env(cfg, reward=REWARD)
    with pytest.raises(ValueError, match="traceable"):
        PPOTrainer(env, ONE_ENV)


def test_minibatch_divisibility_checked():
    env = Engine("torch-scan", device="cpu").env(_mixture())
    with pytest.raises(ValueError, match="num_minibatches"):
        PPOTrainer(env, dataclasses.replace(SMOKE, num_minibatches=7))


@pytest.mark.parametrize("backend,cfg", [("torch-scan", SMOKE),
                                         ("cuda-kinetic", ONE_ENV)])
def test_checkpoint_resume_bitwise_continues_curve(backend, cfg, tmp_path):
    _, tr = _trainer(backend, cfg)
    ts_a, _ = tr.train(tr.init(), 2)
    ts_a, m_a = tr.train(ts_a, 2)
    ts_b, _ = tr.train(tr.init(), 2)
    step = save_train_checkpoint(CheckpointManager(tmp_path,
                                                   async_write=False), tr,
                                 ts_b)
    assert step == 2
    _, fresh = _trainer(backend, cfg)
    ts_r = restore_train_checkpoint(CheckpointManager(tmp_path), fresh)
    ts_b, m_b = fresh.train(ts_r, 2)
    _same_tree(ts_b.params, ts_a.params)
    _same_tree(ts_b.opt_state, ts_a.opt_state)
    _same_tree(m_b, m_a)
    assert torch.equal(ts_b.key, ts_a.key) and ts_b.update_idx == 4
    _same_checkpoints(
        _flat(fresh.env.snapshot(ts_b.env_state) if cfg.num_envs == 1 else
              [fresh.env.snapshot(s) for s in ts_b.env_state]),
        _flat(tr.env.snapshot(ts_a.env_state) if cfg.num_envs == 1 else
              [tr.env.snapshot(s) for s in ts_a.env_state]))


def test_fit_spans_threshold_and_checkpoints(tmp_path):
    _, tr = _trainer()
    mgr = CheckpointManager(tmp_path, async_write=False)
    out = fit(tr, total_updates=4, updates_per_call=2,
              ckpt_manager=mgr, ckpt_every=2)
    assert out["updates"] == 4
    assert out["history"]["reward"].shape == (4,)
    assert out["env_steps"] == 4 * SMOKE.rollout_len * SMOKE.num_envs * 4
    assert out["env_steps_per_s"] > 0
    assert mgr.steps() == [2, 4]
    restored = restore_train_checkpoint(mgr, tr)
    _same_tree(restored.params, out["ts"].params)
    out2 = fit(tr, total_updates=4, updates_per_call=2,
               reward_threshold=-1e9)
    assert out2["updates"] == 2 and out2["time_to_threshold"] is not None
    with pytest.raises(ValueError, match="divide"):
        fit(tr, total_updates=5, updates_per_call=2)


def test_evaluate_greedy_and_scripted_baseline():
    eng, tr = _trainer()
    ts = tr.init()
    batch = tr.evaluate(ts.params, n_steps=8)
    assert batch.reward.shape == (8, 4)
    assert torch.isfinite(batch.reward).all()
    assert batch.extras["action"].dtype == torch.int32
    held_out = eng.env(_mixture(("baseline", "thin-book")), reward=REWARD,
                       obs=MarketFeatures())
    warm = eng.trace_count
    tr.evaluate(ts.params, env=held_out, n_steps=8)
    assert eng.trace_count == warm
    _, b = rollout(held_out, make_market_maker(L), 8)
    assert torch.isfinite(b.reward).all()


def test_kernel_backends_train_as_torch_scan():
    """``cuda-kinetic`` and ``cuda-naive`` (their kernels' plain versions
    here) train bit for bit as ``torch-scan``: params, moments, key,
    metrics and the final env state."""
    runs = {}
    for backend in ("cuda-kinetic", "cuda-naive", "torch-scan"):
        _, tr = _trainer(backend, ONE_ENV)
        ts, metrics = tr.train(tr.init(), 2)
        runs[backend] = (ts, metrics, tr.env.snapshot(ts.env_state))
    ts, metrics, snap = runs["torch-scan"]
    for backend in ("cuda-kinetic", "cuda-naive"):
        got_ts, got_m, got_snap = runs[backend]
        _same_tree(got_ts.params, ts.params, backend)
        _same_tree(got_ts.opt_state, ts.opt_state, backend)
        _same_tree(got_m, metrics, backend)
        _same_checkpoints(_flat(got_snap), _flat(snap))
        assert torch.equal(got_ts.key, ts.key)


def test_sampling_follows_the_key_and_update():
    """The draws are a pure function of (key, update): the same state trains
    the same way twice, another seed or update index differently."""
    _, tr = _trainer("torch-scan", ONE_ENV)
    ts = tr.init()
    _, batch_a = tr.collect(ts)
    _, batch_b = tr.collect(ts)
    assert torch.equal(batch_a.extras.action, batch_b.extras.action)
    _, batch_c = tr.collect(ts._replace(update_idx=1))
    _, batch_d = tr.collect(tr.init(seed=1)._replace(params=ts.params))
    assert not torch.equal(batch_a.extras.action, batch_c.extras.action)
    assert not torch.equal(batch_a.extras.action, batch_d.extras.action)
    counts = torch.bincount(batch_a.extras.action.flatten().long(),
                            minlength=tr.num_actions)
    assert (counts > 0).all()  # near-uniform logits: every action drawn


# ---------------------------------------------------------------------------
# The update as one CUDA graph: its counter, its keys, its wiring.
# ---------------------------------------------------------------------------

def test_counter_tensor_draws_equal_the_int_path():
    """The update counter as a 0-dim int64 tensor (what a graph reads at
    every replay) gives the Python int's bits: the hash, the Gumbel noise
    and the minibatch permutation."""
    from repro_torch.core import rng
    from repro_torch.train.ppo import _ACTIONS, key_word

    gid = torch.arange(50, dtype=torch.int64)
    for u in (0, 1, 7, 2**31 - 1, 2**32 + 5):
        counter = torch.tensor(u, dtype=torch.int64)
        assert torch.equal(rng.kinetic_hash32(11, gid, counter, 3),
                           rng.kinetic_hash32(11, gid, u, 3))
        assert torch.equal(
            buffers.minibatch_indices(5, 64, 4, update=counter, epoch=1),
            buffers.minibatch_indices(5, 64, 4, update=u, epoch=1))
    _, tr = _trainer("torch-scan", ONE_ENV)
    word = key_word(tr.init().key, _ACTIONS)
    assert torch.equal(tr._gumbel(word, torch.tensor(9)), tr._gumbel(word, 9))


@pytest.mark.parametrize("horizon,keys", [(8, 1), (12, 3), (20, 5)])
def test_update_graph_keys_repeat_with_the_cursor(horizon, keys):
    """The update graph's key moves only with the env cursor an update
    starts from: at a horizon H and rollout length T = 8, H / gcd(T, H)
    keys over a trainer's updates; one where H = T (the train phase's
    config), the update counter never in it."""
    eng = Engine("torch-scan", device="cpu")
    tr = PPOTrainer(eng.env(_mixture(), reward=REWARD, obs=MarketFeatures(),
                            horizon=horizon), ONE_ENV)
    ts = tr.init()
    seen = []
    for _ in range(2 * keys + 1):
        seen.append(tr.graph_key(ts))
        ts, _ = tr.update(ts)
    assert len(set(seen)) == keys
    assert seen[keys] == seen[0] and ts.update_idx == 2 * keys + 1


class _CpuGraph:
    """A CPU stand-in for a captured graph, with the real one's contract:
    static input buffers filled by copy, the outputs' Python leaves those
    of the capture, clones returned."""

    def __init__(self, body, tree, out):
        from repro_torch.core import graphs

        leaves, self.structure = graphs.flatten(tree)
        self.static = [x.clone() for x in leaves]
        self.body = body
        self.out_structure = graphs.flatten(out)[1]

    def __call__(self, tree):
        from repro_torch.core import graphs

        for dst, src in zip(self.static, graphs.flatten(tree)[0]):
            dst.copy_(src)
        out, structure = graphs.flatten(
            self.body(graphs.unflatten(self.structure, self.static)))
        assert structure == self.out_structure
        return graphs.unflatten(structure, [x.clone() for x in out])


@pytest.fixture
def cpu_graphs(monkeypatch):
    from repro_torch.core import graphs

    def capture(what, body, tree, device):
        out = body(tree)
        return out, _CpuGraph(body, tree, out)

    monkeypatch.setattr(graphs, "capture", capture)


@pytest.mark.parametrize("backend,cfg", [("cuda-kinetic", ONE_ENV),
                                         ("torch-scan", SMOKE)])
def test_update_graph_path_equals_eager_and_resumes(backend, cfg, tmp_path,
                                                    cpu_graphs):
    """The graph path's wiring on the CPU: a trainer whose env takes graphs
    trains as the eager one, holds two graphs (its update and its greedy
    rollout) after ``train`` and ``evaluate`` at a horizon of its rollout
    length (the train phase's config), and 2 updates, a
    checkpoint, a restore and 2 more equal 4 straight ones, replayed by a
    warm trainer with no new capture."""
    def trainer():
        eng = Engine(backend, device="cpu")
        return eng, PPOTrainer(eng.env(_mixture(), reward=REWARD,
                                       obs=MarketFeatures(), horizon=8), cfg)

    _, eager = trainer()
    want, want_m = eager.train(eager.init(), 4)
    eng, tr = trainer()
    tr.env._graphed = True
    builds = eng.trace_count
    ts2, _ = tr.train(tr.init(), 2)
    ts4, m4 = tr.train(ts2, 2)
    tr.evaluate(ts4.params, n_steps=8)
    tr.evaluate(ts4.params, n_steps=8)
    assert eng.trace_count == builds + 2 and len(tr.graphs()) == 2
    for got, ref in ((ts4.params, want.params),
                     (ts4.opt_state, want.opt_state), (m4, {
                         k: v[2:] for k, v in want_m.items()})):
        _same_tree(got, ref, backend)
    save_train_checkpoint(CheckpointManager(tmp_path, async_write=False),
                          tr, ts2)
    restored = restore_train_checkpoint(CheckpointManager(tmp_path), tr)
    again, again_m = tr.train(restored, 2)
    assert eng.trace_count == builds + 2
    _same_tree(again.params, want.params, backend)
    _same_tree(again_m, {k: v[2:] for k, v in want_m.items()}, backend)


# ---------------------------------------------------------------------------
# Nightly: the learned market-maker learns, and beats the scripted one.
# ---------------------------------------------------------------------------

@pytest.mark.train
@pytest.mark.slow
def test_market_maker_training_improves_reward():
    cfg = PPOConfig(rollout_len=32, num_updates=24, num_envs=4,
                    num_epochs=2, num_minibatches=8, hidden=(32, 32),
                    lr=1e-3, ent_coef=0.003, seed=0)
    _, tr = _trainer(cfg=cfg)
    out = fit(tr, total_updates=24, updates_per_call=8)
    rewards = out["history"]["reward"]
    head, tail = rewards[:6].mean(), rewards[-6:].mean()
    assert tail > head - 0.05, (head, tail)
    assert np.isfinite(out["history"]["loss"]).all()


@pytest.mark.train
@pytest.mark.slow
def test_learned_maker_beats_scripted_at_the_bench_shape():
    """``benchmarks/train_bench.py --full --require-win`` at its defaults
    (2 markets a block, A=16, L=16, rollout 16, 48 updates, seed 7) on
    ``torch-scan`` with 2 seed-envs; the same gate runs at this shape on
    the card in ``chip_smoke.py``'s ``train`` phase."""
    import chip_smoke

    report = chip_smoke.flagship_gate(torch.device("cpu"))
    assert report["learned"] > report["scripted"], report
