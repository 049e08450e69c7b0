"""The port's semantic core against the JAX package, bit for bit (``==``).

Inputs are made with numpy from a seed and handed to both packages; the
port runs its plain PyTorch code on the CPU.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

from repro.core import agents as j_agents
from repro.core import auction as j_auction
from repro.core import rng as j_rng
from repro.core import stats as j_stats
from repro.core.config import MarketConfig as JConfig
from repro.core.numpy_backend import _bin_orders_scatter
from repro.core.params import EnsembleSpec as JSpec
from repro.core.step import apply_scenario_shock as j_shock
from repro_torch import convert
from repro_torch.core import agents, auction, rng, stats
from repro_torch.core import params as params_mod
from repro_torch.core.step import apply_scenario_shock, bin_orders_scatter


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert (got == want).all()


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**32 - 1])
def test_hash_and_uniform_match(seed):
    r = np.random.default_rng(seed % 1000)
    gid = r.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    step = r.integers(0, 2**31, size=4096).astype(np.uint32)
    for ch in range(5):
        want = j_rng.kinetic_hash32(seed, gid, step, ch, np)
        got = rng.kinetic_hash32(seed, _t(gid.astype(np.int64)),
                                 _t(step.astype(np.int64)), ch)
        _eq(got, want.astype(np.int64))
        _eq(rng.uniform32(seed, _t(gid.astype(np.int64)),
                          _t(step.astype(np.int64)), ch),
            j_rng.uniform32(seed, gid, step, ch, np))


@pytest.mark.parametrize("scan", ["cumsum", "hillis-steele"])
@pytest.mark.parametrize("L", [4, 16, 128])
def test_clear_and_best_quotes_match(scan, L):
    r = np.random.default_rng(L)
    buy = (r.integers(0, 9, (6, L)) * (r.random((6, L)) < 0.4)).astype(np.float32)
    ask = (r.integers(0, 9, (6, L)) * (r.random((6, L)) < 0.4)).astype(np.float32)
    buy[0] = 0.0   # an empty side: no cross, mid falls back to last
    ask[1] = 0.0
    want = j_auction.clear(buy, ask, np, scan=scan)
    got = auction.clear(_t(buy), _t(ask), scan=scan)
    for key in want:
        _eq(got[key], want[key])
    last = r.integers(0, L, (6, 1)).astype(np.float32)
    for g, w in zip(auction.best_quotes(_t(buy), _t(ask), _t(last)),
                    j_auction.best_quotes(buy, ask, last, np)):
        _eq(g, w)


def _mixed_specs(A=24, L=32, S=40, seed=2**31 + 11):
    """Every archetype populated, a shock inside the horizon, ring peers."""
    blocks = [JConfig(num_markets=2, num_agents=A, num_levels=L,
                      num_steps=S, seed=seed, **mix)
              for mix in ({"alpha_fundamentalist": 0.25,
                           "fundamental_price": 12.0},
                          {"alpha_whale": 0.25, "whale_period": 3},
                          {"alpha_hft": 0.25, "hft_threshold": 0.1},
                          {"alpha_informed": 0.25, "shock_step": 9,
                           "shock_intensity": 0.7, "shock_cancel": 0.5,
                           "informed_horizon": 4},
                          {"alpha_arbitrageur": 0.3, "arb_kappa": 0.75})]
    jspec = JSpec.concatenate([JSpec.homogeneous(b) for b in blocks])
    M = jspec.num_markets
    jspec = jspec.with_values(coupling_peer=(np.arange(M) + 1) % M)
    return jspec, to_port(jspec)


def to_port(jspec):
    return convert.spec_from_numpy(
        jspec.num_markets, jspec.num_agents, jspec.num_levels,
        jspec.num_steps, jspec.seed, jspec.params.to_numpy()._asdict(),
        jspec.initial_quote_qty, jspec.initial_spread, jspec.scenarios)


def test_agent_types_match():
    jspec, tspec = _mixed_specs()
    from repro.core.params import agent_types as j_types

    got = params_mod.agent_types(
        params_mod.pack_params(tspec.params, "cpu").columns(),
        tspec.num_agents, "cpu")
    _eq(got, np.broadcast_to(j_types(jspec.params, jspec.num_agents, np),
                             (jspec.num_markets, jspec.num_agents)))
    assert set(np.unique(got.numpy())) == set(range(8))


@pytest.mark.parametrize("step", [0, 3, 6, 8, 9, 10])
def test_decide_matches(step):
    jspec, tspec = _mixed_specs()
    M = jspec.num_markets
    r = np.random.default_rng(step)
    mid = r.integers(10, 22, (M, 1)).astype(np.float32) + np.float32(0.5) * (
        r.random((M, 1)) < 0.5)
    prev = mid + r.integers(-1, 2, (M, 1)).astype(np.float32)
    imb = (r.random((M, 1)).astype(np.float32) * 2 - 1)
    imb[0] = 0.0
    peer = mid + r.integers(-3, 4, (M, 1)).astype(np.float32)
    # Ids near 2**31 / A: the int32 gid product wraps modulo 2**32.
    mids = (np.arange(M, dtype=np.int32) + 89478480)[:, None]
    want = j_agents.decide(jspec, jspec.params, mid, prev, np.int32(step),
                           mids, np.arange(jspec.num_agents, dtype=np.int32),
                           np, imbalance=imb, peer_mid=peer)
    cols = params_mod.pack_params(tspec.params, "cpu").columns()
    got = agents.decide(tspec, cols, _t(mid), _t(prev), step, _t(mids),
                        imbalance=_t(imb), peer_mid=_t(peer))
    for g, w in zip(got, want):
        _eq(g, np.broadcast_to(w, (M, jspec.num_agents)))


def test_shock_and_scatter_binning_match():
    jspec, tspec = _mixed_specs()
    M, A, L = jspec.num_markets, jspec.num_agents, jspec.num_levels
    r = np.random.default_rng(1)
    bid = r.integers(0, 40, (M, L)).astype(np.float32)
    cols = params_mod.pack_params(tspec.params, "cpu").columns()
    for s in (8, 9):
        _eq(apply_scenario_shock(cols, _t(bid), s),
            j_shock(jspec.params, bid, np.int32(s), np))
    side = r.random((M, A)) < 0.5
    price = r.integers(0, L, (M, A)).astype(np.int32)
    qty = r.integers(0, 9, (M, A)).astype(np.float32)
    for g, w in zip(bin_orders_scatter(_t(side), _t(price), _t(qty), L),
                    _bin_orders_scatter(side, price, qty, M, L)):
        _eq(g, w)


def test_stats_accumulate_matches():
    r = np.random.default_rng(3)
    js, ts = j_stats.init_stats(5, np), stats.init_stats(5, "cpu")
    for _ in range(7):
        mid = r.integers(0, 128, (5, 1)).astype(np.float32) / np.float32(2)
        vol = r.integers(0, 50, (5, 1)).astype(np.float32)
        js = j_stats.accumulate(js, mid, vol, True, np)
        ts = stats.accumulate(ts, _t(mid), _t(vol))
    for g, w in zip(ts, js):
        _eq(g, w)


@pytest.mark.parametrize("name", ["baseline", "whale", "hft", "informed"])
def test_config_mixture_and_events_match(name):
    from repro.core.config import scenario_config as j_scenario_config
    from repro_torch.core.config import scenario_config

    over = dict(num_markets=6, num_agents=40, num_steps=30,
                alpha_arbitrageur=0.1, alpha_fundamentalist=0.05)
    cfg, jcfg = scenario_config(name, **over), j_scenario_config(name, **over)
    assert cfg.mixture() == jcfg.mixture()
    assert abs(sum(cfg.mixture().values()) - 1.0) < 1e-12
    assert cfg.events() == jcfg.events() == 6 * 40 * 30
    spec = params_mod.EnsembleSpec.from_scenarios(
        ["baseline", name], num_markets=3, num_agents=40, num_steps=30)
    jspec = JSpec.from_scenarios(["baseline", name], num_markets=3,
                                 num_agents=40, num_steps=30)
    assert spec.events() == jspec.events() == 6 * 40 * 30


def test_archetype_names_match():
    assert agents.archetype_names() == j_agents.archetype_names()


def test_market_params_zeros_match():
    from repro.core.params import MarketParams as JParams

    got = params_mod.MarketParams.zeros(5, "cpu")
    want = JParams.zeros(5, np)
    for f in want._fields:
        g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and g.shape == w.shape == (5, 1), f
        assert (g == w).all(), f


def test_register_scenario_matches():
    """A preset registered in both packages builds equal configs and
    params, and joins ``scenario_names``."""
    from repro.core import config as j_config
    from repro_torch.core import config

    def preset(num_steps):
        return {"shock_step": num_steps // 3, "shock_intensity": 0.4,
                "noise_delta": 12.0}

    try:
        config.register_scenario("test-third")(preset)
        j_config.register_scenario("test-third")(preset)
        assert "test-third" in config.scenario_names()
        cfg = config.scenario_config("test-third", num_steps=30)
        jcfg = j_config.scenario_config("test-third", num_steps=30)
        assert cfg.shock_step == jcfg.shock_step == 10
        got = params_mod.params_from_config(cfg)
        want = JSpec.homogeneous(jcfg).params.to_numpy()
        for f in want._fields:
            _eq(getattr(got, f), getattr(want, f))
    finally:
        config.SCENARIO_PRESETS.pop("test-third", None)
        j_config.SCENARIO_PRESETS.pop("test-third", None)


@pytest.mark.parametrize("name", ["baseline", "whale", "hft", "informed"])
def test_config_agent_types_match(name):
    """``MarketConfig.agent_types(device="cpu")`` is ``repro``'s
    ``agent_types(np)``: int32[A] through the one assignment rule."""
    from repro.core.config import scenario_config as j_scenario
    from repro_torch.core.config import scenario_config

    kw = dict(num_agents=40, alpha_arbitrageur=0.1, alpha_fundamentalist=0.1)
    got = scenario_config(name, **kw).agent_types(device="cpu")
    want = j_scenario(name, **kw).agent_types(np)
    assert got.dtype == torch.int32 and got.shape == (40,)
    _eq(got, want)


def test_market_params_asarray_matches():
    """``MarketParams.asarray`` keeps each field's dtype as ``repro``'s
    does, from host columns of other dtypes too."""
    jspec, tspec = _mixed_specs()
    raw = tspec.params._replace(
        shock_step=np.asarray(tspec.params.shock_step, np.float64),
        q_max=np.asarray(tspec.params.q_max, np.int64))
    got = raw.asarray("cpu")
    want = jspec.params._replace(
        shock_step=np.asarray(jspec.params.shock_step, np.float64),
        q_max=np.asarray(jspec.params.q_max, np.int64)).asarray(np)
    for f, g, w in zip(want._fields, got, want):
        assert g.numpy().dtype == np.asarray(w).dtype, f
        _eq(g, w)


@pytest.mark.parametrize("ids", ["arange", "reversed", "offset"])
def test_decide_with_agent_ids_matches(ids):
    """``decide(agent_ids=...)`` equals ``repro``'s ``decide`` given the
    same ids; ``None`` is ``arange(A)``."""
    jspec, tspec = _mixed_specs()
    M, A = jspec.num_markets, jspec.num_agents
    r = np.random.default_rng(5)
    mid = r.integers(10, 22, (M, 1)).astype(np.float32)
    prev = mid + r.integers(-1, 2, (M, 1)).astype(np.float32)
    mids = np.arange(M, dtype=np.int32)[:, None]
    agent_ids = {"arange": np.arange(A), "reversed": np.arange(A)[::-1],
                 "offset": np.arange(A) + 3 * A}[ids].astype(np.int32)
    want = j_agents.decide(jspec, jspec.params, mid, prev, np.int32(4),
                           mids, agent_ids, np)
    cols = params_mod.pack_params(tspec.params, "cpu").columns()
    got = agents.decide(tspec, cols, _t(mid), _t(prev), 4, _t(mids),
                        agent_ids=_t(agent_ids.copy()))
    for g, w in zip(got, want):
        _eq(g, np.broadcast_to(w, (M, A)))
    if ids == "arange":
        plain = agents.decide(tspec, cols, _t(mid), _t(prev), 4, _t(mids))
        for g, w in zip(plain, got):
            assert torch.equal(g, w)


#: Spec edits that trip one of ``EnsembleSpec.validate``'s checks each,
#: with ``repro``'s own wording of that check (``src/repro/core/params.py``).
INVALID_SPECS = [
    ("non_finite", dict(noise_delta=[1.0, np.nan, 1.0]),
     "params.noise_delta contains non-finite values (nan/inf) in markets "
     "[1]; parameter operands must be finite"),
    ("initial_spread", dict(initial_spread=[2, 20, 2]),
     "initial_spread must place both opening quotes on the grid "
     "(0 <= spread, ceil(spread/2) <= 7 for num_levels=16); markets [1] "
     "violate it"),
    ("q_max", dict(q_max=[1.0, 1.0, 0.5]),
     "q_max must be >= 1 (qty = 1 + floor(u * q_max) would go "
     "non-positive); markets [2] violate it"),
    ("fundamental", dict(fundamental=-1.0),
     "fundamental must be a resolved price >= 0 (the config's "
     "negative-means-midpoint sentinel is applied at build time; use "
     "num_levels // 2 = 8 for the grid midpoint); markets [0, 1, 2] "
     "violate it")]


@pytest.mark.parametrize("edit,wording", [c[1:] for c in INVALID_SPECS],
                         ids=[c[0] for c in INVALID_SPECS])
def test_validation_texts_are_repros(edit, wording):
    """The same invalid spec raises the same ``ValueError`` in both
    packages, worded as ``repro`` words it."""
    kw = dict(num_markets=3, num_agents=8, num_levels=16, num_steps=4,
              seed=1)
    specs = (JSpec.homogeneous(JConfig(**kw)),
             params_mod.EnsembleSpec.homogeneous(
                 params_mod.MarketConfig(**kw)))
    texts = []
    for spec in specs:
        with pytest.raises(ValueError, match=re.escape(wording)) as err:
            if "initial_spread" in edit:
                dataclasses.replace(spec, initial_spread=np.asarray(
                    edit["initial_spread"], np.int32))
            else:
                spec.with_values(**edit)
        texts.append(str(err.value))
    assert texts[0] == texts[1] == wording
