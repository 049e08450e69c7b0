"""The port's scenario tier against the JAX package's, with ``==``:
sequential clearing, ``mechanism_gap``, ``CouplingSpec`` and coupled runs,
``EnsembleSpec.product``, ``open_scenario`` and the stylized-facts gate.

The pinned realism gate and the pinned-size mechanism gap are
``scenario``-marked, as in the JAX package's tests.
"""
import math

import numpy as np
import pytest

from repro.core import engine as jengine
from repro.core import sequential as jsequential
from repro.core.config import MarketConfig as JConfig
from repro.core.config import scenario_config as jscenario_config
from repro.core.params import EnsembleSpec as JSpec
from repro.core.session import Engine as JEngine
from repro.kernels import ref as jref
from repro.scenario import CouplingSpec as JCoupling
from repro.scenario import mechanism_gap as jmechanism_gap
from repro.scenario import validate as jvalidate
from repro_torch import convert
from repro_torch.core import engine, params as params_mod
from repro_torch.core.config import MarketConfig, scenario_config
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine
from repro_torch.core.step import initial_state
from repro_torch.kernels import ref
from repro_torch.scenario import (
    CouplingSpec,
    FactCheck,
    ValidationReport,
    coupled_ensemble,
    mechanism_gap,
    simulate_step_sequential,
    stylized_facts,
    validate_pinned,
    validate_spec,
)
from repro_torch.scenario.sequential import GAP_METRICS
from test_torch_session import _port, _same

FIELDS = ("bid", "ask", "last_price", "prev_mid", "price_path", "volume_path")

#: tests/test_scenario.py's sequential configuration.
SEQ_KW = dict(num_markets=8, num_agents=24, num_levels=32, num_steps=12,
              seed=5, alpha_maker=0.15, alpha_momentum=0.15)
#: tests/test_scenario.py's validation-report configuration.
FACTS_KW = dict(num_markets=8, num_agents=32, num_steps=24, alpha_maker=0.15,
                alpha_momentum=0.4, seed=1)


def _same_row(got, want):
    """Key-by-key ``==`` of two flat dicts of floats, NaN matching NaN."""
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert (math.isnan(g) and math.isnan(w)) or g == w, (k, g, w)


# ---------------------------------------------------------------------------
# Sequential clearing.
# ---------------------------------------------------------------------------

def test_sequential_backend_matches_jax_package():
    want = jengine.simulate(JConfig(**SEQ_KW), backend="numpy",
                            clearing="sequential").to_numpy()
    got = engine.simulate(MarketConfig(**SEQ_KW), backend="numpy",
                          device="cpu", clearing="sequential").to_numpy()
    _same(got, want)


def test_sequential_reference_matches_jax_reference():
    want = jref.simulate_reference_sequential(JConfig(**SEQ_KW)).to_numpy()
    got = ref.simulate_reference_sequential(MarketConfig(**SEQ_KW),
                                            device="cpu").to_numpy()
    _same(got, want)


def test_sequential_step_matches_jax_package():
    """One step from a state with a shock and a crossed book: the same
    books, price, volume and mid as the JAX package's host step."""
    kw = dict(SEQ_KW, shock_step=1, shock_cancel=0.5, shock_intensity=0.3,
              alpha_hft=0.2)
    jcfg, cfg = JConfig(**kw), MarketConfig(**kw)
    from repro.core.step import initial_state as jinitial_state

    jstate = jinitial_state(jcfg, np)
    state = initial_state(cfg, "cpu")
    ids = np.arange(cfg.num_markets, dtype=np.int32)[:, None]
    import torch

    tids = torch.from_numpy(ids)
    for step in range(3):
        jstate, jout = jsequential.simulate_step_sequential(
            jcfg, jstate, np.int32(step), ids, np)
        state, out = simulate_step_sequential(cfg, state, step, tids)
        _same(state, jstate)
        _same(out, jout)


def test_sequential_book_masses_stay_integral():
    seq = engine.simulate(MarketConfig(**SEQ_KW), backend="numpy",
                          device="cpu", clearing="sequential").to_numpy()
    par = engine.simulate(MarketConfig(**SEQ_KW), backend="numpy",
                          device="cpu").to_numpy()
    assert not (par.price_path == seq.price_path).all()
    for f in ("bid", "ask", "volume_path"):
        arr = np.asarray(getattr(seq, f))
        assert (arr == np.round(arr)).all(), f
        assert (arr >= 0).all(), f


@pytest.mark.parametrize("backend", ["numpy-splitmix64", "numpy-pcg64"])
def test_sequential_other_streams_match(backend):
    want = jengine.simulate(JConfig(**SEQ_KW), backend=backend,
                            clearing="sequential").to_numpy()
    got = engine.simulate(MarketConfig(**SEQ_KW), backend=backend,
                          device="cpu", clearing="sequential").to_numpy()
    _same(got, want)


def test_mechanism_gap_matches_jax_package():
    want = jmechanism_gap(JConfig(**SEQ_KW))
    got = mechanism_gap(MarketConfig(**SEQ_KW))
    _same_row(got, want)
    for m in GAP_METRICS:
        assert f"{m}_delta" in got
    assert any(got[f"{m}_delta"] != 0.0 for m in GAP_METRICS)


@pytest.mark.scenario
def test_mechanism_gap_at_pinned_size_matches():
    kw = dict(num_markets=64, num_agents=256, num_steps=500,
              alpha_maker=0.15, alpha_momentum=0.5, seed=1)
    _same_row(mechanism_gap(scenario_config("high-vol", **kw)),
              jmechanism_gap(jscenario_config("high-vol", **kw)))


# ---------------------------------------------------------------------------
# CouplingSpec (mirrors tests/test_scenario.py) and coupled runs.
# ---------------------------------------------------------------------------

def test_coupling_constructors_match():
    cases = [(lambda C: C.none(5)), (lambda C: C.ring(4)),
             (lambda C: C.ring(4, offset=-1)),
             (lambda C: C.pairs(6, [(0, 3), (1, 5)])),
             (lambda C: C.explicit({0: 2, 2: 0}, 3))]
    for build in cases:
        got, want = build(CouplingSpec), build(JCoupling)
        assert got.peer.dtype == want.peer.dtype
        assert (got.peer == want.peer).all()
        assert got.num_markets == want.num_markets
        assert (got.coupled_markets == want.coupled_markets).all()
    assert CouplingSpec.ring(4).peer.tolist() == [1, 2, 3, 0]
    assert CouplingSpec.pairs(6, [(0, 3), (1, 5)]).peer.tolist() \
        == [3, 5, -1, 0, -1, 1]


@pytest.mark.parametrize("build,match", [
    (lambda C: C.ring(1), ">= 2 markets"),
    (lambda C: C.ring(4, offset=8), "multiple of num_markets"),
    (lambda C: C.pairs(4, [(2, 2)]), "itself"),
    (lambda C: C.pairs(4, [(0, 1), (1, 2)]), "more than one pair"),
    (lambda C: C.pairs(4, [(0, 7)]), "out of range"),
    (lambda C: C.explicit({5: 0}, 3), "out of range"),
    (lambda C: C(np.array([0, 9], np.int32)), "peer ids must be -1"),
    (lambda C: C(np.array([], np.int32)), "at least one market"),
])
def test_coupling_errors_match(build, match):
    for cls in (CouplingSpec, JCoupling):
        with pytest.raises(ValueError, match=match):
            build(cls)


def test_coupling_apply_checks_width():
    spec = EnsembleSpec.coerce(MarketConfig(num_markets=4, num_agents=8,
                                            num_steps=4))
    with pytest.raises(ValueError, match="over 6 markets"):
        CouplingSpec.ring(6).apply(spec)
    coupled = coupled_ensemble(spec, CouplingSpec.ring(4))
    assert np.asarray(coupled.params.coupling_peer).ravel().tolist() \
        == [1, 2, 3, 0]
    assert coupled.static_key() == spec.static_key()
    carried = convert.coupling_from_numpy(JCoupling.ring(4, offset=3).peer)
    assert carried.peer.tolist() == JCoupling.ring(4, offset=3).peer.tolist()


def _arb_kw(**kw):
    base = dict(num_markets=6, num_agents=32, num_levels=32, num_steps=16,
                seed=3, alpha_maker=0.15, alpha_arbitrageur=0.25,
                noise_delta=4.0, p_marketable=0.25)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def coupled_jax_scan():
    jspec = JCoupling.ring(6).apply(JSpec.coerce(JConfig(**_arb_kw())))
    with JEngine("jax-scan", chunk_size=4).open(jspec) as s:
        return jspec, s.run(jspec.num_steps).to_numpy()


@pytest.mark.parametrize("backend", ["torch-scan", "cuda-kinetic", "numpy"])
def test_coupled_run_matches_jax_scan(backend, coupled_jax_scan):
    """Coupled runs equal the JAX package's ``jax-scan`` over the same
    chunk boundaries (the peer mid freezes at each chunk entry)."""
    jspec, want = coupled_jax_scan
    spec = CouplingSpec.ring(6).apply(
        EnsembleSpec.coerce(MarketConfig(**_arb_kw())))
    _same(spec.params.to_numpy(), jspec.params.to_numpy())
    with Engine(backend, device="cpu", chunk_size=4).open(spec) as s:
        got = s.run(spec.num_steps).to_numpy()
    _same(got, want)
    with Engine(backend, device="cpu", chunk_size=4).open(
            CouplingSpec.none(6).apply(spec)) as s:
        base = s.run(spec.num_steps).to_numpy()
    assert not (np.asarray(base.price) == np.asarray(got.price)).all()


def test_coupling_inert_without_arbitrageurs():
    spec = EnsembleSpec.coerce(MarketConfig(**_arb_kw(alpha_arbitrageur=0.0)))
    base = engine.simulate(spec, backend="numpy", device="cpu").to_numpy()
    coupled = engine.simulate(CouplingSpec.ring(6).apply(spec),
                              backend="numpy", device="cpu").to_numpy()
    _same(coupled, base)


# ---------------------------------------------------------------------------
# EnsembleSpec.product and open_scenario.
# ---------------------------------------------------------------------------

_SWEEP = {"alpha_momentum": (0.15, 0.3, 0.5), "p_marketable": (0.1, 0.2),
          "initial_quote_qty": (5.0, 9.0)}


def test_product_matches_jax_package():
    kw = dict(num_markets=3, num_agents=16, num_levels=32, num_steps=8,
              seed=4, alpha_arbitrageur=0.1)
    want = JSpec.product(JConfig(**kw), _SWEEP, markets_per_config=2)
    got = EnsembleSpec.product(MarketConfig(**kw), _SWEEP,
                               markets_per_config=2)
    assert got.num_markets == want.num_markets == 24
    assert got.static_key() == want.static_key()
    _same(got.params.to_numpy(), want.params.to_numpy())
    assert got.scenarios == want.scenarios
    _same(got.initial_books("cpu"), want.initial_books(np))
    default = EnsembleSpec.product(MarketConfig(**kw), {"q_max": (2, 3)})
    assert default.num_markets == 6
    assert default.params.q_max.ravel().tolist() == [2, 2, 2, 3, 3, 3]


def test_product_rejects_empty_and_non_finite():
    base = MarketConfig(num_markets=2, num_agents=8, num_steps=4)
    with pytest.raises(ValueError, match="non-empty sweep"):
        EnsembleSpec.product(base, {})
    with pytest.raises(ValueError, match=r"params\.fundamentalist_kappa"):
        EnsembleSpec.product(base,
                             {"fundamentalist_kappa": [0.1, float("nan")]})


def test_open_scenario_matches_jax_package():
    over = dict(num_markets=4, num_agents=16, num_levels=32, num_steps=10,
                seed=8)
    assert engine.scenarios() == jengine.scenarios()
    for name in ("flash-crash", "whale"):
        with jengine.open_scenario(name, backend="numpy",
                                   config_overrides=over) as js:
            want = js.run_to_result().to_numpy()
        for backend in ("cuda-kinetic", "numpy-pcg64", "numpy"):
            with engine.open_scenario(name, backend=backend, device="cpu",
                                      config_overrides=over) as s:
                assert s.spec.scenarios == (name,) * 4
                got = s.run_to_result().to_numpy()
            if backend != "numpy-pcg64":
                _same(got, want)


# ---------------------------------------------------------------------------
# The stylized-facts gate.
# ---------------------------------------------------------------------------

def test_factcheck_semantics():
    ok = FactCheck.check("kurt", 4.2, ">", 3.0)
    assert ok.passed and "PASS" in str(ok)
    bad = FactCheck.check("kurt", 2.0, ">", 3.0)
    assert not bad.passed and "FAIL" in str(bad)
    assert not FactCheck.check("nan", float("nan"), ">", -1e9).passed
    with pytest.raises(ValueError, match="op"):
        FactCheck.check("kurt", 1.0, ">=", 0.0)


def test_stylized_facts_match_jax_scan():
    want = jvalidate.stylized_facts(
        jscenario_config("high-vol", **FACTS_KW), backend="jax-scan")
    got = stylized_facts(scenario_config("high-vol", **FACTS_KW),
                         backend="torch-scan", device="cpu")
    _same_row(got, want)


def test_validate_spec_matches_jax_scan():
    kw = dict(min_excess_kurtosis=-100.0, min_vv_corr=-2.0,
              require_acf_decay=False, stats_check=True)
    want = jvalidate.validate_spec(jscenario_config("high-vol", **FACTS_KW),
                                   backend="jax-scan", **kw)
    cfg = scenario_config("high-vol", **FACTS_KW)
    got = validate_spec(cfg, backend="torch-scan", device="cpu", **kw)
    assert isinstance(got, ValidationReport)
    assert got.scenario == "high-vol" and got.passed and got.failures == ()
    _same_row(got.facts, want.facts)
    assert [(c.name, c.value, c.passed) for c in got.checks] \
        == [(c.name, c.value, c.passed) for c in want.checks]
    d = got.to_dict()
    assert d["passed"] and {c["name"] for c in d["checks"]} == {
        "excess_kurtosis", "volume_volatility_corr", "stats_mean_mid_agrees",
        "stats_var_mid_agrees", "stats_volume_agrees"}
    # an unsatisfiable threshold flips the report
    rep2 = validate_spec(cfg, backend="cuda-kinetic", device="cpu",
                         min_vv_corr=2.0, require_acf_decay=False)
    assert not rep2.passed
    assert [c.name for c in rep2.failures] == ["volume_volatility_corr"]
    assert "FAIL" in rep2.summary()


def test_simresult_statistics_match():
    cfg = scenario_config("high-vol", **FACTS_KW)
    got = engine.simulate(cfg, backend="torch-scan", device="cpu")
    want = jengine.simulate(jscenario_config("high-vol", **FACTS_KW),
                            backend="jax-scan")
    for stat in ("mean_clearing_price", "volume_per_market", "trade_count",
                 "volatility", "excess_kurtosis", "volume_volatility_corr"):
        assert getattr(got, stat)() == getattr(want, stat)(), stat
    for absolute in (False, True):
        a = got.autocorrelation(lags=5, absolute=absolute)
        b = want.autocorrelation(lags=5, absolute=absolute)
        assert ((a == b) | (np.isnan(a) & np.isnan(b))).all()


def test_entry_points_default_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = scenario_config("high-vol", **FACTS_KW)
    with pytest.raises(RuntimeError, match="cuda"):
        validate_pinned(num_steps=4)
    with pytest.raises(RuntimeError, match="cuda"):
        stylized_facts(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        engine.open_scenario("baseline")


@pytest.mark.scenario
def test_pinned_mixtures_match_jax_scan():
    """The realism gate on the four pinned mixtures (M=64, A=256, L=128,
    S=500): every report passes, with the facts of ``jax-scan``."""
    want = jvalidate.validate_pinned("jax-scan", stats_check=True)
    got = validate_pinned("torch-scan", stats_check=True, device="cpu")
    assert set(got) == set(want) == {"high-vol-momentum", "whale", "hft",
                                     "informed"}
    for name, rep in got.items():
        assert rep.passed, rep.summary()
        _same_row(rep.facts, want[name].facts)


def test_params_module_product_keeps_column_dtypes():
    spec = EnsembleSpec.product(MarketConfig(num_markets=2, num_agents=8,
                                             num_steps=4), {"q_max": (2, 3)})
    for f in params_mod.MarketParams._fields:
        assert np.asarray(getattr(spec.params, f)).dtype \
            == params_mod.MarketParams.field_dtype(f)
