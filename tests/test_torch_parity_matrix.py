"""Paper §IV-B parity matrix on the port, held against the JAX package.

The paper's correctness claim: across 53 configurations the two custom
engines produce bitwise-identical order books, and aggregate statistics
match the CPU reference to within 0.1%. The matrix is
``tests/test_parity_matrix.py``'s (9 presets x 4 mixtures x 3 shapes, seed
= the case's index). On the CPU every port backend (``cuda-kinetic`` and
``cuda-naive`` through their plain versions, ``torch-scan`` and the host
``numpy`` reference) equals the JAX package's ``numpy`` backend field by
field, and the statistics of ``SimResult`` equal the JAX package's.

Tier-1 runs the 11-case subset; the full 108-case matrix is ``slow``.
``chip_smoke.py``'s ``parity`` phase runs all 108 on the card.
"""
import math

import pytest

import chip_smoke
from repro.core import engine as jengine
from repro.core.config import scenario_config as jscenario_config
from repro_torch.core import engine, params as params_mod
from repro_torch.core.config import (FUNDAMENTALIST, MAKER, MOMENTUM, NOISE,
                                     MarketConfig, scenario_config,
                                     scenario_names)

BOOK_FIELDS = ("bid", "ask", "last_price", "prev_mid", "price_path",
               "volume_path")
STATS = chip_smoke.PARITY_STATS
STAT_TOL = chip_smoke.PARITY_TOL  # the paper's 0.1%
PORT_BACKENDS = ("cuda-kinetic", "cuda-naive", "torch-scan", "numpy")
#: The port's copy of the matrix lives in chip_smoke.py, which runs it on
#: the card; test_matrix_is_the_jax_packages holds it to the original.
MIXTURES = chip_smoke.PARITY_MIXTURES
SHAPES = chip_smoke.PARITY_SHAPES
FULL_MATRIX = chip_smoke.PARITY_MATRIX
TIER1 = chip_smoke.PARITY_TIER1


def _case_id(case):
    sc, mix, (M, A, L, S) = case
    return f"{sc}-{mix}-M{M}A{A}L{L}S{S}"


def _kw(case):
    sc, mix, (M, A, L, S) = case
    return dict(num_markets=M, num_agents=A, num_levels=L, num_steps=S,
                seed=FULL_MATRIX.index(case), **MIXTURES[mix])


def _assert_parity(case):
    sc = case[0]
    want = jengine.simulate(jscenario_config(sc, **_kw(case)),
                            backend="numpy").to_numpy()
    cfg = chip_smoke.parity_config(case)
    assert cfg == scenario_config(sc, **_kw(case))
    results = {b: engine.simulate(cfg, backend=b, device="cpu").to_numpy()
               for b in PORT_BACKENDS}
    # Claim 1: every backend equals the reference, field by field.
    for b, got in results.items():
        for f in BOOK_FIELDS:
            g, w = getattr(got, f), getattr(want, f)
            assert g.dtype == w.dtype and g.shape == w.shape, (b, f)
            assert (g == w).all(), f"{_case_id(case)}: {b} field {f} differs"
    # Claim 2: the statistics within 0.1% of the host reference, and equal
    # to the JAX package's.
    kinetic, host = results["cuda-kinetic"], results["numpy"]
    for stat in STATS:
        got, ref, jax_ref = (getattr(r, stat)() for r in (kinetic, host,
                                                          want))
        if math.isnan(ref):
            assert math.isnan(got) and math.isnan(jax_ref), stat
            continue
        assert abs(got - ref) / max(abs(ref), 1e-9) <= STAT_TOL, stat
        assert got == jax_ref, stat


def test_matrix_is_the_jax_packages():
    import test_parity_matrix as jmatrix

    assert FULL_MATRIX == jmatrix.FULL_MATRIX and TIER1 == jmatrix.TIER1
    assert MIXTURES == jmatrix.MIXTURES and SHAPES == jmatrix.SHAPES
    assert STATS == jmatrix.STATS and STAT_TOL == jmatrix.STAT_TOL
    assert tuple(sorted(chip_smoke.PRESETS)) == scenario_names()
    assert len(FULL_MATRIX) == 108
    assert set(TIER1) <= set(FULL_MATRIX)


@pytest.mark.parametrize("case", TIER1, ids=_case_id)
def test_parity_tier1(case):
    _assert_parity(case)


@pytest.mark.slow
@pytest.mark.parametrize("case", FULL_MATRIX, ids=_case_id)
def test_parity_full_matrix(case):
    _assert_parity(case)


# ---- the guards of tests/test_parity_matrix.py, on the port's config ----

def test_mixture_population_counts():
    cfg = scenario_config("baseline", num_agents=40, num_steps=4,
                          **MIXTURES["fundamental"])
    types = params_mod.agent_types(params_mod.scalar_params(cfg, "cpu"), 40,
                                   "cpu").numpy().ravel()
    assert (types == MAKER).sum() == 4
    assert (types == MOMENTUM).sum() == 4
    assert (types == FUNDAMENTALIST).sum() == 12
    assert (types == NOISE).sum() == 20


def test_scenario_override_precedence():
    cfg = scenario_config("flash-crash", num_steps=20, shock_step=7)
    assert cfg.scenario == "flash-crash" and cfg.shock_step == 7
    assert scenario_config("flash-crash", num_steps=20).shock_step == 10


def test_unknown_and_conflicting_scenarios_raise():
    with pytest.raises(KeyError):
        scenario_config("no-such-scenario")
    with pytest.raises(ValueError):
        scenario_config("baseline", scenario="flash-crash")
    assert scenario_config("baseline",
                           scenario="baseline").scenario == "baseline"


def test_rounding_overshoot_rejected():
    with pytest.raises(ValueError):
        MarketConfig(num_agents=2, alpha_maker=0.4, alpha_momentum=0.3,
                     alpha_fundamentalist=0.3)


def test_archetype_counts_sum_to_population():
    cfg = scenario_config("baseline", num_agents=37, num_steps=4,
                          **MIXTURES["mom-heavy"])
    counts = cfg.archetype_counts()
    assert sum(counts.values()) == 37
    types = params_mod.agent_types(params_mod.scalar_params(cfg, "cpu"), 37,
                                   "cpu").numpy().ravel()
    for tid, n in counts.items():
        assert (types == tid).sum() == n


def test_flash_crash_moves_the_market():
    kw = dict(num_markets=8, num_agents=64, num_levels=64, num_steps=16,
              seed=2)
    base = engine.simulate(scenario_config("baseline", **kw),
                           backend="numpy", device="cpu").to_numpy()
    crash_cfg = scenario_config("flash-crash", **kw)
    crash = engine.simulate(crash_cfg, backend="numpy",
                            device="cpu").to_numpy()
    s = crash_cfg.shock_step
    assert (base.price_path[:, :s] == crash.price_path[:, :s]).all()
    assert crash.price_path[:, s].mean() < base.price_path[:, s].mean()
    assert crash.volatility() > base.volatility()


def test_fundamentalists_dampen_volatility():
    kw = dict(num_markets=16, num_agents=64, num_levels=64, num_steps=40,
              seed=4)
    fund = engine.simulate(
        scenario_config("baseline", alpha_maker=0.1, alpha_momentum=0.0,
                        alpha_fundamentalist=0.5, **kw),
        backend="numpy", device="cpu").to_numpy()
    mom = engine.simulate(
        scenario_config("baseline", alpha_maker=0.1, alpha_momentum=0.5,
                        alpha_fundamentalist=0.0, **kw),
        backend="numpy", device="cpu").to_numpy()
    assert fund.volatility() < mom.volatility()

