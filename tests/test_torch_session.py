"""The port's Session on ``device="cpu"`` against the JAX package's ``numpy``
and ``jax-scan`` backends, on a heterogeneous spec carried across with
``repro_torch.convert``; plus chunking, snapshots and ``step``."""
import numpy as np
import pytest

from repro.core.config import MarketConfig as JConfig
from repro.core.params import EnsembleSpec as JSpec
from repro.core.session import Engine as JEngine
from repro.core.session import ExternalOrders as JOrders
from repro_torch import convert
from repro_torch.core import engine
from repro_torch.core.config import MarketConfig
from repro_torch.core.session import Engine, ExternalOrders, backend_available

FIELDS = ("bid", "ask", "last_price", "prev_mid", "price_path", "volume_path")


def _jspec(num_steps=14):
    jspec = JSpec.from_scenarios(
        ["flash-crash", "whale", "hft", "informed", "thin-book",
         JConfig(num_markets=2, alpha_fundamentalist=0.25,
                 scenario="fundamentalist"),
         JConfig(num_markets=2, alpha_arbitrageur=0.25,
                 scenario="arbitrageur")],
        num_markets=2, num_agents=24, num_levels=16, num_steps=num_steps,
        seed=2**31 + 1)
    M = jspec.num_markets
    return jspec.with_values(coupling_peer=(np.arange(M) + 1) % M)


def _port(jspec):
    return convert.spec_from_numpy(
        jspec.num_markets, jspec.num_agents, jspec.num_levels,
        jspec.num_steps, jspec.seed, jspec.params.to_numpy()._asdict(),
        jspec.initial_quote_qty, jspec.initial_spread, jspec.scenarios)


def _same(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and (g == w).all()


@pytest.mark.parametrize("backend", ["numpy", "jax-scan"])
def test_session_matches_jax_package(backend):
    jspec = _jspec()
    want = JEngine(backend).open(jspec, chunk_size=5).run_to_result()
    got = Engine(device="cpu").open(_port(jspec), chunk_size=5) \
        .run_to_result()
    _same(got.to_numpy(), want.to_numpy())
    assert np.asarray(want.volume_path).sum() > 0


def test_stats_only_matches_jax_package():
    jspec = _jspec()
    js = JEngine("numpy", stats_only=True).open(jspec, chunk_size=4)
    js.run()
    ts = Engine(device="cpu", stats_only=True).open(_port(jspec),
                                                     chunk_size=4)
    batch = ts.run()
    assert batch.num_steps == 0
    _same(ts.stats, js.stats)


def test_chunked_equals_one_shot_without_coupling():
    spec = _port(_jspec(num_steps=13)).with_values(coupling_peer=-1,
                                                   num_arbitrageurs=0)
    one = Engine(device="cpu").open(spec, chunk_size=13).run_to_result()
    sess = Engine(device="cpu").open(spec, chunk_size=4)
    parts = list(sess.stream())
    assert [b.num_steps for b in parts] == [4, 4, 4, 1]
    batch = type(parts[0]).concatenate(parts)
    _same(sess.to_result(batch).to_numpy(), one.to_numpy())


def test_snapshot_restore_round_trips():
    spec = _port(_jspec())
    for stats_only in (False, True):
        eng = Engine(device="cpu", stats_only=stats_only)
        sess = eng.open(spec, chunk_size=3)
        sess.run(5)
        snap = sess.snapshot()
        tail = sess.run(6).to_numpy()
        end = [x.clone() for x in sess.state]
        other = eng.open(spec, chunk_size=3)
        other.restore(snap)
        assert other.step_count == 5
        _same(other.run(6).to_numpy(), tail)
        _same(other.state, end)
        if stats_only:
            _same(other.stats, sess.stats)


def test_restore_rejects_foreign_snapshot():
    spec = _port(_jspec())
    snap = Engine(device="cpu").open(spec).snapshot()
    snap["seed"] = spec.seed + 1
    with pytest.raises(ValueError, match="seed"):
        Engine(device="cpu").open(spec).restore(snap)


def test_step_none_is_invisible():
    spec = _port(_jspec())
    a = Engine(device="cpu").open(spec)
    b = Engine(device="cpu").open(spec)
    for _ in range(3):  # one-step runs: the same coupling freeze points
        _same(a.step(None).to_numpy(), b.run(1).to_numpy())
    _same(a.state, b.state)
    assert a.step_count == b.step_count == 3


def test_step_actions_match_jax_package():
    jspec = _jspec()
    M = jspec.num_markets
    js = JEngine("numpy").open(jspec)
    ts = Engine(device="cpu").open(_port(jspec))
    r = np.random.default_rng(9)
    for _ in range(4):
        side = r.random(M) < 0.5
        price = r.integers(0, jspec.num_levels, M)
        qty = r.integers(0, 6, M).astype(np.float32)
        _same(ts.step(ExternalOrders(side, price, qty)).to_numpy(),
              js.step(JOrders(side, price, qty)).to_numpy())
    _same(ts.state, js.state)


def test_step_rejects_malformed_actions():
    sess = Engine(device="cpu").open(_port(_jspec()))
    M = sess.spec.num_markets
    with pytest.raises(ValueError, match="market mismatch"):
        sess.step(ExternalOrders(True, np.zeros(M + 1, np.int64), 1.0))
    with pytest.raises(ValueError, match="grid"):
        sess.step(ExternalOrders(True, 99, 1.0))
    with pytest.raises(ValueError, match=">= 0"):
        sess.step(ExternalOrders(True, 3, -1.0))


def test_horizon_semantics():
    sess = Engine(device="cpu").open(_port(_jspec(num_steps=6)))
    assert sess.run().num_steps == 6
    with pytest.raises(ValueError, match="horizon"):
        sess.run()
    assert sess.run(2).num_steps == 2


def test_engine_simulate_wrappers():
    cfg = MarketConfig(num_markets=3, num_agents=8, num_levels=8,
                       num_steps=4, seed=1)
    from repro_torch.kernels import ref

    want = ref.simulate_reference(cfg, device="cpu").to_numpy()
    _same(engine.simulate(cfg, device="cpu").to_numpy(), want)
    r = engine.simulate_scenario("flash-crash", device="cpu",
                                 config_overrides=dict(num_markets=2,
                                                       num_agents=8,
                                                       num_levels=8,
                                                       num_steps=4))
    assert r.to_numpy().price_path.shape == (2, 4)
    assert backend_available("cuda-kinetic") is True
    assert backend_available("no-such-backend") is False


@pytest.mark.parametrize("backend", ["numpy", "numpy-pcg64"])
@pytest.mark.parametrize("reset_books", [True, False])
@pytest.mark.parametrize("stats_only", [False, True])
def test_swap_markets_matches_jax_package(backend, reset_books, stats_only):
    """``swap_markets(slots, sub, reset_books=...)``: the params rows are
    spliced and the rows' stats start afresh; the books take ``sub``'s
    opening books only with ``reset_books``. The runs before and after
    the splice equal the JAX package's."""
    jspec = _jspec()
    jsub = JSpec.from_scenarios(["whale", "thin-book"], num_markets=1,
                                num_agents=24, num_levels=16, num_steps=14,
                                seed=2**31 + 1)
    js = JEngine(backend, stats_only=stats_only).open(jspec, chunk_size=4)
    ts = Engine(backend, device="cpu", stats_only=stats_only).open(
        _port(jspec), chunk_size=4)
    sub = _port(jsub)
    outs = []
    for sess, s in ((js, jsub), (ts, sub)):
        sess.run(5)
        before = [np.array(np.asarray(x)) for x in sess.state]
        sess.swap_markets([1, 6], s, reset_books=reset_books)
        after = [np.asarray(x) for x in sess.state]
        for b, a in zip(before, after):
            rows = np.setdiff1d(np.arange(len(b)), [1, 6])
            assert (b[rows] == a[rows]).all()
            assert reset_books or (b == a).all()
        batch = sess.run(6)
        outs.append((list(sess.state), sess.stats, batch))
    (jstate, jstats, jbatch), (tstate, tstats, tbatch) = outs
    _same([x.numpy() for x in tstate], jstate)
    if stats_only:
        _same(tstats, jstats)
    else:
        _same(tbatch.to_numpy(), jbatch.to_numpy())
    assert ts.spec.scenarios[1] == js.spec.scenarios[1] == "whale"


def test_compat_engines_are_shared_and_cleared():
    """``simulate``, ``simulate_scenario`` and ``open_scenario`` share warm
    engines keyed by backend, device and options, as the JAX package's
    wrappers do; ``clear_compat_cache`` releases them."""
    from repro.core import engine as j_engine

    cfg = MarketConfig(num_markets=3, num_agents=8, num_levels=8,
                       num_steps=4, seed=1)
    engine.clear_compat_cache()
    first = engine.simulate(cfg, backend="torch-scan", device="cpu")
    again = engine.simulate(cfg, backend="torch-scan", device="cpu")
    (eng,) = engine._COMPAT_ENGINES.values()
    assert eng.trace_count == 1  # one runner, built once for both calls
    _same(again.to_numpy(), first.to_numpy())
    _same(first.to_numpy(), j_engine.simulate(
        JConfig(num_markets=3, num_agents=8, num_levels=8, num_steps=4,
                seed=1), backend="numpy").to_numpy())
    over = dict(num_markets=2, num_agents=8, num_levels=8, num_steps=4)
    engine.simulate_scenario("flash-crash", backend="torch-scan",
                             device="cpu", config_overrides=over)
    with engine.open_scenario("flash-crash", backend="torch-scan",
                              device="cpu", config_overrides=over) as sess:
        sess.run()
    assert len(engine._COMPAT_ENGINES) == 1
    engine.simulate(cfg, backend="torch-scan", device="cpu", scan="cumsum")
    assert len(engine._COMPAT_ENGINES) == 2  # other options, other engine
    engine.clear_compat_cache()
    assert not engine._COMPAT_ENGINES
