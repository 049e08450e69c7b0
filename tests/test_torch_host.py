"""The CPU reference family's NumPy step (``repro_torch.core.host``) held
against the JAX package's ``xp``-polymorphic core run with ``xp=numpy``,
module by module, with ``==``: the counter RNG and SplitMix64, the call
auction, ``decide``, the ``stats_only`` accumulators, the step with
``np.add.at`` binning and the sequential mechanism. Inputs are made from a
seed with numpy at the parity matrix's small shapes, under both scans.
Also: a session's snapshot taken before a ``run`` is unchanged after it
(the step reads the session's tensors through views and never writes)."""
import numpy as np
import pytest

import chip_smoke
from repro.core import agents as jagents
from repro.core import auction as jauction
from repro.core import config as jconfig
from repro.core import params as jparams
from repro.core import rng as jrng
from repro.core import sequential as jsequential
from repro.core import stats as jstats
from repro.core import step as jstep
from repro.core.config import MarketConfig as JConfig
from repro.core.numpy_backend import _bin_orders_scatter
from repro.core.params import EnsembleSpec as JSpec
from repro_torch.core import config as port_config
from repro_torch.core.config import MarketConfig
from repro_torch.core.host import agents, auction, rng, sequential, stats, step
from repro_torch.core.session import Engine, ExternalOrders
from test_torch_session import _port, _same

SHAPES = chip_smoke.PARITY_SHAPES
SCANS = ("cumsum", "hillis-steele")
STREAMS = ("kinetic", "splitmix64", "pcg64")


def _id(shape):
    return "M{}A{}L{}S{}".format(*shape)


def _jspec(shape):
    """A mixed, ring-coupled JAX-package spec: every archetype and the
    flash-crash overlays, ``M`` markets a block."""
    M, A, L, S = shape
    jspec = JSpec.from_scenarios(
        ["baseline", "flash-crash", "whale", "hft", "informed",
         JConfig(num_markets=M, alpha_fundamentalist=0.25,
                 scenario="fundamentalist"),
         JConfig(num_markets=M, alpha_arbitrageur=0.25,
                 scenario="arbitrageur")],
        num_markets=M, num_agents=A, num_levels=L, num_steps=S,
        seed=M * 1000 + A)
    n = jspec.num_markets
    return jspec.with_values(coupling_peer=(np.arange(n) + 3) % n)


def _streams(mode, seed):
    """Two equal ``uniform_fn`` overrides of ``mode`` (None: the counter
    stream): one for each package."""
    if mode == "kinetic":
        return None, None
    if mode == "splitmix64":
        return (lambda g, s, c: rng.splitmix64_uniform(seed, g, s, c),
                lambda g, s, c: jrng.splitmix64_uniform(seed, g, s, c))
    gens = [np.random.Generator(np.random.PCG64(seed)) for _ in range(2)]
    return tuple((lambda g, s, c, gen=gen: gen.random(size=g.shape,
                                                      dtype=np.float32))
                 for gen in gens)


def _equal(got, want):
    """``==`` with equal dtypes and shapes, leaf by leaf."""
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert (g == w).all()


def _books(r, M, L, fill=0.6):
    """Integer-valued f32 books with some empty rows and levels."""
    q = r.integers(0, 9, size=(M, L)).astype(np.float32)
    q[r.random((M, L)) > fill] = 0.0
    q[0] = 0.0
    return q


# ---------------------------------------------------------------------------
# host.rng
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_rng_matches_jax_package(shape):
    M, A, _, S = shape
    r = np.random.default_rng(M * A)
    gid = r.integers(0, 2**32, size=(M, A), dtype=np.uint64).astype(np.uint32)
    for seed in (0, 7, 2**31 + 5, 2**32 - 1, 2**40 + 3):
        for step_ in (np.uint32(0), np.uint32(S), np.uint32(2**32 - 1)):
            for ch in range(5):
                _equal([rng.kinetic_hash32(seed, gid, step_, ch),
                        rng.uniform32(seed, gid, step_, ch)],
                       [jrng.kinetic_hash32(seed, gid, step_, ch, np),
                        jrng.uniform32(seed, gid, step_, ch, np)])
                if seed < 2**32:
                    _equal([rng.splitmix64_uniform(seed, gid, step_, ch),
                            rng.splitmix64_coord(seed, gid, step_, ch)],
                           [jrng.splitmix64_uniform(seed, gid, step_, ch),
                            jrng.splitmix64_coord(seed, gid, step_, ch)])
    _equal([rng.mix32(gid), rng.splitmix64(gid.astype(np.uint64))],
           [jrng.mix32(gid, np), jrng.splitmix64(gid.astype(np.uint64))])
    u = rng.uniform32(3, gid, np.uint32(1), 0)
    assert u.dtype == np.float32 and (u >= 0).all() and (u < 1).all()


# ---------------------------------------------------------------------------
# host.auction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_auction_matches_jax_package(shape, scan):
    M, _, L, _ = shape
    r = np.random.default_rng(L + M)
    buy, ask = _books(r, M, L), _books(r, M, L)
    last = r.integers(0, L, size=(M, 1)).astype(np.float32)
    _equal([auction.prefix_sum(ask), auction.suffix_sum(buy),
            auction.hillis_steele_prefix(ask),
            auction.hillis_steele_suffix(buy)],
           [jauction.prefix_sum(ask, np), jauction.suffix_sum(buy, np),
            jauction.hillis_steele_prefix(ask, np),
            jauction.hillis_steele_suffix(buy, np)])
    _equal(auction.best_quotes(buy, ask, last),
           jauction.best_quotes(buy, ask, last, np))
    got, want = auction.clear(buy, ask, scan=scan), \
        jauction.clear(buy, ask, np, scan=scan)
    assert sorted(got) == sorted(want)
    _equal([got[k] for k in sorted(got)], [want[k] for k in sorted(want)])
    assert (got["volume"] > 0).any()


# ---------------------------------------------------------------------------
# host.agents
# ---------------------------------------------------------------------------

def test_constants_and_type_lattice_match():
    for name in ("NOISE", "MOMENTUM", "MAKER", "FUNDAMENTALIST", "WHALE",
                 "HFT", "INFORMED", "ARBITRAGEUR", "CH_SIDE", "CH_PRICE",
                 "CH_MKT", "CH_QTY", "CH_SHOCK"):
        assert getattr(agents, name) == getattr(port_config, name) \
            == getattr(jconfig, name), name
    assert sorted(agents.ARCHETYPES) == sorted(jagents.archetype_names())
    jspec = _jspec(SHAPES[2])
    _equal([agents.agent_types(jspec.params, jspec.num_agents),
            agents.assign_agent_types(40, 3, 5, 7, 2, 1, 4, 6)],
           [jparams.agent_types(jspec.params, jspec.num_agents, np),
            jconfig.assign_agent_types(np, 40, 3, 5, 7, 2, 1, 4, 6)])


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_decide_matches_jax_package(shape, stream):
    jspec = _jspec(shape)
    M, A, L = jspec.num_markets, jspec.num_agents, jspec.num_levels
    r = np.random.default_rng(A)
    ours, theirs = _streams(stream, jspec.seed)
    market_ids = np.arange(M, dtype=np.int32)[:, None]
    agent_ids = np.arange(A, dtype=np.int32)
    for t in range(shape[3]):
        mid = r.integers(0, 2 * L, size=(M, 1)).astype(np.float32) \
            * np.float32(0.5)
        prev = r.integers(0, L, size=(M, 1)).astype(np.float32)
        imb = (r.random((M, 1)) * 2 - 1).astype(np.float32)
        peer = r.integers(0, L, size=(M, 1)).astype(np.float32)
        seed = None if t % 2 else 2**31 + t
        kw = dict(seed=seed, imbalance=imb, peer_mid=peer)
        _equal(agents.decide(jspec, jspec.params, mid, prev, np.int32(t),
                             market_ids, agent_ids, uniform_fn=ours, **kw),
               jagents.decide(jspec, jspec.params, mid, prev, np.int32(t),
                              market_ids, agent_ids, np, uniform_fn=theirs,
                              **kw))
    # The defaults: no imbalance, self-coupling, the lattice recomputed.
    _equal(agents.decide(jspec, jspec.params, mid, prev, np.int32(2),
                         market_ids, agent_ids),
           jagents.decide(jspec, jspec.params, mid, prev, np.int32(2),
                          market_ids, agent_ids, np))


# ---------------------------------------------------------------------------
# host.stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_stats_match_jax_package(shape):
    M, _, L, S = shape
    r = np.random.default_rng(S)
    got, want = stats.init_stats(M), jstats.init_stats(M, np)
    _equal(got, want)
    assert len({id(x) for x in got}) == len(got)  # distinct buffers
    for t in range(S):
        mid = (r.integers(0, 2 * L, size=(M, 1)) * 0.5).astype(np.float32)
        vol = r.integers(0, 20, size=(M, 1)).astype(np.float32)
        active = bool(t % 3)
        got = stats.accumulate(got, mid, vol, active)
        want = jstats.accumulate(want, mid, vol, active, np)
        _equal(got, want)


# ---------------------------------------------------------------------------
# host.step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_initial_state_and_peer_mids_match(shape):
    jspec = _jspec(shape)
    got = step.initial_state(jspec)
    _equal(got, jstep.initial_state(jspec, np))
    _equal(step.initial_state(_port(jspec)), got)
    ids = np.arange(jspec.num_markets, dtype=np.int32)[::-1, None]
    for market_ids in (None, ids):
        _equal([step.resolve_peer_mids(got.prev_mid + ids,
                                       jspec.params.coupling_peer,
                                       market_ids)],
               [jstep.resolve_peer_mids(got.prev_mid + ids,
                                        jspec.params.coupling_peer, np,
                                        market_ids)])


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("scan", SCANS)
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_simulate_step_matches_jax_package(shape, scan, stream):
    """S steps side by side, external orders at the first, the coupling
    column frozen at entry as a chunk driver does."""
    jspec = _jspec(shape)
    M, A, L = jspec.num_markets, jspec.num_agents, jspec.num_levels
    params = jspec.params
    ours, theirs = _streams(stream, jspec.seed)
    ids = np.arange(M, dtype=np.int32)[:, None]
    atype = agents.agent_types(params, A)
    r = np.random.default_rng(L)
    eb, ea = _books(r, M, L, fill=0.2), _books(r, M, L, fill=0.2)
    a = b = step.initial_state(jspec)
    peer = step.resolve_peer_mids(a.prev_mid, params.coupling_peer)
    traded = 0.0
    for t in range(jspec.num_steps):
        ext = dict(ext_buy=eb, ext_ask=ea) if t == 0 else {}
        a, out_a = step.simulate_step(
            jspec, a, np.int32(t), ids, params, scan=scan, uniform_fn=ours,
            atype=atype, peer_mid=peer, **ext)
        b, out_b = jstep.simulate_step(
            jspec, jstep.MarketState(*b), np.int32(t), ids, np,
            bin_orders=lambda s, p, q: _bin_orders_scatter(s, p, q, M, L),
            scan=scan, uniform_fn=theirs, params=params, atype=atype,
            peer_mid=peer, **ext)
        _equal(a, b)
        _equal(out_a, out_b)
        traded += float(out_a.volume.sum())
    assert traded > 0
    # A runtime seed, the lattice recomputed, the peer defaulting to self.
    a, out_a = step.simulate_step(jspec, a, np.int32(3), ids, params,
                                  seed=11)
    b, out_b = jstep.simulate_step(
        jspec, jstep.MarketState(*b), np.int32(3), ids, np,
        bin_orders=lambda s, p, q: _bin_orders_scatter(s, p, q, M, L),
        params=params, seed=11)
    _equal([*a, *out_a], [*b, *out_b])


@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_binning_and_shock_match_jax_package(shape):
    jspec = _jspec(shape)
    M, A, L = jspec.num_markets, jspec.num_agents, jspec.num_levels
    r = np.random.default_rng(M)
    side = r.random((M, A)) < 0.5
    price = r.integers(0, L, size=(M, A)).astype(np.int32)
    qty = r.integers(0, 9, size=(M, A)).astype(np.float32)
    _equal(step.bin_orders_scatter(side, price, qty, M, L),
           _bin_orders_scatter(side, price, qty, M, L))
    bid = _books(r, M, L)
    for t in range(jspec.num_steps):
        _equal([step.apply_scenario_shock(jspec.params, bid, np.int32(t))],
               [jstep.apply_scenario_shock(jspec.params, bid, np.int32(t),
                                           np)])


# ---------------------------------------------------------------------------
# host.sequential
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_match_order_matches_jax_package(shape):
    M, _, L, S = shape
    r = np.random.default_rng(M + L)
    bid, ask = _books(r, M, L), _books(r, M, L)
    px = np.zeros((M, 1), np.float32)
    for _ in range(S):
        side = r.random((M, 1)) < 0.5
        price = r.integers(0, L, size=(M, 1)).astype(np.int32)
        qty = r.integers(1, 12, size=(M, 1)).astype(np.float32)
        got = sequential.match_order(bid, ask, px, side, price, qty)
        want = jsequential.match_order(bid, ask, px, side, price, qty, np)
        _equal(got, want)
        bid, ask, _, px = got


@pytest.mark.parametrize("stream", STREAMS)
@pytest.mark.parametrize("shape", SHAPES, ids=_id)
def test_sequential_step_matches_jax_package(shape, stream):
    jspec = _jspec(shape)
    M, A = jspec.num_markets, jspec.num_agents
    params = jspec.params
    ours, theirs = _streams(stream, jspec.seed)
    ids = np.arange(M, dtype=np.int32)[:, None]
    atype = agents.agent_types(params, A)
    a = b = step.initial_state(jspec)
    peer = step.resolve_peer_mids(a.prev_mid, params.coupling_peer)
    for t in range(jspec.num_steps):
        a, out_a = sequential.simulate_step_sequential(
            jspec, a, np.int32(t), ids, params, uniform_fn=ours,
            atype=atype, peer_mid=peer)
        b, out_b = jsequential.simulate_step_sequential(
            jspec, jstep.MarketState(*b), np.int32(t), ids, np,
            uniform_fn=theirs, params=params, atype=atype, peer_mid=peer)
        _equal(a, b)
        _equal(out_a, out_b)


# ---------------------------------------------------------------------------
# the session's tensors are views: the step never writes into them
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stats_only", [False, True])
@pytest.mark.parametrize("backend", ["numpy", "numpy-splitmix64",
                                     "numpy-pcg64"])
def test_snapshot_before_run_is_unchanged_after_it(backend, stats_only):
    cfg = MarketConfig(num_markets=6, num_agents=24, num_levels=16,
                       num_steps=12, seed=4, alpha_maker=0.15,
                       alpha_momentum=0.15)
    sess = Engine(backend, device="cpu", stats_only=stats_only).open(
        cfg, chunk_size=4)
    sess.run(3)
    snap = sess.snapshot()

    def arrays(snap):
        leaves = {k: v for k, v in snap.items() if isinstance(v, np.ndarray)}
        for group in ("params", "stats"):
            leaves.update({f"{group}.{k}": v
                           for k, v in snap.get(group, {}).items()})
        return leaves

    frozen = {k: np.array(v, copy=True) for k, v in arrays(snap).items()}
    assert {"bid", "ask", "last_price", "prev_mid",
            "params.q_max"} <= set(frozen)
    assert ("stats.sum_mid" in frozen) == stats_only
    sess.step(ExternalOrders(True, 9, 3.0))
    sess.run(6)
    for k, v in arrays(snap).items():
        assert (v == frozen[k]).all(), k
    # ... and the run from the snapshot repeats.
    after = sess.run(2).to_numpy()
    sess.restore(snap)
    sess.step(ExternalOrders(True, 9, 3.0))
    sess.run(6)
    _same(sess.run(2).to_numpy(), after)
