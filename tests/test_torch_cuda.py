"""The CUDA kernels against their plain PyTorch versions on the card, and
the kernel and framework backends against each other.

Marked ``cuda``: they need an NVIDIA card and ``nvcc``, and skip without a
card. On the card: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.
"""
import contextlib

import pytest
import torch

import chip_smoke
from repro_torch.core import params as params_mod
from repro_torch.core.config import MarketConfig
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine
from repro_torch.core.stats import init_stats
from repro_torch.core.step import initial_state
from repro_torch.kernels import autotune
from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.kernels import naive_clearing as nc

pytestmark = pytest.mark.cuda

#: (M, A, L): the paper's width, the edges, and every team shape of the
#: launch rule (one warp at L <= 128, 2 and 8 warps beyond; agents in
#: registers and in shared memory) with M = 3, so that the 15 markets of
#: `_spec` and the 3 of `_legacy_cfg` leave the last CTA ragged.
SHAPES = [(4, 256, 128), (2, 300, 1024), (8, 5, 8)] + [
    (3, A, L) for L in (4, 32, 128, 256, 1024) for A in (16, 1024)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _spec(M, A, L, S=40):
    blocks = [MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                           num_steps=S, seed=2**31 + L, **mix)
              for mix in ({"alpha_fundamentalist": 0.2},
                          {"alpha_whale": 0.2, "whale_period": 3},
                          {"alpha_hft": 0.2, "hft_threshold": 0.1},
                          {"alpha_informed": 0.2, "shock_step": 6,
                           "shock_intensity": 0.5, "shock_cancel": 0.5},
                          {"alpha_arbitrageur": 0.3})]
    spec = EnsembleSpec.concatenate([EnsembleSpec.homogeneous(b)
                                     for b in blocks])
    n = spec.num_markets
    return spec.with_values(coupling_peer=[(m + 1) % n for m in range(n)])


@pytest.mark.parametrize("M,A,L", SHAPES)
@pytest.mark.parametrize("stats_only", [False, True])
def test_kernel_equals_plain(cuda, M, A, L, stats_only):
    spec = _spec(M, A, L)
    state = initial_state(spec, cuda)
    params = params_mod.pack_params(spec.params, cuda)
    gen = torch.Generator().manual_seed(L)
    ext = [(torch.randint(0, 3, (spec.num_markets, L), generator=gen)
            .float().to(cuda)) for _ in range(2)]
    kw = dict(cfg=spec, chunk=16, params=params, stats_only=stats_only,
              stats=init_stats(spec.num_markets, cuda) if stats_only
              else None)
    got = kc.kinetic_clearing_chunk(*state, 3, 12, *ext, **kw)
    want = kc.kinetic_clearing_chunk_plain(*state, 3, 12, *ext, **kw)
    torch.cuda.synchronize()
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    rest = zip(got[4], want[4]) if stats_only else \
        ((g[:, :12], w[:, :12]) for g, w in zip(got[4:], want[4:]))
    for g, w in rest:
        assert torch.equal(g, w)


@pytest.mark.parametrize("L", [4, 128, 1024])
@pytest.mark.parametrize("A", [16, 1024, 4096, 50000])
def test_launch_rule_shapes_are_resident(cuda, A, L):
    """Every kernel takes the rule's shape: its C entry accepts it and at
    least one CTA of it fits on an SM."""
    shape = autotune.auto_tile(L, A)
    for module in (kc, nc):
        for legacy in (False, True):
            assert module.resident_ctas(legacy, shape) >= 1


#: (M, A, L) of large populations on few and on many markets.
RULE_SHAPES = [(10, 46080, 128), (10, 20000, 1024), (1, 40000, 128),
               (64, 30000, 128), (264, 30000, 128), (1, 100000, 128),
               (16, 50000, 1024), (128, 50000, 128), (8192, 20000, 1024),
               (2048, 30000, 128), (1024, 40000, 1024), (1, 30000, 128),
               (4, 20000, 1024)]


@pytest.mark.parametrize("W", autotune.WARPS_PER_MARKET)
def test_h100_holds_is_this_cards(cuda, W):
    """On an H100 what the rule counts without a card (``h100_holds``) is
    what the card holds at once, at every agent mode and C of a team of W
    warps at L=128, for the persistent and the per-step kernels; and the
    rules' shapes at large populations are the ones they take without a
    card."""
    if "H100" not in torch.cuda.get_device_name(cuda):
        pytest.skip("h100_holds is an H100's table")
    for C in autotune.CTAS_PER_MARKET:
        for mode, A in (("registers", 256 * W * C), ("shared", 2000 * C),
                        ("shared", 24000 * C), ("fresh", 100000 * C)):
            tile = autotune.TileChoice(128, A, W, 1, mode, C)
            assert autotune.card_holds(tile) == autotune.h100_holds(tile), \
                tile
            assert autotune.card_holds(tile, hoisted=False) == \
                autotune.h100_holds(tile, False), tile
    if W == autotune.MAX_TEAM_WARPS:
        for M, A, L in RULE_SHAPES:
            assert autotune.auto_tile(L, A, M) == autotune.auto_tile(
                L, A, M, sms=autotune.TARGET_SMS, max_ctas=16,
                holds=autotune.h100_holds)
            assert autotune.auto_tile(L, A, M, hoisted=False) == \
                autotune.auto_tile(L, A, M, sms=autotune.TARGET_SMS,
                                   max_ctas=16, hoisted=False)


def test_session_launches_once_per_chunk(cuda):
    spec = _spec(4, 64, 32, S=50)
    chip_smoke.reset_counts()
    with Engine("cuda-kinetic", device=cuda).open(spec, chunk_size=16) as s:
        got = s.run_to_result()
    chip_smoke.expect_counts("session", {"kinetic_clearing_chunk": 4})
    with Engine("cuda-kinetic", device="cpu").open(spec,
                                                   chunk_size=16) as s:
        want = s.run_to_result()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("M,A,L", SHAPES)
@pytest.mark.parametrize("stats_only", [False, True])
def test_naive_kernel_equals_plain(cuda, M, A, L, stats_only):
    spec = _spec(M, A, L)
    state = initial_state(spec, cuda)
    params = params_mod.pack_params(spec.params, cuda)
    gen = torch.Generator().manual_seed(L + 1)
    ext = [(torch.randint(0, 3, (spec.num_markets, L), generator=gen)
            .float().to(cuda)) for _ in range(2)]
    kw = dict(cfg=spec, chunk=16, params=params, stats_only=stats_only,
              stats=init_stats(spec.num_markets, cuda) if stats_only
              else None)
    before = nc.naive_clearing_chunk.launches
    got = nc.naive_clearing_chunk(*state, 3, 12, *ext, **kw)
    want = nc.naive_clearing_chunk_plain(*state, 3, 12, *ext, **kw)
    torch.cuda.synchronize()
    assert nc.naive_clearing_chunk.launches == before + 12
    for g, w in zip(got[:4], want[:4]):
        assert torch.equal(g, w)
    rest = zip(got[4], want[4]) if stats_only else \
        ((g[:, :12], w[:, :12]) for g, w in zip(got[4:], want[4:]))
    for g, w in rest:
        assert torch.equal(g, w)


def test_naive_zero_steps_launch_nothing_and_copy(cuda):
    spec = _spec(4, 16, 16)
    state = initial_state(spec, cuda)
    before = nc.naive_clearing_chunk.launches
    out = nc.naive_clearing_chunk(*state, 0, 0, cfg=spec, chunk=4)
    assert nc.naive_clearing_chunk.launches == before
    for g, w in zip(out[:4], state):
        assert torch.equal(g, w) and g.data_ptr() != w.data_ptr()


def _legacy_cfg(M, A, L, S=20):
    """Arbitrageurs (peer = own mid at every step), a shock and informed
    agents, so a frozen peer or a wrong params column shows."""
    return MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                        num_steps=S, seed=2**31 + L, alpha_arbitrageur=0.2,
                        alpha_informed=0.1, alpha_whale=0.1, whale_period=3,
                        shock_step=6, shock_intensity=0.5, shock_cancel=0.5)


@pytest.mark.parametrize("M,A,L", SHAPES)
@pytest.mark.parametrize("entry", ["kinetic", "naive"])
def test_legacy_kernel_equals_plain(cuda, entry, M, A, L):
    cfg = _legacy_cfg(M, A, L)
    fn, plain = ((kc.kinetic_clearing, kc.kinetic_clearing_plain)
                 if entry == "kinetic"
                 else (nc.naive_clearing, nc.naive_clearing_plain))
    state = initial_state(cfg, cuda)
    before = fn.launches
    got = fn(*state, cfg=cfg)
    want = plain(*state, cfg=cfg)
    torch.cuda.synchronize()
    assert fn.launches == before + (1 if entry == "kinetic"
                                    else cfg.num_steps)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_naive_session_launches_once_per_step(cuda):
    spec = _spec(4, 64, 32, S=50)
    chip_smoke.reset_counts()
    with Engine("cuda-naive", device=cuda).open(spec, chunk_size=16) as s:
        got = s.run_to_result()
    chip_smoke.expect_counts("naive session", {"naive_clearing_chunk": 50})
    with Engine("cuda-kinetic", device=cuda).open(spec, chunk_size=16) as s:
        want = s.run_to_result()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("backend", ["torch-scan", "torch-per-step"])
@pytest.mark.parametrize("stats_only", [False, True])
def test_torch_backends_equal_cuda_kinetic(cuda, backend, stats_only):
    spec = _spec(4, 64, 32, S=50)

    def run(name):
        with Engine(name, device=cuda, stats_only=stats_only).open(
                spec, chunk_size=16) as s:
            batch = s.run()
            return list(s.state) + (list(s.stats) if stats_only
                                    else list(batch))

    for g, w in zip(run(backend), run("cuda-kinetic")):
        assert (torch.as_tensor(g).cpu() == torch.as_tensor(w).cpu()).all()


@pytest.mark.parametrize("case", chip_smoke.PARITY_TIER1,
                         ids=lambda c: "-".join(map(str, c)))
def test_parity_tier1_on_the_card(cuda, case):
    """The parity subset: kernels 1 and 2 and ``torch-scan`` on the card
    equal the host ``numpy`` reference, field by field; the statistics are
    within 0.1% of it."""
    from repro_torch.core import engine

    cfg = chip_smoke.parity_config(case)
    want = engine.simulate(cfg, backend="numpy", device="cpu").to_numpy()
    got = {b: engine.simulate(cfg, backend=b, device=cuda).to_numpy()
           for b in ("cuda-kinetic", "cuda-naive", "torch-scan")}
    assert chip_smoke.parity_faults(got, want) == []


def test_coupled_scenario_on_the_card_equals_the_host(cuda):
    """``open_scenario`` on kernel 1, and a ring-coupled product sweep, equal
    the host ``numpy`` reference over the same chunk boundaries."""
    from repro_torch.core import engine
    from repro_torch.scenario import CouplingSpec, coupled_ensemble

    over = dict(num_markets=16, num_agents=64, num_levels=64, num_steps=40,
                seed=5, alpha_arbitrageur=0.2)
    chip_smoke.reset_counts()
    with engine.open_scenario("flash-crash", device=cuda,
                              config_overrides=over, chunk_size=16) as s:
        got = s.run_to_result().to_numpy()
    chip_smoke.expect_counts("scenario", {"kinetic_clearing_chunk": 3})
    with engine.open_scenario("flash-crash", backend="numpy", device="cpu",
                              config_overrides=over, chunk_size=16) as s:
        want = s.run_to_result().to_numpy()
    for g, w in zip(got, want):
        assert (g == w).all()

    base = MarketConfig(num_markets=4, num_agents=64, num_levels=64,
                        num_steps=40, seed=6, alpha_arbitrageur=0.1)
    spec = coupled_ensemble(EnsembleSpec.product(
        base, {"alpha_momentum": (0.15, 0.5), "p_marketable": (0.1, 0.2)}),
        CouplingSpec.ring(16))
    runs = {}
    for backend, device in (("cuda-kinetic", cuda), ("numpy", "cpu")):
        with Engine(backend, device=device).open(spec, chunk_size=16) as s:
            runs[backend] = s.run_to_result().to_numpy()
    for g, w in zip(runs["cuda-kinetic"], runs["numpy"]):
        assert (g == w).all()


@pytest.mark.parametrize("A,L", [(50000, 128), (45000, 1024)])
def test_fresh_agent_mode_equals_plain(cuda, A, L):
    """Past shared memory the persistent kernels (1 and 3) recompute each
    agent's key and type every step, and still equal their plain
    versions bit for bit."""
    assert autotune.auto_tile(L, A).agents == "fresh"
    spec = _spec(2, A, L, S=8)
    state = initial_state(spec, cuda)
    kw = dict(cfg=spec, chunk=6,
              params=params_mod.pack_params(spec.params, cuda))
    got = kc.kinetic_clearing_chunk(*state, 1, 6, **kw)
    want = kc.kinetic_clearing_chunk_plain(*state, 1, 6, **kw)
    cfg = _legacy_cfg(3, A, L, S=8)
    lstate = initial_state(cfg, cuda)
    lgot = kc.kinetic_clearing(*lstate, cfg=cfg)
    lwant = kc.kinetic_clearing_plain(*lstate, cfg=cfg)
    torch.cuda.synchronize()
    for g, w in zip(list(got) + list(lgot), list(want) + list(lwant)):
        assert torch.equal(g, w)


def _env_rollout(backend, device, spec, steps, obs=None):
    from repro_torch.env import rollout
    from repro_torch.train import make_market_maker

    env = Engine(backend, device=device).env(spec, horizon=16, obs=obs)
    return rollout(env, make_market_maker(spec.num_levels), steps)


@pytest.mark.parametrize("backend,counter", [
    ("cuda-kinetic", kc.kinetic_clearing_chunk),
    ("cuda-naive", nc.naive_clearing_chunk)])
def test_env_launches_once_per_step_and_equals_the_host(cuda, backend,
                                                         counter):
    """The env on a kernel backend launches its kernel once per env step,
    and its maker rollout (across two auto-resets, composite observations)
    equals ``torch-scan`` on the card and the plain version on the CPU."""
    from repro_torch.env import (BookWindow, Composite, MarketFeatures,
                                 PortfolioFeatures, StatsFeatures)

    spec = _spec(3, 256, 128, S=40)
    obs = Composite((MarketFeatures(), BookWindow(4), PortfolioFeatures(),
                     StatsFeatures()))
    chip_smoke.reset_counts()
    final, batch = _env_rollout(backend, cuda, spec, 40, obs)
    torch.cuda.synchronize()
    chip_smoke.expect_counts("env", {counter.__name__: 40})
    want = [_env_rollout(b, d, spec, 40, obs)
            for b, d in (("torch-scan", cuda), (backend, "cpu"))]
    for _, ref in want:
        for g, w in zip(batch.to_numpy()[:8], ref.to_numpy()[:8]):
            assert (g == w).all()
    assert batch.to_numpy().fill_buy.sum() > 0


def test_env_zero_actions_equal_session_run_on_the_card(cuda):
    """Without arbitrageurs (whose peer mid the env resolves every step and
    a chunked run once a chunk), a zero-action rollout equals ``run``."""
    from repro_torch.env import rollout

    spec = _spec(4, 256, 128, S=40).with_values(
        coupling_peer=-1, num_arbitrageurs=0)
    eng = Engine("cuda-kinetic", device=cuda)
    chip_smoke.reset_counts()
    final, batch = rollout(eng.env(spec, auto_reset=False), None, 40)
    chip_smoke.expect_counts("zero actions", {"kinetic_clearing_chunk": 40})
    with eng.open(spec) as sess:
        ref = sess.run(40)
        for g, w in zip(list(batch[3:6]) + list(final.market),
                        list(ref) + list(sess.state)):
            assert torch.equal(g, w)


def _train(backend, device, updates=2):
    """A small trainer (3 markets of each TRAIN_MIX scenario at A=256,
    L=128) after ``updates`` updates of a 16-step rollout."""
    from repro_torch.env import MarketFeatures, SpreadCapture
    from repro_torch.train import PPOConfig

    spec = chip_smoke.train_spec(chip_smoke.TRAIN_MIX, 3, 256, 128, 16, 7)
    cfg = PPOConfig(rollout_len=16, num_epochs=2, num_minibatches=4,
                    hidden=(16,), seed=7)
    tr = Engine(backend, device=device).trainer(
        spec, cfg, reward=SpreadCapture(), obs=MarketFeatures())
    ts, metrics = tr.train(tr.init(), updates)
    return tr, ts, metrics


@pytest.mark.parametrize("backend,counter", [
    ("cuda-kinetic", kc.kinetic_clearing_chunk),
    ("cuda-naive", nc.naive_clearing_chunk)])
def test_trainer_launches_once_per_env_step_and_equals_torch_scan(
        cuda, backend, counter):
    """A trainer on a kernel backend launches its kernel once per env step
    of every rollout (and of a greedy evaluation), and trains bit for bit
    as ``torch-scan`` on the card: params, Adam state, key, metrics and the
    final env state."""
    chip_smoke.reset_counts()
    tr, ts, metrics = _train(backend, cuda)
    torch.cuda.synchronize()
    chip_smoke.expect_counts("trainer", {counter.__name__: 2 * 16})
    counter.launches = 0
    tr.evaluate(ts.params, n_steps=5)
    assert counter.launches == 5
    _, want_ts, want_metrics = _train("torch-scan", cuda)
    for g, w in zip(chip_smoke.train_outputs(ts, metrics),
                    chip_smoke.train_outputs(want_ts, want_metrics)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("mode", autotune.AGENT_MODES)
@pytest.mark.parametrize("C", autotune.CTAS_PER_MARKET[1:])
@pytest.mark.parametrize("W,L", [(1, 128), (2, 64), (4, 128), (8, 1024)])
def test_market_cluster_equals_plain(cuda, W, L, C, mode):
    """Kernels 1 and 3 with each market on a cluster of C CTAs (one team a
    CTA, in each agent mode, each CTA holding its own agents' keys) equal
    their plain versions: paths and stats, external orders, a shock,
    ring-coupled arbitrageurs, a partial chunk; the launch runs as a
    cluster (the card holds at least one). The registers mode takes the
    most agents it holds, 8·32·W·C, up to 3,001."""
    A = min(3001, 8 * 32 * W * C) if mode == "registers" else 3001
    tile = autotune.TileChoice(L, A, W, 1, mode, C)
    assert kc.resident_ctas(False, tile) >= 1
    spec = _spec(3, A, L, S=12)
    M = spec.num_markets
    state = initial_state(spec, cuda)
    params = params_mod.pack_params(spec.params, cuda)
    gen = torch.Generator().manual_seed(C * 100 + W)
    eb, ea = ((torch.randint(0, 3, (M, L), generator=gen)
               * (torch.rand((M, L), generator=gen) < 0.2))
              .to(torch.float32).to(cuda) for _ in range(2))
    for stats_only in (False, True):
        kw = dict(cfg=spec, chunk=10, params=params, stats_only=stats_only,
                  stats=init_stats(M, cuda) if stats_only else None)
        got = kc.kinetic_clearing_chunk(*state, 3, 9, eb, ea, tile=tile,
                                        **kw)
        want = kc.kinetic_clearing_chunk_plain(*state, 3, 9, eb, ea, **kw)
        torch.cuda.synchronize()
        flat = (lambda out: list(out[:4]) + list(out[4])) if stats_only \
            else (lambda out: list(out[:4]) + [p[:, :9] for p in out[4:]])
        for g, w in zip(flat(got), flat(want)):
            assert torch.equal(g, w)
    cfg = _legacy_cfg(5, A, L, S=9)
    lstate = initial_state(cfg, cuda)
    lgot = kc.kinetic_clearing(*lstate, cfg=cfg, tile=tile)
    lwant = kc.kinetic_clearing_plain(*lstate, cfg=cfg)
    torch.cuda.synchronize()
    for g, w in zip(lgot, lwant):
        assert torch.equal(g, w)


@pytest.mark.parametrize("C", autotune.CTAS_PER_MARKET[1:])
@pytest.mark.parametrize("W,L", [(1, 128), (2, 64), (8, 128), (8, 1024)])
def test_step_kernels_on_a_cluster_equal_plain(cuda, W, L, C):
    """Kernels 2 and 4 with each market on a cluster of C CTAs (one team a
    CTA, past the registers mode) equal their plain versions: paths and
    stats, external orders, a shock, ring-coupled arbitrageurs, a partial
    chunk, and the legacy entry's own-mid peer; the launch runs as a
    cluster (the card holds at least one)."""
    A = 3001
    tile = autotune.TileChoice(L, A, W, 1, autotune.auto_tile(L, A).agents,
                               C)
    assert all(nc.resident_ctas(legacy, tile) >= 1
               for legacy in (False, True))
    spec = _spec(3, A, L, S=12)
    M = spec.num_markets
    state = initial_state(spec, cuda)
    params = params_mod.pack_params(spec.params, cuda)
    gen = torch.Generator().manual_seed(C * 100 + W)
    eb, ea = ((torch.randint(0, 3, (M, L), generator=gen)
               * (torch.rand((M, L), generator=gen) < 0.2))
              .to(torch.float32).to(cuda) for _ in range(2))
    for stats_only in (False, True):
        kw = dict(cfg=spec, chunk=10, params=params, stats_only=stats_only,
                  stats=init_stats(M, cuda) if stats_only else None)
        before = nc.naive_clearing_chunk.launches
        got = nc.naive_clearing_chunk(*state, 3, 9, eb, ea, tile=tile, **kw)
        want = nc.naive_clearing_chunk_plain(*state, 3, 9, eb, ea, **kw)
        torch.cuda.synchronize()
        assert nc.naive_clearing_chunk.launches - before == 9
        flat = (lambda out: list(out[:4]) + list(out[4])) if stats_only \
            else (lambda out: list(out[:4]) + [p[:, :9] for p in out[4:]])
        for g, w in zip(flat(got), flat(want)):
            assert torch.equal(g, w)
    cfg = _legacy_cfg(5, A, L, S=9)
    lstate = initial_state(cfg, cuda)
    lgot = nc.naive_clearing(*lstate, cfg=cfg, tile=tile)
    lwant = nc.naive_clearing_plain(*lstate, cfg=cfg)
    torch.cuda.synchronize()
    for g, w in zip(lgot, lwant):
        assert torch.equal(g, w)


@pytest.mark.parametrize(
    "tile", autotune.candidate_tiles(128, 256, hoisted=True),
    ids=lambda t: f"W{t.warps_per_market}-MPC{t.markets_per_cta}-{t.agents}")
def test_every_table_iv_candidate_equals_the_rule(cuda, tile):
    """Kernel 1 at every launch shape the sweep may pick at the Table IV
    width (A=256, L=128) equals the rule's launch and the plain version,
    paths and stats, on 265 markets (two waves of 132 SMs and a ragged
    CTA)."""
    spec = _spec(53, 256, 128, S=64)
    state = initial_state(spec, cuda)
    params = params_mod.pack_params(spec.params, cuda)
    for stats_only in (False, True):
        kw = dict(cfg=spec, chunk=64, params=params, stats_only=stats_only,
                  stats=init_stats(spec.num_markets, cuda) if stats_only
                  else None)
        rule = kc.kinetic_clearing_chunk(*state, 0, 64, **kw)
        got = kc.kinetic_clearing_chunk(*state, 0, 64, tile=tile, **kw)
        plain = kc.kinetic_clearing_chunk_plain(*state, 0, 64, **kw)
        torch.cuda.synchronize()
        flat = (lambda out: list(out[:4]) + list(out[4])) if stats_only \
            else (lambda out: list(out))
        for g, r, p in zip(flat(got), flat(rule), flat(plain)):
            assert torch.equal(g, r) and torch.equal(g, p)


def test_two_shard_mesh_on_one_card_equals_unsharded(cuda):
    """A mesh naming ``cuda:0`` twice: a ring-coupled run whose peers cross
    the cut equals the unsharded run, with two launches a chunk."""
    from repro_torch.launch import MarketsMesh

    spec = _spec(20, 64, 128, S=48)
    mesh = MarketsMesh.of([cuda, cuda])
    runs = {}
    for label, opts in (("one", {}), ("two", {"mesh": mesh})):
        eng = Engine("cuda-kinetic", device=cuda, chunk_size=16, **opts)
        with eng.open(spec) as sess:
            kc.kinetic_clearing_chunk.launches = 0
            batch = sess.run(48)
            torch.cuda.synchronize()
            runs[label] = (list(sess.state) + list(batch),
                           kc.kinetic_clearing_chunk.launches)
    assert runs["one"][1] == 3 and runs["two"][1] == 6
    for g, w in zip(runs["two"][0], runs["one"][0]):
        assert torch.equal(g, w)


def test_roofline_records_table_iv_run_on_the_card(cuda):
    """``Session.run(500)`` at Table IV under a ``Roofline``: its kernel
    record equals the launches counted and ``op_count``/``byte_count``
    summed over the eight chunks (the last runs 52 steps), and the run
    equals the unrecorded one."""
    from repro_torch.launch import Roofline

    M, A, L, S, chunk = 8192, 256, 128, 500, 64
    spec = EnsembleSpec.homogeneous(MarketConfig(
        num_markets=M, num_agents=A, num_levels=L, num_steps=S,
        seed=chip_smoke.SEED))
    eng = Engine("cuda-kinetic", device=cuda, chunk_size=chunk)
    runs = []
    for record in (False, True):
        with eng.open(spec) as sess:
            torch.cuda.synchronize()
            kc.kinetic_clearing_chunk.launches = 0
            with Roofline() if record else contextlib.nullcontext() as rf:
                batch = sess.run(S)
            torch.cuda.synchronize()
            runs.append(list(sess.state) + list(batch))
    for g, w in zip(runs[1], runs[0]):
        assert torch.equal(g, w)
    steps = [min(chunk, S - s) for s in range(0, S, chunk)]
    mix = kc.agent_mix(spec.params, A)
    assert kc.kinetic_clearing_chunk.launches == len(steps) == 8
    assert rf.summarize()["kernels"] == {"kinetic_clearing_chunk": dict(
        calls=8, launches=8,
        operations=sum(kc.op_count(M, A, L, n, mix) for n in steps),
        bytes=sum(kc.byte_count(M, L, n, ext=False, stats_only=False)
                  for n in steps))}


@pytest.mark.parametrize("shards", [2, 3])
def test_rows_stay_on_their_shards_on_the_card(cuda, shards):
    """On a mesh naming ``cuda:0`` ``shards`` times, every leaf a session
    holds is its shards' own rows on the card after every chunk, a swap
    and a restore, and the run equals the unsharded one."""
    from repro_torch.launch import MarketsMesh

    spec = _spec(20, 64, 128, S=48)
    sub = _spec(2, 64, 128, S=48)
    mesh = MarketsMesh.of([cuda] * shards)
    runs = {}
    for label, opts in (("one", {}), ("many", {"mesh": mesh})):
        eng = Engine("cuda-kinetic", device=cuda, chunk_size=16, **opts)
        with eng.open(spec) as sess:
            out = []
            for batch in sess.stream(32):
                out += list(batch)
                if opts:
                    chip_smoke.check_resident(sess, mesh, spec.num_markets)
            sess.swap_markets(list(range(30, 35)) + list(range(64, 69)),
                              sub)
            sess.restore(sess.snapshot())
            if opts:
                chip_smoke.check_resident(sess, mesh, spec.num_markets)
            out += list(sess.run(16)) + list(sess.state)
            torch.cuda.synchronize()
            runs[label] = out
    for g, w in zip(runs["many"], runs["one"]):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------------
# Rollouts and updates as CUDA graphs.
# ---------------------------------------------------------------------------

GRAPH_BACKENDS = [("cuda-kinetic", kc.kinetic_clearing_chunk),
                  ("cuda-naive", nc.naive_clearing_chunk),
                  ("torch-scan", None), ("torch-per-step", None)]


def _graph_env(backend, device, horizon=16):
    from repro_torch.env import (BookWindow, Composite, MarketFeatures,
                                 PortfolioFeatures, StatsFeatures)

    obs = Composite((MarketFeatures(), BookWindow(4), PortfolioFeatures(),
                     StatsFeatures()))
    eng = Engine(backend, device=device)
    return eng, eng.env(_spec(3, 256, 128, S=40), horizon=horizon, obs=obs)


def _leaves(tree):
    from repro_torch.core import graphs

    return graphs.flatten(tree)[0]


@pytest.mark.parametrize("backend,counter", GRAPH_BACKENDS)
def test_rollout_graph_equals_its_eager_body(cuda, backend, counter):
    """A maker rollout across two auto-resets: the first call of its key
    (the eager body, captured), a warm replay under torch's sync debug
    mode at "error" (capturing nothing) and the host loop all equal bit
    for bit; each call launches the kernel once a step; a replay's outputs
    survive the next replay; another start cursor is another graph."""
    from repro_torch.env import rollout
    from repro_torch.train import make_market_maker

    eng, env = _graph_env(backend, cuda)
    maker = make_market_maker(128)
    state0, _ = env.reset()
    runs, counts = [], []
    for warm in (False, True):
        builds = eng.trace_count
        chip_smoke.reset_counts()
        torch.cuda.set_sync_debug_mode("error" if warm else "default")
        try:
            runs.append(rollout(env, maker, 40, state=state0))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts.append(chip_smoke.read_counts())
        assert eng.trace_count == builds + (0 if warm else 1)
    want = {counter.__name__: 40} if counter else {}
    for c in counts:
        assert {k: n for k, n in c.items() if n} == want
    kept = [x.clone() for x in _leaves(runs[1])]
    rollout(env, maker, 40, state=state0)
    rollout(env, maker, 40, state=runs[0][0])     # t0 = 8: a new key
    assert eng.trace_count == builds + 1
    env._graphed = False
    host = rollout(env, maker, 40, state=state0)
    torch.cuda.synchronize()
    for got, first, again, loop in zip(_leaves(runs[1]), _leaves(runs[0]),
                                       kept, _leaves(host)):
        assert torch.equal(got, first) and torch.equal(got, again)
        assert torch.equal(got, loop)


def test_rollout_graph_records_what_its_eager_body_records(cuda):
    """Under a ``Roofline`` a replay reports the kernel calls and aten ops
    its capture recorded: the same records as the eager body's first
    call, and the launch counters agree."""
    from repro_torch.env import rollout
    from repro_torch.launch import Roofline
    from repro_torch.train import make_market_maker

    eng, env = _graph_env("cuda-kinetic", cuda)
    maker = make_market_maker(128)
    state0, _ = env.reset()
    sums = []
    for _ in range(2):
        kc.kinetic_clearing_chunk.launches = 0
        with Roofline() as rf:
            rollout(env, maker, 20, state=state0)
        torch.cuda.synchronize()
        sums.append(rf.summarize())
        assert kc.kinetic_clearing_chunk.launches == 20
    first, replay = sums
    assert replay["kernels"] == first["kernels"]
    assert replay["kernels"]["kinetic_clearing_chunk"]["launches"] == 20
    for key in ("aten_calls", "operations", "hbm_bytes", "flops"):
        assert replay[key] == first[key], key


def test_host_values_a_policy_returns_are_baked(cuda):
    """A policy returning host values (Python scalars, numpy arrays)
    replays them as the capture saw them: the graph equals the host
    loop."""
    import numpy as np
    from repro_torch.env import rollout

    _, env = _graph_env("cuda-kinetic", cuda)
    M = env.num_markets

    def policy(obs, t):
        return (t % 2 == 0, np.full(M, 60 + t % 5), 1.0 + t % 3)

    state0, _ = env.reset()
    first = rollout(env, policy, 20, state=state0)
    warm = rollout(env, policy, 20, state=state0)
    env._graphed = False
    host = rollout(env, policy, 20, state=state0)
    torch.cuda.synchronize()
    for a, b, c in zip(_leaves(first), _leaves(warm), _leaves(host)):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert float(warm[1].fill_buy.sum() + warm[1].fill_ask.sum()) > 0


def test_a_policy_that_waits_for_the_card_raises(cuda):
    """A policy that reads a value back cannot be captured: the rollout
    raises naming the policy at its first such read, and no host loop runs
    in its place."""
    from repro_torch.core import graphs
    from repro_torch.env import rollout

    eng, env = _graph_env("cuda-kinetic", cuda)
    calls = []

    def reads_back(obs, t):
        calls.append(t)
        return (True, int(obs[0, 0].item()), 1.0)

    with pytest.raises(graphs.GraphCaptureError, match="reads_back"):
        rollout(env, reads_back, 10)
    assert calls == [0] and eng.graph_keys() == []


@pytest.mark.parametrize("backend", ["cuda-kinetic", "cuda-naive",
                                     "torch-scan"])
def test_update_graph_equals_the_eager_update_and_resumes(cuda, backend,
                                                          tmp_path):
    """2 updates (the first the eager body, captured; the second a replay)
    and 2 warm ones (replays, under torch's sync debug mode at "error")
    equal the eager body's 2 + 2; 2 updates, a checkpoint restored into a
    fresh trainer and into the warm one (no capture), and 2 more equal 4;
    the trainer holds its update's and its greedy rollout's graphs."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train import (restore_train_checkpoint,
                                   save_train_checkpoint)

    tr, ts2, m2 = _train(backend, cuda)
    eng = tr.env.engine
    builds = eng.trace_count
    torch.cuda.set_sync_debug_mode("error")
    try:
        ts4, m4 = tr.train(ts2, 2)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert eng.trace_count == builds
    tr.env._graphed = False
    e2, em2 = tr.train(tr.init(), 2)
    e4, em4 = tr.train(e2, 2)
    tr.env._graphed = True
    torch.cuda.synchronize()
    for got, want in ((chip_smoke.train_outputs(ts2, m2),
                       chip_smoke.train_outputs(e2, em2)),
                      (chip_smoke.train_outputs(ts4, m4),
                       chip_smoke.train_outputs(e4, em4))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    save_train_checkpoint(CheckpointManager(tmp_path, async_write=False),
                          tr, ts2)
    fresh, _, _ = _train(backend, cuda, updates=0)
    for trainer in (fresh, tr):
        builds = trainer.env.engine.trace_count
        ts, m = trainer.train(restore_train_checkpoint(
            CheckpointManager(tmp_path), trainer), 2)
        if trainer is tr:
            assert eng.trace_count == builds
        for g, w in zip(chip_smoke.train_outputs(ts, m),
                        chip_smoke.train_outputs(ts4, m4)):
            assert torch.equal(g, w)
    tr.evaluate(ts4.params, n_steps=16)
    tr.evaluate(ts4.params, n_steps=16)
    assert len(tr.graphs()) == 2


@pytest.mark.parametrize("backend,A,tile", [
    ("cuda-kinetic", 20000, (1, 1, "shared", 1)),    # 101 KB: the opt-in
    ("cuda-kinetic", 50000, (8, 1, "fresh", 16)),    # a non-portable C
    ("cuda-naive", 50000, (8, 1, "fresh", 16))])
def test_rollout_graph_at_shapes_that_set_kernel_attributes(cuda, backend,
                                                            A, tile):
    """Launch shapes whose wrappers call ``cudaFuncSetAttribute`` at every
    launch (past 48 KB of shared memory; a cluster of 16 CTAs) capture and
    replay equal to the eager body."""
    from repro_torch.env import rollout
    from repro_torch.train import make_market_maker

    eng = Engine(backend, device=cuda, autotune=False,
                 tile=autotune.TileChoice(128, A, *tile))
    env = eng.env(chip_smoke.homogeneous(2, A, 128, 8), horizon=8)
    state0, _ = env.reset()
    maker = make_market_maker(128)
    first = rollout(env, maker, 6, state=state0)
    again = rollout(env, maker, 6, state=state0)
    torch.cuda.synchronize()
    assert len(eng.graph_keys()) == 1
    for g, w in zip(_leaves(again), _leaves(first)):
        assert torch.equal(g, w)
