"""The CUDA kernels against their plain PyTorch versions on the card, and
the kernel and framework backends against each other.

Marked ``cuda``: they need an NVIDIA card and ``nvcc``, and skip without a
card. On the card: ``PYTHONPATH=src python -m pytest -m cuda
tests/test_torch_cuda.py``.
"""
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


def test_session_launches_once_per_chunk(cuda):
    spec = _spec(4, 64, 32, S=50)
    kc.kinetic_clearing_chunk.launches = 0
    with Engine("cuda-kinetic", device=cuda).open(spec, chunk_size=16) as s:
        got = s.run_to_result()
    assert kc.kinetic_clearing_chunk.launches == 4
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
    nc.naive_clearing_chunk.launches = 0
    with Engine("cuda-naive", device=cuda).open(spec, chunk_size=16) as s:
        got = s.run_to_result()
    assert nc.naive_clearing_chunk.launches == 50
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
    kc.kinetic_clearing_chunk.launches = 0
    with engine.open_scenario("flash-crash", device=cuda,
                              config_overrides=over, chunk_size=16) as s:
        got = s.run_to_result().to_numpy()
    assert kc.kinetic_clearing_chunk.launches == 3
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
    counter.launches = 0
    final, batch = _env_rollout(backend, cuda, spec, 40, obs)
    torch.cuda.synchronize()
    assert counter.launches == 40
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
    kc.kinetic_clearing_chunk.launches = 0
    final, batch = rollout(eng.env(spec, auto_reset=False), None, 40)
    assert kc.kinetic_clearing_chunk.launches == 40
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
    counter.launches = 0
    tr, ts, metrics = _train(backend, cuda)
    torch.cuda.synchronize()
    assert counter.launches == 2 * 16
    counter.launches = 0
    tr.evaluate(ts.params, n_steps=5)
    assert counter.launches == 5
    _, want_ts, want_metrics = _train("torch-scan", cuda)
    for g, w in zip(chip_smoke.train_outputs(ts, metrics),
                    chip_smoke.train_outputs(want_ts, want_metrics)):
        assert torch.equal(g, w)
