"""The port's ``torch-scan``, ``torch-per-step`` and ``cuda-naive`` backends
on ``device="cpu"`` against the JAX package's ``jax-scan``,
``jax-per-step``, ``pallas-naive`` (interpret mode) and ``numpy``
backends, on the heterogeneous coupled spec of ``test_torch_session``."""
import numpy as np
import pytest

from repro.core.session import Engine as JEngine
from repro.core.session import ExternalOrders as JOrders
from repro_torch.core import engine, torch_backend
from repro_torch.core.config import MarketConfig
from repro_torch.core.session import Engine, ExternalOrders, backend_available
from repro_torch.kernels import autotune, ops, ref
from test_torch_session import _jspec, _port, _same

PORT_BACKENDS = ("torch-scan", "torch-per-step", "cuda-naive")
#: Each port backend and its counterpart in the JAX package.
COUNTERPART = {"torch-scan": "jax-scan", "torch-per-step": "jax-per-step",
               "cuda-naive": "pallas-naive"}


@pytest.fixture(scope="module")
def numpy_result():
    return JEngine("numpy").open(_jspec(), chunk_size=5).run_to_result()


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_backend_matches_its_counterpart_and_numpy(backend, numpy_result):
    jspec = _jspec()
    want = JEngine(COUNTERPART[backend]).open(jspec, chunk_size=5) \
        .run_to_result()
    got = Engine(backend, device="cpu").open(_port(jspec), chunk_size=5) \
        .run_to_result()
    _same(got.to_numpy(), want.to_numpy())
    _same(got.to_numpy(), numpy_result.to_numpy())
    assert np.asarray(want.volume_path).sum() > 0


@pytest.fixture(scope="module")
def pallas_naive_result():
    return JEngine("pallas-naive").open(_jspec(), chunk_size=5) \
        .run_to_result()


@pytest.mark.parametrize("C", autotune.CTAS_PER_MARKET[1:])
def test_cuda_naive_on_a_cluster_matches_pallas_naive_and_numpy(
        C, numpy_result, pallas_naive_result):
    """``cuda-naive`` pinned to a market cluster of C CTAs (one team a CTA;
    on the CPU its plain version) equals ``repro``'s ``pallas-naive`` in
    interpret mode and its ``numpy`` reference, field by field."""
    jspec = _jspec()
    L, A = jspec.num_levels, jspec.num_agents
    tile = autotune.TileChoice(L, A, 1, 1, autotune.auto_tile(L, A).agents,
                               C)
    assert autotune.check_tile(tile, L, A, False) is tile
    sess = Engine("cuda-naive", device="cpu", tile=tile).open(
        _port(jspec), chunk_size=5)
    assert sess._runner.tile == tile
    got = sess.run_to_result().to_numpy()
    _same(got, pallas_naive_result.to_numpy())
    _same(got, numpy_result.to_numpy())


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_stats_only_matches_numpy(backend):
    jspec = _jspec()
    js = JEngine("numpy", stats_only=True).open(jspec, chunk_size=4)
    js.run()
    ts = Engine(backend, device="cpu", stats_only=True).open(
        _port(jspec), chunk_size=4)
    batch = ts.run()
    assert batch.num_steps == 0
    _same(ts.stats, js.stats)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_step_actions_match_numpy(backend):
    jspec = _jspec()
    M = jspec.num_markets
    js = JEngine("numpy").open(jspec)
    ts = Engine(backend, device="cpu").open(_port(jspec))
    r = np.random.default_rng(11)
    for _ in range(3):
        side = r.random(M) < 0.5
        price = r.integers(0, jspec.num_levels, M)
        qty = r.integers(0, 6, M).astype(np.float32)
        _same(ts.step(ExternalOrders(side, price, qty)).to_numpy(),
              js.step(JOrders(side, price, qty)).to_numpy())
    _same(ts.run(4).to_numpy(), js.run(4).to_numpy())
    _same(ts.state, js.state)


@pytest.mark.parametrize("backend", PORT_BACKENDS)
def test_chunked_equals_one_shot_without_coupling(backend):
    spec = _port(_jspec(num_steps=13)).with_values(coupling_peer=-1,
                                                   num_arbitrageurs=0)
    one = Engine(backend, device="cpu").open(spec, chunk_size=13) \
        .run_to_result()
    sess = Engine(backend, device="cpu").open(spec, chunk_size=4)
    parts = list(sess.stream())
    assert [b.num_steps for b in parts] == [4, 4, 4, 1]
    batch = type(parts[0]).concatenate(parts)
    _same(sess.to_result(batch).to_numpy(), one.to_numpy())


def test_simulate_wrappers_reach_every_backend():
    cfg = MarketConfig(num_markets=3, num_agents=8, num_levels=8,
                       num_steps=5, seed=4)
    want = ref.simulate_reference(cfg, device="cpu").to_numpy()
    for backend in ("cuda-kinetic",) + PORT_BACKENDS:
        _same(engine.simulate(cfg, backend=backend, device="cpu")
              .to_numpy(), want)
    _same(torch_backend.simulate(cfg, mode="per-step", device="cpu")
          .to_numpy(), want)
    _same(ops.simulate_naive(cfg, device="cpu").to_numpy(), want)
    with pytest.raises(ValueError, match="mode"):
        torch_backend.open_chunk_runner(cfg, 4, "cpu", mode="graph")


def test_backend_available_for_all_four():
    for name in ("cuda-kinetic", "cuda-naive", "torch-scan",
                 "torch-per-step"):
        assert backend_available(name) is True
    assert backend_available("jax-scan") is False
