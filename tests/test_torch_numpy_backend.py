"""The port's CPU reference family (``numpy``, ``numpy-splitmix64``,
``numpy-pcg64``) against the JAX package's backends of the same names, with
``==``: the kernel shape sweep, both scans, ``stats_only``, chunking, and
``numpy-pcg64`` snapshots and checkpoints restored across the packages."""
import numpy as np
import pytest

from repro.checkpoint import CheckpointManager as JManager
from repro.core import rng as jrng
from repro.core.config import MarketConfig as JConfig
from repro.core.session import Engine as JEngine
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import engine, numpy_backend, rng
from repro_torch.core.config import MarketConfig
from repro_torch.core.session import Engine, ExternalOrders
from test_torch_session import _jspec, _port, _same

BACKENDS = ("numpy", "numpy-splitmix64", "numpy-pcg64")
#: tests/test_kernels.py's shape sweep: A > 2L, tiny L, A not divisible by L.
SHAPES = [(4, 8, 16, 5), (8, 16, 32, 10), (16, 33, 64, 8), (6, 128, 128, 6),
          (2, 300, 256, 4), (32, 5, 8, 12)]


def _cfg_kw(M, A, L, S):
    return dict(num_markets=M, num_agents=A, num_levels=L, num_steps=S,
                seed=M * 1000 + A, alpha_maker=0.15, alpha_momentum=0.15)


@pytest.mark.parametrize("scan", ["cumsum", "hillis-steele"])
@pytest.mark.parametrize("M,A,L,S", SHAPES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_shape_sweep_matches_jax_package(backend, M, A, L, S, scan):
    kw = _cfg_kw(M, A, L, S)
    want = JEngine(backend, scan=scan).open(JConfig(**kw)).run_to_result()
    got = engine.simulate(MarketConfig(**kw), backend=backend, device="cpu",
                          scan=scan)
    _same(got.to_numpy(), want.to_numpy())
    assert np.asarray(want.volume_path).sum() > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_heterogeneous_coupled_spec_matches(backend):
    jspec = _jspec()
    want = JEngine(backend).open(jspec, chunk_size=5).run_to_result()
    got = Engine(backend, device="cpu").open(_port(jspec), chunk_size=5) \
        .run_to_result()
    _same(got.to_numpy(), want.to_numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_stats_only_matches(backend):
    jspec = _jspec()
    js = JEngine(backend, stats_only=True).open(jspec, chunk_size=4)
    js.run()
    ts = Engine(backend, device="cpu", stats_only=True).open(
        _port(jspec), chunk_size=4)
    assert ts.run().num_steps == 0
    _same(ts.stats, js.stats)
    _same([ts.stats.mean_mid(), ts.stats.var_mid()],
          [js.stats.mean_mid(), js.stats.var_mid()])


@pytest.mark.parametrize("backend", BACKENDS)
def test_chunked_equals_one_shot(backend):
    spec = _port(_jspec(num_steps=13)).with_values(coupling_peer=-1,
                                                   num_arbitrageurs=0)
    one = Engine(backend, device="cpu").open(spec, chunk_size=13) \
        .run_to_result()
    sess = Engine(backend, device="cpu").open(spec, chunk_size=4)
    parts = list(sess.stream())
    assert [b.num_steps for b in parts] == [4, 4, 4, 1]
    batch = type(parts[0]).concatenate(parts)
    _same(sess.to_result(batch).to_numpy(), one.to_numpy())


@pytest.mark.parametrize("backend", BACKENDS)
def test_step_actions_match(backend):
    jspec = _jspec()
    M = jspec.num_markets
    from repro.core.session import ExternalOrders as JOrders

    js = JEngine(backend).open(jspec)
    ts = Engine(backend, device="cpu").open(_port(jspec))
    r = np.random.default_rng(5)
    for _ in range(2):
        side = r.random(M) < 0.5
        price = r.integers(0, jspec.num_levels, M)
        qty = r.integers(0, 6, M).astype(np.float32)
        _same(ts.step(ExternalOrders(side, price, qty)).to_numpy(),
              js.step(JOrders(side, price, qty)).to_numpy())
    _same(ts.run(3).to_numpy(), js.run(3).to_numpy())


def _pcg_pair():
    jspec = _jspec()
    return jspec, _port(jspec)


def test_pcg64_snapshot_restores_across_packages():
    jspec, spec = _pcg_pair()
    js = JEngine("numpy-pcg64").open(jspec, chunk_size=4)
    js.run(6)
    jsnap = js.snapshot()
    want = js.run(8).to_numpy()

    ts = Engine("numpy-pcg64", device="cpu").open(spec, chunk_size=4)
    ts.run(6)
    tsnap = ts.snapshot()
    assert tsnap["rng"] == jsnap["rng"]
    _same(ts.run(8).to_numpy(), want)

    # The JAX package's snapshot continues in the port ...
    ts2 = Engine("numpy-pcg64", device="cpu").open(spec, chunk_size=4)
    ts2.restore(jsnap)
    _same(ts2.run(8).to_numpy(), want)
    # ... and the port's in the JAX package.
    js2 = JEngine("numpy-pcg64").open(jspec, chunk_size=4)
    js2.restore(tsnap)
    _same(js2.run(8).to_numpy(), want)


def test_pcg64_checkpoint_restores_across_packages(tmp_path):
    jspec, spec = _pcg_pair()
    js = JEngine("numpy-pcg64").open(jspec, chunk_size=4)
    js.run(6)
    js.save_checkpoint(JManager(tmp_path / "jax", async_write=False))
    want = js.run(8).to_numpy()

    ts = Engine("numpy-pcg64", device="cpu").open(spec, chunk_size=4)
    ts.run(6)
    ts.save_checkpoint(CheckpointManager(tmp_path / "port",
                                         async_write=False))

    port = Engine("numpy-pcg64", device="cpu").open(spec, chunk_size=4)
    assert port.restore_checkpoint(CheckpointManager(
        tmp_path / "jax", async_write=False)) == 6
    _same(port.run(8).to_numpy(), want)
    jax_side = JEngine("numpy-pcg64").open(jspec, chunk_size=4)
    assert jax_side.restore_checkpoint(JManager(
        tmp_path / "port", async_write=False)) == 6
    _same(jax_side.run(8).to_numpy(), want)


def test_pcg64_restore_without_rng_payload_restarts_the_stream():
    """A snapshot without ``rng`` (a counter backend's) restores a fresh
    generator, as in the JAX package."""
    jspec, spec = _pcg_pair()
    ts = Engine("numpy-pcg64", device="cpu").open(spec, chunk_size=4)
    snap = ts.snapshot()
    first = ts.run(4).to_numpy()
    snap.pop("rng")
    ts.restore(snap)
    _same(ts.run(4).to_numpy(), first)


def test_splitmix64_matches_jax_package():
    r = np.random.default_rng(3)
    gid = r.integers(0, 2**32, size=(7, 9), dtype=np.uint64)
    for seed, step, ch in ((0, 0, 0), (2**31 + 5, 123456, 4), (7, 2**32 - 1,
                                                               2)):
        want = jrng.splitmix64_uniform(seed, gid.astype(np.uint32),
                                       np.uint32(step), ch)
        got = rng.splitmix64_uniform(seed, gid.astype(np.int64), step, ch)
        assert got.dtype.is_floating_point and got.shape == want.shape
        assert (got.numpy() == want).all()
        assert (rng.splitmix64_coord(seed, gid, step, ch)
                == jrng.splitmix64_coord(seed, gid, step, ch)).all()


def test_sequential_rejects_external_orders():
    cfg = MarketConfig(num_markets=2, num_agents=8, num_levels=16,
                       num_steps=4, seed=1)
    sess = Engine("numpy", device="cpu", clearing="sequential").open(cfg)
    with pytest.raises(ValueError, match="external-order injection"):
        sess.step(ExternalOrders(True, 3, 1.0))


def test_unknown_modes_raise():
    cfg = MarketConfig(num_markets=2, num_agents=8, num_steps=4)
    with pytest.raises(ValueError, match="rng_mode"):
        numpy_backend.open_chunk_runner(cfg, 4, rng_mode="mt19937")
    with pytest.raises(ValueError, match="clearing"):
        engine.simulate(cfg, backend="numpy", device="cpu",
                        clearing="continuous")
    with pytest.raises(ValueError, match="scan"):
        engine.simulate(cfg, backend="numpy", device="cpu", scan="serial")


def test_module_simulate_equals_engine():
    cfg = MarketConfig(num_markets=3, num_agents=12, num_levels=16,
                       num_steps=7, seed=9)
    for mode, name in numpy_backend.RNG_MODES.items():
        _same(numpy_backend.simulate(cfg, rng_mode=mode).to_numpy(),
              engine.simulate(cfg, backend=name, device="cpu").to_numpy())
