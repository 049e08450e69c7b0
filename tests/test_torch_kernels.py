"""``kinetic_clearing_chunk`` on the CPU (its plain PyTorch version) against
the JAX package's Pallas kernel in interpret mode, bit for bit, plus the
wrapper's contract: operand checks, the column order it shares with the
CUDA source, the build flags, and the launch counter."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stats as j_stats
from repro.core.config import MarketConfig as JConfig
from repro.core.params import EnsembleSpec as JSpec
from repro.core.engine import simulate as j_simulate
from repro.core.step import initial_state as j_initial_state
from repro.kernels.kinetic_clearing import \
    kinetic_clearing_chunk as j_chunk
from repro_torch import convert
from repro_torch.core import params as params_mod
from repro_torch.core import stats
from repro_torch.core.config import MAKER, NOISE, MarketConfig
from repro_torch.core.step import initial_state
from repro_torch.kernels import _build, autotune
from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.kernels import naive_clearing as nc


def _specs():
    blocks = [JConfig(num_markets=2, num_agents=20, num_levels=16,
                      num_steps=16, seed=2**31 + 3, **mix)
              for mix in ({"alpha_fundamentalist": 0.25},
                          {"alpha_whale": 0.2, "whale_period": 2},
                          {"alpha_hft": 0.2, "hft_threshold": 0.05},
                          {"alpha_informed": 0.2, "shock_step": 5,
                           "shock_intensity": 0.6, "shock_cancel": 0.5},
                          {"alpha_arbitrageur": 0.3})]
    jspec = JSpec.concatenate([JSpec.homogeneous(b) for b in blocks])
    M = jspec.num_markets
    jspec = jspec.with_values(coupling_peer=(np.arange(M) + 3) % M)
    tspec = convert.spec_from_numpy(
        M, jspec.num_agents, jspec.num_levels, jspec.num_steps, jspec.seed,
        jspec.params.to_numpy()._asdict(), jspec.initial_quote_qty,
        jspec.initial_spread)
    return jspec, tspec


def _ext(M, L):
    r = np.random.default_rng(4)
    eb = (r.integers(0, 4, (M, L)) * (r.random((M, L)) < 0.3)).astype(np.float32)
    return eb, np.ascontiguousarray(eb[:, ::-1])


def _flat(out):
    flat = []
    for x in out:
        flat.extend(x if isinstance(x, tuple) else [x])
    return flat


@pytest.mark.parametrize("stats_only,scan", [(False, "cumsum"),
                                             (True, "cumsum"),
                                             (False, "hillis-steele")])
def test_chunk_matches_pallas_interpret(stats_only, scan):
    """ext orders, n_valid < chunk, a shock inside the chunk, coupling."""
    jspec, tspec = _specs()
    M, L = jspec.num_markets, jspec.num_levels
    state = j_initial_state(jspec, np)
    eb, ea = _ext(M, L)
    step0, n_valid, chunk = 2, 6, 8
    js = j_stats.init_stats(M, jnp) if stats_only else None
    want = j_chunk(*(jnp.asarray(x) for x in state),
                   jnp.full((1, 1), step0, jnp.int32),
                   jnp.full((1, 1), n_valid, jnp.int32),
                   jnp.asarray(eb), jnp.asarray(ea), cfg=jspec, chunk=chunk,
                   scan=scan, interpret=True, stats=js, stats_only=stats_only)
    ts = stats.init_stats(M, "cpu") if stats_only else None
    got = kc.kinetic_clearing_chunk(
        *(torch.from_numpy(np.asarray(x)) for x in state), step0, n_valid,
        torch.from_numpy(eb), torch.from_numpy(ea), cfg=tspec, chunk=chunk,
        scan=scan, stats=ts, stats_only=stats_only)
    got, want = _flat(got), [np.asarray(x) for x in _flat(want)]
    assert len(got) == len(want) == (10 if stats_only else 7)
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        if not stats_only and k >= 4:   # only n_valid path columns are read
            g, w = g[:, :n_valid], w[:, :n_valid]
        assert g.shape == w.shape and (g == w).all(), k
    if not stats_only:
        assert want[5].sum() > 0  # the chunk trades


def test_chunks_compose_to_one_call():
    """Two chunk calls equal one call spanning both, when no market is
    coupled across (the coupling column freezes at each chunk entry)."""
    _, tspec = _specs()
    tspec = tspec.with_values(coupling_peer=-1, num_arbitrageurs=0)
    state = initial_state(tspec, "cpu")
    one = kc.kinetic_clearing_chunk(*state, 0, 10, cfg=tspec, chunk=10)
    a = kc.kinetic_clearing_chunk(*state, 0, 4, cfg=tspec, chunk=4)
    b = kc.kinetic_clearing_chunk(*a[:4], 4, 6, cfg=tspec, chunk=6)
    for g, w in zip(b[:4], one[:4]):
        assert torch.equal(g, w)
    for k in range(4, 7):
        assert torch.equal(torch.cat([a[k], b[k]], dim=1), one[k])


def cuda_source(name):
    """``csrc/<name>.cu`` with its local ``#include "..."`` headers inlined,
    as nvcc reads it."""
    def inline(text):
        return re.sub(r'#include "([^"]+)"',
                      lambda m: inline((_build.CSRC / m.group(1)).read_text()),
                      text)

    return inline((_build.CSRC / f"{name}.cu").read_text())


def check_column_order(src):

    def define(name):
        joined = src.replace("\\\n", " ")  # fold continuation lines
        body = re.search(rf"#define {name} (.*)", joined).group(1)
        return "".join(re.findall(r'"([^"]*)"', body))

    assert define("KC_FLOAT_COLS") == ",".join(params_mod.FLOAT_FIELDS)
    assert define("KC_INT_COLS") == ",".join(params_mod.INT_FIELDS)
    assert len(params_mod.FLOAT_FIELDS) == len(params_mod.INT_FIELDS) == 11
    enums = re.findall(r"\b([FI])_([A-Z_]+?)(?=[,\s])", src.split(
        "enum FloatCol")[1].split("// Agent strategy")[0])
    floats = [n.lower() for k, n in enums if k == "F"]
    ints = [n.lower() for k, n in enums if k == "I"]
    assert floats == [f for f in params_mod.FLOAT_FIELDS]
    assert ints == [f for f in params_mod.INT_FIELDS]


def test_column_order_shared_with_cuda_source():
    check_column_order(cuda_source("kinetic_clearing"))


def test_build_flags_keep_ieee_rounding():
    flags = _build.NVCC_FLAGS
    assert "-fmad=false" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    assert "arch=compute_90a,code=sm_90a" in flags
    # Built into a git-ignored directory inside the checkout.
    pkg = Path(kc.__file__).resolve().parent
    assert _build.BUILD_DIR.parent == pkg
    repo = pkg.parents[2]
    ignored = (repo / ".gitignore").read_text().split()
    assert str(_build.BUILD_DIR.relative_to(repo)) + "/" in ignored


@pytest.mark.parametrize("C", autotune.CTAS_PER_MARKET[1:])
def test_entries_take_a_cluster_tile(C):
    """A market-cluster tile (any agent mode, one team a CTA, C CTAs a
    market) is a launch shape the chunk and legacy entries take, the
    per-step entries too; on the CPU they run the plain version, whose
    bits do not change."""
    jspec, tspec = _specs()
    M, A, L = tspec.num_markets, tspec.num_agents, tspec.num_levels
    eb, ea = (torch.from_numpy(x) for x in _ext(M, L))
    state = initial_state(tspec, "cpu")
    tiles = [autotune.TileChoice(L, A, W, 1, "fresh", C) for W in (1, 8)]
    tiles += [autotune.TileChoice(L, A, 1, 1, mode, C)
              for mode in ("shared", "registers")]
    kw = dict(cfg=tspec, chunk=8)
    want = kc.kinetic_clearing_chunk(*state, 2, 6, eb, ea, **kw)
    for tile in tiles:
        assert autotune.check_tile(tile, L, A, True) is tile
        assert tile.grid(M) == M * C and tile.as_c_args()[3] == C
        got = kc.kinetic_clearing_chunk(*state, 2, 6, eb, ea, tile=tile,
                                        **kw)
        naive = nc.naive_clearing_chunk(*state, 2, 6, eb, ea, tile=tile,
                                        **kw)
        for g, n, w in zip(got, naive, want):
            assert torch.equal(g, w) and torch.equal(n, w)
    cfg = MarketConfig(num_markets=3, num_agents=A, num_levels=L,
                       num_steps=7, seed=9, alpha_arbitrageur=0.2)
    lstate = initial_state(cfg, "cpu")
    want = kc.kinetic_clearing(*lstate, cfg=cfg)
    for tile in tiles:
        got = kc.kinetic_clearing(*lstate, cfg=cfg, tile=tile)
        naive = nc.naive_clearing(*lstate, cfg=cfg, tile=tile)
        for g, n, w in zip(got, naive, want):
            assert torch.equal(g, w) and torch.equal(n, w)
    # Not a cluster: several markets a CTA (in each mode), another C.
    for bad in (autotune.TileChoice(L, A, 1, 2, "fresh", C),
                autotune.TileChoice(L, A, 1, 4, "shared", C),
                autotune.TileChoice(L, A, 1, 2, "registers", C),
                autotune.TileChoice(L, A, 1, 1, "fresh", C + 1),
                autotune.TileChoice(L, A, 1, 1, "fresh", 2 * 16)):
        with pytest.raises(ValueError):
            kc.kinetic_clearing_chunk(*state, 2, 6, eb, ea, tile=bad, **kw)
    # Nor the registers mode past REG_AGENTS agents a thread of the
    # cluster, 8·T·C, which it holds exactly.
    for W in (1, 8):
        cap = 8 * 32 * W * C
        ok = autotune.TileChoice(L, cap, W, 1, "registers", C)
        assert autotune.check_tile(ok, L, cap, True) is ok
        over = ok._replace(num_agents=cap + 1)
        with pytest.raises(ValueError, match="registers"):
            autotune.check_tile(over, L, cap + 1, True)


def test_a_population_past_shared_memory_takes_a_cluster():
    """Two markets of 46,081 agents (past shared memory at L=128): the
    rule spreads each over a cluster of 16 CTAs (132 SMs, no card here),
    and the entries' plain versions equal the JAX package's ``numpy``
    reference field by field."""
    kw = dict(num_markets=2, num_agents=46081, num_levels=128, num_steps=3,
              seed=17)
    rule = autotune.auto_tile(128, 46081, 2, sms=132, max_ctas=16)
    # One CTA would recompute them (fresh); each CTA of the cluster holds
    # its own 3,072 agents' keys in its shared memory.
    assert autotune.auto_tile(128, 46081).agents == "fresh"
    assert (rule.agents, rule.markets_per_cta, rule.ctas_per_market) == \
        ("shared", 1, 16) and rule.grid(2) == 32
    want = j_simulate(JConfig(**kw), backend="numpy").to_numpy()
    cfg = MarketConfig(**kw)
    state = initial_state(cfg, "cpu")
    legacy = kc.kinetic_clearing(*state, cfg=cfg)
    chunk = kc.kinetic_clearing_chunk(*state, 0, 3, cfg=cfg, chunk=3)
    for got in (legacy, chunk[:6]):
        for f, g, w in zip(want._fields, got, want):
            assert (g.numpy() == w).all(), f
    assert want.volume_path.sum() > 0


@pytest.mark.parametrize("mode", ["shared", "registers"])
def test_entries_take_a_hoisted_cluster_tile(mode):
    """The chunk and legacy entries take a cluster tile of the shared and
    registers modes at the rule's widest team (every C the mode holds);
    their plain versions give the bits of the rule's launch, with external
    orders, stats and the legacy peer."""
    jspec, tspec = _specs()
    M, A, L = tspec.num_markets, tspec.num_agents, tspec.num_levels
    eb, ea = (torch.from_numpy(x) for x in _ext(M, L))
    state = initial_state(tspec, "cpu")
    cfg = MarketConfig(num_markets=3, num_agents=A, num_levels=L,
                       num_steps=7, seed=9, alpha_arbitrageur=0.2)
    lstate = initial_state(cfg, "cpu")
    want = kc.kinetic_clearing_chunk(*state, 1, 7, eb, ea, cfg=tspec,
                                     chunk=8)
    swant = kc.kinetic_clearing_chunk(
        *state, 1, 7, cfg=tspec, chunk=8, stats_only=True,
        stats=stats.init_stats(M, "cpu"))
    lwant = kc.kinetic_clearing(*lstate, cfg=cfg)
    for C in autotune.CTAS_PER_MARKET[1:]:
        tile = autotune.TileChoice(L, A, 8, 1, mode, C)
        assert autotune.check_tile(tile, L, A, True) is tile
        assert tile.smem_bytes(True) == 4 * (4 * L + (
            256 + 64 if mode == "shared" else 0))
        got = kc.kinetic_clearing_chunk(*state, 1, 7, eb, ea, cfg=tspec,
                                        chunk=8, tile=tile)
        sgot = kc.kinetic_clearing_chunk(
            *state, 1, 7, cfg=tspec, chunk=8, stats_only=True,
            stats=stats.init_stats(M, "cpu"), tile=tile)
        lgot = kc.kinetic_clearing(*lstate, cfg=cfg, tile=tile)
        for g, w in zip(_flat(got) + _flat(sgot) + list(lgot),
                        _flat(want) + _flat(swant) + list(lwant)):
            assert torch.equal(g, w)


def test_the_last_shared_population_takes_a_shared_cluster():
    """Two markets of 46,080 agents at L=128 (B1: the last population one
    CTA's shared memory holds, which the parent's rule gave one warp): the
    rule takes a team of eight warps on a cluster of 16 CTAs in the shared
    mode, each CTA holding 3,072 keys, and the entries' plain versions
    equal the JAX package's ``numpy`` reference field by field."""
    kw = dict(num_markets=2, num_agents=46080, num_levels=128, num_steps=3,
              seed=23, alpha_whale=0.02, whale_period=2,
              alpha_arbitrageur=0.1)
    one = autotune.auto_tile(128, 46080)
    assert (one.agents, one.warps_per_market) == ("shared", 8)
    assert one.smem_bytes(True) == autotune.MAX_DYNAMIC_SMEM
    rule = autotune.auto_tile(128, 46080, 2, sms=132, max_ctas=16)
    assert tuple(rule[2:]) == (8, 1, "shared", 16)
    assert autotune.agent_slots(46080, 256, 16) == 3072
    assert rule.smem_bytes(True) == 4 * (4 * 128 + 3072 + 768)
    want = j_simulate(JConfig(**kw), backend="numpy").to_numpy()
    cfg = MarketConfig(**kw)
    state = initial_state(cfg, "cpu")
    legacy = kc.kinetic_clearing(*state, cfg=cfg)
    chunk = kc.kinetic_clearing_chunk(*state, 0, 3, cfg=cfg, chunk=3)
    for got in (legacy, chunk[:6]):
        for f, g, w in zip(want._fields, got, want):
            assert (g.numpy() == w).all(), f
    assert want.volume_path.sum() > 0


def test_plain_path_on_cpu_never_counts_a_launch():
    _, tspec = _specs()
    before = kc.kinetic_clearing_chunk.launches
    kc.kinetic_clearing_chunk(*initial_state(tspec, "cpu"), 0, 2, cfg=tspec,
                              chunk=2)
    assert kc.kinetic_clearing_chunk.launches == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "n_valid", "stats",
                                 "device"])
def test_wrapper_rejects_bad_operands(bad):
    _, tspec = _specs()
    bid, ask, last, pmid = initial_state(tspec, "cpu")
    kw = dict(cfg=tspec, chunk=4)
    n_valid = 4
    if bad == "dtype":
        bid = bid.double()
    elif bad == "shape":
        last = last[:-1]
    elif bad == "n_valid":
        n_valid = 5
    elif bad == "stats":
        kw["stats_only"] = True
    elif bad == "device":
        bid = bid.to("meta")
    with pytest.raises(ValueError):
        kc.kinetic_clearing_chunk(bid, ask, last, pmid, 0, n_valid, **kw)


def test_bound_counts():
    """The bound counts the function's instructions by class, each weighted
    by 128 over its per-SM rate on compute capability 9.0."""
    assert kc.PIPE_WEIGHTS == {"fp32": 1, "int32": 2, "conversion": 8,
                               "shuffle": 4}
    assert kc.OpMix(fp32=3, int32=2, conversion=1, shuffle=1).slots == \
        3 + 4 + 8 + 4
    cfg = MarketConfig(num_markets=8192, num_agents=256, num_levels=128,
                       num_steps=64)
    mix = kc.agent_mix(params_mod.params_from_config(cfg), 256)
    assert sum(mix.values()) == 8192 * 256
    assert mix[MAKER] == 8192 * cfg.num_makers and mix[MAKER] > 0
    ops = kc.op_count(8192, 256, 128, 64, mix)
    # Each agent pays for the hash channels its archetype reads; the
    # step-invariant (seed, gid) round and type count once per call.
    channels = sum(n * kc.CHANNELS_READ[t] for t, n in mix.items())
    assert ops == (64 * (8192 * 256 * kc.AGENT_STEP.slots
                         + channels * kc.CHANNEL.slots
                         + 8192 * (128 * kc.LEVEL_STEP.slots
                                   + kc.MARKET_STEP.slots))
                   + 8192 * 256 * kc.AGENT_CALL.slots)
    # A channel is mostly integer work at half the FP32 rate plus a
    # conversion at an eighth of it.
    assert kc.CHANNEL.slots == 1 + 2 * 10 + 8
    assert max(kc.CHANNELS_READ.values()) == 4
    assert kc.op_count(8192, 256, 128, 1, mix) < ops / 40
    with pytest.raises(ValueError):
        kc.op_count(8192, 256, 128, 64, {NOISE: 1})
    nbytes = kc.byte_count(8192, 128, 64, ext=False, stats_only=False)
    # books in/out dominate: 4 * M * L floats, plus three [M, 64] paths
    assert 4 * 8192 * 128 * 4 < nbytes < 2 * 4 * 8192 * 128 * 4
    assert kc.byte_count(8192, 128, 64, ext=False, stats_only=True) < nbytes
