"""The per-step kernels' wrappers and the legacy one-shot entries on the CPU
(their plain PyTorch versions) against the JAX package's Pallas kernels in
interpret mode, bit for bit; plus the wrappers' contract: operand checks,
launch counters, the C entries' signatures, the column order and build key
of the CUDA sources, and the per-step byte count."""
import ctypes
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import stats as j_stats
from repro.core.config import MarketConfig as JConfig
from repro.core.config import scenario_config as j_scenario_config
from repro.core.step import initial_state as j_initial_state
from repro.kernels.kinetic_clearing import kinetic_clearing as j_kinetic
from repro.kernels.kinetic_clearing import pick_tile
from repro.kernels.naive_clearing import naive_clearing as j_naive
from repro.kernels.naive_clearing import naive_clearing_chunk as j_naive_chunk
from repro_torch.core import stats
from repro_torch.core.config import MarketConfig, scenario_config
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.step import initial_state
from repro_torch.kernels import _build
from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.kernels import naive_clearing as nc
from test_torch_kernels import _ext, _flat, _specs, check_column_order, \
    cuda_source

FIELDS = ("bid", "ask", "last_price", "prev_mid", "price_path", "volume_path")


@pytest.mark.parametrize("stats_only", [False, True])
def test_chunk_matches_pallas_interpret(stats_only):
    """ext orders, n_valid < chunk, a shock inside the chunk, coupling."""
    jspec, tspec = _specs()
    M, L = jspec.num_markets, jspec.num_levels
    state = j_initial_state(jspec, np)
    eb, ea = _ext(M, L)
    step0, n_valid, chunk = 2, 6, 8
    js = j_stats.init_stats(M, jnp) if stats_only else None
    want = j_naive_chunk(*(jnp.asarray(x) for x in state),
                         jnp.full((1, 1), step0, jnp.int32),
                         jnp.full((1, 1), n_valid, jnp.int32),
                         jnp.asarray(eb), jnp.asarray(ea), cfg=jspec,
                         chunk=chunk, interpret=True, stats=js,
                         stats_only=stats_only)
    ts = stats.init_stats(M, "cpu") if stats_only else None
    got = nc.naive_clearing_chunk(
        *(torch.from_numpy(np.asarray(x)) for x in state), step0, n_valid,
        torch.from_numpy(eb), torch.from_numpy(ea), cfg=tspec, chunk=chunk,
        stats=ts, stats_only=stats_only)
    got, want = _flat(got), [np.asarray(x) for x in _flat(want)]
    assert len(got) == len(want) == (10 if stats_only else 7)
    for k, (g, w) in enumerate(zip(got, want)):
        g = g.numpy()
        if not stats_only and k >= 4:   # only n_valid path columns are read
            g, w = g[:, :n_valid], w[:, :n_valid]
        assert g.shape == w.shape and (g == w).all(), k
    if not stats_only:
        assert want[5].sum() > 0  # the chunk trades


def _legacy_pair(entry):
    if entry == "kinetic":
        return kc.kinetic_clearing, j_kinetic
    return nc.naive_clearing, j_naive


def _legacy_check(entry, cfg, jcfg):
    port, jax_fn = _legacy_pair(entry)
    jstate = j_initial_state(jcfg, jnp)
    want = jax_fn(*jstate, cfg=jcfg, mb=pick_tile(jcfg.num_markets),
                  interpret=True)
    got = port(*initial_state(cfg, "cpu"), cfg=cfg)
    assert len(got) == len(want) == len(FIELDS)
    for f, g, w in zip(FIELDS, got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape, f
        assert (g == w).all(), f"{entry} {f}"
    return got


@pytest.mark.parametrize("M,A,L,S", [
    (4, 8, 16, 5),
    (8, 16, 32, 10),
    (16, 33, 64, 8),     # A not divisible by L
    (6, 128, 128, 6),    # A == L (the paper's grid size)
    (2, 300, 256, 4),    # A > 2L
    (32, 5, 8, 12),      # tiny L
])
@pytest.mark.parametrize("entry", ["kinetic", "naive"])
def test_legacy_entries_match_pallas_interpret(entry, M, A, L, S):
    kw = dict(num_markets=M, num_agents=A, num_levels=L, num_steps=S,
              seed=M * 1000 + A)
    _legacy_check(entry, MarketConfig(**kw), JConfig(**kw))


_HAZARD_KW = dict(num_markets=4, num_agents=48, num_levels=32, num_steps=12,
                  seed=2**31 + 7)


def _hazard_configs(name):
    """(port config, JAX config) of one hazard case."""
    if name == "arbitrageur":   # (a): the peer is the own mid at each step
        extra = dict(alpha_arbitrageur=0.2, arb_kappa=0.5)
        return (MarketConfig(**_HAZARD_KW, **extra),
                JConfig(**_HAZARD_KW, **extra))
    # (b): every broadcast column must reach the kernel
    return (scenario_config(name, **_HAZARD_KW),
            j_scenario_config(name, **_HAZARD_KW))


@pytest.mark.parametrize("name", ["arbitrageur", "flash-crash", "informed"])
@pytest.mark.parametrize("entry", ["kinetic", "naive"])
def test_legacy_hazard_configs(entry, name):
    cfg, jcfg = _hazard_configs(name)
    got = _legacy_check(entry, cfg, jcfg)
    assert got[5].sum() > 0
    if name == "arbitrageur":
        # A peer column frozen at entry, as the chunk entries use, gives
        # other bits: the test would catch a legacy kernel that froze it.
        frozen = kc.kinetic_clearing_chunk_plain(
            *initial_state(cfg, "cpu"), 0, cfg.num_steps, cfg=cfg,
            chunk=cfg.num_steps)
        assert not all(torch.equal(g, w) for g, w in
                       zip(got[:4], frozen[:4]))


def test_zero_valid_steps_return_the_state():
    _, tspec = _specs()
    state = initial_state(tspec, "cpu")
    out = nc.naive_clearing_chunk(*state, 3, 0, cfg=tspec, chunk=4)
    for g, w in zip(out[:4], state):
        assert torch.equal(g, w)


def test_plain_path_on_cpu_never_counts_a_launch():
    _, tspec = _specs()
    cfg = MarketConfig(num_markets=2, num_agents=8, num_levels=8,
                       num_steps=3)
    before = (nc.naive_clearing_chunk.launches, nc.naive_clearing.launches,
              kc.kinetic_clearing.launches)
    nc.naive_clearing_chunk(*initial_state(tspec, "cpu"), 0, 2, cfg=tspec,
                            chunk=2)
    nc.naive_clearing(*initial_state(cfg, "cpu"), cfg=cfg)
    kc.kinetic_clearing(*initial_state(cfg, "cpu"), cfg=cfg)
    assert (nc.naive_clearing_chunk.launches, nc.naive_clearing.launches,
            kc.kinetic_clearing.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "n_valid", "stats",
                                 "device"])
def test_chunk_wrapper_rejects_bad_operands(bad):
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
        nc.naive_clearing_chunk(bid, ask, last, pmid, 0, n_valid, **kw)


@pytest.mark.parametrize("entry", ["kinetic", "naive"])
def test_legacy_entries_reject_bad_operands(entry):
    port, _ = _legacy_pair(entry)
    cfg = MarketConfig(num_markets=2, num_agents=8, num_levels=8,
                       num_steps=3)
    state = initial_state(cfg, "cpu")
    with pytest.raises(TypeError, match="MarketConfig"):
        port(*state, cfg=EnsembleSpec.homogeneous(cfg))
    with pytest.raises(ValueError, match="levels"):
        port(*initial_state(MarketConfig(num_markets=2, num_levels=16),
                            "cpu"), cfg=cfg)
    with pytest.raises(ValueError, match="dtype"):
        port(state[0].double(), *state[1:], cfg=cfg)
    with pytest.raises(ValueError, match="scan"):
        port(*state, cfg=cfg, scan="serial")


def test_column_order_shared_with_naive_source():
    src = cuda_source("naive_clearing")
    check_column_order(src)
    for kernel in ("naive_chunk_step_kernel", "naive_legacy_step_kernel"):
        assert f"__global__ void {kernel}(" in src


_C_TYPES = {"ptr": ctypes.c_void_p, "int": ctypes.c_int,
            "uint32_t": ctypes.c_uint32}


@pytest.mark.parametrize("module", [kc, nc], ids=["kinetic", "naive"])
def test_c_entries_match_their_ctypes_signatures(module):
    """Each C entry's parameter list agrees with the argtypes the wrapper
    gives ctypes (a wrong count or type would cut pointers on the card);
    an entry is defined in the library's source or a header it includes."""
    src = (_build.CSRC / f"{module._LIB_NAME}.cu").read_text()
    src += "".join((_build.CSRC / h).read_text()
                   for h in re.findall(r'#include "(\w+\.cuh)"', src))
    for fn, argtypes in module._ENTRIES.items():
        sig = re.search(rf"\bint {fn}\(([^)]*)\)", src)
        kinds = ["ptr" if "*" in p else p.split()[-2]
                 for p in " ".join(sig.group(1).split()).split(",")]
        assert [_C_TYPES[k] for k in kinds] == list(argtypes), fn
        body = src[sig.end():src.index("\n}\n", sig.end())]
        assert "cudaGetLastError()" in body, fn


def test_library_path_covers_headers_and_sources(tmp_path, monkeypatch):
    """A change to a shared header's bytes rebuilds every library; a change
    to one .cu rebuilds only that one."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("kinetic_clearing", "naive_clearing")
    before = {n: _build.library_path(n) for n in names}
    header = csrc / "kinetic_step.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build.library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "naive_clearing.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    again = {n: _build.library_path(n) for n in names}
    assert again["kinetic_clearing"] == after["kinetic_clearing"]
    assert again["naive_clearing"] != after["naive_clearing"]


def test_per_step_byte_count():
    M, L, S = 8192, 128, 64
    per_launch = (4 * M * L * 4 + 4 * M * 4 + 22 * M * 4 + 2 * M * 4
                  + 3 * M * 4)
    assert nc.byte_count(M, L, S, ext=False, stats_only=False) == \
        S * per_launch
    assert nc.byte_count(M, L, S, ext=True, stats_only=False) == \
        S * per_launch + 2 * M * L * 4
    # Books cross device memory every step: about S times the persistent
    # kernel's floor for the same function.
    floor = kc.byte_count(M, L, S, ext=False, stats_only=False)
    assert 0.5 * S * floor < S * per_launch < S * floor
    assert nc.byte_count(M, L, S, ext=False, stats_only=True) > S * per_launch
    legacy = nc.legacy_byte_count(M, L, S)
    assert legacy == S * (4 * M * L * 4 + 4 * M * 4 + 22 * 4 + 2 * M * 4)
    assert kc.legacy_byte_count(M, L, S) == \
        4 * M * L * 4 + 4 * M * 4 + 22 * 4 + 2 * M * S * 4
