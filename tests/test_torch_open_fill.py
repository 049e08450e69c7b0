"""Specs held as blocks of equal rows, and the open fill, on the CPU.

An :class:`EnsembleSpec` holds its markets as blocks
(:class:`~repro_torch.core.params.SpecBlocks`): one a config, or one a
market where a value is given per market. Its per-market views equal the
JAX package's spec (which holds M rows) leaf for leaf and dtype for dtype,
and its checks name the same markets. A kernel runner on one device opens
a session from the B rows through the open fill, whose plain version gives
the bits of ``pack_params`` + ``initial_state`` + ``init_stats``; the CUDA
kernel is held to the plain version in ``tests/test_torch_cuda.py``.
"""
import ast
import dataclasses
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro.core.config import MarketConfig as JConfig
from repro.core.params import EnsembleSpec as JSpec
from repro_torch.core import params as params_mod
from repro_torch.core.config import MarketConfig
from repro_torch.core.params import EnsembleSpec, pack_params
from repro_torch.core.session import ChunkRunner, Engine
from repro_torch.core.stats import init_stats
from repro_torch.core.step import initial_state
from repro_torch.kernels import _build, open_fill
from repro_torch.kernels.ops import ClearingChunkRunner
from repro_torch.ops import trace
from repro_torch.scenario import CouplingSpec
from repro_torch.serve import journal

SHAPE = dict(num_agents=16, num_levels=16, num_steps=12, seed=2**31 + 5)
PRESETS = ["baseline", "flash-crash", "high-vol", "low-vol", "whale", "hft",
           "informed", "wide-book", "thin-book"]


def _both(build):
    """``build(MarketConfig, EnsembleSpec)`` in the port and in the JAX
    package."""
    return build(MarketConfig, EnsembleSpec), build(JConfig, JSpec)


def _ring(spec):
    M = spec.num_markets
    return spec.with_values(coupling_peer=[(m + 1) % M for m in range(M)])


#: Each way to build a spec, and the block count the spec holds.
BUILDS = {
    "homogeneous": (lambda C, S: S.homogeneous(C(num_markets=7, **SHAPE)),
                    1),
    "nine_presets": (lambda C, S: S.from_scenarios(
        PRESETS, num_markets=3, **SHAPE), 9),
    "product": (lambda C, S: S.product(
        C(num_markets=2, **SHAPE),
        {"noise_delta": [2.0, 8.0], "initial_spread": [0, 3, 5]}), 6),
    "concatenate": (lambda C, S: S.concatenate([
        S.homogeneous(C(num_markets=n, alpha_whale=w, **SHAPE))
        for n, w in ((5, 0.0), (1, 0.1), (3, 0.2))]), 3),
    "with_scalar": (lambda C, S: S.from_scenarios(
        ["baseline", "whale"], num_markets=4, **SHAPE).with_values(
        arb_kappa=0.25, whale_period=np.int32(4)), 2),
    "with_array": (lambda C, S: _ring(S.from_scenarios(
        ["baseline", "hft"], num_markets=3, **SHAPE)), 6),
    "replace_markets": (lambda C, S: S.homogeneous(
        C(num_markets=6, **SHAPE)).replace_markets(
        [1, 4], S.from_scenarios(["flash-crash", "thin-book"],
                                 num_markets=1, **SHAPE)), 6),
    "replace_seed": (lambda C, S: dataclasses.replace(S.from_scenarios(
        ["low-vol", "wide-book"], num_markets=3, **SHAPE), seed=11), 2),
}


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_a_spec_in_blocks_reads_as_its_market_rows(name):
    build, blocks = BUILDS[name]
    ours, theirs = _both(build)
    assert ours.num_blocks == blocks
    assert ours.static_key() == theirs.static_key()
    for f in params_mod.MarketParams._fields:
        a, b = getattr(ours.params, f), getattr(theirs.params, f)
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, f
        assert a.shape == b.shape and np.array_equal(a, b), f
    for f in ("initial_quote_qty", "initial_spread"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert ours.scenarios == theirs.scenarios
    assert repr(ours) == repr(theirs)
    assert ours.coupled_markets() == params_mod.coupled_count(
        theirs.params.coupling_peer)
    # the views are built once and kept
    assert ours.params is ours.params


def test_a_journal_round_trip_keeps_the_rows():
    spec, _ = _both(BUILDS["nine_presets"][0])
    back = journal.spec_from_wire(journal.spec_to_wire(spec))
    assert back.num_blocks == back.num_markets == spec.num_markets
    for a, b in zip(back.params, spec.params):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert back.scenarios == spec.scenarios
    assert back.static_key() == spec.static_key()


def test_replace_with_the_static_fields_keeps_the_blocks():
    spec = EnsembleSpec.from_scenarios(PRESETS, num_markets=3, **SHAPE)
    again = dataclasses.replace(spec, seed=9)
    assert again.blocks is spec.blocks and again.seed == 9
    assert again.static_key() == (spec.num_markets, 16, 16, 9)


#: A bad value planted in one block of a three-block spec: (field, value,
#: the block's markets).
BAD_ROWS = [("q_max", 0.5, 1), ("shock_step", 99, 2), ("fundamental", -1.0, 0),
            ("coupling_peer", 40, 2), ("shock_intensity", np.nan, 1)]


@pytest.mark.parametrize("field,value,block", BAD_ROWS)
def test_a_bad_row_inside_a_block_names_its_markets(field, value, block):
    """The checks run on the B rows, and name the first eight offending
    markets as the JAX package's checks over the M rows do."""
    sizes = (3, 11, 2)

    def build(C, S):
        return S.concatenate([S.homogeneous(C(num_markets=n, **SHAPE))
                              for n in sizes])

    ours, theirs = _both(build)
    rows = dict(zip(params_mod.MarketParams._fields, (
        np.array(x) for x in ours.blocks.params)))
    rows[field][block] = value
    with pytest.raises(ValueError) as got:
        dataclasses.replace(ours, blocks=ours.blocks._replace(
            params=params_mod.MarketParams(**rows)))
    leaves = {f: np.array(getattr(theirs.params, f))
              for f in params_mod.MarketParams._fields}
    lo = sum(sizes[:block])
    leaves[field][lo:lo + sizes[block]] = value
    with pytest.raises(ValueError) as want:
        dataclasses.replace(theirs, params=type(theirs.params)(**leaves))
    assert str(got.value).startswith(f"{field} ") or \
        str(got.value).startswith(f"params.{field} ")

    def named(err):
        return ast.literal_eval(re.search(r"markets (\[[0-9, ]*\])",
                                          str(err.value)).group(1))

    assert named(got) == named(want) == list(range(
        lo, lo + min(8, sizes[block])))


def test_a_bad_spread_in_a_block_names_its_markets():
    spec = EnsembleSpec.concatenate([
        EnsembleSpec.homogeneous(MarketConfig(num_markets=n, **SHAPE))
        for n in (2, 3)])
    spread = np.array([0, 15], np.int32)
    with pytest.raises(ValueError, match=re.escape("markets [2, 3, 4]")):
        dataclasses.replace(spec, blocks=spec.blocks._replace(
            initial_spread=spread))


def _opened_as_before(spec, stats_only):
    """``pack_params`` + ``initial_state`` + ``init_stats`` on the CPU."""
    packed = pack_params(spec.params, "cpu")
    stats = init_stats(spec.num_markets, "cpu") if stats_only else None
    return initial_state(spec, "cpu"), packed, stats


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_same(got, want):
    for a, b in zip(got, want):
        if b is None:
            assert a is None
            continue
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(_bits(x), _bits(y))


def fill_spec(case: str, L: int):
    """B = 1, nine ragged blocks with spreads 0 and odd, or B = M, over 13
    markets at ``L`` levels (13 is no multiple of a CTA's 8 markets)."""
    shape = dict(SHAPE, num_levels=L)
    if case == "one":
        return EnsembleSpec.homogeneous(MarketConfig(
            num_markets=13, initial_spread=1, **shape))
    sizes = (1, 2, 1, 3, 1, 1, 2, 1, 1)
    spreads = (0, 1, 2, 1, 0, 1, 2, 1, 0) if L == 4 else \
        (0, 1, 2, 3, 5, 7, 0, 2 * (L // 2 - 1) - 1, 2 * (L // 2 - 1))
    spec = EnsembleSpec.concatenate([EnsembleSpec.homogeneous(MarketConfig(
        num_markets=n, initial_spread=sp, initial_quote_qty=float(k),
        alpha_whale=0.05 * (k % 3), **shape))
        for k, (n, sp) in enumerate(zip(sizes, spreads))])
    return _ring(spec) if case == "rows" else spec


FILL_CASES = [(case, L) for case in ("one", "blocks", "rows")
              for L in (4, 128, 1024)]


@pytest.mark.parametrize("case,L", FILL_CASES)
@pytest.mark.parametrize("stats_only", [False, True])
def test_the_plain_fill_gives_the_bits_of_the_host_open(case, L, stats_only):
    spec = fill_spec(case, L)
    assert spec.num_blocks == {"one": 1, "blocks": 9, "rows": 13}[case]
    got = open_fill.open_fill(spec.blocks, L, stats_only,
                              torch.device("cpu"))
    want = _opened_as_before(spec, stats_only)
    _assert_same(got, want)
    host = params_mod.host_ints(got[1])
    assert host.dtype == np.int32 and host.flags.c_contiguous
    assert np.array_equal(host, params_mod.host_ints(want[1]))


@pytest.mark.parametrize("backend", ["cuda-kinetic", "cuda-naive"])
@pytest.mark.parametrize("stats_only", [False, True])
def test_a_run_from_the_fill_equals_one_from_the_host_open(
        backend, stats_only, monkeypatch):
    spec = fill_spec("blocks", 16)

    def run():
        eng = Engine(backend, device="cpu", chunk_size=5,
                     stats_only=stats_only)
        with eng.open(spec) as sess:
            batch = sess.run(12)
            return (sess.stats if stats_only else batch.to_numpy(),
                    sess.state)

    new = run()
    monkeypatch.setattr(ClearingChunkRunner, "open_leaves",
                        ChunkRunner.open_leaves)
    old = run()
    for a, b in zip(new[0] + tuple(new[1]), old[0] + tuple(old[1])):
        assert np.array_equal(np.asarray(a).view(np.int32),
                              np.asarray(b).view(np.int32))


@pytest.mark.parametrize("case,rows", [("homogeneous", 1), ("presets", 9),
                                       ("ring", 27)])
def test_the_open_counts_the_rows_it_uploads(case, rows):
    spec = {"homogeneous": lambda: EnsembleSpec.homogeneous(
                MarketConfig(num_markets=27, **SHAPE)),
            "presets": lambda: EnsembleSpec.from_scenarios(
                PRESETS, num_markets=3, **SHAPE),
            "ring": lambda: CouplingSpec.ring(27).apply(
                EnsembleSpec.from_scenarios(PRESETS, num_markets=3,
                                            **SHAPE))}[case]()
    eng = Engine("cuda-kinetic", device="cpu", stats_only=True)
    trace.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            eng.open(spec).close()
        (span,) = [r for r in trace.spans() if r.name == "open.params"]
    finally:
        trace.clear()
    assert span.attrs["rows"] == rows and span.attrs["markets"] == 27
    eng.open(spec).close()       # counted with the profiler off too
    assert eng.metrics.counter("param_rows_uploaded_total") == 2 * rows


def test_the_table_layout_is_the_kernels():
    """The block table's columns, as ``csrc/open_fill.cuh`` reads them:
    the params in the order the library checks at load, then the depth,
    the spread and the first market."""
    src = (_build.CSRC / "open_fill.cuh").read_text()
    defines = dict(re.findall(r"#define (FILL_\w+) \((.*)\)", src))
    assert defines["FILL_QUOTE"] == "NUM_FLOAT_COLS + NUM_INT_COLS"
    assert params_mod.FILL_QUOTE == len(params_mod.FLOAT_FIELDS) + len(
        params_mod.INT_FIELDS)
    for name, k in (("FILL_SPREAD", 1), ("FILL_START", 2), ("FILL_COLS", 3)):
        assert defines[name] == f"FILL_QUOTE + {k}"
        assert getattr(params_mod, name) == params_mod.FILL_QUOTE + k
