"""The timed tile sweep of the port (``repro_torch.kernels.autotune``) and
its fault, ``AutotuneOOM``.

Counterparts of ``repro``'s sweep tests and of
``tests/test_chaos.py::test_autotune_oom_falls_back_to_conservative_tile``:
the candidates are exactly the launch shapes the C entries accept, each
covering every level and agent of a market once; the rule's tile comes
first and a pinned agent mode is never swept away; keys keep kernel
configurations apart; a cache hit sweeps nothing; the winner is the
fastest candidate, and only when every candidate fails is the rule's tile
cached, with the failures recorded. On the CPU the sweep times the plain
version (``autotune=True``); every shape gives the same bits, and the
recovered chaos stream equals the fault-free one and ``repro``'s.
"""
import re

import numpy as np
import pytest
import torch

from repro.core.config import scenario_config as j_scenario_config
from repro.kernels import autotune as j_autotune
from repro.ops import AutotuneOOM as JAutotuneOOM
from repro.ops import FaultPlan as JFaultPlan
from repro.ops import run_plan as j_run_plan
from repro_torch.core.config import MarketConfig, scenario_config
from repro_torch.core.session import Engine
from repro_torch.core.step import initial_state
from repro_torch.kernels import _build, autotune, ops
from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.kernels import naive_clearing as nc
from repro_torch.ops import (AutotuneOOM, FaultPlan, force_autotune_oom,
                             run_plan)

HEADER = (_build.CSRC / "kinetic_step.cuh").read_text()
LEVELS = [4, 8, 32, 128, 256, 1024]
AGENTS = [1, 16, 256, 1024, 3000, 50000]
CPU = {"device": "cpu"}
CFG = MarketConfig(num_markets=6, num_agents=16, num_levels=32, num_steps=12,
                   seed=5)


@pytest.fixture(autouse=True)
def fresh_cache():
    autotune.clear_tune_cache()
    yield
    autotune.clear_tune_cache()


# ---------------------------------------------------------------------------
# The candidates: the C entries' domain, in a fixed order.
# ---------------------------------------------------------------------------

def _c_accepts(L, A, W, mpc, mode, C=1, max_lpl=32):
    """``check_lanes`` of ``kinetic_step.cuh`` (``check_persistent_shape``;
    ``check_shape`` at ``max_lpl=4``), transcribed condition by condition
    (:func:`test_check_shape_is_the_headers` holds the text)."""
    pow2 = 4 <= L <= 1024 and (L & (L - 1)) == 0
    w_ok = W in (1, 2, 4, 8)
    c_ok = 1 <= C <= 16 and (C & (C - 1)) == 0
    code = autotune.AGENT_MODES.index(mode)
    if (not pow2 or A < 1 or not w_ok or max(4, L // (32 * W)) > max_lpl
            or (max(4, L // (32 * W)) > 4 and (code != 1 or C != 1))
            or mpc < 1 or (W > 1 and mpc != 1) or 32 * W * mpc > 256
            or code < 0 or code > 2 or not c_ok
            or (code == 1 and A > 8 * 32 * W * C)
            or (C > 1 and mpc != 1)):
        return False
    return mpc * 4 * _c_team_words(L, A, 32 * W, C, code == 0) \
        <= 232448 - 1024


def _c_team_words(L, A, T, C, agents_in_smem):
    """``team_smem_words`` and ``agent_slots`` of ``kinetic_step.cuh``,
    transcribed (:func:`test_check_shape_is_the_headers` holds the text)."""
    K = (A + C * T - 1) // (C * T) * T if C > 1 else A
    return (4 if C > 1 else 2) * L + (K + (K + 3) // 4 if agents_in_smem
                                      else 0)


def test_check_shape_is_the_headers():
    body = re.search(r"static inline int check_lanes\(.*?\n}\n", HEADER,
                     re.S).group(0)
    for cond in ("W == 1 || W == 2 || W == 4 || W == 8",
                 "!w_ok || levels_per_lane(L, W) > max_lpl",
                 "(levels_per_lane(L, W) > LEVELS_PER_LANE &&\n"
                 "       (agents != AGENTS_REGISTERS || C != 1))", "MPC < 1",
                 "(W > 1 && MPC != 1)", "32 * W * MPC > MAX_CTA_THREADS",
                 "(agents == AGENTS_REGISTERS && A > REG_AGENTS * 32 * W * C)",
                 "C >= 1 && C <= MAX_CLUSTER_CTAS && (C & (C - 1)) == 0",
                 "(C > 1 && MPC != 1)",
                 "*smem = (size_t)MPC * 4 *\n          team_smem_words(L, A, "
                 "32 * W, C, agents == AGENTS_SHARED);",
                 "*smem <= MAX_DYNAMIC_SMEM"):
        assert cond in body, cond
    # The per-step kernels' check keeps four levels a lane, the persistent
    # kernels' takes up to MAX_LEVELS_PER_LANE; levels_per_lane is
    # max(4, L / (32·W)).
    for text in ("return check_lanes(L, A, W, MPC, agents, C, "
                 "LEVELS_PER_LANE, smem);",
                 "return check_lanes(L, A, W, MPC, agents, C, "
                 "MAX_LEVELS_PER_LANE, smem);",
                 "const int lpl = L / (32 * W);\n"
                 "  return lpl > LEVELS_PER_LANE ? lpl : LEVELS_PER_LANE;",
                 "return C > 1 ? (A + C * T - 1) / (C * T) * T : A;",
                 "const int K = agent_slots(A, T, C);\n"
                 "  return (C > 1 ? 4 : 2) * L + (agents_in_smem ? "
                 "K + (K + 3) / 4 : 0);"):
        assert text in HEADER, text
    assert "#define MAX_CLUSTER_CTAS 16" in HEADER
    assert autotune.CTAS_PER_MARKET[-1] == 16
    # The per-step kernels check their shape in the fresh mode, at the
    # launch's C (one CTA a market or a market cluster).
    naive = (_build.CSRC / "naive_clearing.cu").read_text()
    assert "AGENTS_FRESH, C, &smem" in naive
    assert "AGENTS_FRESH, ctas_per_market, &smem" in naive
    assert "check_persistent_shape" not in naive
    kinetic = (_build.CSRC / "kinetic_clearing.cu").read_text()
    assert kinetic.count("check_persistent_shape(") == 2
    assert "check_shape(" not in kinetic
    for L in (4, 64, 128, 512, 1024):
        for A in (1, 300, 2048, 2049, 46080, 46081):
            for W in range(0, 10):
                for mpc in range(0, 10):
                    for mode in autotune.AGENT_MODES:
                        for C in (0, 1, 2, 3, 4, 8, 16, 32):
                            try:
                                autotune.check_shape(L, A, W, mpc, mode,
                                                     True, C)
                                ok = True
                            except ValueError:
                                ok = False
                            assert ok == _c_accepts(L, A, W, mpc, mode, C), \
                                (L, A, W, mpc, mode, C)


@pytest.mark.parametrize("mode", autotune.AGENT_MODES)
def test_per_step_check_shape_is_the_fresh_domain(mode):
    """A per-step kernel checks every shape, whatever mode it carries, as
    its C entries do: ``check_shape`` in the fresh mode at the launch's C,
    a market cluster included."""
    for L in (4, 128, 1024):
        for A in (1, 300, 46081):
            for W in range(0, 10):
                for mpc in range(0, 10):
                    for C in (0, 1, 2, 3, 4, 8, 16, 32):
                        try:
                            autotune.check_shape(L, A, W, mpc, mode, False,
                                                 C)
                            ok = True
                        except ValueError:
                            ok = False
                        assert ok == _c_accepts(L, A, W, mpc, "fresh", C,
                                                max_lpl=4), \
                            (L, A, W, mpc, mode, C)


@pytest.mark.parametrize("hoisted", [True, False])
@pytest.mark.parametrize("L", LEVELS)
@pytest.mark.parametrize("A", AGENTS)
def test_candidates_are_the_c_domain(L, A, hoisted):
    cands = autotune.candidate_tiles(L, A, hoisted=hoisted, max_ctas=16)
    assert cands[0] == autotune.auto_tile(L, A)
    assert len(set(cands)) == len(cands)
    mode = autotune.auto_tile(L, A).agents
    # Clusters for either kind of kernel whose population is past the
    # registers mode (without a market count, where the rule may take one).
    sizes = (1, 2, 4, 8, 16) if mode != "registers" else (1,)
    want = {(W, mpc, m, C) for W in (1, 2, 4, 8) for mpc in (1, 2, 4, 8)
            for m in (autotune.AGENT_MODES if hoisted else (mode,))
            for C in sizes
            if _c_accepts(L, A, W, mpc, m if hoisted else "fresh", C)}
    got = {(c.warps_per_market, c.markets_per_cta, c.agents,
            c.ctas_per_market) for c in cands}
    assert got == want
    for c in cands:
        assert (c.num_levels, c.num_agents) == (L, A)
        assert autotune.check_tile(c, L, A, hoisted) is c
    pairs = {(W, mpc) for W, mpc, _, C in got if C == 1}
    one = [c for c in cands if c.ctas_per_market == 1]
    if L <= 128:
        assert len(pairs) == 7      # W in {1,2,4,8}; MPC in {1,2,4,8} at W=1
    if L == 1024:
        # A persistent kernel's narrower teams hold L/(32·W) levels a lane
        # in the registers mode; a per-step kernel keeps eight warps.
        narrow = {(W, mpc) for W, mpc in ((1, 1), (1, 2), (1, 4), (1, 8),
                                          (2, 1), (4, 1))
                  if hoisted and A <= 8 * 32 * W}
        assert pairs == {(8, 1)} | narrow
        eight = [c for c in one if c.warps_per_market == 8]
        assert len(one) == len(narrow) + len(eight)
        assert len(eight) <= (3 if hoisted else 1)
        assert all(c.agents == "registers" for c in one
                   if c.warps_per_market < 8)
        if hoisted and A <= 2048:   # registers, shared and fresh
            assert {c.agents for c in eight} == set(autotune.AGENT_MODES)
    if hoisted and L <= 128 and A <= 256:
        assert len(cands) == 21
    # A cluster is one team a CTA, of each W that holds L and each mode
    # that fits its CTAs; the fresh mode always does.
    clusters = {(c.warps_per_market, c.agents, c.ctas_per_market)
                for c in cands if c.ctas_per_market > 1}
    if len(sizes) > 1:
        # A per-step kernel's clusters carry the rule's mode and run fresh.
        fresh = "fresh" if hoisted else mode
        assert {(W, C) for W, m, C in clusters if m == fresh} == {
            (W, C) for W in (1, 2, 4, 8) if 128 * W >= L
            for C in (2, 4, 8, 16)}
        assert all(c.markets_per_cta == 1 for c in cands
                   if c.ctas_per_market > 1)
    else:
        assert not clusters
    # A smaller cluster limit (the card's occupancy query) caps the list.
    capped = autotune.candidate_tiles(L, A, hoisted=hoisted, max_ctas=4)
    assert [c for c in cands if c.ctas_per_market <= 4] == capped


@pytest.mark.parametrize("L,A", [(4, 16), (32, 5), (128, 256), (128, 1024),
                                 (1024, 300), (128, 50000), (1024, 32),
                                 (512, 256)])
def test_candidates_cover_levels_and_agents_once(L, A):
    """At every candidate's team size the kernel's index maps (levels
    ``[LPL·t, LPL·t + LPL)``, register slots ``t + k·T``, strided agents
    ``t, t + T, ...``) cover every level and agent of a market once, and a
    CTA's teams take disjoint shared memory within the limit."""
    assert "const int lv = tm.t * LPL + j;" in HEADER
    # Every mode walks the span the bins give: first + j·stride, where
    # one CTA a market starts thread t at t and strides T, and a cluster's
    # rank r starts it at r·T + t and strides C·T; slot k of the registers
    # is agent first + k·stride, and the shared mode keeps agent
    # first + j·stride in the CTA's slot j·T + t.
    assert "return AgentSpan{tm.t, tm.T};" in HEADER
    assert "return AgentSpan{rank * tm.T + tm.t, ranks * tm.T};" in HEADER
    assert HEADER.count("const int a = s.first + k * s.stride;") == 2
    assert HEADER.count("for (int a = s.first, i = tm.t; a < A; "
                        "a += s.stride, i += tm.T)") == 2
    assert "for (int a = s.first; a < A; a += s.stride)" in HEADER
    for c in autotune.candidate_tiles(L, A, hoisted=True, max_ctas=16):
        T, C, lpl = c.threads_per_market, c.ctas_per_market, \
            c.levels_per_lane
        levels = sorted(lpl * t + j for t in range(T) for j in range(lpl)
                        if lpl * t + j < L)
        assert levels == list(range(L)), c
        spans = [(r * T + t, C * T) for r in range(C) for t in range(T)]
        if c.agents == "registers":
            agents = [f + k * st for f, st in spans for k in range(8)
                      if f + k * st < A]
        else:
            agents = [a for f, st in spans for a in range(f, A, st)]
        assert sorted(agents) == list(range(A)), c
        K = autotune.agent_slots(A, T, C)
        if c.agents == "shared":  # each CTA's slots j·T + t, once, below K
            for r in range(C):
                slots = [j * T + t for t in range(T)
                         for j, _ in enumerate(range(r * T + t, A, C * T))]
                assert len(set(slots)) == len(slots)
                assert max(slots, default=0) < K
        assert c.threads_per_cta <= autotune.MAX_CTA_THREADS
        per_team = autotune.team_smem_bytes(L, A, c.agents == "shared", T, C)
        # A cluster's CTA holds two parity buffers of bins and its own
        # agents' keys and types.
        assert per_team == 4 * ((4 if C > 1 else 2) * L + (
            K + -(-K // 4) if c.agents == "shared" else 0))
        assert c.smem_bytes(True) == c.markets_per_cta * per_team \
            <= autotune.MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("hoisted", [True, False])
@pytest.mark.parametrize("mode", autotune.AGENT_MODES)
def test_pinned_agents_is_kept(mode, hoisted):
    cands = autotune.candidate_tiles(128, 256, hoisted=hoisted, agents=mode)
    assert cands and all(c.agents == mode for c in cands)
    assert cands[0] == autotune.auto_tile(128, 256)._replace(agents=mode)
    with pytest.raises(ValueError, match="agents"):
        autotune.candidate_tiles(128, 256, hoisted=hoisted, agents="disk")


#: (L, M, SMs, the card's largest C, the C the rule takes) at A=10^5.
SM_FILLING = [
    (128, 1, 132, 16, 16), (128, 10, 132, 16, 16), (128, 16, 132, 16, 16),
    (128, 17, 132, 16, 8), (128, 33, 132, 16, 4), (128, 66, 132, 16, 2),
    (128, 128, 132, 16, 2), (128, 131, 132, 16, 2), (128, 132, 132, 16, 1),
    (128, 528, 132, 16, 1), (128, 4096, 132, 16, 1), (128, 10, 132, 8, 8),
    (128, 10, 132, 1, 1), (128, 10, 114, 16, 16), (128, 15, 114, 16, 8),
    (1024, 1, 132, 16, 16), (1024, 16, 132, 16, 16), (1024, 66, 132, 16, 2),
    (1024, 132, 132, 16, 1), (32, 10, 132, 16, 16)]


@pytest.mark.parametrize("L,M,sms,cap,want", SM_FILLING)
def test_rule_takes_the_smallest_cluster_that_fills_the_sms(L, M, sms, cap,
                                                            want):
    """In the fresh mode the rule takes the smallest C whose grid reaches
    the SMs (C = 1 at its own markets a CTA, a cluster at one), at most
    the card's limit; the count of SMs and the limit are parameters."""
    A = 10 ** 5
    base = autotune.auto_tile(L, A)
    got = autotune.auto_tile(L, A, M, sms=sms, max_ctas=cap)
    assert base.agents == "fresh" and base.ctas_per_market == 1
    assert got.ctas_per_market == want
    if want == 1:
        assert got == base
    else:
        # On the cluster the mode of the fewest waves on an H100 (no card
        # here), the first on a tie.
        on = base._replace(markets_per_cta=1, ctas_per_market=want)
        modes = [m for m in autotune.RULE_MODES
                 if _c_accepts(L, A, 8, 1, m, want)]
        assert got == min((on._replace(agents=m) for m in modes),
                          key=lambda t: autotune.waves(
                              t, M, sms, autotune.h100_holds))
        assert got.grid(M) == M * want
        assert got.grid(M) >= sms or want == cap
        assert want == 2 or M * want // 2 < sms   # the smallest such C
        assert autotune.check_tile(got, L, A, True) is got
        # The per-step kernels take the cluster too (in the fresh mode).
        assert autotune.check_tile(got, L, A, False) is got
    assert got.smem_bytes(True) == autotune.team_smem_bytes(
        L, A, got.agents == "shared", 256, want)


@pytest.mark.parametrize("L,M,sms,cap,want", SM_FILLING)
def test_per_step_rule_takes_the_same_cluster(L, M, sms, cap, want):
    """The per-step kernels' rule takes the persistent rule's C, the
    smallest whose grid reaches the SMs (at most the card's limit), and
    weighs no mode: the kernels run fresh. On a cluster a team of eight
    warps, one a CTA, in the mode the rule gives without a market count;
    at C = 1 the one-CTA shape it gave before."""
    A = 10 ** 5
    base = autotune.auto_tile(L, A)
    got = autotune.auto_tile(L, A, M, sms=sms, max_ctas=cap, hoisted=False)
    assert got.ctas_per_market == want == autotune.auto_tile(
        L, A, M, sms=sms, max_ctas=cap).ctas_per_market
    assert got == (base if want == 1 else base._replace(
        warps_per_market=8, markets_per_cta=1, ctas_per_market=want))
    assert autotune.check_tile(got, L, A, False) is got
    assert got.smem_bytes(False) == 4 * (4 if want > 1 else 2) * L


#: The per-step rule's shape (W, markets a CTA, mode, C) on an H100's 132
#: SMs: Table IV and the timed agent sweep keep four one-warp teams a CTA;
#: a few markets of a large population (P1, Q1, B1, `edges`, the M=2
#: population past 2^24) take a cluster of 16; many markets keep one CTA
#: a market. The mode is the one the rule gives without a market count.
PER_STEP_RULES = [
    ("table-iv", 8192, 256, 128, (1, 4, "registers", 1)),
    ("a16", 8192, 16, 128, (1, 4, "registers", 1)),
    ("a1024", 8192, 1024, 128, (1, 4, "shared", 1)),
    ("l1024", 8192, 32, 1024, (8, 1, "registers", 1)),
    ("P1", 1, 100000, 128, (8, 1, "fresh", 16)),
    ("Q1", 1, 40000, 128, (8, 1, "shared", 16)),
    ("B1", 10, 46080, 128, (8, 1, "shared", 16)),
    ("edges-128", 10, 50000, 128, (8, 1, "fresh", 16)),
    ("edges-1024", 10, 45000, 1024, (8, 1, "fresh", 16)),
    ("exact", 2, 100000, 8, (8, 1, "fresh", 16)),
    ("Q2", 64, 30000, 128, (8, 1, "shared", 4)),
    ("Q3", 264, 30000, 128, (8, 1, "shared", 1)),
    ("W1", 8192, 20000, 1024, (8, 1, "shared", 1))]


@pytest.mark.parametrize("label,M,A,L,want", PER_STEP_RULES,
                         ids=[r[0] for r in PER_STEP_RULES])
def test_per_step_rule_on_an_h100(label, M, A, L, want):
    """Without a card the per-step rule counts an H100's SMs and the
    largest cluster it holds of the per-step kernels (``h100_holds(tile,
    False)``); at Table IV it is the launch shape it was before clusters,
    and its candidates take a cluster exactly where the rule does."""
    got = autotune.auto_tile(L, A, M, hoisted=False)
    assert (got.warps_per_market, got.markets_per_cta, got.agents,
            got.ctas_per_market) == want
    assert got == autotune.auto_tile(L, A, M, sms=132, max_ctas=16,
                                     hoisted=False)
    if want[3] == 1:
        assert got == autotune.auto_tile(L, A)
    cands = autotune.candidate_tiles(L, A, M, hoisted=False)
    assert cands[0] == got
    sizes = {c.ctas_per_market for c in cands}
    assert sizes == ({1} if want[3] == 1 else {1, 2, 4, 8, 16})
    assert all(c.agents == got.agents for c in cands)
    for c in cands:
        assert autotune.check_tile(c, L, A, False) is c
    if label == "table-iv":
        assert cands == autotune.candidate_tiles(L, A, hoisted=False)


@pytest.mark.parametrize("A", [16, 256, 1024, 46080])
def test_rule_keeps_one_cta_a_market_below_the_fresh_mode(A):
    """Below the fresh mode a market keeps one CTA wherever the grid of
    the markets reaches the SMs; the registers mode of a team of
    ``max(1, L / 128)`` warps never takes a cluster, however few the
    markets; nor does the rule without a market count."""
    one = autotune.auto_tile(128, A)
    assert one.ctas_per_market == 1 and one.agents != "fresh"
    for M in (132 * one.markets_per_cta, 8192):
        # A=46,080's shared CTA is alone on its SM, a fresh one is not:
        # 8192 markets take 63 waves shared and 32 fresh.
        assert autotune.auto_tile(128, A, M, sms=132, max_ctas=16) == (
            one._replace(agents="fresh") if (A, M) == (46080, 8192)
            else one)
    if one.agents == "registers":
        for M in (1, 10, 132):
            assert autotune.auto_tile(128, A, M, sms=132,
                                      max_ctas=16) == one
    else:
        assert autotune.auto_tile(128, A, 10, sms=132,
                                  max_ctas=16).ctas_per_market == 16
    assert autotune.auto_tile(128, 50000).ctas_per_market == 1
    assert autotune.auto_tile(128, 50000, 1, sms=132,
                              max_ctas=16).ctas_per_market == 16


#: The rule's shape (W, markets a CTA, mode, C) on an H100's 132 SMs and
#: clusters of up to 16, at large populations (M, A, L), beside the rule's
#: shape there before the hoisted modes took clusters: B1 the last
#: population one CTA's shared memory holds at L=128, B2 a wide book,
#: Q1-Q3 one exchange, half the SMs' markets and two markets an SM, P1-P3
#: and `edges` past one CTA's shared memory, W1-W3 many more markets than
#: the card holds at once, R1 and R2 a registers-mode cluster the card
#: holds. A cluster's CTA holds only its own agents' keys, so each past
#: that memory may keep them in the shared mode; a hoisted grid that takes
#: more waves than the fresh mode's (Q2, Q3, P2, P3, W2, W3) runs fresh.
LARGE_RULES = [
    ("B1", 10, 46080, 128, (8, 1, "shared", 16), (1, 1, "shared", 1)),
    ("B2", 10, 20000, 1024, (8, 1, "shared", 16), (8, 1, "shared", 1)),
    ("Q1", 1, 40000, 128, (8, 1, "shared", 16), (1, 1, "shared", 1)),
    ("Q2", 64, 30000, 128, (8, 1, "fresh", 4), (1, 1, "shared", 1)),
    ("Q3", 264, 30000, 128, (8, 1, "fresh", 1), (1, 1, "shared", 1)),
    ("P1", 1, 100000, 128, (8, 1, "shared", 16), (8, 1, "fresh", 16)),
    ("P2", 16, 50000, 1024, (8, 1, "fresh", 16), (8, 1, "fresh", 16)),
    ("P3", 128, 50000, 128, (8, 1, "fresh", 2), (8, 1, "fresh", 2)),
    ("edges-128", 10, 50000, 128, (8, 1, "shared", 16),
     (8, 1, "fresh", 16)),
    ("edges-1024", 10, 45000, 1024, (8, 1, "shared", 16),
     (8, 1, "fresh", 16)),
    ("W1", 8192, 20000, 1024, (8, 1, "shared", 1), (8, 1, "shared", 1)),
    ("W2", 2048, 30000, 128, (8, 1, "fresh", 1), (1, 1, "shared", 1)),
    ("W3", 1024, 40000, 1024, (8, 1, "fresh", 1), (8, 1, "shared", 1)),
    ("R1", 1, 30000, 128, (8, 1, "registers", 16), (1, 1, "shared", 1)),
    ("R2", 4, 20000, 1024, (8, 1, "registers", 16), (8, 1, "shared", 1))]


@pytest.mark.parametrize("label,M,A,L,want,earlier", LARGE_RULES,
                         ids=[r[0] for r in LARGE_RULES])
def test_rule_at_large_populations(label, M, A, L, want, earlier):
    """Past the registers mode a market takes the widest team where a CTA
    holds fewer than four one-warp teams, and, where its markets leave SMs
    idle, the smallest cluster whose M·C CTAs reach them; the rule without
    a card is the H100's."""
    got = autotune.auto_tile(L, A, M, sms=132, max_ctas=16)
    assert (got.warps_per_market, got.markets_per_cta, got.agents,
            got.ctas_per_market) == want
    assert autotune.auto_tile(L, A, M) == got
    C = got.ctas_per_market
    assert autotune.check_tile(got, L, A, True) is got
    if C > 1:
        assert M * C >= 132 or C == 16
        assert M * C // 2 < 132
    else:
        assert got.grid(M) >= 132
    # The earlier rule gave the shared mode's populations one warp at L=128
    # (one market a CTA, as shared memory held no more).
    old = autotune.TileChoice(L, A, *earlier)
    assert autotune.check_tile(old, L, A, True) is old
    if old.agents == "shared" and L == 128:
        assert old.warps_per_market == 1


@pytest.mark.parametrize("label,M,A,L,want,earlier", LARGE_RULES,
                         ids=[r[0] for r in LARGE_RULES])
def test_rule_takes_the_mode_of_fewest_waves(label, M, A, L, want, earlier):
    """At its C the rule takes, of the modes a CTA of eight warps fits,
    the one whose grid the H100 runs in the fewest waves, the first of
    registers, shared and fresh on a tie: no earlier mode takes as few,
    and no later one fewer."""
    got = autotune.auto_tile(L, A, M, sms=132, max_ctas=16)
    C = got.ctas_per_market
    fewest = autotune.waves(got, M, 132, autotune.h100_holds)
    assert fewest >= 1
    order = autotune.RULE_MODES
    for mode in order:
        if mode == got.agents or not _c_accepts(L, A, 8, 1, mode, C):
            continue
        other = autotune.waves(got._replace(agents=mode), M, 132,
                               autotune.h100_holds)
        if order.index(mode) < order.index(got.agents):
            assert other > fewest
        else:
            assert other >= fewest


#: What an H100 (NVIDIA H100 80GB HBM3, 700 W) holds at once of the
#: persistent kernels' shapes at L=128 (``tools/kernel_times.py --holds``):
#: (W, mode, A at C = 1) -> the CTAs an SM at C = 1, then the clusters at
#: C = 2, 4, 8, 16 with A·C agents.
H100_READINGS = {
    (1, "registers", 256): (20, 528, 248, 124, 58),
    (1, "shared", 2000): (18, 528, 248, 124, 58),
    (1, "shared", 24000): (1, 66, 30, 15, 7),
    (1, "fresh", 100000): (20, 528, 248, 124, 58),
    (2, "registers", 512): (10, 396, 186, 92, 42),
    (2, "shared", 2000): (10, 528, 248, 124, 58),
    (2, "shared", 24000): (1, 66, 30, 15, 7),
    (2, "fresh", 100000): (10, 528, 248, 124, 58),
    (4, "registers", 1024): (5, 198, 92, 45, 21),
    (4, "shared", 2000): (5, 330, 154, 77, 35),
    (4, "shared", 24000): (1, 66, 30, 15, 7),
    (4, "fresh", 100000): (5, 396, 186, 92, 42),
    (8, "registers", 2048): (2, 66, 30, 15, 7),
    (8, "shared", 2000): (2, 132, 62, 30, 14),
    (8, "shared", 24000): (1, 66, 30, 15, 7),
    (8, "fresh", 100000): (2, 198, 92, 45, 21)}


#: What the H100 (the same card) holds at once of the persistent
#: registers-mode teams narrower than L / 128 warps
#: (``tools/kernel_times.py --wide``): (L, W, markets a CTA) -> CTAs an SM.
H100_WIDE_READINGS = {(1024, 1, 1): 8, (1024, 1, 2): 4, (1024, 1, 4): 2,
                      (1024, 2, 1): 6, (1024, 4, 1): 4, (512, 1, 1): 12,
                      (512, 1, 2): 6, (512, 1, 4): 3, (512, 2, 1): 8,
                      (256, 1, 1): 16, (256, 1, 2): 8, (256, 1, 4): 4}


def test_h100_holds_the_narrow_teams_as_the_card_read():
    """Without a card the rule counts the narrow teams' residency from
    ``H100_WIDE_REGISTERS`` (255, 146 and 106 registers at 32, 16 and 8
    levels a lane), which is what the card read."""
    for (L, W, mpc), held in H100_WIDE_READINGS.items():
        for A in (1, 32, 256 * W):
            tile = autotune.TileChoice(L, A, W, mpc, "registers")
            assert tile.levels_per_lane > 4
            assert autotune.h100_holds(tile) == held, tile
            assert autotune.card_holds(tile) == held


#: What the H100 holds at once of the per-step kernels (``tools/
#: kernel_times.py --holds``, the same card): W -> the CTAs an SM at
#: C = 1, then the clusters at C = 2, 4, 8, 16. They keep no agents, so
#: the population does not change it.
H100_STEP_READINGS = {1: (28, 528, 248, 124, 58), 2: (14, 528, 248, 124, 58),
                      4: (7, 528, 248, 124, 58), 8: (3, 264, 124, 62, 28)}


@pytest.mark.parametrize("C", autotune.CTAS_PER_MARKET)
def test_h100_holds_is_the_cards_reading(C):
    """Without a card the rule counts what an H100 holds at once
    (``h100_holds``, from registers, shared memory and threads a CTA and
    the card's cluster table), and that is what the card read at every
    team width, mode and C of ``H100_READINGS``."""
    at = autotune.CTAS_PER_MARKET.index(C)
    for (W, mode, A), held in H100_READINGS.items():
        tile = autotune.TileChoice(128, A * C, W, 1, mode, C)
        assert autotune.h100_holds(tile) == held[at], tile
        assert autotune.card_holds(tile) == held[at]
    # The per-step kernels, whatever mode the tile carries.
    for W, held in H100_STEP_READINGS.items():
        for mode, A in (("fresh", 100000), ("shared", 2000),
                        ("registers", 256 * W)):
            tile = autotune.TileChoice(128, A * C, W, 1, mode, C)
            assert autotune.h100_holds(tile, False) == held[at], tile
            assert autotune.card_holds(tile, hoisted=False) == held[at]


#: The (A, L) of the ``timing`` and ``agent_sweep`` phases at M=8192, and
#: the earlier rule's shape (W, markets a CTA, mode, C) there.
TIMED_SHAPES = [(16, 128, (1, 4, "registers", 1)),
                (64, 128, (1, 4, "registers", 1)),
                (256, 128, (1, 4, "registers", 1)),
                (1024, 128, (1, 4, "shared", 1)),
                (32, 1024, (8, 1, "registers", 1))]


@pytest.mark.parametrize("A,L,earlier", TIMED_SHAPES)
def test_rule_is_the_parents_at_the_timed_shapes(A, L, earlier):
    """At M=8192 the rule launches the earlier rule's shape at every timed
    width of L=128: the registers mode, or four one-warp teams a CTA in
    the shared mode (A=1024), one CTA a market. At A=32, L=1024 (the
    ``wide_book`` cell) the persistent rule gives a grid that eight warps
    a market run in more than one wave one warp a market, four a CTA, at
    32 levels a lane, and one wave the earlier eight warps; the per-step
    rule keeps eight warps at any grid."""
    wide_from = 2 * 132 + 1    # two CTAs of eight warps an SM: 264 a wave
    edges = (wide_from, wide_from - 1) if L > 128 else ()
    for M in (8192, 1024, 264 if A != 1024 else 528) + edges:
        got = autotune.auto_tile(L, A, M, sms=132, max_ctas=16)
        want = autotune.TileChoice(L, A, *earlier)
        if L > 128 and M >= wide_from:
            want = want._replace(warps_per_market=1, markets_per_cta=4)
            assert got.levels_per_lane == 32
        assert got == want
        assert autotune.auto_tile(L, A, M, sms=132, max_ctas=16,
                                  hoisted=False) == \
            autotune.TileChoice(L, A, *earlier)
    assert autotune.auto_tile(L, A) == autotune.TileChoice(L, A, *earlier)
    assert autotune.auto_tile(L, A).ctas_per_market == 1


#: The persistent rule past L = 128 on an H100's 132 SMs: (label, M, A, L,
#: the shape (W, markets a CTA, mode, C), levels a lane). A grid that the
#: team of L / 128 warps runs in more than one wave (past 264 markets at
#: L = 1024, two CTAs of eight warps an SM) takes the fewest warps whose
#: registers hold its agents (8·32·W >= A); one wave, and L <= 128, keep
#: the earlier shapes.
NARROW_RULES = [
    ("wide_book", 8192, 32, 1024, (1, 4, "registers", 1), 32),
    ("ragged", 8191, 32, 1024, (1, 4, "registers", 1), 32),
    ("a1", 8192, 1, 1024, (1, 4, "registers", 1), 32),
    ("a300", 8192, 300, 1024, (2, 1, "registers", 1), 16),
    ("a1024", 8192, 1024, 1024, (4, 1, "registers", 1), 8),
    ("a2048", 8192, 2048, 1024, (8, 1, "registers", 1), 4),
    ("a2049", 8192, 2049, 1024, (8, 1, "shared", 1), 4),
    ("l256", 8192, 32, 256, (1, 4, "registers", 1), 8),
    ("l512-a256", 8192, 256, 512, (1, 4, "registers", 1), 16),
    ("l512-a257", 8192, 257, 512, (2, 1, "registers", 1), 8),
    ("small-M", 132, 32, 1024, (8, 1, "registers", 1), 4),
    ("one-wave", 264, 32, 1024, (8, 1, "registers", 1), 4),
    ("two-waves", 265, 32, 1024, (1, 4, "registers", 1), 32),
    ("l256-one-wave", 1320, 32, 256, (2, 1, "registers", 1), 4),
    ("l256-two-waves", 1321, 32, 256, (1, 4, "registers", 1), 8),
    ("l128", 8192, 256, 128, (1, 4, "registers", 1), 4)]


@pytest.mark.parametrize("label,M,A,L,want,lpl", NARROW_RULES,
                         ids=[r[0] for r in NARROW_RULES])
def test_persistent_rule_takes_the_narrowest_team_past_l128(label, M, A, L,
                                                            want, lpl):
    """Past L = 128, where the agents fit the registers mode and the team
    of L / 128 warps would run the grid in more than one wave on an
    H100, a persistent kernel takes the fewest warps whose registers hold
    the agents, four teams a CTA at one warp, each lane holding
    L / (32·W) levels; the per-step kernels, the rule without a market
    count and a grid of one wave keep the team of L / 128 warps."""
    got = autotune.auto_tile(L, A, M, sms=132, max_ctas=16)
    assert (got.warps_per_market, got.markets_per_cta, got.agents,
            got.ctas_per_market) == want
    assert got.levels_per_lane == lpl
    assert autotune.auto_tile(L, A, M) == got   # the H100's count here
    assert autotune.check_tile(got, L, A, True) is got
    four = autotune.auto_tile(L, A)
    assert four.levels_per_lane == 4
    assert autotune.auto_tile(L, A, M, sms=132, max_ctas=16,
                              hoisted=False) == four
    # The SMs and what an SM holds are the rule's parameters: where the
    # four-level team's grid is one wave, it stays.
    assert autotune.auto_tile(L, A, M, sms=M, max_ctas=16) == four
    held = autotune.auto_tile(L, A, M, sms=132, max_ctas=16,
                              holds=lambda t: M)
    assert held == four or four.agents != "registers" or L <= 128
    if lpl > 4:
        assert autotune.waves(four, M, 132, autotune.h100_holds) > 1
        assert want[0] == min(w for w in autotune.WARPS_PER_MARKET
                              if A <= 8 * 32 * w) < four.warps_per_market


def test_check_tile_takes_narrow_teams_only_where_the_kernels_have_them():
    """A team narrower than L / 128 warps is a launch shape of the
    persistent kernels in the registers mode at one CTA a market (the
    instances of 8, 16 and 32 levels a lane), and of nothing else: not of
    the per-step kernels, not in the shared or fresh mode, not on a
    cluster, and not past the registers its warps have."""
    assert [autotune.levels_per_lane(L, W) for L, W in (
        (128, 1), (256, 1), (512, 1), (1024, 1), (1024, 2), (1024, 4),
        (1024, 8), (256, 8), (4, 1))] == [4, 8, 16, 32, 16, 8, 4, 4, 4]
    narrow = autotune.TileChoice(1024, 32, 1, 4, "registers")
    assert narrow.levels_per_lane == 32
    assert autotune.check_tile(narrow, 1024, 32, True) is narrow
    assert autotune.check_shape(1024, 32, 1, 4, "registers", True) == \
        4 * 4 * 2 * 1024     # the bins alone, as at eight warps
    with pytest.raises(ValueError, match="cannot hold"):
        autotune.check_tile(narrow, 1024, 32, False)
    for mode in ("shared", "fresh"):
        with pytest.raises(ValueError, match="cannot hold"):
            autotune.check_tile(narrow._replace(agents=mode), 1024, 32,
                                True)
    with pytest.raises(ValueError, match="cannot hold"):
        autotune.check_tile(narrow._replace(markets_per_cta=1,
                                            ctas_per_market=2), 1024, 32,
                            True)
    with pytest.raises(ValueError, match="registers"):
        autotune.check_tile(autotune.TileChoice(1024, 300, 1, 1,
                                                "registers"), 1024, 300,
                            True)
    two = autotune.TileChoice(1024, 300, 2, 1, "registers")
    assert autotune.check_tile(two, 1024, 300, True).levels_per_lane == 16


def test_candidates_at_l1024_list_the_narrow_teams():
    """At A=32, L=1024 a persistent kernel's sweep offers the rule's one
    warp a market first, then one warp at 1, 2 and 8 markets a CTA, two
    and four warps (16 and 8 levels a lane), and eight warps in each
    mode; a per-step kernel offers eight warps alone; at A=300 one warp's
    registers cannot hold the agents."""
    cands = autotune.candidate_tiles(1024, 32, 8192, hoisted=True)
    assert [tuple(c[2:]) for c in cands] == [
        (1, 4, "registers", 1), (1, 1, "registers", 1),
        (1, 2, "registers", 1), (1, 8, "registers", 1),
        (2, 1, "registers", 1), (4, 1, "registers", 1),
        (8, 1, "shared", 1), (8, 1, "registers", 1), (8, 1, "fresh", 1)]
    assert [c.levels_per_lane for c in cands] == [32, 32, 32, 32, 16, 8, 4,
                                                  4, 4]
    assert autotune.candidate_tiles(1024, 32, 8192, hoisted=False) == [
        autotune.TileChoice(1024, 32, 8, 1, "registers")]
    wider = autotune.candidate_tiles(1024, 300, 8192, hoisted=True)
    assert wider[0] == autotune.TileChoice(1024, 300, 2, 1, "registers")
    assert min(c.warps_per_market for c in wider) == 2


@pytest.mark.parametrize("C", autotune.CTAS_PER_MARKET)
@pytest.mark.parametrize("mode", autotune.AGENT_MODES)
def test_smem_is_the_c_formula(mode, C):
    """``check_shape`` and ``TileChoice.smem_bytes`` take the C side's
    shared memory (``team_smem_words`` over ``agent_slots``, transcribed
    in ``_c_team_words``) at every cluster size and mode: a cluster's CTA
    holds two parity buffers of bins and ⌈A / (C·T)⌉·T keys and type
    bytes."""
    for L, A in ((128, 256), (128, 3001), (128, 46080), (1024, 20000),
                 (128, 100000), (32, 7)):
        for W in (1, 2, 4, 8):
            if 128 * W < L:
                continue
            tile = autotune.TileChoice(L, A, W, 1, mode, C)
            words = _c_team_words(L, A, 32 * W, C, mode == "shared")
            if _c_accepts(L, A, W, 1, mode, C):
                assert autotune.check_shape(L, A, W, 1, mode, True, C) == \
                    tile.smem_bytes(True) == 4 * words
                assert autotune.estimate_smem_bytes(tile, L, A, True) == \
                    4 * words
            else:
                with pytest.raises(ValueError):
                    autotune.check_shape(L, A, W, 1, mode, True, C)
            assert tile.smem_bytes(False) == 4 * _c_team_words(
                L, A, 32 * W, C, False)


def test_card_limits_without_a_card(monkeypatch):
    """A process without a card counts the H100's 132 SMs and clusters of
    up to 16 CTAs, and asks no library."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert autotune.card_limits(128, 50000, 1) == (132, 16)
    assert autotune.auto_tile(128, 50000, 10) == autotune.auto_tile(
        128, 50000, 10, sms=132, max_ctas=16)


def test_shards_pick_their_own_cluster(monkeypatch):
    """On a mesh, the rule's tile is each shard's rows' own: 65 markets of
    a fresh population over 2 shards are 33 and 32 rows, one cluster of 4
    and one of 8 CTAs a market (132 SMs)."""
    from repro_torch.launch import set_host_device_count

    monkeypatch.setattr(autotune, "card_limits", lambda *a: (132, 16))
    prev = set_host_device_count(2)
    try:
        cfg = MarketConfig(num_markets=65, num_agents=46081, num_levels=128,
                           num_steps=4, seed=3)
        with Engine("cuda-kinetic", devices=2, autotune=False,
                    chunk_size=4, **CPU).open(cfg) as s:
            runner = s._runner
            g = s.metrics.snapshot()["gauges"]
    finally:
        set_host_device_count(prev)
    assert [t.ctas_per_market for t in runner.shard_tiles] == [4, 8]
    assert runner.tile == runner.shard_tiles[0]
    assert g["tile_ctas_per_market"] == 4


def test_keys_are_distinct_per_configuration():
    base = dict(kernel="kinetic_clearing_chunk", scan="cumsum",
                stats_only=False, agents=None)
    keys = {autotune.tune_key(128, 256, 64, device="cpu", **base)}
    for field, other in (("kernel", "naive_clearing_chunk"),
                         ("scan", "hillis-steele"), ("stats_only", True),
                         ("agents", "shared")):
        keys.add(autotune.tune_key(128, 256, 64, device="cpu",
                                   **dict(base, **{field: other})))
    keys.add(autotune.tune_key(128, 256, 1, device="cpu", **base))
    keys.add(autotune.tune_key(64, 256, 64, device="cpu", **base))
    assert len(keys) == 7
    # The runner's keys carry the rule's cluster size: shapes that differ
    # in C never share a winner.
    by_c = {autotune.tune_key(128, 50000, 64, device="cpu",
                              ctas_per_market=C, **base)
            for C in autotune.CTAS_PER_MARKET}
    assert len(by_c) == len(autotune.CTAS_PER_MARKET)
    assert not by_c & keys
    key = autotune.tune_key(128, 256, 64, device="cpu", **base)
    assert key[:4] == ("cpu", 128, 256, 64)
    # Sorted context, as repro's: the order of the keywords does not matter.
    assert key == autotune.tune_key(128, 256, 64, device="cpu",
                                    agents=None, stats_only=False,
                                    scan="cumsum",
                                    kernel="kinetic_clearing_chunk")


# ---------------------------------------------------------------------------
# The sweep machinery.
# ---------------------------------------------------------------------------

def test_cache_hit_does_not_resweep():
    cands = autotune.candidate_tiles(128, 16, hoisted=True)
    timed = []

    def time_candidate(c):
        timed.append(c)
        return float(len(timed))

    key = ("k",)
    first = autotune.autotune_tile(key, time_candidate, cands)
    assert first == cands[0] and timed == cands
    again = autotune.autotune_tile(key, time_candidate, cands)
    assert again == first and timed == cands
    assert len(autotune.sweep_reports()) == 1
    rep = autotune.last_sweep_report()
    assert rep.key == key and not rep.fell_back and rep.tried == tuple(cands)
    assert [c for c, _ in rep.times] == cands and rep.failures == ()


def _scripted(monkeypatch):
    """``time_call`` patched to call each candidate once, untimed, and
    return rising scripted times (the first candidate wins); returns the
    list of the candidates' outputs."""
    calls = []

    def fake_time_call(fn, block, trials=2):
        out = fn()                    # the candidate's outputs, not timed
        calls.append(out)
        return 1.0 + 0.001 * len(calls)

    monkeypatch.setattr(autotune, "time_call", fake_time_call)
    return calls


@pytest.mark.parametrize("backend,hoisted", [("cuda-kinetic", True),
                                             ("cuda-naive", False)])
def test_winner_is_the_fastest(backend, hoisted, monkeypatch):
    """With scripted times the runner takes the fastest candidate, writes
    one report per miss, and every candidate's call gives the same bits."""
    spec = CFG
    cands = autotune.candidate_tiles(spec.num_levels, spec.num_agents,
                                     hoisted=hoisted)
    fastest = cands[len(cands) // 2]
    outs = []

    def fake_time_call(fn, block, trials=2):
        outs.append(fn())
        return 0.5 if len(outs) == cands.index(fastest) + 1 else 1.0

    monkeypatch.setattr(autotune, "time_call", fake_time_call)
    eng = Engine(backend, autotune=True, chunk_size=4, **CPU)
    with eng.open(spec) as s:
        assert s._runner.tile == fastest
        s.run(4)
    assert len(outs) == len(cands) and len(autotune.sweep_reports()) == 1
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)
    # A second engine, same key: a cache hit; another chunk: a new sweep.
    with Engine(backend, autotune=True, chunk_size=4, **CPU).open(spec) as s:
        assert s._runner.tile == fastest
    assert len(autotune.sweep_reports()) == 1
    Engine(backend, autotune=True, chunk_size=3, **CPU).open(spec)
    assert len(autotune.sweep_reports()) == 2


def test_all_candidates_fail_falls_back_to_the_rule():
    cands = autotune.candidate_tiles(32, 16, hoisted=True)

    def refuse(c):
        raise RuntimeError(f"kinetic_clearing_chunk launch failed: CUDA "
                           f"error 701 (too many resources requested for "
                           f"launch) at W={c.warps_per_market}")

    rule = autotune.auto_tile(32, 16)
    got = autotune.autotune_tile(("all-fail",), refuse, cands[::-1],
                                 fallback=rule)
    assert got == rule
    rep = autotune.last_sweep_report()
    assert rep.fell_back and rep.winner == rule and rep.times == ()
    assert len(rep.failures) == len(cands)
    assert all("RuntimeError" in f and "too many resources" in f
               for f in rep.failures)
    assert rep.failures[0].startswith(repr(cands[-1]))
    # The fall-back is cached: a later call hits it without sweeping.
    assert autotune.autotune_tile(("all-fail",), refuse, cands) == rule
    assert len(autotune.sweep_reports()) == 1


def test_a_failing_candidate_is_disqualified_not_hidden():
    cands = autotune.candidate_tiles(128, 16, hoisted=True)

    def time_candidate(c):
        if c.markets_per_cta == 8:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return 1.0 if c != cands[3] else 0.5

    got = autotune.autotune_tile(("some-fail",), time_candidate, cands)
    rep = autotune.last_sweep_report()
    assert got == cands[3] and not rep.fell_back
    bad = [c for c in cands if c.markets_per_cta == 8]
    assert len(rep.failures) == len(bad) > 0
    assert all("OutOfMemoryError" in f for f in rep.failures)


@pytest.mark.parametrize("exc,oom", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate "
                                 "2.00 GiB"), True),
    (RuntimeError("naive_clearing_chunk launch failed: CUDA error 701 (too "
                  "many resources requested for launch)"), True),
    (RuntimeError("RESOURCE_EXHAUSTED: while allocating"), True),
    (ValueError("launch shape needs 300000 bytes of shared memory over the "
                "limit of 231424"), True),
    (RuntimeError("kinetic_clearing_chunk launch failed: CUDA error 1 "
                  "(invalid argument)"), False),
    (ValueError("tile is for L=64, A=16 but the operands have L=32"), False),
])
def test_is_oom_error_spellings(exc, oom):
    assert autotune.is_oom_error(exc) is oom


def test_check_tile_refusals():
    with pytest.raises(ValueError, match="shared memory over the limit") \
            as info:
        autotune.check_shape(128, 46081, 1, 1, "shared", True)
    assert autotune.is_oom_error(info.value)
    with pytest.raises(ValueError, match="operands"):
        autotune.check_tile(autotune.auto_tile(64, 16), 32, 16, True)
    with pytest.raises(ValueError, match="registers"):
        autotune.check_tile(autotune.TileChoice(128, 300, 1, 4, "registers"),
                            128, 300, True)
    # A per-step kernel keeps no agents: the same shape is fine there.
    autotune.check_tile(autotune.TileChoice(128, 300, 1, 4, "registers"),
                        128, 300, False)
    with pytest.raises(TypeError):
        autotune.check_tile((128, 16, 1, 4, "registers"), 128, 16, True)


def test_force_autotune_oom_restores_time_call():
    real = autotune.time_call
    with force_autotune_oom():
        assert autotune.time_call is not real
        with pytest.raises(torch.cuda.OutOfMemoryError) as info:
            autotune.time_call(lambda: None, lambda _: None)
        assert autotune.is_oom_error(info.value)
    assert autotune.time_call is real
    with pytest.raises(KeyError):
        with force_autotune_oom():
            raise KeyError("boom")
    assert autotune.time_call is real


def test_time_call_takes_the_blocks_device_time():
    """A ``block`` that returns a time (a card's CUDA events) ranks by it;
    one that returns None falls back to the wall. Either way the warm-up
    is not timed and the best of ``TRIALS`` calls is kept."""
    calls = []
    device = iter([9.0, 0.3, 0.2])       # warm-up, then the two trials

    def fn():
        calls.append(len(calls))

    assert autotune.time_call(fn, lambda _: next(device)) == 0.2
    assert len(calls) == 1 + autotune.TRIALS
    wall = autotune.time_call(fn, lambda _: None)
    assert 0.0 <= wall < 1.0 and len(calls) == 2 * (1 + autotune.TRIALS)


def test_estimate_smem_bytes_is_the_tiles():
    for hoisted in (True, False):
        for c in autotune.candidate_tiles(128, 1024, hoisted=hoisted):
            assert autotune.estimate_smem_bytes(c, 128, 1024, hoisted) == \
                c.smem_bytes(hoisted)


# ---------------------------------------------------------------------------
# The entries and the runner's knobs.
# ---------------------------------------------------------------------------

def _operands(spec):
    return tuple(initial_state(spec, "cpu"))


@pytest.mark.parametrize("entry,hoisted", [(kc.kinetic_clearing_chunk, True),
                                           (nc.naive_clearing_chunk, False)])
def test_chunk_entries_take_a_tile(entry, hoisted):
    state = _operands(CFG)
    kw = dict(cfg=CFG, chunk=6)
    want = entry(*state, 0, 6, **kw)
    for tile in autotune.candidate_tiles(32, 16, hoisted=hoisted):
        got = entry(*state, 0, 6, tile=tile, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="operands"):
        entry(*state, 0, 6, tile=autotune.auto_tile(64, 16), **kw)
    with pytest.raises(ValueError, match="operands"):
        entry(*state, 0, 6, tile=autotune.auto_tile(32, 17), **kw)
    # The plain version accepts and ignores a tile.
    plain = kc.kinetic_clearing_chunk_plain(*state, 0, 6, tile=object(), **kw)
    for a, b in zip(plain, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("entry,hoisted", [(kc.kinetic_clearing, True),
                                           (nc.naive_clearing, False)])
def test_legacy_entries_take_a_tile(entry, hoisted):
    cfg = MarketConfig(num_markets=3, num_agents=16, num_levels=32,
                       num_steps=5, seed=2)
    state = _operands(cfg)
    want = entry(*state, cfg=cfg)
    for tile in autotune.candidate_tiles(32, 16, hoisted=hoisted)[::5]:
        got = entry(*state, cfg=cfg, tile=tile)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="operands"):
        entry(*state, cfg=cfg, tile=autotune.auto_tile(128, 16))
    plain = kc.kinetic_clearing_plain(*state, cfg=cfg, tile=None)
    for a, b in zip(plain, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("backend", ["cuda-kinetic", "cuda-naive"])
def test_runner_knobs(backend, monkeypatch):
    """``tile=`` pins (no sweep), ``autotune=False`` and ``"auto"`` on the
    CPU keep the rule, ``agents=`` pins the mode and sweeps the rest, and
    a sweep builds nothing; every choice runs the same bits."""
    _scripted(monkeypatch)
    rule = autotune.auto_tile(32, 16)
    pinned = autotune.TileChoice(32, 16, 2, 1, "fresh")

    def stream(**opts):
        eng = Engine(backend, chunk_size=4, **CPU, **opts)
        with eng.open(CFG) as s:
            return s._runner, s.run(12).to_numpy(), eng, s.metrics

    runner, want, _, _ = stream(autotune=False)
    assert runner.tile == rule
    runner, got, _, _ = stream()                 # "auto": no card, no sweep
    assert runner.tile == rule and not autotune.sweep_reports()
    runner, got, _, _ = stream(tile=pinned, autotune=True)
    assert runner.tile == pinned and not autotune.sweep_reports()
    for a, b in zip(got, want):
        assert (a == b).all()
    runner, got, eng, _ = stream(agents="shared", autotune=True)
    assert runner.tile.agents == "shared" and eng.trace_count == 1
    rep = autotune.last_sweep_report()
    assert all(c.agents == "shared" for c in rep.tried)
    assert ("agents", "shared") in rep.key
    for a, b in zip(got, want):
        assert (a == b).all()
    with pytest.raises(ValueError, match="operands"):
        stream(tile=autotune.auto_tile(64, 16))
    with pytest.raises(ValueError, match="autotune"):
        stream(autotune="sometimes")


def test_the_sweep_times_one_shards_rows(monkeypatch):
    """A sharded runner times its candidates on one shard's rows (the
    largest), from the opening books."""
    from repro_torch.launch import set_host_device_count

    calls = _scripted(monkeypatch)
    prev = set_host_device_count(3)
    try:
        cfg = MarketConfig(num_markets=10, num_agents=16, num_levels=32,
                           num_steps=8, seed=1)
        Engine("cuda-kinetic", autotune=True, devices=3, chunk_size=4,
               **CPU).open(cfg)
    finally:
        set_host_device_count(prev)
    assert calls and all(out[0].shape == (4, 32) for out in calls)


@pytest.mark.parametrize("backend,hoisted", [("cuda-kinetic", True),
                                             ("cuda-naive", False)])
def test_session_tile_gauges(backend, hoisted):
    eng = Engine(backend, chunk_size=4, **CPU)
    with eng.open(CFG) as s:
        g = s.metrics.snapshot()["gauges"]
        tile = s._runner.tile
    assert g["tile_warps_per_market"] == tile.warps_per_market
    assert g["tile_markets_per_cta"] == tile.markets_per_cta
    assert g["tile_agents"] == tile.agents
    assert g["tile_levels_per_lane"] == tile.levels_per_lane == 4
    assert g["autotune_smem_bytes"] == tile.smem_bytes(hoisted)
    with Engine("torch-scan", chunk_size=4, **CPU).open(CFG) as s:
        assert "tile_agents" not in s.metrics.snapshot()["gauges"]


@pytest.mark.parametrize("backend,want", [
    ("cuda-kinetic", (1, 4, "registers", 32)),
    ("cuda-naive", (8, 1, "registers", 4))])
def test_session_gauges_show_a_narrow_team(backend, want):
    """A persistent session of 265 markets at L=1024 (two waves of eight
    warps a market on an H100) opens on one warp a market, 32 levels a
    lane; a per-step one keeps eight warps, four levels a lane."""
    cfg = MarketConfig(num_markets=265, num_agents=8, num_levels=1024,
                       num_steps=2, seed=3)
    with Engine(backend, chunk_size=2, **CPU).open(cfg) as s:
        g = s.metrics.snapshot()["gauges"]
        s.run(2)
    assert (g["tile_warps_per_market"], g["tile_markets_per_cta"],
            g["tile_agents"], g["tile_levels_per_lane"]) == want


# ---------------------------------------------------------------------------
# AutotuneOOM through the chaos harness.
# ---------------------------------------------------------------------------

CHAOS_KW = dict(num_markets=6, num_agents=16, num_levels=32, num_steps=24,
                shock_step=11, seed=7)
CHUNK = 6


def test_autotune_oom_falls_back_and_stays_bitwise(tmp_path):
    """Restarting under an OOM-shaped sweep falls back to the rule's tile
    and the recovered stream equals the fault-free one and ``repro``'s
    ``run_plan`` of the same plan on ``pallas-kinetic``."""
    cfg = scenario_config("flash-crash", **CHAOS_KW)
    with Engine("cuda-kinetic", chunk_size=CHUNK, **CPU).open(cfg) as s:
        want = s.run(CHAOS_KW["num_steps"]).to_numpy()
    plan = FaultPlan([AutotuneOOM(at_step=12)], checkpoint_every=CHUNK)
    rep = run_plan(plan, cfg, backend="cuda-kinetic", ckpt_dir=tmp_path / "p",
                   chunk_size=CHUNK, engine_opts=CPU)
    assert rep.replay_matched
    for a, b in zip(rep.batch, want):
        assert (np.asarray(a) == np.asarray(b)).all()
    ev = rep.events[0]
    rule = autotune.auto_tile(32, 16)
    assert "fell_back=True" in ev.detail and repr(rule) in ev.detail
    assert len(ev.errors) == len(autotune.candidate_tiles(32, 16,
                                                          hoisted=True))
    assert all("OutOfMemoryError" in e and "CUDA out of memory" in e
               for e in ev.errors)
    report = autotune.last_sweep_report()
    assert report.fell_back and report.winner == rule
    j_autotune.clear_tune_cache()
    try:
        jrep = j_run_plan(
            JFaultPlan([JAutotuneOOM(at_step=12)], checkpoint_every=CHUNK),
            j_scenario_config("flash-crash", **CHAOS_KW),
            backend="pallas-kinetic", ckpt_dir=tmp_path / "j",
            chunk_size=CHUNK)
    finally:
        j_autotune.clear_tune_cache()
    assert "fell_back=True" in jrep.events[0].detail
    for a, b in zip(rep.batch, jrep.batch):
        assert (np.asarray(a) == np.asarray(b)).all()
    for a, b in zip(rep.state, jrep.state):
        assert (np.asarray(a) == np.asarray(b)).all()


def test_autotune_oom_needs_a_sweep(tmp_path):
    """A pinned tile disables the sweep, so the fault cannot fall back:
    the harness says so instead of passing silently."""
    cfg = scenario_config("flash-crash", **CHAOS_KW)
    plan = FaultPlan([AutotuneOOM(at_step=12)], checkpoint_every=CHUNK)
    with pytest.raises(RuntimeError, match="fall back"):
        run_plan(plan, cfg, backend="cuda-kinetic", ckpt_dir=tmp_path,
                 chunk_size=CHUNK,
                 engine_opts=dict(CPU, tile=autotune.auto_tile(32, 16)))


def test_runners_are_opened_through_the_factories():
    """Both factories take the knobs by name, as ``Engine`` passes them."""
    spec = CFG
    for factory in (ops.open_kinetic_runner, ops.open_naive_runner):
        r = factory(spec, 4, "cpu", tile=None, agents=None, autotune=False,
                    devices=None, mesh=None)
        assert r.tile == autotune.auto_tile(32, 16) and r.mesh.size == 1


def test_shared_memory_opt_in_counts_the_static_scratch():
    """Some candidates take just under 48 KB of dynamic shared memory, which
    fits the default limit only without the kernels' static reduction
    scratch: the C side opts in above 48 KB less that scratch."""
    assert "smem + sizeof(TeamScratch) <= 48 * 1024" in HEADER
    window = [c for c in autotune.candidate_tiles(128, 1024, hoisted=True)
              if 48 * 1024 - 1024 < c.smem_bytes(True) <= 48 * 1024]
    assert autotune.TileChoice(128, 1024, 1, 8, "shared") in window
