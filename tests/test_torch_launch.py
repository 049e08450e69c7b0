"""The launch rule of the port's clearing kernels
(``repro_torch.kernels.autotune``): every shape it gives fits a Hopper CTA
and covers every level and every agent of a market exactly once; it takes
any population (past shared memory, in the fresh agent mode) and raises
only outside its domain; and its constants are the CUDA header's."""
import re

import pytest

from repro_torch.kernels import _build, autotune

LEVELS = [2 ** k for k in range(2, 11)]          # 4 .. 1024
AGENTS = [1, 5, 16, 32, 300, 1024, 4096, 50000]

#: What one Hopper CTA can take (H100 SXM: 227 KB of shared memory, 1024
#: threads).
CTA_SMEM = 232448
CTA_THREADS = 1024

HEADER = (_build.CSRC / "kinetic_step.cuh").read_text()


@pytest.mark.parametrize("L", LEVELS)
@pytest.mark.parametrize("A", AGENTS)
def test_shape_fits_a_cta(L, A):
    shape = autotune.auto_tile(L, A)
    assert shape.threads_per_cta <= min(CTA_THREADS,
                                        autotune.MAX_CTA_THREADS)
    for hoisted in (False, True):
        # The dynamic part plus the static reduction scratch.
        assert shape.smem_bytes(hoisted) + 1024 <= CTA_SMEM
    # A several-warp team is the whole CTA (its barrier is __syncthreads).
    assert shape.warps_per_market == 1 or shape.markets_per_cta == 1
    assert shape.grid(10 ** 4 + 1) * shape.markets_per_cta >= 10 ** 4 + 1


def _header_map(pattern: str, count: int):
    """The index expression that ``pattern`` captures in kinetic_step.cuh
    (found ``count`` times), as a Python function of the team thread ``t``,
    the team size ``T`` and the loop counters ``j``, ``k``."""
    found = re.findall(pattern, HEADER)
    assert len(found) == count and len(set(found)) == 1, (pattern, found)
    # One CTA a market: the bins' span starts thread t at t, strides T.
    assert "return AgentSpan{tm.t, tm.T};" in HEADER
    expr = (found[0].replace("tm.t", "t").replace("tm.T", "T")
            .replace("s.first", "t").replace("s.stride", "T")
            .replace("LEVELS_PER_LANE", str(autotune.LEVELS_PER_LANE)))
    return eval(f"lambda t, T, j=0, k=0: {expr}")


@pytest.mark.parametrize("L", LEVELS)
@pytest.mark.parametrize("A", AGENTS)
def test_shape_covers_levels_and_agents_once(L, A):
    """The kernel's own index maps (read from the header) cover, at the
    rule's team size, every level and every agent exactly once."""
    shape = autotune.auto_tile(L, A)
    T = shape.threads_per_market
    assert "tm.T = 32 * W;" in HEADER and "% tm.T;" in HEADER
    # Levels: load_book, store_book and the step's lv0 agree.
    level = _header_map(r"const int lv = (tm\.t \* LEVELS_PER_LANE \+ j);",
                        2)
    assert "const int lv0 = tm.t * LEVELS_PER_LANE;" in HEADER
    own = {t: [lv for j in range(autotune.LEVELS_PER_LANE)
               if (lv := level(t, T, j=j)) < L] for t in range(T)}
    assert sorted(lv for t in own for lv in own[t]) == list(range(L))
    for levels in own.values():  # contiguous, at most LEVELS_PER_LANE
        assert levels == sorted(levels)
        assert not levels or levels[-1] - levels[0] == len(levels) - 1
    # Agents: register slots k of RegAgents, else the strided loops of
    # SmemAgents (init and each, slot i = a at one CTA a market) and
    # FreshAgents.
    if shape.agents == "registers":
        agent = _header_map(r"const int a = (s\.first \+ k \* s\.stride);",
                            2)
        mine = {t: [a for k in range(autotune.REG_AGENTS)
                    if (a := agent(t, T, k=k)) < A] for t in range(T)}
    else:
        assert HEADER.count("for (int a = s.first, i = tm.t; a < A; "
                            "a += s.stride, i += tm.T)") == 2
        assert "for (int a = s.first; a < A; a += s.stride)" in HEADER
        mine = {t: list(range(t, A, T)) for t in range(T)}
    assert sorted(a for t in mine for a in mine[t]) == list(range(A))
    # Lane-strided: a warp holds 32 consecutive agent ids.
    for t, agents in mine.items():
        assert all(a % T == t for a in agents)


@pytest.mark.parametrize("L,A", [(128, 256), (128, 16), (1024, 32),
                                 (8, 5)])
def test_the_paper_shapes(L, A):
    """One warp per market at the paper's L=128, agents in registers;
    eight warps at L=1024."""
    shape = autotune.auto_tile(L, A)
    want_warps = max(1, L // 128)
    assert shape.warps_per_market == want_warps
    assert shape.markets_per_cta == (4 if want_warps == 1 else 1)
    assert shape.agents == "registers"
    assert shape.as_c_args() == (want_warps, shape.markets_per_cta, 1, 1)


def test_large_populations_move_to_shared_memory():
    shape = autotune.auto_tile(128, 1024)
    assert shape.agents == "shared"
    assert shape.as_c_args()[2] == 0
    assert shape.smem_bytes(True) > shape.smem_bytes(False) == \
        shape.markets_per_cta * 8 * 128
    # A population too large for four teams per CTA gets fewer.
    big = autotune.auto_tile(128, 20000)
    assert big.markets_per_cta < 4
    assert big.smem_bytes(True) <= autotune.MAX_DYNAMIC_SMEM


@pytest.mark.parametrize("L,A", [(2, 16), (3, 16), (0, 16), (96, 16),
                                 (2048, 16), (128, 0), (128, -1)])
def test_rule_raises_outside_its_domain(L, A):
    with pytest.raises(ValueError):
        autotune.auto_tile(L, A)


@pytest.mark.parametrize("L,ceiling", [(128, 46080), (1024, 44646),
                                       (1024, 10 ** 6 - 1)])
def test_population_ceiling(L, ceiling):
    """The shared-memory ceiling the module docstring states: up to it a
    market's keys and type bytes fill at most one CTA's shared memory; one
    agent more (and any population beyond) takes the fresh mode, which
    keeps only the bins there; there a market hashes every agent at every
    step, so it takes the widest team, one a CTA."""
    shape = autotune.auto_tile(L, ceiling)
    if ceiling < 10 ** 5:
        assert shape.agents == "shared"
        assert shape.markets_per_cta == 1
        assert shape.smem_bytes(True) == autotune.MAX_DYNAMIC_SMEM
    beyond = autotune.auto_tile(L, ceiling + 1)
    assert beyond.agents == "fresh"
    assert beyond.as_c_args() == (8, 1, 2, 1)
    assert beyond.markets_per_cta == 1
    assert beyond.smem_bytes(True) == beyond.smem_bytes(False) == \
        beyond.markets_per_cta * 8 * L


def test_constants_are_the_headers():
    def define(name):
        return re.search(rf"#define {name} (.+?)(\s+//.*)?$", HEADER,
                         re.M).group(1)

    assert int(define("LEVELS_PER_LANE")) == autotune.LEVELS_PER_LANE
    assert define("LEVELS_PER_WARP") == "(32 * LEVELS_PER_LANE)"
    assert int(define("REG_AGENTS")) == autotune.REG_AGENTS
    assert int(define("MAX_CTA_THREADS")) == autotune.MAX_CTA_THREADS
    assert eval(define("MAX_DYNAMIC_SMEM")) == autotune.MAX_DYNAMIC_SMEM
    assert int(define("MAX_CLUSTER_CTAS")) == autotune.CTAS_PER_MARKET[-1]
    assert int(define("PORTABLE_CLUSTER_CTAS")) == 8
    # The C side's shared-memory formula is the Python one.
    assert ("(C > 1 ? 4 : 2) * L + (agents_in_smem ? K + (K + 3) / 4 : 0)"
            in HEADER)
    # The agent mode codes are the C enum's, in order.
    assert ("enum AgentMode { AGENTS_SHARED = 0, AGENTS_REGISTERS = 1, "
            "AGENTS_FRESH = 2 };") in HEADER
    assert autotune.AGENT_MODES == ("shared", "registers", "fresh")


def test_one_warp_teams_cross_no_cta_barrier():
    """At L <= 128 a market is one warp, and every __syncthreads() of the
    device step sits behind the one-warp early return (or the else of
    team_sync), so four markets share a CTA without a block barrier."""
    header = re.sub(r"//[^\n]*", "", HEADER)
    bodies = re.split(r"\n(?=__device__|template|static|struct|extern)",
                      header)
    with_barrier = [b for b in bodies if "__syncthreads()" in b]
    assert with_barrier
    for body in with_barrier:
        head = body.split("__syncthreads()")[0]
        assert ("if (tm.W == 1) return;" in head
                or "if (tm.W == 1) __syncwarp(); else" in head), body[:80]
    for t in (autotune.auto_tile(L, A) for L in (4, 32, 128)
              for A in AGENTS):
        assert t.warps_per_market == (8 if t.agents == "fresh" else 1)
