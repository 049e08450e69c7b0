"""Launch shapes of the port's clearing kernels: the fixed rule and the
timed sweep.

It is the counterpart of ``repro.kernels.autotune`` (``TileChoice``,
``auto_tile``, ``candidate_tiles``, ``autotune_tile``) for Hopper, where the
unit is a *market team* and not a sublane tile (``csrc/kinetic_step.cuh``):

  * a team of ``warps_per_market`` warps clears one market; thread ``t``
    owns the :func:`levels_per_lane` = LPL contiguous levels
    ``[LPL·t, LPL·t + LPL)`` and holds them in registers: four
    (``LEVELS_PER_LANE``) wherever the team has ``L / 128`` warps or more,
    as the per-step kernels and every market cluster always do; a
    persistent kernel in the registers mode at one CTA a market may run a
    narrower team, up to ``MAX_LEVELS_PER_LANE`` = 32 levels a lane (a
    one-warp team at L = 1024), where it crosses no block barrier;
  * one CTA holds ``markets_per_cta`` teams: several one-warp teams, or one
    several-warp team (whose barrier is then ``__syncthreads()``); a
    ragged last CTA is masked in the kernel;
  * agent ``a`` is handled by thread ``a mod T``. The persistent kernels
    compute each agent's step-invariant hash round and type once per call
    and keep them in registers while a thread has at most ``REG_AGENTS``
    agents (``agents="registers"``), else in the CTA's shared memory
    after its bins (``"shared"``). A market whose keys and type bytes (5
    bytes an agent) do not fit one CTA's shared memory beside the 8·L
    bytes of bins, past 46,080 agents at L=128 (44,646 at L=1024), has
    them recomputed at every step (``"fresh"``), as the per-step kernels
    always do: its books still stay on chip for the chunk. So the rule
    takes any population, as the JAX package's agent chunking does;
  * a kernel may spread one market over a thread-block cluster of
    ``ctas_per_market`` = C CTAs (C in ``CTAS_PER_MARKET``, one team a
    CTA): a persistent kernel in any agent mode, a per-step kernel in the
    fresh mode it always runs. CTA rank ``r`` handles the agents
    ``a ≡ r·T + t (mod C·T)``, holds only their keys and types
    (:func:`agent_slots` of them in the shared mode, ``REG_AGENTS`` a
    thread in registers), bins them into its own bins, and the C CTAs sum
    their bins through distributed shared memory, each clearing its own
    copy of the book. A few markets of a large population then fill the
    card's SMs, where one CTA a market would leave most of them idle, and
    a population past one CTA's shared memory can keep its keys on chip.

:func:`auto_tile` is the rule: ``W = max(1, L / 128)``, four one-warp
teams a CTA, agents in registers while they fit (past L = 128, for a
persistent kernel's grid that such a team runs in more than one wave,
the fewest warps whose registers hold the agents, at ``L / (32·W)``
levels a lane); past that the first
agent mode that fits one CTA, at a team of ``MAX_TEAM_WARPS`` warps, one
a CTA, wherever shared memory holds fewer than ``MARKETS_PER_CTA``
one-warp teams (always in the fresh mode); and, given the number of
markets, where they leave SMs idle, the smallest C whose grid reaches
the card's SMs; at that C (and at C = 1 for the widest team) the mode
of ``RULE_MODES`` whose grid takes the fewest waves (:func:`waves`, over
what the card holds at once: :func:`card_holds`, the H100's
:func:`h100_holds` without a card), the first on a tie. The per-step
kernels' rule (``hoisted=False``) takes the same C, counted with their
own residency, and no mode: they always run fresh.
:func:`check_shape` repeats the C side's domain check, and
:func:`candidate_tiles` lists every shape in it. :func:`autotune_tile`
times candidates once (the runner's ``time_candidate``) and caches the
winner per :func:`tune_key`; a candidate that raises is disqualified and
its failure recorded in a :class:`SweepReport`, and only when every
candidate fails does the rule's tile win, with ``fell_back=True``. Every shape computes the same bits, so
the choice changes the time of a launch and nothing else. The wrapper
passes the shape to the C entry, which checks it again. The constants
repeat ``kinetic_step.cuh``.
"""
from __future__ import annotations

import math
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

from repro_torch.ops import trace

LEVELS_PER_LANE = 4
LEVELS_PER_WARP = 32 * LEVELS_PER_LANE
#: Levels a lane of a persistent team in the registers mode may hold: a
#: one-warp team at L = 1024.
MAX_LEVELS_PER_LANE = 32
#: Agent slots a thread of a persistent kernel holds in registers.
REG_AGENTS = 8
#: Teams per CTA the rule takes when a market is one warp.
MARKETS_PER_CTA = 4
MAX_CTA_THREADS = 256
#: Warps a market may take, and teams a CTA of one-warp teams may hold.
WARPS_PER_MARKET = (1, 2, 4, 8)
#: The widest team, which the rule gives a market in the fresh mode.
MAX_TEAM_WARPS = WARPS_PER_MARKET[-1]
MARKETS_PER_CTA_CHOICES = (1, 2, 4, 8)
#: Dynamic shared memory a CTA may take: the 227 KB a block can use on
#: Hopper, less 1 KB for the static reduction scratch.
MAX_DYNAMIC_SMEM = 232448 - 1024
#: Where a persistent kernel keeps the agents' keys and types, in the order
#: of the C side's ``AgentMode`` codes (``kinetic_step.cuh``).
AGENT_MODES = ("shared", "registers", "fresh")
#: CTAs a market may take as a thread-block cluster; past the portable 8 a
#: cluster is non-portable, and Hopper's limit is 16.
CTAS_PER_MARKET = (1, 2, 4, 8, 16)
#: The agent modes the rule weighs for a team of ``MAX_TEAM_WARPS`` warps,
#: the first preferred where they take as many waves.
RULE_MODES = ("registers", "shared", "fresh")
#: SMs of the card the port is built for (an H100 SXM): the rule's count
#: where the process has no card (:func:`card_limits`).
TARGET_SMS = 132

#: Timed calls of a sweep candidate after its warm-up (:func:`time_call`).
TRIALS = 2

#: Winner cache of the timed sweep: :func:`tune_key` -> TileChoice.
_TUNE_CACHE: Dict[Tuple, "TileChoice"] = {}
#: One record per real sweep (cache misses only), newest last; the chaos
#: harness reads these to assert that an OOM-shaped sweep fell back.
_SWEEP_REPORTS: List["SweepReport"] = []
#: :func:`card_holds` per (card, tile).
_CARD_HOLDS: Dict[Tuple, int] = {}

# Substrings of an out-of-memory-shaped failure: the JAX package's markers
# (XLA's RESOURCE_EXHAUSTED, Mosaic's VMEM) and the card's spellings
# (torch.cuda.OutOfMemoryError, the runtime's launch-resource error, and
# check_tile's shared-memory refusal).
_OOM_MARKERS = ("resource_exhausted", "out of memory", "oom", "vmem",
                "outofmemoryerror", "too many resources requested for launch",
                "shared memory over the limit")


class TileChoice(NamedTuple):
    """A resolved launch shape for ``num_levels`` and ``num_agents``."""

    num_levels: int
    num_agents: int
    warps_per_market: int
    markets_per_cta: int
    agents: str    # persistent kernels: one of AGENT_MODES
    ctas_per_market: int = 1   # > 1: a market's cluster

    @property
    def threads_per_market(self) -> int:
        return 32 * self.warps_per_market

    @property
    def threads_per_cta(self) -> int:
        return self.threads_per_market * self.markets_per_cta

    @property
    def levels_per_lane(self) -> int:
        return levels_per_lane(self.num_levels, self.warps_per_market)

    def grid(self, num_markets: int) -> int:
        """CTAs for ``num_markets``: the last may be ragged, and a
        market's cluster is ``ctas_per_market`` CTAs side by side."""
        return -(-num_markets // self.markets_per_cta) * self.ctas_per_market

    def smem_bytes(self, hoisted: bool) -> int:
        """Dynamic shared memory per CTA: each team's int bins (2·L, two
        such buffers in a cluster) and, for a persistent kernel
        (``hoisted``) in the ``"shared"`` mode, the CTA's keys and type
        bytes (:func:`team_smem_bytes`)."""
        return self.markets_per_cta * team_smem_bytes(
            self.num_levels, self.num_agents,
            hoisted and self.agents == "shared", self.threads_per_market,
            self.ctas_per_market)

    def as_c_args(self) -> Tuple[int, int, int, int]:
        """``(warps_per_market, markets_per_cta, agent mode code,
        ctas_per_market)``."""
        return (self.warps_per_market, self.markets_per_cta,
                AGENT_MODES.index(self.agents), self.ctas_per_market)


class SweepReport(NamedTuple):
    """Outcome of one sweep (for observability and the chaos tests)."""

    key: Tuple                     # the tune_key that was populated
    winner: TileChoice            # the cached choice (the rule's if fell_back)
    fell_back: bool                # True iff every candidate failed
    tried: Tuple[TileChoice, ...]
    failures: Tuple[str, ...]      # one "TileChoice(...): ExcType: msg" each
    times: Tuple[Tuple[TileChoice, float], ...] = ()  # seconds, the timed ones
    seconds: float = 0.0           # the sweep's wall, every candidate's


def levels_per_lane(num_levels: int, warps_per_market: int) -> int:
    """Levels a lane of a team of ``warps_per_market`` warps holds at
    ``num_levels`` (``levels_per_lane`` of the C side): four up to
    L = 128·W, else ``L / (32·W)``."""
    return max(LEVELS_PER_LANE,
               int(num_levels) // (32 * int(warps_per_market)))


def agent_slots(num_agents: int, threads_per_market: int,
                ctas_per_market: int = 1) -> int:
    """Agent slots K of one CTA's key area (``agent_slots`` of the C side):
    the market's A agents at one CTA a market; at C > 1 a cluster CTA's
    share, ⌈A / (C·T)⌉·T."""
    A, T, C = int(num_agents), int(threads_per_market), int(ctas_per_market)
    return A if C == 1 else -(-A // (C * T)) * T


def team_smem_bytes(num_levels: int, num_agents: int, agents_in_smem: bool,
                    threads_per_market: int = 32,
                    ctas_per_market: int = 1) -> int:
    """One team's dynamic shared memory (``team_smem_words`` × 4): its
    bins (2·L words; two parity buffers, 4·L, on a market cluster) and,
    with ``agents_in_smem``, K = :func:`agent_slots` keys and K type
    bytes. ``threads_per_market`` matters only on a cluster."""
    C = int(ctas_per_market)
    words = (4 if C > 1 else 2) * num_levels
    if agents_in_smem:
        K = agent_slots(num_agents, threads_per_market, C)
        words += K + -(-K // 4)
    return 4 * words


def _check_domain(num_levels: int, num_agents: int) -> Tuple[int, int]:
    L, A = int(num_levels), int(num_agents)
    if L < 4 or L > 1024 or L & (L - 1):
        raise ValueError(f"num_levels must be a power of two in [4, 1024], "
                         f"got {num_levels}")
    if A < 1:
        raise ValueError(f"num_agents must be >= 1, got {num_agents}")
    return L, A


def check_shape(num_levels: int, num_agents: int, warps_per_market: int,
                markets_per_cta: int, agents: str, hoisted: bool,
                ctas_per_market: int = 1) -> int:
    """The C side's ``check_persistent_shape`` (``hoisted``) or
    ``check_shape``: the dynamic shared memory a CTA of this shape takes,
    or ``ValueError`` for a shape the kernels refuse. A per-step kernel
    (``hoisted=False``) keeps no agents, so it checks the shape in the
    fresh mode, as its C entry does, at four levels a lane. Either kind
    takes a cluster at one market a CTA (the registers mode holding
    ``REG_AGENTS`` agents a thread of it, four levels a lane); a
    persistent kernel in the registers mode at one CTA a market takes a
    team narrower than ``L / 128`` warps, up to ``MAX_LEVELS_PER_LANE``
    levels a lane."""
    L, A = _check_domain(num_levels, num_agents)
    W, mpc = int(warps_per_market), int(markets_per_cta)
    C = int(ctas_per_market)
    mode = agents if hoisted else "fresh"
    if agents not in AGENT_MODES:
        raise ValueError(f"agents must be one of {AGENT_MODES}, got "
                         f"{agents!r}")
    if W not in WARPS_PER_MARKET:
        raise ValueError(f"warps_per_market={W} is not one of "
                         f"{WARPS_PER_MARKET}")
    lpl = levels_per_lane(L, W)
    wide_ok = hoisted and mode == "registers" and C == 1
    if lpl > (MAX_LEVELS_PER_LANE if wide_ok else LEVELS_PER_LANE):
        raise ValueError(f"warps_per_market={W} cannot hold L={L} levels "
                         f"(128·W >= L, or up to {MAX_LEVELS_PER_LANE} "
                         f"levels a lane for a persistent kernel in the "
                         f"registers mode at one CTA a market)")
    if mpc < 1 or (W > 1 and mpc != 1) or \
            32 * W * mpc > MAX_CTA_THREADS:
        raise ValueError(f"markets_per_cta={mpc} at warps_per_market={W}: "
                         f"several markets a CTA only at one warp a market, "
                         f"at most {MAX_CTA_THREADS} threads")
    if C not in CTAS_PER_MARKET:
        raise ValueError(f"ctas_per_market must be one of "
                         f"{CTAS_PER_MARKET}, got {C}")
    if mode == "registers" and A > REG_AGENTS * 32 * W * C:
        raise ValueError(f"agents='registers' holds at most "
                         f"{REG_AGENTS * 32 * W * C} agents at W={W}, "
                         f"C={C}, got A={A}")
    if C > 1 and mpc != 1:
        raise ValueError(f"ctas_per_market={C}: a market spans a cluster "
                         f"only at one market a CTA")
    smem = mpc * team_smem_bytes(L, A, mode == "shared", 32 * W, C)
    if smem > MAX_DYNAMIC_SMEM:
        raise ValueError(f"launch shape needs {smem} bytes of shared memory "
                         f"over the limit of {MAX_DYNAMIC_SMEM}")
    return smem


def check_tile(tile: TileChoice, num_levels: int, num_agents: int,
               hoisted: bool) -> TileChoice:
    """``tile`` if it is a launch shape of ``(num_levels, num_agents)``
    the kernels take, else ``ValueError``."""
    if not isinstance(tile, TileChoice):
        raise TypeError(f"tile must be a TileChoice, got "
                        f"{type(tile).__name__}")
    if (tile.num_levels, tile.num_agents) != (num_levels, num_agents):
        raise ValueError(
            f"tile is for L={tile.num_levels}, A={tile.num_agents} but the "
            f"operands have L={num_levels}, A={num_agents}")
    check_shape(num_levels, num_agents, tile.warps_per_market,
                tile.markets_per_cta, tile.agents, hoisted,
                tile.ctas_per_market)
    return tile


def estimate_smem_bytes(tile: TileChoice, num_levels: int, num_agents: int,
                        hoisted: bool) -> int:
    """Dynamic shared memory a CTA of ``tile`` takes, bytes: the
    counterpart of ``repro``'s ``estimate_vmem_bytes``, exact here."""
    return check_tile(tile, num_levels, num_agents, hoisted).smem_bytes(
        hoisted)


#: Registers a thread of each persistent instance takes on the H100 (the
#: larger of the chunk and legacy kernels'), as ``ptxas`` reports them for
#: sm_90a (``chip_smoke.py``'s ``build`` line): (agent mode, on a
#: cluster) -> registers.
H100_REGISTERS = {("shared", False): 83, ("registers", False): 95,
                  ("fresh", False): 84, ("shared", True): 90,
                  ("registers", True): 144, ("fresh", True): 80}
#: Registers a thread of each persistent registers-mode instance of more
#: than four levels a lane takes on the H100 (one CTA a market): levels a
#: lane -> registers, no spills.
H100_WIDE_REGISTERS = {8: 106, 16: 146, 32: 255}
#: Registers a thread of each per-step instance takes on the H100 (the
#: larger of the chunk and legacy step kernels', ``build`` line): on a
#: cluster -> registers.
H100_STEP_REGISTERS = {False: 69, True: 64}
#: Clusters of C CTAs the H100 holds at once where an SM holds k of their
#: CTAs (``cudaOccupancyMaxActiveClusters``, read by
#: ``tools/kernel_times.py --holds`` and ``--matrix``): (C, k) ->
#: clusters. A cluster takes CTAs of one GPC, and the 132 SMs lie in GPCs
#: of unequal size, so this is not k·132/C.
H100_CLUSTERS = {
    (2, 1): 66, (2, 2): 132, (2, 3): 198, (2, 4): 264, (2, 6): 396,
    (2, 8): 528,
    (4, 1): 30, (4, 2): 62, (4, 3): 92, (4, 4): 124, (4, 5): 154,
    (4, 6): 186, (4, 8): 248,
    (8, 1): 15, (8, 2): 30, (8, 3): 45, (8, 4): 62, (8, 5): 77, (8, 6): 92,
    (8, 8): 124,
    (16, 1): 7, (16, 2): 14, (16, 3): 21, (16, 4): 28, (16, 5): 35,
    (16, 6): 42, (16, 8): 58}
#: An SM of the H100: four sub-partitions of 16K registers each (a warp
#: takes its registers in one), 228 KB of shared memory (1 KB of it
#: reserved a CTA), 2,048 threads and 32 CTAs, and no more than 8 CTAs of
#: clusters (read by ``--holds``: every cluster shape of more CTAs an SM
#: holds what 8 hold).
H100_SM = dict(partitions=4, partition_registers=16384, smem=233472,
               reserved=1024, threads=2048, ctas=32, cluster_ctas=8)
#: Static shared memory of a persistent CTA: ``TeamScratch``'s eight
#: arrays of ``MAX_TEAM_WARPS`` words.
STATIC_SMEM = 8 * 4 * MAX_TEAM_WARPS


def h100_holds(tile: TileChoice, hoisted: bool = True) -> int:
    """What an H100 holds of ``tile`` at once for the persistent kernels
    (for the per-step ones, ``hoisted=False``), as :func:`card_holds` reads
    it on the card: k CTAs an SM from each thread's registers
    (``H100_REGISTERS``, ``H100_WIDE_REGISTERS``,
    ``H100_STEP_REGISTERS``; 8 at a time, a warp's in
    one sub-partition), the CTA's shared memory (128 bytes at a time) and
    its threads; at C > 1 the clusters of ``H100_CLUSTERS`` (where the
    card was not asked at that k, those of the nearest k below it,
    scaled)."""
    sm = H100_SM
    cluster = tile.ctas_per_market > 1
    if not hoisted:
        regs = H100_STEP_REGISTERS[cluster]
    elif tile.levels_per_lane > LEVELS_PER_LANE:
        regs = H100_WIDE_REGISTERS[tile.levels_per_lane]
    else:
        regs = H100_REGISTERS[(tile.agents, cluster)]
    regs = -(-regs // 8) * 8
    warps = sm["partitions"] * (sm["partition_registers"] // (32 * regs))
    smem = -(-(tile.smem_bytes(hoisted) + STATIC_SMEM + sm["reserved"])
             // 128) * 128
    k = min(warps // (tile.threads_per_cta // 32), sm["smem"] // smem,
            sm["threads"] // tile.threads_per_cta, sm["ctas"])
    C = tile.ctas_per_market
    if C == 1 or k == 0:
        return k
    k = min(k, sm["cluster_ctas"])
    near = max(j for j in range(1, k + 1) if (C, j) in H100_CLUSTERS)
    return H100_CLUSTERS[(C, near)] * k // near


def card_holds(tile: TileChoice, hoisted: bool = True) -> int:
    """What the current card holds of ``tile`` at once, for both
    persistent kernels (the fewer; both per-step kernels with
    ``hoisted=False``): at C > 1 the clusters
    (``cudaOccupancyMaxActiveClusters``; 0: it cannot place one), else the
    CTAs an SM; in a process without a card, the H100's
    (:func:`h100_holds`). Cached per card, kernel kind and tile: the
    modes' shared memory and registers differ."""
    import torch

    if not torch.cuda.is_available():
        return h100_holds(tile, hoisted)
    key = (torch.cuda.current_device(), bool(hoisted), tile)
    if key not in _CARD_HOLDS:
        if hoisted:
            from repro_torch.kernels import kinetic_clearing as lib
        else:
            from repro_torch.kernels import naive_clearing as lib

        _CARD_HOLDS[key] = min(lib.resident_ctas(legacy, tile)
                               for legacy in (False, True))
    return _CARD_HOLDS[key]


def card_sms() -> int:
    """The current card's SMs; the H100's ``TARGET_SMS`` without one."""
    import torch

    if not torch.cuda.is_available():
        return TARGET_SMS
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count


def card_limits(num_levels: int, num_agents: int, warps_per_market: int,
                agents: str = "fresh", hoisted: bool = True
                ) -> Tuple[int, int]:
    """``(SMs, largest C)`` the rule counts on for a cluster of teams of
    ``warps_per_market`` warps in the agent mode ``agents`` of a
    persistent kernel (of a per-step one, ``hoisted=False``): the current
    card's SM count and the largest C of ``CTAS_PER_MARKET`` up to which
    the card holds a cluster at every C the mode admits
    (:func:`card_holds` >= 1); in a process without a card, the H100's
    (``TARGET_SMS``, and C as :func:`h100_holds` answers)."""
    L, A, W = int(num_levels), int(num_agents), int(warps_per_market)
    cap = 1
    for C in CTAS_PER_MARKET[1:]:
        shape = TileChoice(L, A, W, 1, agents, C)
        try:
            check_tile(shape, L, A, hoisted)
        except ValueError:
            continue                # not a shape of this mode
        if card_holds(shape, hoisted) < 1:
            break
        cap = C
    return card_sms(), cap


def waves(tile: TileChoice, num_markets: int, sms: int,
          holds: Callable[[TileChoice], int] = card_holds) -> float:
    """Waves in which the card runs ``tile``'s grid over ``num_markets``:
    the markets over the clusters it holds at once (``holds(tile)``) at
    C > 1, else the grid over the CTAs that ``holds(tile)`` CTAs an SM on
    ``sms`` SMs make; ``inf`` where it holds none."""
    held, M = holds(tile), int(num_markets)
    if held < 1:
        return math.inf
    if tile.ctas_per_market > 1:
        return float(-(-M // held))
    return float(-(-tile.grid(M) // (held * int(sms))))


def _fits(L: int, A: int, W: int, mode: str, C: int) -> bool:
    try:
        check_shape(L, A, W, 1, mode, True, C)
    except ValueError:
        return False
    return True


def auto_tile(num_levels: int, num_agents: int,
              num_markets: Optional[int] = None, *,
              sms: Optional[int] = None, max_ctas: Optional[int] = None,
              holds: Optional[Callable[[TileChoice], int]] = None,
              hoisted: bool = True) -> TileChoice:
    """The launch rule for ``num_levels`` (a power of two in [4, 1024]) and
    ``num_agents`` (>= 1); raises ``ValueError`` outside that domain.

    While a thread of ``max(1, L / 128)`` warps holds its agents in
    registers, that team, four a CTA at one warp, and C = 1; but a
    persistent kernel (``hoisted``) past L = 128 whose ``num_markets``
    that team runs in more than one wave (:func:`waves` over ``holds`` on
    ``sms`` SMs) takes the fewest warps whose registers hold the agents
    (four a CTA at one warp), each lane holding ``L / (32·W)`` levels: a
    narrow team's step is a longer serial pass, which more markets in
    flight repay once the wide team's grid no longer fits the card at
    once (on an H100 at A=32, L=1024: eight warps 0.19 ms and one warp
    0.24 ms a 64-step call at 264 markets, 0.36 and 0.24 at 528). Past
    that, the
    first mode one CTA holds, at one CTA a market of ``MAX_TEAM_WARPS``
    warps wherever shared memory holds fewer than ``MARKETS_PER_CTA``
    one-warp teams. Given ``num_markets`` whose grid leaves SMs idle, a
    market cluster of the smallest C whose M·C CTAs reach the SMs,
    counting ``sms`` SMs and at most ``max_ctas`` CTAs a cluster (default:
    :func:`card_limits` of the fresh mode). At that C, and at C = 1 for a
    team of ``MAX_TEAM_WARPS`` warps, the mode of ``RULE_MODES`` that fits
    a CTA and whose grid takes the fewest :func:`waves` (over ``holds``,
    default :func:`card_holds`), the first on a tie: a hoisted mode that
    takes more shared memory or registers than the card can give as many
    CTAs as the fresh mode's runs in more waves, slower than recomputing
    the keys in fewer.

    The per-step kernels' rule (``hoisted=False``) is the same up to the
    choice of C, its limit counted with their own residency (``max_ctas``
    defaults to :func:`card_limits` of the per-step kernels); they keep
    no agents and run fresh, so no mode is weighed (``holds`` is not
    read): on a cluster a team of ``MAX_TEAM_WARPS`` warps in the mode
    the rule gives without ``num_markets`` (which the kernels do not
    read), at C = 1 the one-CTA shape."""
    L, A = _check_domain(num_levels, num_agents)
    W = max(1, L // LEVELS_PER_WARP)
    if A <= REG_AGENTS * 32 * W:
        tile = TileChoice(L, A, W, MARKETS_PER_CTA if W == 1 else 1,
                          "registers")
        if hoisted and W > 1 and num_markets is not None and waves(
                tile, num_markets, card_sms() if sms is None else sms,
                card_holds if holds is None else holds) > 1:
            W = min(w for w in WARPS_PER_MARKET if A <= REG_AGENTS * 32 * w)
            tile = TileChoice(L, A, W, MARKETS_PER_CTA if W == 1 else 1,
                              "registers")
        return tile
    per_market = team_smem_bytes(L, A, True)
    agents = "shared" if per_market <= MAX_DYNAMIC_SMEM else "fresh"
    # A thread of a one-warp team past the registers mode handles more
    # than REG_AGENTS agents a step; where a CTA holds fewer than four
    # such teams an SM runs one or two warps, and the widest team hashes
    # MAX_TEAM_WARPS times as fast.
    if agents == "fresh" or MARKETS_PER_CTA * per_market > MAX_DYNAMIC_SMEM:
        W = MAX_TEAM_WARPS
    tile = TileChoice(L, A, W, MARKETS_PER_CTA if W == 1 else 1, agents)
    if num_markets is None:
        return tile
    M = int(num_markets)
    sms = card_sms() if sms is None else int(sms)
    if max_ctas is None:
        max_ctas = card_limits(L, A, MAX_TEAM_WARPS, "fresh", hoisted)[1]
    C = 1
    if tile.grid(M) < sms:
        for C in (c for c in CTAS_PER_MARKET[1:] if c <= max_ctas):
            if M * C >= sms:
                break
    if C == 1 and (W != MAX_TEAM_WARPS or not hoisted):
        return tile
    if not hoisted:
        return TileChoice(L, A, MAX_TEAM_WARPS, 1, tile.agents, C)
    holds = card_holds if holds is None else holds
    cands = [TileChoice(L, A, MAX_TEAM_WARPS, 1, mode, C)
             for mode in RULE_MODES if _fits(L, A, MAX_TEAM_WARPS, mode, C)]
    return min(cands, key=lambda t: waves(t, M, sms, holds))


def candidate_tiles(num_levels: int, num_agents: int,
                    num_markets: Optional[int] = None, *, hoisted: bool,
                    agents=..., max_ctas: Optional[int] = None
                    ) -> List[TileChoice]:
    """Every launch shape :func:`check_shape` accepts for ``(L, A)`` at one
    CTA a market, the rule's (for ``num_markets``) first, then by warps a
    market, markets a CTA and agent mode; then, where the rule takes a
    market cluster (without ``num_markets``: where it may, past the
    registers mode), each team size and agent mode on a cluster of every
    C > 1 of ``CTAS_PER_MARKET`` up to ``max_ctas`` (default:
    :func:`card_limits`) that the mode admits.

    A persistent kernel (``hoisted``) sweeps the agent modes valid for
    ``(L, A)``; a per-step kernel keeps none, so only ``(W, MPC, C)`` is
    swept and each candidate carries the rule's mode. An explicit
    ``agents`` pins the mode: a caller's choice is never swept away (the
    counterpart of a pinned ``agent_chunk``).
    """
    rule = auto_tile(num_levels, num_agents, num_markets, max_ctas=max_ctas,
                     hoisted=hoisted)
    L, A = rule.num_levels, rule.num_agents
    clusters = (rule.ctas_per_market > 1 if num_markets is not None
                else rule.agents != "registers")
    if agents is not ...:
        if agents not in AGENT_MODES:
            raise ValueError(f"agents must be one of {AGENT_MODES}, got "
                             f"{agents!r}")
        if agents != rule.agents:   # one CTA a market, in that mode
            rule = auto_tile(L, A)._replace(agents=agents)
        modes = (agents,)
    else:
        modes = AGENT_MODES if hoisted else (rule.agents,)
    out = []
    try:
        check_tile(rule, L, A, hoisted)
        out.append(rule)
    except ValueError:
        pass               # a pinned mode the rule's shape cannot hold
    shapes = [(W, mpc, mode, 1) for W in WARPS_PER_MARKET
              for mpc in MARKETS_PER_CTA_CHOICES for mode in modes]
    if clusters:
        for W in WARPS_PER_MARKET:
            if W * LEVELS_PER_WARP < L:
                continue
            for mode in modes:
                cap = card_limits(L, A, W, mode, hoisted)[1] \
                    if max_ctas is None else max_ctas
                shapes += [(W, 1, mode, C) for C in CTAS_PER_MARKET[1:]
                           if C <= cap]
    for W, mpc, mode, C in shapes:
        cand = TileChoice(L, A, W, mpc, mode, C)
        if cand in out:
            continue
        try:
            check_shape(L, A, W, mpc, mode, hoisted, C)
        except ValueError:
            continue
        out.append(cand)
    return out


def device_kind(device=None) -> str:
    """The card's name (``torch.cuda.get_device_name``) for a CUDA device,
    ``"cpu"`` for the host; ``None`` is the first card if there is one."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def tune_key(num_levels: int, num_agents: int, chunk: int, *, device=None,
             **context) -> Tuple:
    """Winner cache key: (device kind, L, A, chunk) plus any ``context``
    that changes what is timed (kernel, scan, ``stats_only``, a pinned
    ``agents``, the rule's ``ctas_per_market``): distinct kernel
    configurations never share a winner. The number of markets enters
    through the rule's C, which depends on it past the registers mode
    (the runner passes it): markets the rule gives one C share a winner,
    and shapes that differ in C do not."""
    return ((device_kind(device), int(num_levels), int(num_agents),
             int(chunk)) + tuple(sorted(context.items())))


def autotune_tile(key: Tuple, time_candidate: Callable[[TileChoice], float],
                  cands: List[TileChoice],
                  fallback: Optional[TileChoice] = None) -> TileChoice:
    """Time each candidate once, cache the winner under ``key``.

    ``time_candidate`` runs one representative chunk call of a candidate
    and returns its time; an exception disqualifies the candidate (a shape
    the card refuses, an out-of-memory) and is recorded. Only if every
    candidate fails is ``fallback`` (the caller's rule tile; default the
    first candidate) cached, with ``fell_back=True`` in the report. A
    cache hit sweeps nothing.
    """
    return sweep_tile(key, time_candidate, cands, fallback)[0]


def sweep_tile(key: Tuple, time_candidate: Callable[[TileChoice], float],
               cands: List[TileChoice],
               fallback: Optional[TileChoice] = None,
               ) -> Tuple[TileChoice, Optional[SweepReport]]:
    """:func:`autotune_tile`, with the report of the sweep it ran (None on
    a cache hit), under the span ``open.runner.autotune``."""
    cached = _TUNE_CACHE.get(key)
    if cached is not None:
        return cached, None
    with trace.span("open.runner.autotune", candidates=len(cands)) as sp:
        t0 = time.perf_counter()
        best, best_t = None, float("inf")
        failures, times = [], []
        for cand in cands:
            try:
                t = time_candidate(cand)
            except Exception as exc:  # a refused or OOM shape disqualifies
                failures.append(f"{cand!r}: {type(exc).__name__}: {exc}")
                continue
            times.append((cand, t))
            if t < best_t:
                best, best_t = cand, t
        fell_back = best is None
        if fell_back:
            best = fallback if fallback is not None else cands[0]
        report = SweepReport(
            key=key, winner=best, fell_back=fell_back, tried=tuple(cands),
            failures=tuple(failures), times=tuple(times),
            seconds=time.perf_counter() - t0)
        sp.set(pick=repr(best), seconds=report.seconds)
    _TUNE_CACHE[key] = best
    _SWEEP_REPORTS.append(report)
    return best, report


def time_call(fn: Callable[[], object],
              block: Callable[[object], Optional[float]],
              trials: int = TRIALS) -> float:
    """Best-of-``trials`` time of ``fn`` after one warm-up call, seconds.

    ``block`` waits for a result. If it returns a time (a card's device
    time between two CUDA events the call recorded), that is the call's
    time; if it returns None, the wall around the call and the wait is."""
    block(fn())
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        took = block(fn())
        wall = time.perf_counter() - t0
        best = min(best, wall if took is None else took)
    return best


def is_oom_error(exc: BaseException) -> bool:
    """Heuristic: does this exception look like a device or on-chip memory
    exhaustion?"""
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(m in text for m in _OOM_MARKERS)


def sweep_reports() -> Tuple[SweepReport, ...]:
    return tuple(_SWEEP_REPORTS)


def last_sweep_report() -> Optional[SweepReport]:
    return _SWEEP_REPORTS[-1] if _SWEEP_REPORTS else None


def clear_tune_cache() -> None:
    _TUNE_CACHE.clear()
    _SWEEP_REPORTS.clear()


def resolve_tile(tile: Optional[TileChoice], num_levels: int,
                 num_agents: int, hoisted: bool,
                 num_markets: Optional[int] = None) -> TileChoice:
    """The shape a wrapper launches: ``tile`` checked against the operands,
    or the rule's when ``None`` (for ``num_markets``, which may then take a
    cluster; one CTA a market without it)."""
    if tile is None:
        return auto_tile(num_levels, num_agents, num_markets,
                         hoisted=hoisted)
    return check_tile(tile, num_levels, num_agents, hoisted)
