"""Launch shapes of the port's clearing kernels: the fixed rule and the
timed sweep.

It is the counterpart of ``repro.kernels.autotune`` (``TileChoice``,
``auto_tile``, ``candidate_tiles``, ``autotune_tile``) for Hopper, where the
unit is a *market team* and not a sublane tile (``csrc/kinetic_step.cuh``):

  * a team of ``warps_per_market`` warps clears one market; thread ``t``
    owns the ``LEVELS_PER_LANE`` contiguous levels ``[4t, 4t + 4)`` and
    holds them in registers, so a market needs ``L / 128`` warps at least;
  * one CTA holds ``markets_per_cta`` teams: several one-warp teams, or one
    several-warp team (whose barrier is then ``__syncthreads()``); a
    ragged last CTA is masked in the kernel;
  * agent ``a`` is handled by thread ``a mod T``. The persistent kernels
    compute each agent's step-invariant hash round and type once per call
    and keep them in registers while a thread has at most ``REG_AGENTS``
    agents (``agents="registers"``), else in the team's shared memory
    after its bins (``"shared"``). A market whose keys and type bytes (5
    bytes an agent) do not fit one CTA's shared memory beside the 8·L
    bytes of bins, past 46,080 agents at L=128 (44,646 at L=1024), has
    them recomputed at every step (``"fresh"``), as the per-step kernels
    always do: its books still stay on chip for the chunk. So the rule
    takes any population, as the JAX package's agent chunking does;
  * in the fresh mode a persistent kernel may spread one market over a
    thread-block cluster of ``ctas_per_market`` = C CTAs (C in
    ``CTAS_PER_MARKET``, one team a CTA): CTA rank ``r`` hashes the agents
    ``a ≡ r·T + t (mod C·T)`` into its own bins, and the C CTAs sum their
    bins through distributed shared memory, each clearing its own copy of
    the book. A few markets of a large population then fill the card's
    SMs, where one CTA a market would leave most of them idle.

:func:`auto_tile` is the rule: ``W = max(1, L / 128)``, four one-warp
teams a CTA, and the first agent mode that fits; in the fresh mode a team
of ``MAX_TEAM_WARPS`` warps, one a CTA, and, given the number of markets,
the smallest C whose grid reaches the card's SMs (:func:`cluster_ctas`).
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

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

LEVELS_PER_LANE = 4
LEVELS_PER_WARP = 32 * LEVELS_PER_LANE
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
#: CTAs a market may take as a thread-block cluster (the fresh mode of the
#: persistent kernels only); past the portable 8 a cluster is non-portable,
#: and Hopper's limit is 16.
CTAS_PER_MARKET = (1, 2, 4, 8, 16)
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
#: :func:`card_limits` per (card, L, A, W).
_CARD_LIMITS: Dict[Tuple, Tuple[int, int]] = {}

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
    ctas_per_market: int = 1   # > 1: a market's cluster (fresh mode only)

    @property
    def threads_per_market(self) -> int:
        return 32 * self.warps_per_market

    @property
    def threads_per_cta(self) -> int:
        return self.threads_per_market * self.markets_per_cta

    def grid(self, num_markets: int) -> int:
        """CTAs for ``num_markets``: the last may be ragged, and a
        market's cluster is ``ctas_per_market`` CTAs side by side."""
        return -(-num_markets // self.markets_per_cta) * self.ctas_per_market

    def smem_bytes(self, hoisted: bool) -> int:
        """Dynamic shared memory per CTA: each team's int bins (2·L, two
        such buffers in a cluster) and, for a persistent kernel
        (``hoisted``) in the ``"shared"`` mode, A keys and A type bytes."""
        return self.markets_per_cta * team_smem_bytes(
            self.num_levels, self.num_agents,
            hoisted and self.agents == "shared") * (
                2 if self.ctas_per_market > 1 else 1)

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


def team_smem_bytes(num_levels: int, num_agents: int,
                    agents_in_smem: bool) -> int:
    """One team's dynamic shared memory (``team_smem_words`` × 4)."""
    words = 2 * num_levels
    if agents_in_smem:
        words += num_agents + -(-num_agents // 4)
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
    """The C side's ``check_shape``: the dynamic shared memory a CTA of
    this shape takes, or ``ValueError`` for a shape the kernels refuse. A
    per-step kernel (``hoisted=False``) keeps no agents, so it checks the
    shape in the fresh mode, as its C entry does; it runs one CTA a
    market, so only a persistent kernel takes a cluster."""
    L, A = _check_domain(num_levels, num_agents)
    W, mpc = int(warps_per_market), int(markets_per_cta)
    C = int(ctas_per_market)
    mode = agents if hoisted else "fresh"
    if agents not in AGENT_MODES:
        raise ValueError(f"agents must be one of {AGENT_MODES}, got "
                         f"{agents!r}")
    if W not in WARPS_PER_MARKET or W * LEVELS_PER_WARP < L:
        raise ValueError(f"warps_per_market={W} cannot hold L={L} levels "
                         f"(one of {WARPS_PER_MARKET} with 128·W >= L)")
    if mpc < 1 or (W > 1 and mpc != 1) or \
            32 * W * mpc > MAX_CTA_THREADS:
        raise ValueError(f"markets_per_cta={mpc} at warps_per_market={W}: "
                         f"several markets a CTA only at one warp a market, "
                         f"at most {MAX_CTA_THREADS} threads")
    if mode == "registers" and A > REG_AGENTS * 32 * W:
        raise ValueError(f"agents='registers' holds at most "
                         f"{REG_AGENTS * 32 * W} agents at W={W}, got A={A}")
    if C not in CTAS_PER_MARKET:
        raise ValueError(f"ctas_per_market must be one of "
                         f"{CTAS_PER_MARKET}, got {C}")
    if C > 1 and not (hoisted and mode == "fresh" and mpc == 1):
        raise ValueError(f"ctas_per_market={C}: a market spans a cluster "
                         f"only in a persistent kernel's fresh mode, at "
                         f"one market a CTA")
    smem = mpc * team_smem_bytes(L, A, mode == "shared") * (2 if C > 1 else 1)
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


def card_limits(num_levels: int, num_agents: int,
                warps_per_market: int) -> Tuple[int, int]:
    """``(SMs, largest C)`` the rule counts on for a fresh team of
    ``warps_per_market`` warps: the current card's SM count and the largest
    C of ``CTAS_PER_MARKET`` at which it holds a cluster of both persistent
    kernels (``cudaOccupancyMaxActiveClusters`` >= 1); in a process without
    a card, the H100's (``TARGET_SMS``, 16). Cached per card and shape."""
    import torch

    if not torch.cuda.is_available():
        return TARGET_SMS, CTAS_PER_MARKET[-1]
    card = torch.cuda.current_device()
    key = (card, int(num_levels), int(num_agents), int(warps_per_market))
    if key not in _CARD_LIMITS:
        from repro_torch.kernels import kinetic_clearing as kc

        cap = 1
        for C in CTAS_PER_MARKET[1:]:
            shape = TileChoice(key[1], key[2], key[3], 1, "fresh", C)
            if min(kc.resident_ctas(legacy, shape)
                   for legacy in (False, True)) < 1:
                break
            cap = C
        _CARD_LIMITS[key] = (
            torch.cuda.get_device_properties(card).multi_processor_count, cap)
    return _CARD_LIMITS[key]


def cluster_ctas(tile: TileChoice, num_markets: int, sms: int,
                 max_ctas: int) -> int:
    """The rule's C for a fresh ``tile`` (one CTA a market) over
    ``num_markets``: the smallest C of ``CTAS_PER_MARKET`` up to
    ``max_ctas`` whose grid reaches ``sms`` SMs (C = 1 at the tile's own
    markets a CTA, C > 1 at one), else the largest admitted."""
    best = 1
    for C in CTAS_PER_MARKET:
        if C > max_ctas:
            break
        best = C
        grid = tile.grid(num_markets) if C == 1 else num_markets * C
        if grid >= sms:
            break
    return best


def auto_tile(num_levels: int, num_agents: int,
              num_markets: Optional[int] = None, *,
              sms: Optional[int] = None,
              max_ctas: Optional[int] = None) -> TileChoice:
    """The launch rule for ``num_levels`` (a power of two in [4, 1024]) and
    ``num_agents`` (>= 1); raises ``ValueError`` outside that domain.

    In the fresh mode, given ``num_markets``, a market spans a cluster of
    :func:`cluster_ctas` CTAs (one team a CTA), counting ``sms`` SMs and at
    most ``max_ctas`` CTAs a cluster (default: :func:`card_limits`). Without
    ``num_markets``, and in every other mode, C = 1."""
    L, A = _check_domain(num_levels, num_agents)
    W = max(1, L // LEVELS_PER_WARP)
    if A <= REG_AGENTS * 32 * W:
        agents = "registers"
    elif team_smem_bytes(L, A, True) <= MAX_DYNAMIC_SMEM:
        agents = "shared"
    else:
        agents = "fresh"
        # A fresh market hashes its A > 44,646 agents at every step: the
        # widest team hashes them MAX_TEAM_WARPS times as fast as one warp.
        W = MAX_TEAM_WARPS
    per_market = team_smem_bytes(L, A, agents == "shared")
    mpc = MARKETS_PER_CTA if W == 1 else 1
    while mpc > 1 and mpc * per_market > MAX_DYNAMIC_SMEM:
        mpc //= 2
    tile = TileChoice(L, A, W, mpc, agents)
    if agents != "fresh" or num_markets is None:
        return tile
    if sms is None or max_ctas is None:
        card_sms, card_cap = card_limits(L, A, W)
        sms = card_sms if sms is None else sms
        max_ctas = card_cap if max_ctas is None else max_ctas
    C = cluster_ctas(tile, int(num_markets), int(sms), int(max_ctas))
    return tile if C == 1 else tile._replace(markets_per_cta=1,
                                             ctas_per_market=C)


def candidate_tiles(num_levels: int, num_agents: int,
                    num_markets: Optional[int] = None, *, hoisted: bool,
                    agents=..., max_ctas: Optional[int] = None
                    ) -> List[TileChoice]:
    """Every launch shape :func:`check_shape` accepts for ``(L, A)`` at one
    CTA a market, the rule's (for ``num_markets``) first, then by warps a
    market, markets a CTA and agent mode; then, where the population is
    past shared memory (the rule's mode is fresh) and the kernel is
    persistent, each fresh team size on a cluster of every C > 1 of
    ``CTAS_PER_MARKET`` up to ``max_ctas`` (default: :func:`card_limits`).

    A persistent kernel (``hoisted``) sweeps the agent modes valid for
    ``(L, A)``; a per-step kernel keeps none, so only ``(W, MPC)`` is swept
    and each candidate carries the rule's mode. An explicit ``agents``
    pins the mode: a caller's choice is never swept away (the counterpart
    of a pinned ``agent_chunk``).
    """
    rule = auto_tile(num_levels, num_agents,
                     num_markets if hoisted else None, max_ctas=max_ctas)
    L, A = rule.num_levels, rule.num_agents
    clusters = hoisted and rule.agents == "fresh"
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
    if clusters and "fresh" in modes:
        for W in WARPS_PER_MARKET:
            if W * LEVELS_PER_WARP < L:
                continue
            cap = card_limits(L, A, W)[1] if max_ctas is None else max_ctas
            shapes += [(W, 1, "fresh", C) for C in CTAS_PER_MARKET[1:]
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
    through the rule's C, which depends on it in the fresh mode (the
    runner passes it): markets the rule gives one C share a winner, and
    shapes that differ in C do not."""
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
    cached = _TUNE_CACHE.get(key)
    if cached is not None:
        return cached
    best, best_t = None, float("inf")
    failures, times = [], []
    for cand in cands:
        try:
            t = time_candidate(cand)
        except Exception as exc:  # a refused or OOM shape disqualifies itself
            failures.append(f"{cand!r}: {type(exc).__name__}: {exc}")
            continue
        times.append((cand, t))
        if t < best_t:
            best, best_t = cand, t
    fell_back = best is None
    if fell_back:
        best = fallback if fallback is not None else cands[0]
    _TUNE_CACHE[key] = best
    _SWEEP_REPORTS.append(SweepReport(
        key=key, winner=best, fell_back=fell_back, tried=tuple(cands),
        failures=tuple(failures), times=tuple(times)))
    return best


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
    or the rule's when ``None`` (for ``num_markets`` in a persistent
    kernel, which may then take a cluster; one CTA a market otherwise)."""
    if tile is None:
        return auto_tile(num_levels, num_agents,
                         num_markets if hoisted else None)
    return check_tile(tile, num_levels, num_agents, hoisted)
