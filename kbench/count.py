"""The work one ensemble needs, counted from the simulator's semantics.

The yardstick of the kernel's roofline share. It counts the elementary
operations (an add, a multiply, a compare, a select, a shift, a logic op,
a conversion: one each) that the semantics needs for given inputs, as the
plain reference (``kbench/reference/market.py``) spells them, with each
value counted once where its inputs allow: the hash rounds of (seed, agent)
once an ensemble, of the step once an agent-step, and one round per
uniform draw that reaches an output. It is a function of the shapes and
the archetype mix alone, and does not follow any kernel's instructions, so
a rewrite of the kernel leaves it as it is.

Peaks: NVIDIA H100 SXM5 80 GB data sheet (dense, at the 700 W limit):
67 TFLOP/s in FP32 outside the tensor cores, which counts a fused
multiply-add as two operations, and 3.35 TB/s of HBM3. An instruction does
at most two of the operations counted here (a fused multiply-add, an
integer multiply-add, a three-input logic op), so no kernel can beat the
least time this gives.
"""
from __future__ import annotations

from typing import Dict, Mapping

PEAK_OPS_PER_S = 67e12
PEAK_BYTES_PER_S = 3.35e12
PEAK_SOURCE = ("NVIDIA H100 SXM5 80GB data sheet: 67 TFLOP/s FP32 "
               "(non-tensor), 3.35 TB/s HBM3")

NOISE, MOMENTUM, MAKER, FUNDAMENTALIST = 0, 1, 2, 3
WHALE, HFT, INFORMED, ARBITRAGEUR = 4, 5, 6, 7

#: One hash round: the add and lowbias32's 3 shifts, 3 xors, 2 multiplies.
ROUND = 9
#: One uniform draw: its channel's round, then >> 8, the conversion and
#: the 2^-24 scaling.
DRAW = ROUND + 3
#: Once an agent an ensemble: its global id (multiply, add), the (seed,
#: gid) round with the id's multiply, and its type from the seven block
#: bounds (two compares, a select each).
AGENT_ONCE = 2 + ROUND + 1 + 7 * 3
#: Once an agent-step: the step's round.
AGENT_STEP = ROUND
#: Draws whose value reaches an output, by archetype. A momentum,
#: fundamentalist or arbitrageur agent reads its side coin only where its
#: signal is zero, an HFT only below its trigger, and any agent the shock
#: channel only at its market's shock step: none of these is counted.
DRAWS = {NOISE: 4, MOMENTUM: 2, MAKER: 1, FUNDAMENTALIST: 3, WHALE: 1,
         HFT: 2, INFORMED: 4, ARBITRAGEUR: 3}
#: The archetype's own side and price arithmetic, an agent-step.
DECIDE = {NOISE: 5, MOMENTUM: 3, MAKER: 5, FUNDAMENTALIST: 5, WHALE: 2,
          HFT: 3, INFORMED: 6, ARBITRAGEUR: 5}
#: Every agent-step besides: the select of its archetype, the rounding to
#: a tick (round, two clamps, a conversion), the quantity (multiply,
#: floor, add), and the binning (the address's multiply and add, the
#: side's select, the add into the bin).
COMMON = 1 + 4 + 3 + 4
#: A non-maker's marketable overlay: the compare and the two selects.
MARKETABLE = 3
#: One level at one step: best quotes (a compare, select and max or min a
#: side), the two resting sums, the incoming flow joined (2), one add of
#: each cumulative scan (2), the match's min, the argmax's compare and
#: select, each side's allocation (two subtracts, a max and a min) and
#: residual (a subtract).
LEVEL_STEP = 6 + 2 + 2 + 2 + 1 + 2 + 2 * 5
#: One market at one step: the mid (add, conversion, multiply, the test
#: and its select), the imbalance (add, subtract, divide, compare, two
#: selects), the new last price (compare, conversion, select), the
#: momentum signal (subtract, sign) and the volume's gather.
MARKET_STEP = 5 + 6 + 3 + 2 + 1
#: A market-step of the ``stats_only`` accumulators: the count, the mid's
#: sum, square and sum of squares, min, max, and the volume's sum.
STATS_STEP = 7


def agent_step_ops(kind: int) -> int:
    marketable = 0 if kind == MAKER else MARKETABLE
    return AGENT_STEP + DRAWS[kind] * DRAW + DECIDE[kind] + COMMON \
        + marketable


def ensemble_ops(num_markets: int, num_agents: int, num_levels: int,
                 num_steps: int, mix: Mapping[int, int],
                 stats_only: bool = False) -> int:
    """Operations one ensemble of ``num_steps`` steps needs. ``mix`` gives
    the agents of each archetype over all its markets."""
    if sum(mix.values()) != num_markets * num_agents:
        raise ValueError("mix must count num_markets * num_agents agents")
    per_step = sum(n * agent_step_ops(k) for k, n in mix.items()) \
        + num_markets * (num_levels * LEVEL_STEP + MARKET_STEP
                         + (STATS_STEP if stats_only else 0))
    return num_steps * per_step + num_markets * num_agents * AGENT_ONCE


def call_bytes(num_markets: int, num_levels: int, steps: int, *,
               stats_only: bool, params: int = 22) -> int:
    """Bytes one chunk call must move: each input read once and each
    output written once (books and the two scalar columns in and out, the
    ids and peer column, the params, and the paths or the accumulators)."""
    M, L = num_markets, num_levels
    books = 2 * 2 * M * L * 4
    scalars = 2 * 2 * M * 4 + 2 * M * 4
    out = 2 * 6 * M * 4 if stats_only else 3 * M * steps * 4
    return books + scalars + M * params * 4 + out


def ensemble_bytes(num_markets: int, num_levels: int, num_steps: int,
                   chunk: int, stats_only: bool = False) -> int:
    """:func:`call_bytes` over the calls of one ensemble."""
    total, left = 0, num_steps
    while left > 0:
        n = min(chunk, left)
        total += call_bytes(num_markets, num_levels, n,
                            stats_only=stats_only)
        left -= n
    return total


def least_seconds(ops: float, nbytes: float) -> float:
    """The roofline's least time: the larger of the two bounds."""
    return max(ops / PEAK_OPS_PER_S, nbytes / PEAK_BYTES_PER_S)


def mix_of(counts: Dict[int, int], num_markets: int,
           num_agents: int) -> Dict[int, int]:
    """A homogeneous ensemble's mix from one market's non-noise counts."""
    mix = {k: n * num_markets for k, n in counts.items()}
    mix[NOISE] = num_markets * num_agents - sum(mix.values())
    return mix
