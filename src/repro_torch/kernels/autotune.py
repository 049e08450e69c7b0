"""The launch rule of the port's clearing kernels: one fixed map from
``(num_levels, num_agents)`` to the CUDA launch shape.

It is the counterpart of ``repro.kernels.autotune`` (``TileChoice``,
``auto_tile``) for Hopper, where the unit is a *market team* and not a
sublane tile (``csrc/kinetic_step.cuh``):

  * a team of ``warps_per_market`` warps clears one market; thread ``t``
    owns the ``LEVELS_PER_LANE`` contiguous levels ``[4t, 4t + 4)`` and
    holds them in registers, so a market is one warp up to L=128 and
    ``L / 128`` warps beyond;
  * one CTA holds ``markets_per_cta`` teams: four one-warp teams, or one
    several-warp team (whose barrier is then ``__syncthreads()``); a
    ragged last CTA is masked in the kernel;
  * agent ``a`` is handled by thread ``a mod T``. The persistent kernels
    compute each agent's step-invariant hash round and type once per call
    and keep them in registers while a thread has at most ``REG_AGENTS``
    agents, else in the team's shared memory after its bins.

The rule raises on a shape it cannot take. There is no sweep, no
environment variable and no fallback: the wrapper passes the shape to the
C entry, which checks it again. The constants repeat ``kinetic_step.cuh``.

This is a limit of the port: one market's keys and type bytes must fit a
CTA's shared memory, 5 bytes an agent beside the 8·L bytes of bins, so
``auto_tile`` raises past 46,080 agents a market at L=128 (44,646 at
L=1024), where the JAX package's agent chunking takes any population.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

LEVELS_PER_LANE = 4
LEVELS_PER_WARP = 32 * LEVELS_PER_LANE
#: Agent slots a thread of a persistent kernel holds in registers.
REG_AGENTS = 8
#: Teams per CTA when a market is one warp.
MARKETS_PER_CTA = 4
MAX_CTA_THREADS = 256
#: Dynamic shared memory a CTA may take: the 227 KB a block can use on
#: Hopper, less 1 KB for the static reduction scratch.
MAX_DYNAMIC_SMEM = 232448 - 1024


class TileChoice(NamedTuple):
    """A resolved launch shape for ``num_levels`` and ``num_agents``."""

    num_levels: int
    num_agents: int
    warps_per_market: int
    markets_per_cta: int
    agents_in_registers: bool    # persistent kernels: else shared memory

    @property
    def threads_per_market(self) -> int:
        return 32 * self.warps_per_market

    @property
    def threads_per_cta(self) -> int:
        return self.threads_per_market * self.markets_per_cta

    def grid(self, num_markets: int) -> int:
        """CTAs for ``num_markets``; the last may be ragged."""
        return -(-num_markets // self.markets_per_cta)

    def smem_bytes(self, hoisted: bool) -> int:
        """Dynamic shared memory per CTA: each team's int bins (2·L) and,
        for a persistent kernel (``hoisted``) whose agents do not fit in
        registers, A keys and A type bytes."""
        return self.markets_per_cta * team_smem_bytes(
            self.num_levels, self.num_agents,
            hoisted and not self.agents_in_registers)

    def as_c_args(self) -> Tuple[int, int, int]:
        """``(warps_per_market, markets_per_cta, agents_in_registers)``."""
        return (self.warps_per_market, self.markets_per_cta,
                int(self.agents_in_registers))


def team_smem_bytes(num_levels: int, num_agents: int,
                    agents_in_smem: bool) -> int:
    """One team's dynamic shared memory (``team_smem_words`` × 4)."""
    words = 2 * num_levels
    if agents_in_smem:
        words += num_agents + -(-num_agents // 4)
    return 4 * words


def auto_tile(num_levels: int, num_agents: int) -> TileChoice:
    """The launch shape for ``num_levels`` (a power of two in [4, 1024]) and
    ``num_agents`` (>= 1); raises ``ValueError`` outside that domain or
    when one market's shared memory does not fit a CTA."""
    L, A = int(num_levels), int(num_agents)
    if L < 4 or L > 1024 or L & (L - 1):
        raise ValueError(f"num_levels must be a power of two in [4, 1024], "
                         f"got {num_levels}")
    if A < 1:
        raise ValueError(f"num_agents must be >= 1, got {num_agents}")
    W = max(1, L // LEVELS_PER_WARP)
    in_regs = A <= REG_AGENTS * 32 * W
    per_market = team_smem_bytes(L, A, not in_regs)
    mpc = MARKETS_PER_CTA if W == 1 else 1
    while mpc > 1 and mpc * per_market > MAX_DYNAMIC_SMEM:
        mpc //= 2
    if per_market > MAX_DYNAMIC_SMEM:
        raise ValueError(
            f"one market at L={L}, A={A} needs {per_market} bytes of shared "
            f"memory, more than the {MAX_DYNAMIC_SMEM} a CTA can take")
    return TileChoice(L, A, W, mpc, in_regs)
