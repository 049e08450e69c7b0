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
    agents (``agents="registers"``), else in the team's shared memory
    after its bins (``"shared"``). A market whose keys and type bytes (5
    bytes an agent) do not fit one CTA's shared memory beside the 8·L
    bytes of bins, past 46,080 agents at L=128 (44,646 at L=1024), has
    them recomputed at every step (``"fresh"``), as the per-step kernels
    always do: its books still stay on chip for the chunk. So the rule
    takes any population, as the JAX package's agent chunking does.

The rule raises only outside its domain. There is no sweep, no environment
variable and no fallback: the wrapper passes the shape to the C entry,
which checks it again. The constants repeat ``kinetic_step.cuh``.
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
#: Where a persistent kernel keeps the agents' keys and types, in the order
#: of the C side's ``AgentMode`` codes (``kinetic_step.cuh``).
AGENT_MODES = ("shared", "registers", "fresh")


class TileChoice(NamedTuple):
    """A resolved launch shape for ``num_levels`` and ``num_agents``."""

    num_levels: int
    num_agents: int
    warps_per_market: int
    markets_per_cta: int
    agents: str    # persistent kernels: one of AGENT_MODES

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
        for a persistent kernel (``hoisted``) in the ``"shared"`` mode, A
        keys and A type bytes."""
        return self.markets_per_cta * team_smem_bytes(
            self.num_levels, self.num_agents,
            hoisted and self.agents == "shared")

    def as_c_args(self) -> Tuple[int, int, int]:
        """``(warps_per_market, markets_per_cta, agent mode code)``."""
        return (self.warps_per_market, self.markets_per_cta,
                AGENT_MODES.index(self.agents))


def team_smem_bytes(num_levels: int, num_agents: int,
                    agents_in_smem: bool) -> int:
    """One team's dynamic shared memory (``team_smem_words`` × 4)."""
    words = 2 * num_levels
    if agents_in_smem:
        words += num_agents + -(-num_agents // 4)
    return 4 * words


def auto_tile(num_levels: int, num_agents: int) -> TileChoice:
    """The launch shape for ``num_levels`` (a power of two in [4, 1024]) and
    ``num_agents`` (>= 1); raises ``ValueError`` outside that domain."""
    L, A = int(num_levels), int(num_agents)
    if L < 4 or L > 1024 or L & (L - 1):
        raise ValueError(f"num_levels must be a power of two in [4, 1024], "
                         f"got {num_levels}")
    if A < 1:
        raise ValueError(f"num_agents must be >= 1, got {num_agents}")
    W = max(1, L // LEVELS_PER_WARP)
    if A <= REG_AGENTS * 32 * W:
        agents = "registers"
    elif team_smem_bytes(L, A, True) <= MAX_DYNAMIC_SMEM:
        agents = "shared"
    else:
        agents = "fresh"
    per_market = team_smem_bytes(L, A, agents == "shared")
    mpc = MARKETS_PER_CTA if W == 1 else 1
    while mpc > 1 and mpc * per_market > MAX_DYNAMIC_SMEM:
        mpc //= 2
    return TileChoice(L, A, W, mpc, agents)
