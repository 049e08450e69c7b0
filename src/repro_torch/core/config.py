"""Configuration for the KineticSim market engine (PyTorch port).

The port's own copy of the scalar configuration surface: the archetype and
RNG-channel constants, :class:`MarketConfig` with its validation, the
deterministic agent-type assignment rule, the opening-book seeding rule,
and the nine scenario presets. The values are those of the JAX package's
``repro.core.config``; the array code is written on torch tensors.

A ``MarketConfig`` is the *scalar* surface: one value per field, uniform
over the ensemble. The engine-facing generalization is
:class:`repro_torch.core.params.EnsembleSpec`, which stacks per-market values
of every scenario-varying field into per-market columns.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.core.device import DEFAULT_DEVICE, resolve_device

# Agent strategy classes.
NOISE = 0
MOMENTUM = 1
MAKER = 2
FUNDAMENTALIST = 3
WHALE = 4
HFT = 5
INFORMED = 6
ARBITRAGEUR = 7

# RNG channels (the fixed five-channel draw schedule).
CH_SIDE = 0
CH_PRICE = 1
CH_MKT = 2
CH_QTY = 3
CH_SHOCK = 4


@dataclasses.dataclass(frozen=True)
class MarketConfig:
    """Parameters of the uniform-price call-auction ensemble.

    Defaults follow the paper's benchmarked configuration: L=128 price ticks,
    S=500 steps, population mix 15% makers / 15% momentum / 70% noise.
    """

    num_markets: int = 64          # M — independent markets
    num_agents: int = 256          # A — agents per market
    num_levels: int = 128          # L — price grid ticks (power of two)
    num_steps: int = 500           # S — simulation steps
    seed: int = 0

    q_max: int = 8                 # max order quantity
    p_marketable: float = 0.1      # probability of a marketable order
    noise_delta: float = 8.0       # noise-trader price offset half-width
    maker_half_spread: float = 2.0

    # Static population mix: agents [0, A·α_maker) are makers, then momentum,
    # fundamentalists, whales, HFTs, informed, arbitrageurs; the rest noise.
    alpha_maker: float = 0.15
    alpha_momentum: float = 0.15
    alpha_fundamentalist: float = 0.0

    fundamental_price: float = -1.0   # < 0 → grid midpoint
    fundamentalist_kappa: float = 0.5

    alpha_whale: float = 0.0
    alpha_hft: float = 0.0
    alpha_informed: float = 0.0
    alpha_arbitrageur: float = 0.0
    whale_size: float = 32.0       # lots per whale sweep (integer-valued)
    whale_period: int = 16         # steps between sweeps (>= 1)
    hft_threshold: float = 0.2     # |imbalance| trigger, in [0, 1]
    informed_horizon: int = 8      # steps of early shock knowledge (>= 0)
    arb_kappa: float = 0.5         # gap-chasing strength (>= 0)

    scenario: str = "baseline"
    shock_step: int = -1           # flash-crash step (< 0 → disabled)
    shock_intensity: float = 0.0   # P(agent panic-sells marketably at shock)
    shock_cancel: float = 0.0      # fraction of resting bids withdrawn

    initial_quote_qty: float = 10.0
    initial_spread: int = 2

    def __post_init__(self):
        L = self.num_levels
        if L < 4 or (L & (L - 1)) != 0:
            raise ValueError(f"num_levels must be a power of two >= 4, got {L}")
        if L > 1024:
            raise ValueError("num_levels > 1024 requires tiling (paper §V)")
        mix_total = (self.alpha_maker + self.alpha_momentum
                     + self.alpha_fundamentalist + self.alpha_whale
                     + self.alpha_hft + self.alpha_informed
                     + self.alpha_arbitrageur)
        if not (0.0 <= mix_total <= 1.0):
            raise ValueError("agent fractions must sum to <= 1")
        assigned = self.num_agents - self.archetype_counts()[NOISE]
        if assigned > self.num_agents:
            raise ValueError(
                f"per-class rounding assigns {assigned} agents > "
                f"num_agents={self.num_agents}; adjust alphas or num_agents")
        if not (0.0 <= self.shock_intensity <= 1.0):
            raise ValueError("shock_intensity must be in [0, 1]")
        if not (0.0 <= self.shock_cancel <= 1.0):
            raise ValueError("shock_cancel must be in [0, 1]")
        if self.shock_step >= self.num_steps:
            raise ValueError("shock_step must be < num_steps")
        if self.whale_size < 1 or self.whale_size != int(self.whale_size):
            raise ValueError("whale_size must be an integer-valued lot "
                             "count >= 1 (exact in f32)")
        if self.whale_period < 1:
            raise ValueError("whale_period must be >= 1")
        if not (0.0 <= self.hft_threshold <= 1.0):
            raise ValueError("hft_threshold must be in [0, 1] (book "
                             "imbalance is normalized)")
        if self.informed_horizon < 0:
            raise ValueError("informed_horizon must be >= 0")
        if self.arb_kappa < 0:
            raise ValueError("arb_kappa must be >= 0")

    def _count(self, alpha: float) -> int:
        return int(round(self.num_agents * alpha))

    @property
    def num_makers(self) -> int:
        return self._count(self.alpha_maker)

    @property
    def num_momentum(self) -> int:
        return self._count(self.alpha_momentum)

    @property
    def num_fundamentalists(self) -> int:
        return self._count(self.alpha_fundamentalist)

    @property
    def num_whales(self) -> int:
        return self._count(self.alpha_whale)

    @property
    def num_hft(self) -> int:
        return self._count(self.alpha_hft)

    @property
    def num_informed(self) -> int:
        return self._count(self.alpha_informed)

    @property
    def num_arbitrageurs(self) -> int:
        return self._count(self.alpha_arbitrageur)

    @property
    def mid0(self) -> float:
        return float(self.num_levels // 2)

    @property
    def fundamental(self) -> float:
        """Resolved fundamental price (grid midpoint unless overridden)."""
        return self.mid0 if self.fundamental_price < 0 else self.fundamental_price

    def mixture(self) -> Dict[int, float]:
        """Static archetype weights {type_id: fraction}, summing to 1."""
        noise = 1.0 - (self.alpha_maker + self.alpha_momentum
                       + self.alpha_fundamentalist + self.alpha_whale
                       + self.alpha_hft + self.alpha_informed
                       + self.alpha_arbitrageur)
        return {NOISE: noise, MOMENTUM: self.alpha_momentum,
                MAKER: self.alpha_maker,
                FUNDAMENTALIST: self.alpha_fundamentalist,
                WHALE: self.alpha_whale, HFT: self.alpha_hft,
                INFORMED: self.alpha_informed,
                ARBITRAGEUR: self.alpha_arbitrageur}

    def archetype_counts(self) -> Dict[int, int]:
        """Resolved population {type_id: agent count} (sums to num_agents)."""
        counts = {MAKER: self.num_makers, MOMENTUM: self.num_momentum,
                  FUNDAMENTALIST: self.num_fundamentalists,
                  WHALE: self.num_whales, HFT: self.num_hft,
                  INFORMED: self.num_informed,
                  ARBITRAGEUR: self.num_arbitrageurs}
        counts[NOISE] = self.num_agents - sum(counts.values())
        return counts

    def agent_types(self, device=DEFAULT_DEVICE) -> torch.Tensor:
        """int32[A] strategy class per agent index, on ``device``.

        The config's scalar counts through the one assignment rule
        (:func:`assign_agent_types`), which the per-market ensemble path
        (``repro_torch.core.params.agent_types``) shares, so the two cannot
        drift apart.
        """
        return assign_agent_types(
            self.num_agents, self.num_makers, self.num_momentum,
            self.num_fundamentalists, self.num_whales, self.num_hft,
            self.num_informed, self.num_arbitrageurs, device=device)[0]

    def initial_books(self, device=DEFAULT_DEVICE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bid, ask) float32[M, L] opening books on ``device``."""
        M = self.num_markets
        return seed_books(
            self.num_levels,
            torch.full((M,), self.initial_quote_qty, dtype=torch.float32),
            torch.full((M,), self.initial_spread, dtype=torch.int32),
            device=device)

    def events(self) -> int:
        """Total agent events M·A·S (the paper's throughput denominator)."""
        return self.num_markets * self.num_agents * self.num_steps


def assign_agent_types(num_agents: int, num_makers, num_momentum,
                       num_fundamentalists, num_whales=0, num_hft=0,
                       num_informed=0, num_arbitrageurs=0,
                       device=DEFAULT_DEVICE):
    """int32 strategy-class lattice broadcastable to [M, A].

    Makers first, then momentum, fundamentalists, whales, HFTs, informed
    traders, arbitrageurs, then noise, by agent index. Counts are Python
    ints (one row) or ``[M, 1]`` int32 columns (one row per market).
    """
    device = resolve_device(device)
    a = torch.arange(num_agents, dtype=torch.int32, device=device)[None, :]
    blocks = ((MAKER, num_makers), (MOMENTUM, num_momentum),
              (FUNDAMENTALIST, num_fundamentalists), (WHALE, num_whales),
              (HFT, num_hft), (INFORMED, num_informed),
              (ARBITRAGEUR, num_arbitrageurs))
    uppers = []
    cum = torch.zeros((), dtype=torch.int32, device=device)
    for tid, count in blocks:
        cum = cum + torch.as_tensor(count, dtype=torch.int32, device=device)
        uppers.append((tid, cum))
    out = torch.full_like(a, NOISE)
    # Fold highest threshold first so each earlier block overrides later ones.
    for tid, upper in reversed(uppers):
        # A Python scalar, not a tensor made from it: no host copy, so a
        # CUDA graph can capture the lattice.
        out = torch.where(a < upper, tid, out)
    return out


def seed_books(num_levels: int, quote_qty, spread,
               device=DEFAULT_DEVICE) -> Tuple:
    """(bid, ask) float32[M, L] opening books: quotes of per-market depth
    ``quote_qty`` (f32[M]) straddling L/2 at ``ceil(spread / 2)`` ticks."""
    L = num_levels
    device = resolve_device(device)
    spread = torch.as_tensor(spread, dtype=torch.int32).to(device)
    q = torch.as_tensor(quote_qty, dtype=torch.float32).to(device)[:, None]
    half = spread // 2 + spread % 2
    pb = (L // 2 - half)[:, None]
    pa = (L // 2 + half)[:, None]
    levels = torch.arange(L, dtype=torch.int32, device=device)[None, :]
    bid = (levels == pb).to(torch.float32) * q
    ask = (levels == pa).to(torch.float32) * q
    return bid, ask


# ---------------------------------------------------------------------------
# Scenario presets: name -> fn(num_steps) -> field overrides.
# ---------------------------------------------------------------------------
SCENARIO_PRESETS: Dict[str, Callable[[int], dict]] = {
    "baseline": lambda S: {},
    # Mid-run shock: 60% of non-maker agents dump marketably while half the
    # resting bid support is withdrawn at the same step.
    "flash-crash": lambda S: {"shock_step": S // 2, "shock_intensity": 0.6,
                              "shock_cancel": 0.5},
    "high-vol": lambda S: {"noise_delta": 16.0, "p_marketable": 0.25},
    "low-vol": lambda S: {"noise_delta": 2.0, "p_marketable": 0.05},
    "whale": lambda S: {"noise_delta": 16.0, "p_marketable": 0.25,
                        "alpha_maker": 0.15, "alpha_momentum": 0.40,
                        "alpha_whale": 0.05, "whale_size": 32.0,
                        "whale_period": 16},
    "hft": lambda S: {"noise_delta": 16.0, "p_marketable": 0.25,
                      "alpha_maker": 0.15, "alpha_momentum": 0.35,
                      "alpha_hft": 0.03, "hft_threshold": 0.5},
    "informed": lambda S: {"noise_delta": 16.0, "p_marketable": 0.25,
                           "alpha_maker": 0.15, "alpha_momentum": 0.40,
                           "alpha_informed": 0.05, "shock_step": S // 2,
                           "shock_intensity": 0.3, "informed_horizon": 8},
    "wide-book": lambda S: {"initial_quote_qty": 64.0, "initial_spread": 8},
    "thin-book": lambda S: {"initial_quote_qty": 1.0, "initial_spread": 2},
}


def register_scenario(name: str):
    """Decorator: register ``fn(num_steps) -> field overrides`` as the
    scenario preset ``name``."""
    def deco(fn):
        SCENARIO_PRESETS[name] = fn
        return fn
    return deco


def scenario_names() -> Tuple[str, ...]:
    return tuple(sorted(SCENARIO_PRESETS))


def scenario_config(name: str, **overrides) -> MarketConfig:
    """Build a MarketConfig for a named scenario; explicit ``overrides``
    win over preset fields."""
    if name not in SCENARIO_PRESETS:
        raise KeyError(f"unknown scenario {name!r}; have {scenario_names()}")
    if overrides.get("scenario", name) != name:
        raise ValueError(
            f"scenario={overrides['scenario']!r} override conflicts with "
            f"preset name {name!r}")
    num_steps = overrides.get(
        "num_steps", MarketConfig.__dataclass_fields__["num_steps"].default)
    fields = dict(SCENARIO_PRESETS[name](num_steps))
    fields.update(overrides)
    fields["scenario"] = name
    return MarketConfig(**fields)
