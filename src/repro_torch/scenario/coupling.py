"""Cross-market coupling: who is whose arbitrage peer.

A :class:`CouplingSpec` is a pure description of the coupling graph — one
peer id per market, ``-1`` meaning *self-coupled* (the arbitrageur gap is
identically zero, so an uncoupled market is bitwise the baseline). It
lowers onto the :class:`repro_torch.core.params.MarketParams`
``coupling_peer`` column via :meth:`apply`, so coupling is a *value*: turning
it on, off, or rewiring it between chunks reuses the warm runner and kernel.

Runtime semantics (every backend, same freeze boundary): at each chunk
entry the engine gathers ``prev_mid`` at the peer row, and arbitrageur
agents trade toward that frozen peer mid for the whole chunk. Coupled runs
are therefore bit for bit equal across backends whenever the chunk lengths
agree (the freeze boundaries are part of the semantics, like the RNG step
coordinate).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.params import EnsembleSpec


@dataclasses.dataclass(frozen=True)
class CouplingSpec:
    """Peer map over the market axis: ``peer[m]`` is the market whose
    previous-chunk mid market ``m``'s arbitrageurs track (``-1``: self)."""

    peer: np.ndarray  # int32[M]

    def __post_init__(self):
        arr = np.asarray(self.peer, dtype=np.int32).reshape(-1)
        object.__setattr__(self, "peer", arr)
        M = arr.size
        if M == 0:
            raise ValueError("CouplingSpec needs at least one market")
        bad = (arr < -1) | (arr >= M)
        if bad.any():
            rows = np.where(bad)[0]
            raise ValueError(
                f"coupling peer ids must be -1 (self) or in [0, {M}); "
                f"markets {rows[:8].tolist()} have "
                f"{arr[rows[:8]].tolist()}")

    # ---- constructors ----
    @classmethod
    def none(cls, num_markets: int) -> "CouplingSpec":
        """Fully decoupled (every market self-coupled) — the baseline."""
        return cls(np.full(num_markets, -1, np.int32))

    @classmethod
    def ring(cls, num_markets: int, offset: int = 1) -> "CouplingSpec":
        """Each market tracks its neighbor ``offset`` rows ahead (mod M)."""
        if num_markets < 2:
            raise ValueError("ring coupling needs >= 2 markets")
        if offset % num_markets == 0:
            raise ValueError(
                f"ring offset {offset} is a multiple of num_markets="
                f"{num_markets}: every market would track itself")
        idx = np.arange(num_markets, dtype=np.int32)
        return cls((idx + offset) % num_markets)

    @classmethod
    def pairs(cls, num_markets: int,
              pairs: Sequence[Sequence[int]]) -> "CouplingSpec":
        """Mutually coupled pairs ``(a, b)``; unlisted markets stay self-
        coupled. A market may appear in at most one pair."""
        peer = np.full(num_markets, -1, np.int32)
        for a, b in pairs:
            a, b = int(a), int(b)
            if a == b:
                raise ValueError(f"pair ({a}, {b}) couples a market to "
                                 "itself; omit it instead")
            for m in (a, b):
                if not 0 <= m < num_markets:
                    raise ValueError(
                        f"pair market {m} out of range [0, {num_markets})")
                if peer[m] != -1:
                    raise ValueError(
                        f"market {m} appears in more than one pair")
            peer[a], peer[b] = b, a
        return cls(peer)

    @classmethod
    def explicit(cls, mapping: Mapping[int, int],
                 num_markets: int) -> "CouplingSpec":
        """Arbitrary directed peer map ``{market: peer}``; unlisted markets
        stay self-coupled."""
        peer = np.full(num_markets, -1, np.int32)
        for m, p in mapping.items():
            if not 0 <= int(m) < num_markets:
                raise ValueError(
                    f"market {m} out of range [0, {num_markets})")
            peer[int(m)] = int(p)
        return cls(peer)

    # ---- derived ----
    @property
    def num_markets(self) -> int:
        return int(self.peer.size)

    @property
    def coupled_markets(self) -> np.ndarray:
        """Indices of markets with a real (non-self) peer."""
        idx = np.arange(self.num_markets)
        return idx[(self.peer >= 0) & (self.peer != idx)]

    def apply(self, spec: EnsembleSpec) -> EnsembleSpec:
        """Lower onto ``spec``'s ``coupling_peer`` params column.

        Pure value update (:meth:`EnsembleSpec.with_values`): the result
        shares the source spec's static key, hence its warm runner.
        The spec's arbitrageur population (``alpha_arbitrageur`` /
        ``num_arbitrageurs``) decides whether the coupling has any effect;
        applying a coupling to an arbitrageur-free spec is bitwise inert.
        """
        if spec.num_markets != self.num_markets:
            raise ValueError(
                f"coupling is over {self.num_markets} markets but the spec "
                f"has {spec.num_markets}")
        return spec.with_values(coupling_peer=self.peer)


def coupled_ensemble(spec: EnsembleSpec,
                     coupling: CouplingSpec) -> EnsembleSpec:
    """Convenience: ``coupling.apply(EnsembleSpec.coerce(spec))``."""
    return coupling.apply(EnsembleSpec.coerce(spec))
