"""Slot scheduler: multiplexing client markets onto one warm ensemble.

The gateway's engine runs ONE ensemble of ``slots`` markets forever — the
shape never changes, so its runner is never rebuilt. A client session is an
*assignment* of one ensemble row (a slot) to that client: attaching writes
the client's per-market params row + fresh opening book into the row at
the next chunk boundary (:meth:`Session.swap_markets`), detaching parks
the row with :meth:`EnsembleSpec.parked` values. Slots are the unit of
admission control: a gateway with all slots attached refuses new sessions
(:class:`GatewayFull`) instead of building a wider ensemble.

The scheduler itself is pure bookkeeping — it validates static-field
agreement eagerly (a mismatched client spec must fail at ``attach``, not
deep inside the splice), queues mutations, and coalesces everything
pending into ONE ``swap_markets`` call per chunk boundary so an attach
burst costs one host round-trip, not one per client.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.config import MarketConfig, scenario_config
from repro_torch.core.params import EnsembleSpec, _STATIC_FIELDS


class GatewayFull(RuntimeError):
    """Every slot is attached — admission refused (no rebuild to grow)."""


class GatewayRecovering(RuntimeError):
    """The gateway is mid-recovery — admission paused; retry after the
    ``reconnect`` broadcast (existing streams resume bitwise)."""


class GatewayDegraded(RuntimeError):
    """The recovery retry budget is exhausted — the gateway is serving
    health only (HTTP 503) and refuses sessions until restarted."""


class SlotScheduler:
    """Free-list of ensemble rows + a pending-mutation queue.

    ``template`` fixes the static shape every client must agree with; rows
    are coerced through :meth:`coerce_row` (preset name, single-market
    :class:`MarketConfig`, or single-market :class:`EnsembleSpec`).
    """

    def __init__(self, template: EnsembleSpec) -> None:
        self.template = template
        self._free: List[int] = list(range(template.num_markets))[::-1]
        self._attached: Dict[int, str] = {}      # slot -> scenario label
        self._pending: List[Tuple[int, EnsembleSpec]] = []

    # ---- introspection ----
    @property
    def num_slots(self) -> int:
        return self.template.num_markets

    @property
    def attached(self) -> Tuple[int, ...]:
        return tuple(sorted(self._attached))

    @property
    def free(self) -> int:
        return len(self._free)

    def label(self, slot: int) -> Optional[str]:
        return self._attached.get(slot)

    # ---- row coercion ----
    def coerce_row(self, spec: Union[str, MarketConfig, EnsembleSpec],
                   ) -> EnsembleSpec:
        """Normalize a client's market request to a 1-market spec agreeing
        with the template's static fields — loudly, at admission time."""
        t = self.template
        if isinstance(spec, str):
            spec = scenario_config(
                spec, num_markets=1, num_agents=t.num_agents,
                num_levels=t.num_levels, num_steps=t.num_steps, seed=t.seed)
        row = EnsembleSpec.coerce(spec)
        if row.num_markets != 1:
            raise ValueError(
                f"a client session attaches exactly one market; got a "
                f"{row.num_markets}-market spec")
        for f in _STATIC_FIELDS:
            if getattr(row, f) != getattr(t, f):
                raise ValueError(
                    f"client spec disagrees with the serving template on "
                    f"static field {f!r}: template has {getattr(t, f)}, "
                    f"client asked for {getattr(row, f)} — static fields "
                    "fix the warm runner and cannot vary per session")
        return row

    # ---- mutation queue (applied at chunk boundaries by the gateway) ----
    def attach(self, spec: Union[str, MarketConfig, EnsembleSpec]) -> int:
        """Reserve a free slot for ``spec``; the splice lands at the next
        chunk boundary. Raises :class:`GatewayFull` when no slot is free."""
        row = self.coerce_row(spec)
        if not self._free:
            raise GatewayFull(
                f"all {self.num_slots} slots attached; detach a session or "
                "serve from a wider template")
        slot = self._free.pop()
        self._attached[slot] = row.scenarios[0] if row.scenarios else "?"
        self._pending.append((slot, row))
        return slot

    def detach(self, slot: int) -> None:
        """Queue parking ``slot``; it returns to the free list now (it can
        be re-attached immediately; mutations coalesce in queue order)."""
        if slot not in self._attached:
            raise KeyError(f"slot {slot} is not attached")
        del self._attached[slot]
        self._free.append(slot)
        self._pending.append((slot, EnsembleSpec.parked(self.template, 1)))

    def coalesce(self) -> Optional[Tuple[Tuple[int, ...], EnsembleSpec,
                                         Tuple[Optional[str], ...]]]:
        """Pop every pending mutation as ONE coalesced splice — without
        applying it.

        Later mutations of the same slot win (detach-then-attach between
        two boundaries nets to the attach). Returns ``(slots, sub_spec,
        labels)`` — ``labels`` is the post-splice attachment label per
        slot (``None`` for a park/detach) — or ``None`` when nothing was
        pending. The gateway journals the splice durably *before* calling
        ``session.swap_markets`` (write-ahead ordering: a crash between
        the two replays the splice, never loses it).
        """
        if not self._pending:
            return None
        last: Dict[int, EnsembleSpec] = {}
        for slot, row in self._pending:
            last[slot] = row
        self._pending.clear()
        slots = sorted(last)
        sub = EnsembleSpec.concatenate([last[s] for s in slots])
        labels = tuple(self._attached.get(s) for s in slots)
        return tuple(slots), sub, labels

    def drain(self, session
              ) -> Optional[Tuple[Tuple[int, ...], EnsembleSpec]]:
        """Apply every pending mutation in ONE ``swap_markets`` splice
        (:meth:`coalesce` + apply, for callers without a journal)."""
        pending = self.coalesce()
        if pending is None:
            return None
        slots, sub, _ = pending
        session.swap_markets(list(slots), sub)
        return slots, sub

    # ---- restart reconstruction (journal replay / checkpoint labels) ----
    def mark_attached(self, slot: int, label: str) -> None:
        """Record ``slot`` as attached with ``label`` without queueing any
        splice — rebuilding bookkeeping after a process restart, where the
        row's params already live in the restored checkpoint (or arrive
        via journal replay)."""
        if slot not in self._attached:
            self._free.remove(slot)
        self._attached[slot] = label

    def mark_parked(self, slot: int) -> None:
        """Inverse of :meth:`mark_attached` for journal-replayed parks."""
        if slot in self._attached:
            del self._attached[slot]
            self._free.append(slot)
