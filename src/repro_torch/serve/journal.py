"""Durable splice journal: WAL for the gateway's slot mutations.

The serving gateway mutates the running ensemble exclusively through
coalesced :meth:`Session.swap_markets` splices at chunk boundaries. This
module makes the record of those splices durable, so it survives process
death as well as a device fault: an append-only, fsync'd JSON-lines file living
next to the checkpoint ladder, written **before** the splice is applied
(write-ahead ordering), so a gateway restart can

  1. restore the newest committed checkpoint (step ``r``),
  2. replay every journaled splice with boundary ``t >= r`` at its
     original chunk boundary, and
  3. resume each client stream bitwise — the engine's determinism
     (RNG keyed on (seed, market, step, channel)) does the rest.

Entries carry the full replacement
:class:`~repro_torch.core.params.EnsembleSpec` bitwise (base64 of each leaf's raw bytes + dtype/shape), because "the same
scenario label" is not enough for bitwise replay once ``with_values`` or
custom configs are in play.

Durability cost sits on the engine thread (one line + ``fsync`` per
splice) but splices are *rare* — admission events, not per-chunk work —
so this never touches steady-state chunk latency.

Compaction (the checkpoint GC hook): entries older than the oldest
retained checkpoint can never be replayed (every restore starts at a
committed step ``>=`` that) and are dropped by :meth:`compact`, which
rewrites the file crash-atomically via the checkpoint module's
tmp + fsync + rename primitive. Appends and compaction may race (engine
thread vs checkpoint-writer thread) — an internal lock serializes them.

A torn *trailing* line (process died mid-append) is tolerated and
dropped on read: the splice it described was never applied before the
crash, per the write-ahead ordering... unless it was — in which case the
restored checkpoint predates it only if the checkpoint ladder lost a
race it cannot lose (checkpoints only commit at chunk boundaries already
past the splice). Any *non-trailing* damage raises
:class:`JournalCorruptError` — silent partial replay would break the
bitwise guarantee.
"""
from __future__ import annotations

import base64
import dataclasses
import json
import os
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint.manager import _durable_write
from repro_torch.core.params import EnsembleSpec, MarketParams

JOURNAL_NAME = "splices.journal"


class JournalCorruptError(IOError):
    """A non-trailing journal line is damaged — replay would be partial."""


def _array_to_wire(arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"b64": base64.b64encode(arr.tobytes()).decode("ascii"),
            "dtype": str(arr.dtype), "shape": list(arr.shape)}


def _array_from_wire(wire: dict) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(wire["b64"]), dtype=np.dtype(wire["dtype"]),
    ).reshape(wire["shape"]).copy()


def spec_to_wire(spec: EnsembleSpec) -> dict:
    """Bitwise-exact JSON encoding of an :class:`EnsembleSpec`."""
    return {
        "num_markets": spec.num_markets, "num_agents": spec.num_agents,
        "num_levels": spec.num_levels, "num_steps": spec.num_steps,
        "seed": spec.seed,
        "params": {f: _array_to_wire(np.asarray(getattr(spec.params, f)))
                   for f in MarketParams._fields},
        "initial_quote_qty": _array_to_wire(
            np.asarray(spec.initial_quote_qty)),
        "initial_spread": _array_to_wire(np.asarray(spec.initial_spread)),
        "scenarios": list(spec.scenarios),
    }


def spec_from_wire(wire: dict) -> EnsembleSpec:
    return EnsembleSpec(
        num_markets=int(wire["num_markets"]),
        num_agents=int(wire["num_agents"]),
        num_levels=int(wire["num_levels"]),
        num_steps=int(wire["num_steps"]),
        seed=int(wire["seed"]),
        params=MarketParams(**{f: _array_from_wire(wire["params"][f])
                               for f in MarketParams._fields}),
        initial_quote_qty=_array_from_wire(wire["initial_quote_qty"]),
        initial_spread=_array_from_wire(wire["initial_spread"]),
        scenarios=tuple(wire["scenarios"]),
    )


@dataclasses.dataclass(frozen=True)
class SpliceEntry:
    """One journaled splice: apply ``spec`` to ``slots`` at boundary ``t``.

    ``labels`` records, per slot, the client-visible scenario label (or
    None for a detach-to-parked row) so a restart can rebuild the slot
    scheduler's attachment table without guessing from ``spec.scenarios``.
    """

    t: int                              # step boundary the splice landed on
    slots: Tuple[int, ...]
    labels: Tuple[Optional[str], ...]   # per-slot attachment label
    spec: EnsembleSpec                  # replacement rows (len(slots) markets)

    def to_json(self) -> str:
        return json.dumps({"t": self.t, "slots": list(self.slots),
                           "labels": list(self.labels),
                           "spec": spec_to_wire(self.spec)},
                          separators=(",", ":"))

    @classmethod
    def from_json(cls, line: str) -> "SpliceEntry":
        obj = json.loads(line)
        return cls(t=int(obj["t"]), slots=tuple(obj["slots"]),
                   labels=tuple(obj["labels"]),
                   spec=spec_from_wire(obj["spec"]))


class SpliceJournal:
    """Append-only fsync'd splice log next to the checkpoint ladder."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / JOURNAL_NAME
        self._lock = threading.Lock()
        self._fh = None
        self.appended = 0       # entries appended by this process
        self.compactions = 0

    # -- write side (engine thread) ------------------------------------
    def append(self, entry: SpliceEntry) -> None:
        """Durably append one entry (line + flush + fsync) — called
        *before* the splice is applied to the live session (WAL order)."""
        line = entry.to_json() + "\n"
        with self._lock:
            if self._fh is None:
                self._fh = open(self.path, "a", encoding="utf-8")
            self._fh.write(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.appended += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def reset(self) -> None:
        """Drop every entry (fresh checkpoint ladder: a journal left by a
        process that died before its step-0 anchor committed has nothing
        to replay onto)."""
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            if self.path.exists():
                self.path.unlink()

    # -- read side (restart / recovery) --------------------------------
    def entries(self) -> List[SpliceEntry]:
        """All journaled splices, oldest first.

        Tolerates a torn trailing line (crash mid-append: that splice was
        never applied). Damage anywhere else raises
        :class:`JournalCorruptError` — partial replay must never load.
        """
        with self._lock:
            if not self.path.exists():
                return []
            raw = self.path.read_text(encoding="utf-8")
        lines = raw.split("\n")
        # A complete file ends with "\n" → last element is "". Anything
        # else in the final slot is a torn tail.
        torn_tail = lines.pop() if lines else ""
        out: List[SpliceEntry] = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                out.append(SpliceEntry.from_json(line))
            except (json.JSONDecodeError, KeyError, ValueError) as exc:
                raise JournalCorruptError(
                    f"splice journal line {i + 1} is damaged "
                    f"({type(exc).__name__}: {exc}); refusing partial "
                    "replay") from exc
        if torn_tail.strip():
            try:
                out.append(SpliceEntry.from_json(torn_tail))
            except (json.JSONDecodeError, KeyError, ValueError):
                pass  # torn trailing append: the splice never applied
        return out

    # -- compaction (checkpoint-writer thread, via on_gc) ---------------
    def compact(self, oldest_retained_step: int) -> int:
        """Drop entries with ``t < oldest_retained_step``; returns the
        number dropped.

        Safe because every restore starts from a committed checkpoint
        ``>= oldest_retained_step``, and a splice at boundary ``t`` is
        already baked into any checkpoint taken at a step ``> t`` (the
        journal is written before the splice, the splice before the
        steps that follow it). The rewrite is crash-atomic (tmp + fsync +
        rename), so a crash mid-compaction leaves the old journal intact.
        """
        with self._lock:
            if not self.path.exists():
                return 0
            raw = self.path.read_text(encoding="utf-8")
            lines = [ln for ln in raw.split("\n") if ln.strip()]
            keep: List[str] = []
            dropped = 0
            for ln in lines:
                try:
                    t = int(json.loads(ln)["t"])
                except (json.JSONDecodeError, KeyError, ValueError):
                    keep.append(ln)  # torn tail: preserved, read-side drops
                    continue
                if t < oldest_retained_step:
                    dropped += 1
                else:
                    keep.append(ln)
            if not dropped:
                return 0
            # Close the append handle around the rename so later appends
            # reopen the new inode rather than the unlinked one.
            if self._fh is not None:
                self._fh.close()
                self._fh = None
            _durable_write(self.path,
                           ("\n".join(keep) + "\n" if keep else "").encode())
            self.compactions += 1
            return dropped

    def __len__(self) -> int:
        return len(self.entries())
