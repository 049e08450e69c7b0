"""Wire shapes for the serving gateway: per-chunk frames + control events.

A :class:`Frame` is one client's slice of one completed chunk — the
per-step ``mid``/``price``/``volume`` paths for *their* market (or, on a
``stats_only`` gateway, the running
:class:`~repro_torch.core.stats.MarketStats` row instead of paths). Frames are produced once per chunk per attached
slot and fanned out through :class:`repro_torch.serve.bus.FrameBus`; the
in-process transport hands the NamedTuple over directly, the WebSocket
transport sends :meth:`Frame.to_json`.

An :class:`Event` is an out-of-band control message delivered on the same
per-client queue (attach/detach acknowledgements, fault-recovery
``reconnect`` markers, ``closed`` on a backpressure disconnect), so a
client observes control flow in order with its data frames.
"""
from __future__ import annotations

import json
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np


class Frame(NamedTuple):
    """One chunk's outputs for one serving slot."""

    slot: int                     # ensemble row this client is attached to
    seq: int                      # gateway-global chunk index (monotonic)
    step0: int                    # absolute step of the chunk's first step
    num_steps: int                # steps in this chunk (partial tails < chunk)
    mid: np.ndarray               # f32[num_steps] pre-clearing mid path
    price: np.ndarray             # f32[num_steps] clearing-price path
    volume: np.ndarray            # f32[num_steps] transacted-volume path
    stats: Optional[Dict[str, float]] = None  # stats_only gateways only

    def to_json(self) -> str:
        payload = {
            "type": "frame", "slot": int(self.slot), "seq": int(self.seq),
            "step0": int(self.step0), "num_steps": int(self.num_steps),
            "mid": np.asarray(self.mid, np.float64).tolist(),
            "price": np.asarray(self.price, np.float64).tolist(),
            "volume": np.asarray(self.volume, np.float64).tolist(),
        }
        if self.stats is not None:
            payload["stats"] = {k: float(v) for k, v in self.stats.items()}
        return json.dumps(payload)

    @classmethod
    def from_json(cls, text: str) -> "Frame":
        d = json.loads(text)
        if d.get("type") != "frame":
            raise ValueError(f"not a frame payload: {d.get('type')!r}")
        return cls(
            slot=int(d["slot"]), seq=int(d["seq"]), step0=int(d["step0"]),
            num_steps=int(d["num_steps"]),
            mid=np.asarray(d["mid"], np.float32),
            price=np.asarray(d["price"], np.float32),
            volume=np.asarray(d["volume"], np.float32),
            stats=d.get("stats"),
        )


class Event(NamedTuple):
    """Out-of-band control message on a client's queue.

    ``kind`` is one of ``"attached"`` (slot assignment ack, carries the
    slot and scenario label), ``"detached"``, ``"reconnect"`` (the gateway
    recovered from a fault and resumed at ``payload["resume_step"]`` — the
    stream continues bitwise from there), or ``"closed"`` (the gateway
    disconnected this client: backpressure ``disconnect`` policy, detach,
    or shutdown; ``payload["reason"]`` says which).
    """

    kind: str
    payload: Dict[str, Any]

    def to_json(self) -> str:
        return json.dumps({"type": "event", "kind": self.kind,
                           "payload": self.payload})

    @classmethod
    def from_json(cls, text: str) -> "Event":
        d = json.loads(text)
        if d.get("type") != "event":
            raise ValueError(f"not an event payload: {d.get('type')!r}")
        return cls(kind=d["kind"], payload=d.get("payload", {}))


def decode(text: str):
    """Decode one wire message into a :class:`Frame` or :class:`Event`."""
    kind = json.loads(text).get("type")
    if kind == "frame":
        return Frame.from_json(text)
    if kind == "event":
        return Event.from_json(text)
    raise ValueError(f"unknown wire message type {kind!r}")


def slice_frames(batch, stats, slots, seq: int, step0: int,
                 n: int) -> Tuple[Tuple[int, Frame], ...]:
    """Cut one host-side chunk batch into per-slot frames.

    ``batch`` is a host :class:`~repro_torch.core.session.StepBatch`
    (zero-width paths on a ``stats_only`` gateway, in which case the per-market
    ``stats`` NamedTuple supplies the payload); ``slots`` is the iterable
    of attached slot ids to emit for. Parked slots simply get no frame —
    their rows are computed (shape-static ensemble) but never leave the
    host batch.
    """
    out = []
    for slot in slots:
        s = None
        if stats is not None:
            s = {field: float(np.asarray(leaf)[slot, 0])
                 for field, leaf in zip(stats._fields, stats)}
        width = np.asarray(batch.mid).shape[-1]
        empty = np.zeros(0, np.float32)
        out.append((slot, Frame(
            slot=slot, seq=seq, step0=step0, num_steps=n,
            mid=np.asarray(batch.mid)[slot] if width else empty,
            price=np.asarray(batch.price)[slot] if width else empty,
            volume=np.asarray(batch.volume)[slot] if width else empty,
            stats=s)))
    return tuple(out)
