"""Bounded fan-out bus: per-client queues with explicit backpressure.

The simulation side of the gateway must never block on a consumer — the
paper's warm step loop is the asset being served, and one slow WebSocket
reader stalling it would stall *every* client. So delivery is strictly
non-blocking: each subscriber owns a bounded ``asyncio.Queue`` and
:meth:`FrameBus.publish` uses ``put_nowait`` only. When a queue is full
the subscription's policy decides:

  * ``"drop-oldest"`` (default) — evict the oldest queued frame, count it
    (``frames_dropped_total`` + per-client ``dropped``), enqueue the new
    one. A stalled client loses history but reconverges on the live edge;
    frame ``seq`` gaps tell it exactly what it missed.
  * ``"disconnect"``  — close the subscription with a ``closed`` event
    (reason ``"backpressure"``). Strictest latency guarantee: a client
    that can't keep up is shed rather than served stale data.

Either way the publisher returns in O(1) per subscriber and the step loop
never waits — the property the stalled-client test in
``tests/test_serve.py`` asserts with a deliberately frozen consumer.
"""
from __future__ import annotations

import asyncio
import itertools
from typing import Any, Dict, Iterable, Optional, Tuple

from repro_torch.serve.frames import Event, Frame

#: Queue policies a subscription may choose from.
POLICIES = ("drop-oldest", "disconnect")

#: Sentinel pushed to wake a consumer after close() (never user-visible).
_CLOSED = object()


class Subscription:
    """One client's bounded view of the bus (an async iterator).

    Yields :class:`Frame` and :class:`Event` objects in publish order.
    Iteration ends after a ``closed`` event (which is still delivered) or
    :meth:`close`.
    """

    def __init__(self, bus: "FrameBus", client: str, slot: int,
                 maxsize: int, policy: str) -> None:
        if policy not in POLICIES:
            raise ValueError(
                f"unknown backpressure policy {policy!r}; have {POLICIES}")
        self.bus = bus
        self.client = client
        self.slot = slot
        self.policy = policy
        self.queue: asyncio.Queue = asyncio.Queue(maxsize=max(1, maxsize))
        self.dropped = 0          # frames evicted by drop-oldest
        self.delivered = 0        # messages handed to the consumer
        self.closed = False

    def qsize(self) -> int:
        return self.queue.qsize()

    # ---- producer side (called by FrameBus only; never blocks) ----
    def _offer(self, item: Any) -> None:
        if self.closed:
            return
        try:
            self.queue.put_nowait(item)
        except asyncio.QueueFull:
            if self.policy == "drop-oldest":
                try:
                    evicted = self.queue.get_nowait()
                except asyncio.QueueEmpty:   # consumer raced us; retry once
                    evicted = None
                if isinstance(evicted, (Frame, Event)):
                    self.dropped += 1
                    self.bus._on_drop(self)
                try:
                    self.queue.put_nowait(item)
                except asyncio.QueueFull:
                    self.dropped += 1
                    self.bus._on_drop(self)
            else:  # disconnect: shed the slow client, keep the loop hot
                self.bus.close_subscription(
                    self, reason="backpressure",
                    detail=f"queue full at {self.queue.maxsize}")

    def _force(self, item: Any) -> None:
        """Deliver a control item even over a full queue (evicting a frame
        if needed) so ``closed``/``reconnect`` events are never lost."""
        try:
            self.queue.put_nowait(item)
        except asyncio.QueueFull:
            try:
                evicted = self.queue.get_nowait()
                if isinstance(evicted, (Frame, Event)):
                    self.dropped += 1
            except asyncio.QueueEmpty:
                pass
            try:
                self.queue.put_nowait(item)
            except asyncio.QueueFull:
                pass

    # ---- consumer side ----
    async def get(self) -> Optional[Any]:
        """Next frame/event, or ``None`` once the subscription is closed
        and drained."""
        while True:
            if self.closed and self.queue.empty():
                return None
            item = await self.queue.get()
            if item is _CLOSED:
                continue  # wake-up marker; loop re-checks closed+empty
            self.delivered += 1
            return item

    def __aiter__(self) -> "Subscription":
        return self

    async def __anext__(self):
        item = await self.get()
        if item is None:
            raise StopAsyncIteration
        return item

    def close(self) -> None:
        self.bus.close_subscription(self, reason="client")


class FrameBus:
    """Routes per-slot frames and broadcast events to subscribers.

    All methods must run on the event-loop thread (the gateway publishes
    from its async step loop after the executor hop); the data structures
    are plain dicts, and non-blocking puts are the only queue operations.
    An optional :class:`repro_torch.ops.metrics.MetricsRegistry` receives the
    gateway series documented in :mod:`repro_torch.ops.metrics`.
    """

    def __init__(self, metrics=None) -> None:
        self.metrics = metrics
        self._subs: Dict[str, Subscription] = {}
        self._ids = itertools.count()

    # ---- membership ----
    def subscribe(self, slot: int, *, client: Optional[str] = None,
                  maxsize: int = 8,
                  policy: str = "drop-oldest") -> Subscription:
        name = client if client is not None else f"client-{next(self._ids)}"
        if name in self._subs:
            raise ValueError(f"client id {name!r} already subscribed")
        sub = Subscription(self, name, slot, maxsize, policy)
        self._subs[name] = sub
        if self.metrics is not None:
            self.metrics.inc("sessions_opened_total")
            self.metrics.gauge("clients_connected", len(self._subs))
        return sub

    def close_subscription(self, sub: Subscription, *, reason: str,
                           detail: str = "") -> None:
        if sub.closed:
            return
        sub.closed = True
        self._subs.pop(sub.client, None)
        sub._force(Event("closed", {"reason": reason, "detail": detail,
                                    "client": sub.client}))
        # Wake a blocked get() — plain put, never evicting: a consumer can
        # only be blocked when the queue is empty, and evicting here could
        # displace the closed event itself on a maxsize-1 queue.
        try:
            sub.queue.put_nowait(_CLOSED)
        except asyncio.QueueFull:
            pass
        if self.metrics is not None:
            self.metrics.inc("sessions_closed_total")
            self.metrics.gauge("clients_connected", len(self._subs))
            self.metrics.gauge(f"queue_depth.{sub.client}", 0)

    def close_all(self, reason: str = "shutdown") -> None:
        for sub in list(self._subs.values()):
            self.close_subscription(sub, reason=reason)

    # ---- introspection ----
    @property
    def clients(self) -> Tuple[str, ...]:
        return tuple(self._subs)

    def subscribers_of(self, slot: int) -> Tuple[Subscription, ...]:
        return tuple(s for s in self._subs.values() if s.slot == slot)

    def queue_depths(self) -> Dict[str, int]:
        return {name: sub.qsize() for name, sub in self._subs.items()}

    # ---- delivery (producer side; never blocks, never awaits) ----
    def publish(self, frames: Iterable[Tuple[int, Frame]]) -> int:
        """Fan one chunk's ``(slot, frame)`` pairs out to every subscriber
        of each slot; returns the number of frames enqueued."""
        by_slot: Dict[int, Frame] = dict(frames)
        published = 0
        for sub in list(self._subs.values()):
            frame = by_slot.get(sub.slot)
            if frame is None:
                continue
            sub._offer(frame)
            published += 1
        if self.metrics is not None:
            self.metrics.inc("frames_published_total", published)
            for name, sub in self._subs.items():
                self.metrics.gauge(f"queue_depth.{name}", sub.qsize())
        return published

    def broadcast(self, event: Event) -> None:
        """Deliver a control event to every subscriber (never dropped)."""
        for sub in list(self._subs.values()):
            sub._force(event)

    def _on_drop(self, sub: Subscription) -> None:
        if self.metrics is not None:
            self.metrics.inc("frames_dropped_total")
            self.metrics.inc(f"frames_dropped.{sub.client}")
