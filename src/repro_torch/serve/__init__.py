"""Streaming serving gateway: multi-tenant sessions over one warm engine.

Public surface:

  * :class:`Gateway` / :class:`ClientSession` / :func:`parked_template` —
    the serving core (in-process transport);
  * :class:`SlotScheduler` / :class:`GatewayFull` /
    :class:`GatewayRecovering` / :class:`GatewayDegraded` — slot
    multiplexing + typed admission refusals;
  * :class:`SpliceJournal` / :class:`SpliceEntry` — the durable
    write-ahead splice log (process-crash recovery + bitwise restart);
  * :class:`FrameBus` / :class:`Subscription` — bounded backpressure bus;
  * :class:`Frame` / :class:`Event` / :func:`decode` — wire shapes;
  * :class:`DoubleBuffer` / :class:`HostCopy` — the lag-one device→host
    pipeline;
  * :class:`HealthServer` (and, with the optional ``websockets`` package,
    :class:`WebSocketServer`) in :mod:`repro_torch.serve.transport`.

``Engine.warm()`` runs inside :meth:`Gateway.start` before the first
frame — serving never pays a build, and ``Gateway.traces_delta`` stays 0
for any mixture of client scenarios (runners are keyed on the shape; the
tests assert it).
"""
from repro_torch.serve.bus import POLICIES, FrameBus, Subscription
from repro_torch.serve.frames import Event, Frame, decode, slice_frames
from repro_torch.serve.gateway import ClientSession, Gateway, parked_template
from repro_torch.serve.journal import SpliceEntry, SpliceJournal
from repro_torch.serve.pipeline import DoubleBuffer, HostCopy
from repro_torch.serve.slots import (GatewayDegraded, GatewayFull,
                                     GatewayRecovering, SlotScheduler)

__all__ = [
    "POLICIES", "FrameBus", "Subscription",
    "Event", "Frame", "decode", "slice_frames",
    "ClientSession", "Gateway", "parked_template",
    "SpliceEntry", "SpliceJournal",
    "DoubleBuffer", "HostCopy",
    "GatewayDegraded", "GatewayFull", "GatewayRecovering", "SlotScheduler",
]
