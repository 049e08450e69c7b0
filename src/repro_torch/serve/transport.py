"""Network transports for the gateway: HTTP health + WebSocket fan-out.

The gateway core (:mod:`repro_torch.serve.gateway`) is transport-agnostic — the
in-process :class:`~repro_torch.serve.gateway.ClientSession` is the canonical
front door and what tests/benchmarks use. This module adds the two wire
surfaces the serving deployment needs:

  * :class:`HealthServer` — a dependency-free asyncio HTTP/1.1 endpoint
    (``GET /healthz``) returning :meth:`Gateway.health` as JSON: ``200``
    when the engine is warm, the loop is running, and the gateway is in
    the ``serving`` state; ``503`` otherwise — including the
    ``recovering`` and ``degraded`` supervision states, where the body
    still carries full diagnostics (state, ``degraded_reason``,
    checkpoint-writer lag, journal size) for operators while the
    load-balancer routes traffic away. This is the k8s readiness probe,
    backed by ``Engine.readiness()`` — a gateway that would build a runner on
    the next request reports unready *before* taking traffic.
  * :class:`WebSocketServer` — one WebSocket connection per client
    session. The handshake message selects the scenario; frames and
    control events stream as the JSON codecs in
    :mod:`repro_torch.serve.frames`. Requires the optional ``websockets``
    package; constructing it without raises a clear error (the rest of
    the serve stack — and all of CI — works without it).

Per-client backpressure bounds (queue size, drop-oldest/disconnect) apply
identically on both transports because they live in the bus, not here.
"""
from __future__ import annotations

import asyncio
import json
from typing import Any, Dict, Optional

from repro_torch.serve.frames import Event
from repro_torch.serve.gateway import Gateway

try:                                   # optional dependency, never required
    import websockets as _websockets
except Exception:                      # pragma: no cover - env-dependent
    _websockets = None


class HealthServer:
    """``GET /healthz`` over stdlib asyncio — no HTTP framework needed.

    Responds ``200 OK`` with the :meth:`Gateway.health` JSON payload when
    ``payload["ready"]`` is true, ``503 Service Unavailable`` (same body)
    when not. Any other path returns ``404``. The handler never touches
    the engine thread — ``health()`` reads cached readiness state — so the
    probe stays cheap under load.
    """

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        self.gateway = gateway
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> int:
        """Bind and serve; returns the bound port (useful with port 0)."""
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), timeout=5.0)
            parts = request.decode("latin-1").split()
            path = parts[1] if len(parts) >= 2 else ""
            while True:            # drain headers; we need none of them
                line = await asyncio.wait_for(reader.readline(), timeout=5.0)
                if line in (b"\r\n", b"\n", b""):
                    break
            if path in ("/healthz", "/health", "/"):
                payload = self.gateway.health()
                status = ("200 OK" if payload["ready"]
                          else "503 Service Unavailable")
            else:
                payload = {"error": f"not found: {path}"}
                status = "404 Not Found"
            body = json.dumps(payload).encode()
            writer.write(
                f"HTTP/1.1 {status}\r\n"
                f"Content-Type: application/json\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: close\r\n\r\n".encode() + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError):
            pass
        finally:
            writer.close()


class WebSocketServer:
    """WebSocket fan-out: one connection per client session.

    Protocol: the client's first message is a JSON handshake
    ``{"scenario": <preset name>, "maxsize": ..., "policy": ...}``; the
    server attaches a slot and then streams ``frame``/``event`` JSON
    messages (:mod:`repro_torch.serve.frames` codecs) until the client
    disconnects or backpressure policy closes the session. Queue bounds
    are enforced bus-side, so a slow socket drops frames (or is shed)
    without ever stalling the simulation.
    """

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1",
                 port: int = 0) -> None:
        if _websockets is None:
            raise RuntimeError(
                "the WebSocket transport needs the optional 'websockets' "
                "package, which is not installed in this environment; use "
                "the in-process transport (Gateway.open_session) or "
                "install websockets")
        self.gateway = gateway
        self.host = host
        self.port = port
        self._server = None

    async def start(self) -> int:
        self._server = await _websockets.serve(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def _handle(self, ws) -> None:   # pragma: no cover - needs dep
        try:
            hello: Dict[str, Any] = json.loads(await ws.recv())
        except Exception:
            await ws.close(code=1002, reason="bad handshake")
            return
        cs = None
        try:
            cs = self.gateway.open_session(
                hello.get("scenario", "baseline"),
                maxsize=hello.get("maxsize"),
                policy=hello.get("policy"),
                client=hello.get("client"))
            async for item in cs.subscription:
                await ws.send(item.to_json())
                if isinstance(item, Event) and item.kind == "closed":
                    break
        except Exception:
            pass
        finally:
            if cs is not None and not cs.closed:
                cs.close()
            await ws.close()
