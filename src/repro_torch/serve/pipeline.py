"""Lag-one device-to-host pipeline for the gateway's frames.

A kernel launch returns before the card finishes it, so reading chunk
``k``'s paths at once would serialize every chunk as ``[compute | copy |
host work]``. The gateway instead runs a two-deep pipeline on its engine
thread:

    launch chunk k            (the card starts computing, the host returns)
    start chunk k's copy      (launch.sharding.HostCopy on a copy stream:
                               queued behind chunk k, off the compute
                               stream, into pinned host buffers)
    convert chunk k-1         (waits for chunk k-1's copy event only, while
                               chunk k computes)
    stream chunk k-1's frames

With PyTorch a plain ``.cpu()`` of chunk ``k-1`` issued after chunk ``k``'s
launch would queue behind chunk ``k`` on the same stream and wait for it,
giving the same bits and none of the overlap. The gateway therefore
starts each chunk's copy right after its launch, as a
:class:`repro_torch.launch.sharding.HostCopy` on a copy stream that waits
for the compute stream's work so far and records an event; no numpy view
of a pinned buffer is read before that event completes.

:class:`DoubleBuffer` is the lag-one stage: :meth:`~DoubleBuffer.push`
stores the fresh item and returns the previous one converted, and
``conversion_seconds`` adds up the time conversion blocked, which shows
how much of the copy the overlap hid. On the CPU (the plain versions) the
outputs already are host memory and the pipeline is a one-item delay line.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Generic, Optional, Tuple, TypeVar

T = TypeVar("T")
U = TypeVar("U")


class DoubleBuffer(Generic[T, U]):
    """Lag-one conversion pipeline: ``push(x_k) -> convert(x_{k-1})``.

    ``convert`` is the (blocking) device-to-host read; it runs on the item
    pushed one call earlier, after the *next* chunk has been launched.
    ``conversion_seconds`` accumulates the observed blocking time.
    """

    def __init__(self, convert: Callable[[T], U]) -> None:
        self._convert = convert
        self._pending: Optional[Tuple[Any, T]] = None
        self.conversions = 0
        self.conversion_seconds = 0.0

    @property
    def depth(self) -> int:
        """Items currently in flight (0 or 1)."""
        return 0 if self._pending is None else 1

    def push(self, tag: Any, item: T) -> Optional[Tuple[Any, U]]:
        """Store ``item`` (freshly launched, possibly still computing) and
        return the previously pushed ``(tag, converted)`` pair, or ``None``
        on the first call."""
        done = self._drain()
        self._pending = (tag, item)
        return done

    def flush(self) -> Optional[Tuple[Any, U]]:
        """Convert and return the in-flight item (end of stream), if any."""
        return self._drain()

    def _drain(self) -> Optional[Tuple[Any, U]]:
        if self._pending is None:
            return None
        tag, item = self._pending
        self._pending = None
        t0 = time.perf_counter()
        out = self._convert(item)
        self.conversion_seconds += time.perf_counter() - t0
        self.conversions += 1
        return tag, out
