"""Lag-one device-to-host pipeline for the gateway's frames.

A kernel launch returns before the card finishes it, so reading chunk
``k``'s paths at once would serialize every chunk as ``[compute | copy |
host work]``. The gateway instead runs a two-deep pipeline on its engine
thread:

    launch chunk k            (the card starts computing, the host returns)
    start chunk k's copy      (HostCopy: queued behind chunk k, off the
                               compute stream, into pinned host buffers)
    convert chunk k-1         (waits for chunk k-1's copy event only, while
                               chunk k computes)
    stream chunk k-1's frames

With PyTorch a plain ``.cpu()`` of chunk ``k-1`` issued after chunk ``k``'s
launch would queue behind chunk ``k`` on the same stream and wait for it,
giving the same bits and none of the overlap. :class:`HostCopy` therefore
starts each chunk's copy right after its launch, on a copy stream that
waits for the compute stream's work so far, and records an event; no numpy
view of a pinned buffer is read before that event completes.

:class:`DoubleBuffer` is the lag-one stage: :meth:`~DoubleBuffer.push`
stores the fresh item and returns the previous one converted, and
``conversion_seconds`` adds up the time conversion blocked, which shows
how much of the copy the overlap hid. On the CPU (the plain versions) the
outputs already are host memory and the pipeline is a one-item delay line.
"""
from __future__ import annotations

import time
from typing import (Any, Callable, Generic, List, Optional, Sequence, Tuple,
                    TypeVar)

import numpy as np
import torch

T = TypeVar("T")
U = TypeVar("U")


class HostCopy:
    """A device-to-host copy of ``tensors`` (``None`` entries pass
    through), started at construction and read by :meth:`result`.

    On the card every copy goes on ``copy_stream`` after the work already
    queued on the tensors' current stream, into pinned buffers with
    ``non_blocking=True``, and an event is recorded after them. The source
    tensors are held until :meth:`result` has waited for that event, so
    their memory cannot be reused while the copy reads it.
    """

    def __init__(self, tensors: Sequence[Optional[torch.Tensor]],
                 copy_stream: Optional["torch.cuda.Stream"] = None) -> None:
        self._src: Optional[List[Optional[torch.Tensor]]] = list(tensors)
        self._event = None
        device = next((t.device for t in self._src if t is not None), None)
        if device is None or device.type == "cpu":
            self._host = [None if t is None else t.detach()
                          for t in self._src]
            return
        if copy_stream is None:
            raise ValueError("a copy from the card needs a copy_stream")
        copy_stream.wait_stream(torch.cuda.current_stream(device))
        self._host = []
        with torch.cuda.stream(copy_stream):
            for t in self._src:
                if t is None:
                    self._host.append(None)
                    continue
                t.record_stream(copy_stream)
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                buf.copy_(t, non_blocking=True)
                self._host.append(buf)
            self._event = torch.cuda.Event()
            self._event.record(copy_stream)

    def result(self) -> List[Optional[np.ndarray]]:
        """Wait for this copy's event only; numpy views of the buffers."""
        if self._event is not None:
            self._event.synchronize()
        self._src = None
        return [None if h is None else h.numpy() for h in self._host]


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
