"""Spans: named ranges at the program's layer boundaries, on the clock of
``torch.profiler``'s trace.

    with trace.span("dispatch", kind="chunk", steps=n, chunk=c):
        ...

A span is on while a ``torch.profiler`` profile records on the calling
thread, and only then; there is no other switch. On, it enters
``torch.profiler.record_function("repro_torch." + name)``, so the range
lands in the profiler's trace beside the kernels, copies and memsets it
launched, on the clock they share, and it appends a :class:`Record` to a
bounded in-memory buffer (:func:`spans`). Off, :func:`span` returns one
shared no-op context: no record, no range, no object of its own.

``metrics=`` and ``timing=`` name a
:class:`~repro_torch.ops.metrics.MetricsRegistry` timing that the span's
duration also goes into, on or off (a block that raises records none):
with a registry in reach an off span is a bare timer, the
``perf_counter`` pair it stands for.

A span's request id (``rid=``) defaults to its parent's, so only the
outermost span of a request names it. The spans the program opens, with
their attributes (the request id: a session's ``session_id``, or a
trainer's ``update_idx``):

  ``open``                  ``Engine.open``
    ``open.runner``         the runner cache lookup (``hit``)
      ``open.runner.build``   the backend's factory on a miss, libraries
                              loaded included
        ``open.runner.autotune``  the timed tile sweep (``candidates``,
                                  ``pick``, ``seconds``)
    ``open.state``, ``open.params``, ``open.stats``  the session's books,
                              packed params (``scenarios``: the spec's
                              distinct labels, in order; ``rows``: the
                              params rows packed on the host, B or M;
                              ``markets``: M) and accumulators; a kernel
                              runner on one device opens all three with
                              one fill under ``open.params`` alone
  ``dispatch``              one runner call (``kind``, ``steps``,
                            ``chunk``; ``agents``: the kernel runner's
                            agent mode, None for a runner without a
                            tile; ``ctas_per_market``: its tile's C,
                            None without a tile; ``agent_steps``:
                            markets × agents × steps dispatched)
    ``dispatch.peer``       a kernel runner's chunk-entry peer gather
                            (``rows``; ``coupled``: the rows with a real
                            peer, from the params' host copy)
  ``to_host``               ``StepBatch.to_numpy`` and ``Session.stats``
    ``to_host.wait``        one synchronize of the producing stream (made
                            on or off)
    ``to_host.copy``        the copy (``bytes``: host bytes written;
                            ``pinned_bytes``: those in page-locked memory)
  ``close``, ``swap``, ``snapshot``, ``restore``  the session's own calls
  ``train``                 ``PPOTrainer.train``
    ``update``              ``PPOTrainer.update``
      ``graph.capture``     a key's first call (``Engine._graph``)
      ``graph.replay``      a later call: ``graph.copy_in``,
                            ``graph.launch``, ``graph.copy_out``
    ``train.stack``         stacking the updates' metrics
  ``env.step``              one env step, eager (a replay runs none):
                            ``env.actions``, ``env.clear``,
                            ``env.transition``, ``env.obs``
"""
from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import _profiler_enabled

#: The prefix of every range this module puts in a profiler's trace.
PREFIX = "repro_torch."
#: Records the buffer keeps, newest last.
CAPACITY = 1 << 16


class Record(NamedTuple):
    """One finished span."""

    name: str
    parent: Optional[str]    # the enclosing span's name, None at the top
    rid: Any                 # the request id
    start_ns: int            # time.perf_counter_ns()
    end_ns: int
    attrs: Dict[str, Any]

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_BUFFER: "collections.deque[Record]" = collections.deque(maxlen=CAPACITY)
_LOCAL = threading.local()


def enabled() -> bool:
    """True while a ``torch.profiler`` profile records on this thread."""
    return _profiler_enabled()


def spans() -> List[Record]:
    """The buffer's records, oldest first: the spans that finished while a
    profiler recorded."""
    return list(_BUFFER)


def clear() -> None:
    _BUFFER.clear()


class _Off:
    """The shared no-op span."""

    __slots__ = ()
    on = False

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs: Any) -> None:
        return None


_OFF = _Off()


class _Timed(_Off):
    """An off span with a registry in reach: the timing alone."""

    __slots__ = ("_metrics", "_timing", "_t0")

    def __init__(self, metrics, timing: str) -> None:
        self._metrics, self._timing = metrics, timing

    def __enter__(self) -> "_Timed":
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self._metrics.observe(
                self._timing, (time.perf_counter_ns() - self._t0) * 1e-9)


class _Span:
    """An on span: a ``record_function`` range and a :class:`Record`."""

    __slots__ = ("name", "rid", "attrs", "_metrics", "_timing", "_range",
                 "_parent", "_t0")
    on = True

    def __init__(self, name: str, rid: Any, attrs: Dict[str, Any],
                 metrics, timing: Optional[str]) -> None:
        self.name, self.rid, self.attrs = name, rid, attrs
        self._metrics, self._timing = metrics, timing

    def set(self, **attrs: Any) -> None:
        """Attributes known only inside the block."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        parent = stack[-1] if stack else None
        self._parent = None if parent is None else parent.name
        if self.rid is None and parent is not None:
            self.rid = parent.rid
        stack.append(self)
        self._range = torch.profiler.record_function(PREFIX + self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter_ns()
        self._range.__exit__(exc_type, exc, tb)
        _LOCAL.stack.pop()
        _BUFFER.append(Record(self.name, self._parent, self.rid, self._t0,
                              t1, self.attrs))
        if self._metrics is not None and exc_type is None:
            self._metrics.observe(self._timing, (t1 - self._t0) * 1e-9)


def span(name: str, *, rid: Any = None, metrics=None,
         timing: Optional[str] = None, **attrs: Any):
    """The span ``name`` (see the module docstring): a context manager
    whose ``set(**attrs)`` adds attributes and whose ``on`` says whether it
    records. ``metrics`` (a registry, or None) takes the duration under
    ``timing``."""
    if not _profiler_enabled():
        return _OFF if metrics is None else _Timed(metrics, timing)
    return _Span(name, rid, attrs, metrics, timing)


def tag(t: Any, rid: Any) -> None:
    """Mark a tensor with a request id, read back by :func:`rid_of` (where
    the span that copies it has no parent to take one from)."""
    try:
        t._trace_rid = rid
    except AttributeError:
        pass


def rid_of(t: Any) -> Any:
    return getattr(t, "_trace_rid", None)
