"""CUDA graphs: the port's counterpart of the JAX package's one compiled
executable.

The JAX package runs a rollout (a ``lax.scan`` of env and policy) and a
whole PPO update as one jitted executable, traced once per static
signature and cached. On one card the port captures the same Python body
into a ``torch.cuda.CUDAGraph`` once per key (:func:`capture`; the engine
keeps the :class:`Graph`, ``Engine._graph``) and replays it with no host
work per kernel:

  * The first call of a key runs the body eagerly on a side stream, the
    warm-up torch asks for before a capture, under torch's sync debug mode
    ``"error"``, so a body that waits for the card fails there, before any
    capture; it returns those outputs. It then captures the body on the
    same stream from static copies of its inputs. Nothing is replayed, so
    a first call launches what an eager call launches.
  * A later call copies its inputs into the static buffers (the caller's
    tensors are never written), replays, and returns clones of the
    outputs, so what a call returns survives the next replay.
  * What the body bakes is in the key, as JAX's static arguments are: the
    inputs' tree structure with every non-tensor leaf (a step cursor, a
    seed) by value and every tensor leaf's shape, dtype and device
    (:func:`signature`). The outputs' non-tensor leaves are the capture's.
  * The kernel wrappers' launch counters move only where kernels run: the
    increments made at capture are taken back, and each replay adds them.
    A :class:`~repro_torch.launch.roofline.Roofline` sees the capture's
    records once a replay (``roofline.capturing`` and ``roofline.replay``).
  * A host value the body turns into a device tensor goes through
    :func:`stage`: the copy the warm-up made is the graph's constant, kept
    with it, as JAX bakes a host constant into its trace.

A failed capture raises :class:`GraphCaptureError` naming what was
captured; nothing falls back to the eager body.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from typing import Any, Callable, List, Tuple

import torch

from repro_torch.core import params as params_mod
from repro_torch.core.device import upload
from repro_torch.launch import roofline
from repro_torch.ops import trace

# Node tags of a flattened tree (see :func:`flatten`).
_TENSOR, _CONST, _DICT = "tensor", "const", "dict"
#: The host values :func:`stage` placed at this thread's warm-up, which
#: its capture takes as constants.
_STAGING = threading.local()


class GraphCaptureError(RuntimeError):
    """A body could not be captured: it waits for the card, or the capture
    failed."""


def flatten(tree) -> Tuple[List[torch.Tensor], Any]:
    """``(tensor leaves, structure)`` of a tree of named tuples, tuples,
    lists and dicts (keys sorted). The structure is hashable: it holds
    every non-tensor leaf by type and value and every tensor leaf's shape,
    dtype and device."""
    leaves: List[torch.Tensor] = []
    return leaves, _flatten(tree, leaves)


def _flatten(x, leaves):
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return (_TENSOR, tuple(x.shape), x.dtype, str(x.device))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_flatten(v, leaves) for v in x))
    if isinstance(x, dict):
        keys = tuple(sorted(x))       # the JAX package's leaf order
        return (_DICT, keys, tuple(_flatten(x[k], leaves) for k in keys))
    try:
        hash(x)
    except TypeError:
        raise TypeError(
            f"a {type(x).__name__} leaf cannot be baked into a CUDA graph's "
            "key: carry tensors, or hashable host values") from None
    return (_CONST, type(x), x)


def unflatten(structure, leaves) -> Any:
    """The tree of ``structure`` with its tensor leaves from ``leaves``."""
    return _unflatten(structure, iter(leaves))


def _unflatten(node, it):
    tag = node[0]
    if tag == _TENSOR:
        return next(it)
    if tag == _CONST:
        return node[2]
    if tag == _DICT:
        return {k: _unflatten(c, it) for k, c in zip(node[1], node[2])}
    kids = [_unflatten(c, it) for c in node[1]]
    return tag(*kids) if hasattr(tag, "_fields") else tag(kids)


def signature(tree) -> Any:
    """The part of a key a tree gives: its structure (:func:`flatten`)."""
    return flatten(tree)[1]


def stage(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host tensor on ``device``: a one-element tensor made there by a
    fill, any other by :func:`~repro_torch.core.device.upload`. Under a
    capture no copy is recorded: the warm-up's copy of the same value
    (checked on the host) is the graph's constant, kept with it, as JAX
    bakes a host constant into its trace."""
    if device.type == "cpu":
        return host
    if host.numel() == 1:
        return torch.full(host.shape, host.item(), dtype=host.dtype,
                          device=device)
    staged = getattr(_STAGING, "staged", None)
    if staged is not None and torch.cuda.is_current_stream_capturing():
        if not staged:
            raise GraphCaptureError("the capture staged a host value the "
                                    "warm-up did not")
        seen, placed = staged.pop(0)
        if seen.dtype != host.dtype or not torch.equal(seen, host):
            raise GraphCaptureError(
                "a host value differs between the warm-up and the capture: "
                "a policy's host values must be a function of its inputs")
        return placed
    placed = upload(host, device)
    if staged is not None:
        staged.append((host.clone(), placed))
    return placed


def _copy(t: torch.Tensor) -> torch.Tensor:
    """A clone of ``t`` that keeps a packed params block's host copy (the
    kernels' ``Roofline`` records read it)."""
    out = t.clone()
    params_mod.carry_host_ints(t, out)
    return out


def _counted() -> tuple:
    """The kernel wrappers whose ``launches`` count the launches run."""
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    return (kc.kinetic_clearing_chunk, kc.kinetic_clearing,
            nc.naive_clearing_chunk, nc.naive_clearing)


@contextlib.contextmanager
def _sync_errors():
    """torch's sync debug mode at ``"error"`` for the block."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


@contextlib.contextmanager
def _staging(staged: list):
    """:func:`stage` records into (at the warm-up) or takes from (at the
    capture) ``staged`` in the block."""
    _STAGING.staged = staged
    try:
        yield
    finally:
        _STAGING.staged = None


@contextlib.contextmanager
def _no_gc():
    """No garbage collection in the block: a collected graph of an earlier
    capture would be destroyed inside this one, which the card refuses."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


class Graph:
    """One captured body: call it with a tree of the captured signature."""

    def __init__(self, what: str, device: torch.device,
                 graph: "torch.cuda.CUDAGraph", static_in, out_structure,
                 static_out, launches, tape, keep):
        self.what = what
        self.device = device
        self._graph = graph
        self._in = static_in
        self._out_structure = out_structure
        self._out = static_out
        self._launches = launches
        self._tape = tape
        self._keep = keep

    def __call__(self, tree) -> Any:
        """Copy ``tree``'s tensors into the static inputs, replay, and
        return clones of the outputs."""
        leaves, _ = flatten(tree)
        with torch.cuda.device(self.device):
            with trace.span("graph.copy_in"), roofline.uncounted():
                for dst, src in zip(self._in, leaves):
                    dst.copy_(src)
            with trace.span("graph.launch"), roofline.uncounted():
                self._graph.replay()
            for fn, n in self._launches:
                fn.launches += n
            roofline.replay(self._tape)
            with trace.span("graph.copy_out"), roofline.uncounted():
                out = [_copy(t) for t in self._out]
        return unflatten(self._out_structure, out)


def capture(what: str, body: Callable[[Any], Any], tree,
            device: torch.device) -> Tuple[Any, Graph]:
    """The first call of a key: ``(body(tree) run eagerly, the Graph of
    body)``. ``what`` names the body (its key and policy) in errors."""
    leaves, structure = flatten(tree)
    staged: list = []
    with torch.cuda.device(device):
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            try:
                with _sync_errors(), _staging(staged):
                    out = body(tree)
            except RuntimeError as exc:
                if "synchroniz" not in str(exc):
                    raise
                raise GraphCaptureError(
                    f"{what} cannot be captured into a CUDA graph: its "
                    f"body waits for the card ({exc})") from exc
            with roofline.uncounted():
                static_in = [_copy(x) for x in leaves]
        keep = [placed for _, placed in staged]
        graph = torch.cuda.CUDAGraph()
        counted = _counted()
        before = [fn.launches for fn in counted]
        failed = []
        try:
            with _staging(staged), _no_gc(), roofline.capturing() as tape:
                with torch.cuda.graph(graph, stream=side):
                    # The tape inside the capture: torch's own set-up of
                    # the graph (its RNG state's fills) is no work of the
                    # body's.
                    try:
                        with tape:
                            static = body(unflatten(structure, static_in))
                    except Exception as exc:
                        failed.append(exc)
                        raise
        except Exception as exc:
            cause = failed[0] if failed else exc
            raise GraphCaptureError(
                f"capturing {what} into a CUDA graph failed: "
                f"{type(cause).__name__}: {cause}") from cause
        finally:
            ran = [fn.launches - n for fn, n in zip(counted, before)]
            for fn, n in zip(counted, before):
                fn.launches = n
        current.wait_stream(side)
    static_out, out_structure = flatten(static)
    return out, Graph(what, device, graph, static_in, out_structure,
                      static_out, list(zip(counted, ran)), tape, keep)
