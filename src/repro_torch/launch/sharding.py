"""Market-axis placement rules for simulation ensembles.

The counterpart of ``repro.launch.sharding``. Every per-market tensor
(books ``[M, L]``, scalars and statistics ``[M, 1]``, the packed params
``[M, 11]``) is row-major over the market axis, so one cut of the rows
serves the whole session state: :func:`market_sharding` gives each mesh
device its contiguous rows, near-equal as ``torch.tensor_split`` cuts
them. A sharded kernel runner holds its session's state as
:class:`RowShards`, each shard's rows on that shard's device from open to
close, as ``repro`` holds a ``jax.Array`` under its ``NamedSharding``.
State that is not cut (a trainer's parameters, the joined copies the API
returns) lives on :func:`replicated_sharding`'s device, the mesh's first.

Moves between devices are ``Tensor.to(..., non_blocking=True)`` copies.
Between two cards torch orders such a copy by a two-way event barrier
between the two devices' current streams (ATen's device-to-device copy),
so a copy neither reads a part before the launch that writes it has run
nor overwrites memory a launch still reads; on one card a move to the same
device is no copy at all. Every move is reported to
:mod:`repro_torch.launch.roofline` (``scatter`` when a part is placed,
``gather`` when one is joined onto the first device), and its copies are
not counted again as aten ops.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree

from repro_torch.core import params as params_mod
from repro_torch.core import result
from repro_torch.core.device import upload
from repro_torch.core.params import PackedParams
from repro_torch.launch import roofline
from repro_torch.launch.mesh import MarketsMesh


def _markets_axis(mesh: MarketsMesh) -> None:
    if "markets" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh} has no 'markets' axis")


def market_sharding(mesh: MarketsMesh, num_markets: int
                    ) -> Tuple[slice, ...]:
    """Each mesh device's rows of an ``[M, ...]`` tensor: contiguous slices,
    the first ``M % n`` one row longer (``torch.tensor_split``'s cut); a
    device past ``M`` rows gets an empty slice."""
    _markets_axis(mesh)
    n, M = mesh.size, int(num_markets)
    base, extra = divmod(M, n)
    bounds = [0]
    for i in range(n):
        bounds.append(bounds[-1] + base + (1 if i < extra else 0))
    return tuple(slice(a, b) for a, b in zip(bounds, bounds[1:]))


def replicated_sharding(mesh: MarketsMesh) -> torch.device:
    """Where state that is not cut lives: the mesh's first device."""
    _markets_axis(mesh)
    return mesh.devices[0]


def replicate_tree(tree, mesh: MarketsMesh):
    """Every tensor of a nested dict/list/tuple ``tree`` on
    :func:`replicated_sharding`'s device (other leaves as they are).

    A trainer's parameter and optimizer trees ride through the sharded
    rollout path unsharded, so the trainer places them here once at init,
    as ``repro``'s does with its replicated sharding."""
    device = replicated_sharding(mesh)

    def place(x):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(place(v) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        return x

    return place(tree)


def _moved(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A copy of ``t`` on ``device`` with storage of its own: from the host
    to a card through pinned memory, queued without blocking."""
    if t.device.type == "cpu" and device.type == "cuda":
        return upload(t, device)
    return t.to(device, non_blocking=True, copy=True)


class RowShards:
    """A row-sharded ``[M, ...]`` tensor: ``parts[k]`` holds rows
    ``rows[k]`` (:func:`market_sharding`'s slices) on shard ``k``'s device.
    A shard past the last row holds an empty part.

    It has the few operations a session needs and no other: :meth:`place`,
    :meth:`join`, :meth:`to_host` and :meth:`splice`; no arithmetic and no
    ``__torch_function__``, so a kernel runner reads ``parts`` itself.
    """

    __slots__ = ("parts", "rows")

    def __init__(self, parts: Sequence[torch.Tensor],
                 rows: Sequence[slice]):
        self.parts = tuple(parts)
        self.rows = tuple(rows)

    @classmethod
    def place(cls, t: torch.Tensor, mesh: MarketsMesh) -> "RowShards":
        """Each shard's rows of the canonical tensor ``t`` (host or device),
        copied straight to the shard's device (a ``scatter`` each)."""
        rows = market_sharding(mesh, t.shape[0])
        with roofline.uncounted():
            parts = [_moved(t[r], dev) for dev, r in zip(mesh.devices, rows)]
        for pos, part in enumerate(parts):
            if part.numel():
                roofline.transfer("scatter", pos, t.device, [part])
        return cls(parts, rows)

    def join(self, device) -> torch.Tensor:
        """The whole ``[M, ...]`` tensor on ``device``, the mesh's first,
        where the first shard's part already lives: every other part is a
        ``gather``."""
        device = torch.device(device)
        parts = [p for p in self.parts if p.shape[0]]
        for pos, part in enumerate(self.parts[1:], 1):
            if part.shape[0]:
                roofline.transfer("gather", pos, device, [part])
        with roofline.uncounted():
            return torch.cat([p.to(device, non_blocking=True)
                              for p in parts], dim=0)

    @property
    def shape(self) -> Tuple[int, ...]:
        """The canonical tensor's shape."""
        return (self.rows[-1].stop,) + tuple(self.parts[0].shape[1:])

    def to_host(self) -> np.ndarray:
        """A pageable host copy: each part copied straight into its rows of
        one host array, with no hop through another device, waiting for
        each copy."""
        buf = torch.empty(self.shape, dtype=self.parts[0].dtype)
        for part, r in zip(self.parts, self.rows):
            buf[r].copy_(part.detach())
        return buf.numpy()

    def splice(self, idx: np.ndarray, src: torch.Tensor) -> "RowShards":
        """A copy with global rows ``idx`` (distinct ints) replaced by the
        rows of ``src`` (``[len(idx), ...]``, on any device): only the
        shards that own one of them get a new part (``index_copy`` on their
        device, a ``scatter`` of their new rows); the others share theirs."""
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        parts = list(self.parts)
        for pos, (part, r) in enumerate(zip(self.parts, self.rows)):
            mine = np.flatnonzero((idx >= r.start) & (idx < r.stop))
            if not mine.size:
                continue
            with roofline.uncounted():
                rows = _moved(src[torch.from_numpy(mine)], part.device)
                local = torch.from_numpy(idx[mine] - r.start).to(part.device)
            roofline.transfer("scatter", pos, src.device, [rows])
            parts[pos] = part.index_copy(0, local, rows)
        return RowShards(parts, self.rows)


def per_shard(fn: Callable, *trees) -> Any:
    """``fn(*trees)`` applied shard by shard: where a leaf of ``trees`` is a
    :class:`RowShards`, ``fn`` runs once per shard on every such leaf's
    part for that shard (other leaves as they are), under
    :func:`roofline.shard`, so each shard's ops are charged to its device;
    the tensors ``fn`` returns come back as :class:`RowShards` over the
    same rows, and any other result is the first shard's. ``fn`` must work
    row by row. Without a :class:`RowShards` among the leaves it is one
    plain call, so an unsharded caller keeps one path."""
    leaves, spec = _pytree.tree_flatten(trees)
    sharded = [x for x in leaves if isinstance(x, RowShards)]
    if not sharded:
        return fn(*trees)
    rows = sharded[0].rows
    outs = []
    for pos in range(len(rows)):
        part = [x.parts[pos] if isinstance(x, RowShards) else x
                for x in leaves]
        device = next(x.parts[pos].device for x in sharded)
        with roofline.shard(pos, device):
            outs.append(fn(*_pytree.tree_unflatten(part, spec)))
    flat = [_pytree.tree_flatten(o) for o in outs]
    out_spec = flat[0][1]
    merged = [RowShards([f[0][k] for f in flat], rows)
              if isinstance(first, torch.Tensor) else first
              for k, first in enumerate(flat[0][0])]
    return _pytree.tree_unflatten(merged, out_spec)


# ---- placement of a session's leaves, plain or row-sharded ----

def join(x, device):
    """``x`` whole on ``device``: a plain tensor as it is, a
    :class:`RowShards` joined."""
    return x.join(device) if isinstance(x, RowShards) else x


def wait(leaves) -> None:
    """Wait for the current stream of every card that holds a tensor of
    ``leaves`` (plain tensors, :class:`RowShards` or host values), once a
    card."""
    cards = set()
    for x in leaves:
        for t in x.parts if isinstance(x, RowShards) else (x,):
            if isinstance(t, torch.Tensor) and t.device.type == "cuda":
                cards.add(t.device)
    for dev in cards:
        torch.cuda.current_stream(dev).synchronize()


def to_host(x) -> np.ndarray:
    """A pageable host numpy copy of a plain tensor or a
    :class:`RowShards`, for copies that live long (snapshots,
    checkpoints)."""
    return x.to_host() if isinstance(x, RowShards) else result.to_host(x)


def _parts(x) -> Tuple[Sequence[torch.Tensor], Sequence[Any]]:
    """``x``'s parts and the rows each fills: a :class:`RowShards`' own, a
    tensor whole, nothing for a host value or ``None``."""
    if isinstance(x, RowShards):
        return x.parts, x.rows
    if isinstance(x, torch.Tensor):
        return (x,), (Ellipsis,)
    return (), ()


class HostCopy:
    """Host numpy copies of ``leaves`` (plain tensors, :class:`RowShards`,
    host values or ``None``, which passes through), queued at construction
    and read by :meth:`result`: the port's one device-to-host copy, for
    results the caller reads and drops. Copies that live long (snapshots,
    checkpoints) take :func:`to_host`, which holds no page-locked memory.

    A leaf with a part on a card lands in one page-locked buffer from
    PyTorch's caching host allocator, each part copied into its rows
    without blocking. Each array returned is a view that holds its buffer:
    the allocator hands the block out again only once the array is gone
    and the copy's recorded event has completed, so call after call reuses
    the same blocks and no caller's array changes under it. Any other leaf
    goes through :func:`to_host`.

    Without ``stream`` each copy goes on its part's current stream, and
    :meth:`result` synchronizes that stream once a card. With ``stream`` (a
    copy stream of the one card that holds the parts) the stream first
    waits for that card's current stream, every source is recorded on it,
    an event follows the copies, and :meth:`result` waits for that event
    alone, so the copy overlaps the work queued after it; the sources are
    held until then.
    """

    def __init__(self, leaves, stream: Optional["torch.cuda.Stream"] = None
                 ) -> None:
        self._src, self._event = list(leaves), None
        self._cards = {p.device for x in self._src for p in _parts(x)[0]
                       if p.is_cuda}
        if stream is not None:
            if self._cards - {stream.device}:
                raise ValueError(f"a copy stream of {stream.device} cannot "
                                 f"copy from {sorted(map(str, self._cards))}")
            for dev in self._cards:
                stream.wait_stream(torch.cuda.current_stream(dev))
        self._out = []
        with torch.cuda.stream(stream):
            for x in self._src:
                parts, rows = _parts(x)
                if not any(p.is_cuda for p in parts):
                    self._out.append(None if x is None else to_host(x))
                    continue
                buf = torch.empty(x.shape, dtype=parts[0].dtype,
                                  pin_memory=True)
                for part, r in zip(parts, rows):
                    if stream is not None:
                        part.record_stream(stream)
                    buf[r].copy_(part.detach(), non_blocking=True)
                self._out.append(buf)
            if stream is not None:
                self._event = torch.cuda.Event()
                self._event.record(stream)

    def result(self) -> list:
        """The numpy arrays, after this copy's event (with a stream) or one
        synchronize of each card's current stream (without)."""
        if self._event is not None:
            self._event.synchronize()
        else:
            for dev in self._cards:
                torch.cuda.current_stream(dev).synchronize()
        self._src = None
        return [x.numpy() if isinstance(x, torch.Tensor) else x
                for x in self._out]


def splice(x, idx: np.ndarray, src: torch.Tensor, device):
    """``x`` with global rows ``idx`` replaced by ``src``'s (a host
    tensor): ``index_copy`` on ``device`` for a plain tensor, the owning
    shards' parts for a :class:`RowShards`."""
    if isinstance(x, RowShards):
        return x.splice(idx, src)
    rows = upload(torch.from_numpy(np.asarray(idx, np.int64).reshape(-1)),
                  device)
    return x.index_copy(0, rows, upload(src, device))


def place_params(params: PackedParams, mesh: MarketsMesh) -> PackedParams:
    """``params`` row-sharded over ``mesh``: a :class:`PackedParams` of two
    :class:`RowShards`, each shard's int32 part with its rows of the host
    copy (where ``params`` has one: the roofline's kernel records read it,
    see :func:`shard_params`)."""
    placed = PackedParams(*(RowShards.place(t, mesh) for t in params))
    try:
        host = params_mod.host_ints(params)
    except LookupError:
        return placed
    for pos, r in enumerate(placed.ints.rows):
        params_mod.with_host_ints(shard_params(placed, pos), host[r].copy())
    return placed


def shard_params(params: PackedParams, pos: int) -> PackedParams:
    """Shard ``pos``'s own :class:`PackedParams` of row-sharded params."""
    return PackedParams(params.floats.parts[pos], params.ints.parts[pos])


def _host_ints(params: PackedParams, pos: int):
    try:
        return params_mod.host_ints(shard_params(params, pos))
    except LookupError:
        return None


def join_params(params: PackedParams, device) -> PackedParams:
    """``params`` whole on ``device`` (plain params as they are), with the
    joined host copy where every shard has one."""
    if not isinstance(params.ints, RowShards):
        return params
    joined = PackedParams(params.floats.join(device),
                          params.ints.join(device))
    hosts = [_host_ints(params, pos) for pos in range(len(params.ints.parts))]
    if all(h is not None for h in hosts):
        params_mod.with_host_ints(joined, np.concatenate(hosts, axis=0))
    return joined


def splice_params(params: PackedParams, idx: np.ndarray,
                  packed: PackedParams, device) -> PackedParams:
    """``params`` with global rows ``idx`` replaced by ``packed``'s (host
    blocks with a host copy), the host copy of every changed block updated:
    the whole copy of plain params, the owning shards' rows of row-sharded
    ones."""
    idx = np.asarray(idx, dtype=np.int64).reshape(-1)
    new = params_mod.host_ints(packed)
    out = PackedParams(*(splice(t, idx, src, device)
                         for t, src in zip(params, packed)))
    if not isinstance(params.ints, RowShards):
        host = params_mod.host_ints(params).copy()
        host[idx] = new
        return params_mod.with_host_ints(out, host)
    for pos, r in enumerate(params.ints.rows):
        if out.ints.parts[pos] is params.ints.parts[pos]:
            continue
        host = params_mod.host_ints(shard_params(params, pos)).copy()
        mine = np.flatnonzero((idx >= r.start) & (idx < r.stop))
        host[idx[mine] - r.start] = new[mine]
        params_mod.with_host_ints(shard_params(out, pos), host)
    return out
