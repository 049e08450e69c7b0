"""The port's roofline: operations, bytes and cross-device bytes per device,
counted where the work runs.

The counterpart of ``repro.launch.hlo_analysis``. ``repro`` re-derives the
three roofline inputs from compiled, partitioned XLA HLO text: it multiplies
``while`` bodies by their trip count and charges slices and updates only
for the region they touch. PyTorch eager has no such text, and the port's
kernels launch through ``ctypes``, out of the dispatcher's sight. So the
port counts at run time, where the work runs:

  * **aten ops**, through a ``TorchDispatchMode`` (:class:`Roofline`), by
    ``repro``'s rules: a dot (``mm``, ``addmm``, ``bmm``, ``baddbmm``,
    ``mv``, ``addmv``, ``dot``, their backward ops included) costs 2·M·N·K
    flops; any other materializing op one flop per output element; views,
    ``empty*``, ``detach``, ``alias`` and a ``.to()`` that does not move
    cost nothing. Bytes are the operands read plus the result written;
    slicing and gathering ops (``index``, ``gather``, ``index_select``,
    the ``*_copy`` slices) charge the sliced bytes, updates
    (``index_put_``, ``scatter_add_``, ``scatter_``, ``index_add_``,
    ``index_copy_``) twice the update. A loop is its iterations, each
    counted as it runs, so there is no trip count to find.
  * **kernel calls**, at their counted wrappers (:func:`kernel_call`): each
    call is charged the work of the function it computes, the
    ``op_count``/``byte_count`` of ``repro_torch.kernels``, on every device
    alike (on the CPU the wrapper runs its plain version; its aten ops are
    not counted a second time).
  * **cross-device bytes**, where a sharded runner moves rows
    (:func:`transfer`, from ``launch/sharding.py`` and ``kernels/ops.py``):
    ``scatter`` where a shard's rows are placed on its device (a session's
    opening, ``restore``, ``swap_markets``, ``Session.step``'s external
    orders, an env's reset and the order triple of its every step),
    ``gather`` where a part is joined onto the mesh's first device (the
    paths a ``run`` returns; an env step's observation, reward and info
    columns), and one
    ``collective-permute`` per ring hop of the chunk-entry mid column, as
    ``repro``'s ``ppermute`` ring (``src/repro/kernels/ops.py:176-200``):
    (n-1) hops a chunk of M·4 bytes each, recorded with their source and
    destination shard (``collective_routes``). ``repro``'s other four
    collective kinds stay 0: the port issues no all-reduce, all-gather,
    reduce-scatter or all-to-all.

Totals are kept per device, by shard position in the mesh (work outside a
shard counts at position 0, the mesh's first device; so does host work on
CPU tensors, such as a session's uploads when the recorder encloses its
opening), as ``repro``'s analyzer reads one device of a partitioned
program; the top-level totals sum the devices. A mesh that names one
device twice, or a CPU mesh, reports the plan's bytes all the same, and
``wire_no_link`` says how many of them crossed no link. Since moves count
as transfers, not as aten ops, and a shard resolves its own rows' peers
with the ops the unsharded run applies to every row, the per-device flops
and bytes of a sharded run sum to the unsharded run's.

Bytes are eager's: every op reads its operands and writes its result, where
XLA would fuse, so they are held to closed forms, not to ``repro``'s fused
count. Operations are FP32-lane issue slots (``HW["peak_lane_ops"]``): a
kernel call's ``op_count``, a dot's M·N·K fused multiply-adds, one per
element of any other op. aten ops are counted on the thread that entered
the recorder and on autograd's threads for its backward (their records
are marked ``(backward)``); kernel calls and transfers on any thread. The
recorder reads no device tensor and adds no launch. A CUDA graph's capture
records into a tape of its own (:func:`capturing`), and each replay reports
the tape to the recorders active then (:func:`replay`), so a replayed
rollout or update records what the same body records run eagerly.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch.mesh import HW

#: ``repro``'s collective kinds (the port issues collective-permute only),
#: then the port's placements and joins.
COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
TRANSFERS = ("scatter", "gather")
KINDS = COLLECTIVES + TRANSFERS

_aten = torch.ops.aten
#: Dots, by the position of the operand whose last dim is contracted.
_DOTS = {_aten.mm: 0, _aten.bmm: 0, _aten.mv: 0, _aten.dot: 0,
         _aten.vdot: 0, _aten.addmm: 1, _aten.baddbmm: 1, _aten.addmv: 1,
         _aten._addmm_activation: 1}
#: Ops that only take part of an operand: they move the sliced bytes.
_SLICES = {_aten.index, _aten.gather, _aten.index_select, _aten.slice_copy,
           _aten.select_copy, _aten.narrow_copy, _aten.take}
#: Ops that update a region: they move twice the update.
_UPDATES = {_aten.index_put, _aten.index_put_, _aten._index_put_impl_,
            _aten.scatter, _aten.scatter_, _aten.scatter_add,
            _aten.scatter_add_, _aten.scatter_reduce, _aten.scatter_reduce_,
            _aten.index_add, _aten.index_add_, _aten.index_copy,
            _aten.index_copy_, _aten.masked_scatter, _aten.masked_scatter_}
#: Free ops whose schema does not mark them as views.
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten._unsafe_view,
         _aten.resize_, _aten.set_}
#: In-place ops that write their first operand without reading it.
_WRITE_ONLY = {_aten.copy_, _aten.fill_, _aten.zero_, _aten.uniform_,
               _aten.normal_, _aten.bernoulli_, _aten.random_,
               _aten.exponential_}
_KIND: Dict[object, str] = {}

#: The recorders entered and not yet left, innermost last.
_ACTIVE: List["Roofline"] = []
#: This thread's shard position and device, and the depth of kernel calls
#: and transfers it is inside (their aten ops are not counted).
_LOCAL = threading.local()
#: The hooks' context when no recorder is active.
_NULL = contextlib.nullcontext()


def _kind(func) -> str:
    kind = _KIND.get(func)
    if kind is None:
        packet = func.overloadpacket
        if packet in _DOTS:
            kind = "dot"
        elif packet in _SLICES:
            kind = "slice"
        elif packet in _UPDATES:
            kind = "update"
        elif packet in _FREE or any(
                r.alias_info is not None and not r.alias_info.is_write
                for r in func._schema.returns):
            kind = "free"
        elif packet in _WRITE_ONLY:
            kind = "write"
        else:
            kind = "op"
        _KIND[func] = kind
    return kind


def _nbytes(t: torch.Tensor) -> int:
    """Bytes of the memory ``t`` covers (a broadcast dim counts once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in _pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _update_bytes(func, args, kwargs) -> int:
    """Bytes of an update's region: its values/src/source operand, or for
    a scalar scattered at an index, that many elements of the target."""
    names = [a.name for a in func._schema.arguments]

    def arg(name):
        i = names.index(name)
        return args[i] if i < len(args) else kwargs.get(name)

    for name in ("values", "src", "source"):
        if name in names and isinstance(arg(name), torch.Tensor):
            return _nbytes(arg(name))
    return arg("index").numel() * args[0].element_size()


def _cost(func, args, kwargs, out) -> Optional[Tuple[int, int, int]]:
    """(flops, operations, bytes) of one aten op; None for a free op."""
    kind = _kind(func)
    if kind == "free":
        return None
    outs = _tensors(out)
    if kind == "slice":
        return 0, 0, sum(map(_nbytes, outs))
    if kind == "update":
        return 0, 0, 2 * _update_bytes(func, args, kwargs)
    ins = _tensors((args, {k: v for k, v in kwargs.items() if k != "out"}))
    if kind == "write":
        ins = ins[1:]
    nbytes = sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
    elems = sum(t.numel() for t in outs)
    if kind == "dot":
        macs = elems * args[_DOTS[func.overloadpacket]].shape[-1]
        return 2 * macs, macs, nbytes
    return elems, elems, nbytes


def _where() -> Tuple[int, Optional[str]]:
    return getattr(_LOCAL, "pos", 0), getattr(_LOCAL, "device", None)


class Roofline(TorchDispatchMode):
    """Record the work run inside ``with Roofline() as rf:``.

    Counts aten ops through the dispatch mode and takes the reports of the
    kernel wrappers (:func:`kernel_call`) and of the shard loop
    (:func:`transfer`); :meth:`analyze`, :meth:`summarize` and
    :meth:`top_contributors` read the totals. Recorders nest, with each
    other, ``torch.profiler`` and torch's sync debug mode.
    """

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._devices: Dict[int, Dict[str, object]] = {}
        self._aten: Dict[str, List[int]] = {}
        self._kernels: Dict[str, Dict[str, int]] = {}
        self._coll = {k: 0 for k in KINDS}
        self._cnt = {k: 0 for k in KINDS}
        self._routes: Dict[Tuple[int, int], int] = {}

    def __enter__(self) -> "Roofline":
        super().__enter__()
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if getattr(_LOCAL, "quiet", 0) or self not in _ACTIVE:
            return out
        cost = _cost(func, args, kwargs, out)
        if cost is not None:
            name = str(func)
            if torch._C._current_graph_task_id() != -1:
                name += " (backward)"
            pos, device = _where()
            with self._lock:
                entry = self._aten.setdefault(name, [0, 0, 0, 0])
                for k, v in enumerate((1,) + cost):
                    entry[k] += v
                self._charge(pos, device, flops=cost[0],
                             operations=cost[1], bytes=cost[2])
                if self._devices[pos]["device"] is None:
                    first = next(iter(_tensors((args, out))), None)
                    if first is not None:
                        self._devices[pos]["device"] = str(first.device)
        return out

    # ---- reports from the wrappers and the shard loop (under the lock) ----
    def _charge(self, pos: int, device: Optional[str], **amounts) -> None:
        """Add ``amounts`` at shard ``pos``; ``device`` (the shard's, or a
        kernel call's) names it, else its first aten op's device does."""
        dev = self._devices.setdefault(pos, dict(
            device=None, flops=0, operations=0, bytes=0, wire=0,
            wire_no_link=0))
        if device is not None:
            dev["device"] = device
        for k, v in amounts.items():
            dev[k] += v

    def _kernel(self, name, device, ops, nbytes, launches) -> None:
        pos, where = _where()
        with self._lock:
            entry = self._kernels.setdefault(name, dict(
                calls=0, launches=0, operations=0, bytes=0))
            entry["calls"] += 1
            entry["launches"] += launches
            entry["operations"] += ops
            entry["bytes"] += nbytes
            self._charge(pos, where or device, operations=ops, bytes=nbytes)

    def _transfer(self, kind, pos, device, nbytes, count, local, to) -> None:
        with self._lock:
            self._coll[kind] += nbytes
            self._cnt[kind] += count
            if to is not None:
                route = (pos, to)
                self._routes[route] = self._routes.get(route, 0) + nbytes
            self._charge(pos, device, wire=nbytes, wire_no_link=local)

    def _merge(self, tape: "Roofline") -> None:
        """Add every record of ``tape`` (a capture's, see :func:`capturing`)
        to this recorder's."""
        with tape._lock:
            aten = {k: list(v) for k, v in tape._aten.items()}
            kernels = {k: dict(v) for k, v in tape._kernels.items()}
            devices = {k: dict(v) for k, v in tape._devices.items()}
            coll, cnt = dict(tape._coll), dict(tape._cnt)
            routes = dict(tape._routes)
        with self._lock:
            for name, e in aten.items():
                mine = self._aten.setdefault(name, [0, 0, 0, 0])
                for k, v in enumerate(e):
                    mine[k] += v
            for name, e in kernels.items():
                mine = self._kernels.setdefault(name, dict.fromkeys(e, 0))
                for k, v in e.items():
                    mine[k] += v
            for pos, d in devices.items():
                self._charge(pos, d.pop("device"), **d)
            for k in KINDS:
                self._coll[k] += coll[k]
                self._cnt[k] += cnt[k]
            for route, v in routes.items():
                self._routes[route] = self._routes.get(route, 0) + v

    # ---- reading ----
    def analyze(self) -> Dict[str, float]:
        """``repro``'s ``analyze`` keys (``flops``, ``bytes``, ``wire``,
        ``coll_<kind>``, ``cnt_<kind>``, the transfers' kinds included),
        plus ``operations``; totals over every device."""
        with self._lock:
            devs = list(self._devices.values())
            out = {k: sum(d[k] for d in devs)
                   for k in ("flops", "operations", "bytes", "wire")}
            for k in KINDS:
                out["coll_" + k] = self._coll[k]
                out["cnt_" + k] = self._cnt[k]
        return out

    def summarize(self) -> Dict[str, object]:
        """``repro``'s ``summarize`` keys, plus ``operations``,
        ``aten_calls`` (materializing aten ops run), ``wire_no_link``,
        ``per_device`` (by shard position: device, flops, operations,
        bytes, wire, wire_no_link), ``kernels`` (by entry: calls,
        launches, operations, bytes) and ``collective_routes`` (the ring
        hops' bytes by ``(source, destination)`` shard)."""
        r = self.analyze()
        with self._lock:
            per_device = {pos: dict(d) for pos, d in
                          sorted(self._devices.items())}
            kernels = {name: dict(e) for name, e in self._kernels.items()}
            calls = sum(e[0] for e in self._aten.values())
            routes = dict(sorted(self._routes.items()))
        return {
            "flops": r["flops"],
            "hbm_bytes": r["bytes"],
            "collective_wire_bytes": r["wire"],
            "collective_breakdown": {k: r["coll_" + k] for k in KINDS},
            "collective_counts": {k: r["cnt_" + k] for k in KINDS},
            "operations": r["operations"],
            "aten_calls": calls,
            "wire_no_link": sum(d["wire_no_link"]
                                for d in per_device.values()),
            "per_device": per_device,
            "kernels": kernels,
            "collective_routes": routes,
        }

    def top_contributors(self, key: str = "bytes", n: int = 25):
        """The largest contributors to ``key`` (``"bytes"``, ``"flops"`` or
        ``"operations"``): ``(total, calls, name, "aten" | "kernel")``, an
        aten op or a kernel entry with its call count as the multiplier.
        Kernel calls count no flops, as ``repro`` counts none for a
        custom call: their work is operations."""
        col = {"flops": 1, "operations": 2, "bytes": 3}[key]
        with self._lock:
            items = [(e[col], e[0], name, "aten")
                     for name, e in self._aten.items()]
            if key != "flops":
                items += [(e[key], e["calls"], name, "kernel")
                          for name, e in self._kernels.items()]
        items.sort(key=lambda item: (-item[0], item[2]))
        return items[:n]


class _Scope:
    """Set this thread's shard position and device, or count it as inside a
    kernel call or a transfer, for the length of a ``with`` block."""

    def __init__(self, pos=None, device=None, quiet=False):
        self._pos, self._device, self._quiet = pos, device, quiet

    def __enter__(self):
        self._saved = _where()
        if self._pos is not None:
            _LOCAL.pos, _LOCAL.device = self._pos, self._device
        if self._quiet:
            _LOCAL.quiet = getattr(_LOCAL, "quiet", 0) + 1
        return self

    def __exit__(self, *exc):
        _LOCAL.pos, _LOCAL.device = self._saved
        if self._quiet:
            _LOCAL.quiet -= 1
        return False


def shard(pos: int, device) -> _Scope:
    """Charge the work of the block to shard ``pos`` of the mesh, on
    ``device``."""
    return _Scope(pos, str(device)) if _ACTIVE else _NULL


def uncounted():
    """Count no aten op of the block: a transfer's copies and joins, which
    :func:`transfer` reports instead."""
    return _Scope(quiet=True) if _ACTIVE else _NULL


def kernel_call(name: str, device, cost: Callable[[], Tuple[int, int, int]]):
    """Report one call of the kernel entry ``name`` on ``device``:
    ``cost()`` gives its ``(operations, bytes, launches)``, evaluated on
    entry, and the aten ops of the block (the plain version on the CPU,
    the operand set-up on a card) are not counted again. Does nothing when
    no recorder is active; a failing ``cost`` raises."""
    if not _ACTIVE:
        return _NULL
    ops, nbytes, launches = cost()
    for rec in list(_ACTIVE):
        rec._kernel(name, str(device), int(ops), int(nbytes), int(launches))
    return _Scope(quiet=True)


@contextlib.contextmanager
def capturing():
    """Record nothing of the block in the recorders active around it, and
    yield a fresh :class:`Roofline`, the tape, to enter where the work to
    record runs: a CUDA graph's capture, whose work runs only at its
    replays, each of which reports the tape again (:func:`replay`)."""
    saved = list(_ACTIVE)
    _ACTIVE.clear()
    try:
        yield Roofline()
    finally:
        _ACTIVE[:] = saved


def replay(tape: Roofline) -> None:
    """Report the records of ``tape`` (:func:`capturing`) to every active
    recorder once: one replay of the graph it was taken at."""
    for rec in list(_ACTIVE):
        rec._merge(tape)


def transfer(kind: str, pos: int, peer, parts, to: Optional[int] = None
             ) -> None:
    """Report the tensors ``parts`` moved between shard ``pos`` and the
    device ``peer``, charged to shard ``pos``: ``"scatter"`` the rows placed
    on it from ``peer`` (the host or the first device), ``"gather"`` a part
    joined from it onto ``peer``, ``"collective-permute"`` one ring hop
    sent from it to shard ``to`` on ``peer``. A part already on ``peer``
    crossed no link."""
    if not _ACTIVE:
        return
    if kind not in TRANSFERS + ("collective-permute",):
        raise ValueError(f"unknown transfer kind {kind!r}")
    peer = torch.device(peer)
    nbytes = local = 0
    for t in parts:
        b = _nbytes(t)
        nbytes += b
        local += b if t.device == peer else 0
    for rec in list(_ACTIVE):
        rec._transfer(kind, pos, str(parts[0].device), nbytes, len(parts),
                      local, to)


def _run(fn, args, kwargs) -> Roofline:
    with Roofline() as rf:
        fn(*args, **kwargs)
    return rf


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`Roofline`;
    :meth:`Roofline.analyze` of it."""
    return _run(fn, args, kwargs).analyze()


def summarize(fn: Callable, *args, **kwargs) -> Dict[str, object]:
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`Roofline`;
    :meth:`Roofline.summarize` of it."""
    return _run(fn, args, kwargs).summarize()


def top_contributors(fn: Callable, *args, key: str = "bytes", n: int = 25,
                     **kwargs):
    """Run ``fn(*args, **kwargs)`` under a fresh :class:`Roofline`;
    :meth:`Roofline.top_contributors` of it."""
    return _run(fn, args, kwargs).top_contributors(key, n)


def bound(ops, nbytes, wire=0, hw=HW) -> Dict[str, object]:
    """The least time for ``ops`` FP32-lane issue slots, ``nbytes`` bytes
    of device memory and ``wire`` bytes over a link: the largest of ops
    over ``hw["peak_lane_ops"]``, bytes over ``hw["hbm_bw"]`` and wire
    over ``hw["nvlink_bw"]``, and which one bounds it."""
    times = {"operations": ops / hw["peak_lane_ops"] * 1e3,
             "bytes": nbytes / hw["hbm_bw"] * 1e3,
             "wire": wire / hw["nvlink_bw"] * 1e3}
    by = max(times, key=times.get)   # ties go to the first: operations
    return dict(ops=ops, bytes=nbytes, wire=wire, bound_ms=times[by],
                bound_by=by)
