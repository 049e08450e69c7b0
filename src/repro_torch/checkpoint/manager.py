"""Crash-consistent checkpointing with a non-blocking async writer.

The on-disk layout and ``FORMAT_VERSION`` are the JAX package's, so a
checkpoint written by either package restores in the other.

Layout (per step):
    <dir>/step_000040/
        manifest.json            # tree structure, shapes, dtypes, shard map
        shard_00000_of_00001.npz # per-host flat arrays
        COMMIT                   # terminal commit marker (written LAST)
    <dir>/LATEST                 # fast-path pointer (renamed into place)

Commit protocol — a step directory is **committed** iff its terminal
``COMMIT`` marker exists. Every durable byte goes through
:func:`_durable_write` (write-to-tmp → fsync → atomic rename), files are
committed in dependency order (shards → manifest → ``COMMIT`` → ``LATEST``),
and re-saving an existing step *removes* its ``COMMIT`` first — so a crash
at **any** write offset leaves either the previous committed checkpoint
intact or an uncommitted directory that :meth:`CheckpointManager.steps` /
:meth:`~CheckpointManager.restore` skip. A torn write can never produce a
loadable-but-wrong checkpoint (the torn-write chaos fault in
``repro_torch.ops.chaos`` enumerates every offset and asserts exactly that).
``LATEST`` is advisory only: :meth:`~CheckpointManager.latest_step` falls
back to scanning committed directories when the pointer is stale (a crash
between ``COMMIT`` and ``LATEST`` is benign).

Async writes are a **two-stage pipeline** (the serving gateway's hot-path
contract):

  * :meth:`CheckpointManager.save` runs on the caller (engine) thread and
    only takes host arrays (``np.asarray`` per leaf of a snapshot that
    :meth:`Session.snapshot` copied from the card synchronously, so the
    writer never sees memory still being filled) before handing them to
    the writer — no serialization, no fsync, no disk I/O ever happens on
    the engine thread;
  * a single persistent writer thread serializes (npz), commits, and GCs;
  * lag is bounded by a **one-deep latest-wins mailbox** — if a save
    arrives while the writer is busy and a newer snapshot is already
    queued, the queued one is *skipped and counted*
    (:attr:`~CheckpointManager.skipped`), never queued behind it. The
    writer can fall at most one checkpoint behind; memory stays O(1)
    snapshots however slow the disk is.

Writer failures are sticky: the first exception is re-raised from
:meth:`~CheckpointManager.wait` (and recorded on
:attr:`~CheckpointManager.error`) instead of vanishing on a daemon thread.

Restore accepts a different host count than save (elastic restart) and
never loads damaged data silently — uncommitted directories, unparseable
manifests, truncated shards, missing leaves, and shape/dtype disagreements
all raise a typed :class:`CheckpointCorruptError` naming the offending
file or leaf.
"""
from __future__ import annotations

import io
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

# MarketState leaf names packed by session_tree / snapshot_from_tree.
_SESSION_ARRAY_FIELDS = ("bid", "ask", "last_price", "prev_mid")
# Snapshot keys holding dicts of arrays (packed as subtrees, not JSON meta).
_SESSION_ARRAY_SUBTREES = ("params", "stats", "init")

#: On-disk session-checkpoint format version (the JSON meta leaf carries it).
FORMAT_VERSION = 1

#: Terminal commit-marker filename: a step directory is committed iff this
#: file exists (written last, removed first on rewrite).
COMMIT_NAME = "COMMIT"


class CheckpointError(Exception):
    """Base class for typed checkpoint failures."""


class CheckpointCorruptError(CheckpointError, IOError):
    """The on-disk payload is damaged (truncated / bit-flipped / torn /
    unparseable) or the step directory was never committed.

    Always names the offending file or leaf. Corrupt data must never load
    silently — callers fall back to an earlier step (see
    ``repro_torch.ops.chaos``) or fail loudly.
    """


class CheckpointVersionError(CheckpointError, ValueError):
    """The checkpoint was written by an incompatible format version."""


class CheckpointShapeError(CheckpointError, ValueError):
    """A restored leaf's shape disagrees with the live session, with the
    offending config field (num_markets / num_levels / num_agents) named."""


def session_tree(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """Pack a ``Session.snapshot()`` dict into a checkpointable pytree.

    Array leaves (the book state, the per-market parameter operands, and
    the ``stats_only`` accumulators when present) go in as-is; non-array
    metadata — the step cursor and any stateful-RNG payload (PCG64 state
    holds 128-bit ints that numpy cannot represent) — is JSON-encoded into
    a unicode scalar leaf.
    """
    meta = {k: v for k, v in snapshot.items()
            if k not in _SESSION_ARRAY_FIELDS
            and k not in _SESSION_ARRAY_SUBTREES}
    meta["format_version"] = FORMAT_VERSION
    tree = {
        "state": {k: np.asarray(snapshot[k]) for k in _SESSION_ARRAY_FIELDS},
        "meta": np.asarray(json.dumps(meta)),
    }
    for sub in _SESSION_ARRAY_SUBTREES:
        if snapshot.get(sub) is not None:
            tree[sub] = {k: np.asarray(v) for k, v in snapshot[sub].items()}
    return tree


def snapshot_from_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`session_tree` (for ``Session.restore``).

    Raises :class:`CheckpointCorruptError` when the meta leaf is not valid
    JSON and :class:`CheckpointVersionError` for a format this reader does
    not understand (pre-versioning checkpoints, with no ``format_version``
    key, still load).
    """
    missing = [k for k in ("state", "meta") if k not in tree]
    if missing:
        raise CheckpointCorruptError(
            f"checkpoint tree is missing required subtree(s) {missing}")
    snap: Dict[str, Any] = dict(tree["state"])
    try:
        meta = json.loads(str(tree["meta"]))
    except (json.JSONDecodeError, ValueError) as exc:
        raise CheckpointCorruptError(
            f"checkpoint meta leaf is not valid JSON: {exc}") from exc
    version = meta.pop("format_version", None)
    if version is not None and version != FORMAT_VERSION:
        raise CheckpointVersionError(
            f"checkpoint meta leaf has format_version={version}; this "
            f"reader understands format_version={FORMAT_VERSION}")
    snap.update(meta)
    for sub in _SESSION_ARRAY_SUBTREES:
        if sub in tree:
            snap[sub] = dict(tree[sub])
    return snap


def meta_leaf(meta: Dict[str, Any]) -> np.ndarray:
    """JSON-encode ``meta`` (plus ``format_version``) into a unicode
    scalar leaf — the shared idiom every wire format (session, env,
    trainer) uses for its non-array metadata."""
    out = dict(meta)
    out["format_version"] = FORMAT_VERSION
    return np.asarray(json.dumps(out))


def read_meta(leaf, what: str = "checkpoint") -> Dict[str, Any]:
    """Decode a :func:`meta_leaf`, raising the typed corruption/version
    errors restore paths rely on."""
    try:
        meta = dict(json.loads(str(leaf)))
    except (json.JSONDecodeError, ValueError) as exc:
        raise CheckpointCorruptError(
            f"{what} meta leaf is not valid JSON: {exc}") from exc
    version = meta.pop("format_version", None)
    if version is not None and version != FORMAT_VERSION:
        raise CheckpointVersionError(
            f"{what} meta leaf has format_version={version}; this reader "
            f"understands format_version={FORMAT_VERSION}")
    return meta


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}/#{i}")
    else:
        yield prefix, tree


def _unflatten(flat: Dict[str, Any]):
    root: Dict[str, Any] = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value

    def rebuild(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            items = sorted(node.items(), key=lambda kv: int(kv[0][1:]))
            return tuple(rebuild(v) for _, v in items)
        return {k: rebuild(v) for k, v in node.items()}

    return rebuild(root)


# ---------------------------------------------------------------------------
# durable-write choke point (the chaos tier's torn-write injection surface)
# ---------------------------------------------------------------------------

def _barrier(label: str) -> None:
    """Crash-injection hook called between every durable sub-operation.

    A no-op in production. ``repro_torch.ops.chaos.crash_during_write`` patches
    it to raise after the N-th call, simulating a process crash at that
    exact write offset — the enumeration the torn-write chaos tests sweep.
    """


def _durable_write(path: Path, data: bytes) -> None:
    """Write ``data`` to ``path`` crash-atomically: tmp → fsync → rename.

    A crash at any point leaves either the previous contents of ``path``
    (or no file) or the complete new contents — never a torn file under
    the final name. The mid-write barrier deliberately exposes the
    partial-tmp state to the chaos sweep.
    """
    tmp = path.with_name(path.name + ".tmp")
    _barrier(f"open:{path.name}")
    with open(tmp, "wb") as f:
        half = len(data) // 2
        f.write(data[:half])
        _barrier(f"mid-write:{path.name}")
        f.write(data[half:])
        f.flush()
        _barrier(f"pre-fsync:{path.name}")
        os.fsync(f.fileno())
    _barrier(f"pre-rename:{path.name}")
    os.replace(tmp, path)
    _barrier(f"post-rename:{path.name}")


def _fsync_dir(path: Path) -> None:
    """Fsync a directory so renames inside it are durable (POSIX)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:          # pragma: no cover - exotic filesystems
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    """See the module docstring for the commit protocol and async pipeline.

    ``on_write(step, seconds)`` and ``on_gc(oldest_retained_step)`` are
    optional callbacks fired **on the writer thread** after each commit /
    garbage collection — the serving gateway uses them for write-latency
    metrics and splice-journal compaction. They must be thread-safe.
    """

    def __init__(self, directory, *, host_id: int = 0, num_hosts: int = 1,
                 keep: int = 3, async_write: bool = True,
                 on_write: Optional[Callable[[int, float], None]] = None,
                 on_gc: Optional[Callable[[int], None]] = None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.keep = keep
        self.async_write = async_write
        self.on_write = on_write
        self.on_gc = on_gc
        # ---- async-writer state (all guarded by _cv's lock) ----
        self._cv = threading.Condition()
        self._queued: Optional[Tuple[int, Dict[str, np.ndarray]]] = None
        self._writing: Optional[int] = None
        self._writer: Optional[threading.Thread] = None
        self._stop = False
        self.error: Optional[BaseException] = None  # sticky writer failure
        self.writes = 0            # committed checkpoints
        self.skipped = 0           # saves dropped by the lag-bound policy
        self.last_write_seconds = 0.0

    # ------------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.dir / f"step_{step:08d}"

    # ---- save side ----------------------------------------------------
    def save(self, step: int, tree) -> bool:
        """Persist a pytree; returns True if the save was accepted.

        The caller-thread cost is the device→host mirror only. In async
        mode the snapshot is handed to the writer thread; when the writer
        is busy *and* a newer snapshot is already queued, the queued one is
        replaced (latest wins) and counted in :attr:`skipped` — the
        lag-bounded skip-and-count policy. Returns False only when this
        very snapshot was itself superseded before being accepted (cannot
        happen with a single saver thread). Sync mode writes inline.
        """
        host_arrays = {path: np.asarray(leaf)
                       for path, leaf in _flatten(tree)}
        if not self.async_write:
            self._write(step, host_arrays)
            return True
        with self._cv:
            self._raise_sticky()
            if self._queued is not None:
                # Writer is a full commit behind: drop the stale queued
                # snapshot (never grow a queue), keep the freshest.
                self.skipped += 1
            self._queued = (step, host_arrays)
            self._ensure_writer()
            self._cv.notify_all()
        return True

    @property
    def pending(self) -> int:
        """Snapshots not yet committed (0–2: queued + in-flight write)."""
        with self._cv:
            return (self._queued is not None) + (self._writing is not None)

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every accepted save is committed; re-raises the
        first (sticky) writer failure, if any."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._queued is not None or self._writing is not None:
                remaining = None if deadline is None \
                    else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    raise TimeoutError(
                        f"checkpoint writer still busy after {timeout}s "
                        f"(writing step {self._writing})")
                self._cv.wait(remaining)
            self._raise_sticky()

    def close(self) -> None:
        """Flush and stop the writer thread (idempotent)."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._writer is not None:
            self._writer.join(timeout=60)
            self._writer = None

    def _raise_sticky(self) -> None:
        if self.error is not None:
            raise self.error

    def _ensure_writer(self) -> None:
        if self._writer is None or not self._writer.is_alive():
            self._stop = False
            self._writer = threading.Thread(
                target=self._writer_loop, name="ckpt-writer", daemon=True)
            self._writer.start()

    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while self._queued is None and not self._stop:
                    self._cv.wait()
                if self._queued is None:        # stop requested, fully drained
                    return
                step, host_arrays = self._queued
                self._queued = None
                self._writing = step
            err: Optional[BaseException] = None
            seconds = 0.0
            try:
                seconds = self._write(step, host_arrays)
            except BaseException as exc:        # sticky: surfaced by wait()
                err = exc
            with self._cv:
                self._writing = None
                if err is not None and self.error is None:
                    self.error = err
                self._cv.notify_all()
            if err is None and self.on_write is not None:
                self.on_write(step, seconds)

    # ---- the commit sequence (writer thread, or inline in sync mode) ----
    def _write(self, step: int, host_arrays: Dict[str, np.ndarray]) -> float:
        t0 = time.perf_counter()
        sdir = self._step_dir(step)
        sdir.mkdir(parents=True, exist_ok=True)
        commit = sdir / COMMIT_NAME
        if commit.exists():
            # Rewriting a committed step: uncommit FIRST so a crash during
            # the rewrite can never leave a committed-but-torn directory.
            os.remove(commit)
            _fsync_dir(sdir)
        shard_name = f"shard_{self.host_id:05d}_of_{self.num_hosts:05d}.npz"
        buf = io.BytesIO()
        np.savez(buf, **{k.replace("/", "|"): v
                         for k, v in host_arrays.items()})
        _durable_write(sdir / shard_name, buf.getvalue())
        if self.host_id == 0:
            manifest = {
                "step": step,
                "num_hosts": self.num_hosts,
                "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                           for k, v in host_arrays.items()},
            }
            _durable_write(sdir / "manifest.json",
                           json.dumps(manifest).encode())
            _durable_write(commit, json.dumps(
                {"step": step, "format_version": FORMAT_VERSION}).encode())
            _fsync_dir(sdir)
            _durable_write(self.dir / "LATEST", sdir.name.encode())
            self._gc()
        seconds = time.perf_counter() - t0
        with self._cv:
            self.writes += 1
            self.last_write_seconds = seconds
        return seconds

    def _gc(self) -> None:
        """Drop committed steps beyond ``keep`` plus any dead uncommitted
        directories and stray tmp files (torn-write leftovers)."""
        committed, torn = [], []
        for p in sorted(self.dir.glob("step_*")):
            (committed if (p / COMMIT_NAME).exists() else torn).append(p)
        writing = None
        with self._cv:
            if self._writing is not None:
                writing = self._step_dir(self._writing)
        for p in committed[:-self.keep] if self.keep else []:
            shutil.rmtree(p, ignore_errors=True)
        for p in torn:
            if writing is None or p != writing:
                shutil.rmtree(p, ignore_errors=True)
        for tmp in self.dir.glob("*.tmp"):
            tmp.unlink(missing_ok=True)
        if self.on_gc is not None:
            remaining = self.steps()
            if remaining:
                self.on_gc(remaining[0])

    # ------------------------------------------------------------------
    def _is_committed(self, sdir: Path) -> bool:
        return (sdir / COMMIT_NAME).exists() \
            and (sdir / "manifest.json").exists()

    def latest_step(self) -> Optional[int]:
        """Newest committed step. ``LATEST`` is a fast path only — when the
        pointer is stale or torn (crash between ``COMMIT`` and ``LATEST``)
        this falls back to scanning committed directories."""
        ptr = self.dir / "LATEST"
        if ptr.exists():
            sdir = self.dir / ptr.read_text().strip()
            if self._is_committed(sdir):
                try:
                    pointed = int(sdir.name.split("_")[1])
                except ValueError:
                    pointed = None
                if pointed is not None:
                    all_steps = self.steps()
                    if all_steps and all_steps[-1] == pointed:
                        return pointed
        steps = self.steps()
        return steps[-1] if steps else None

    def steps(self) -> "list[int]":
        """All **committed** checkpoint steps (terminal ``COMMIT`` marker
        present), ascending — the fallback ladder an elastic/resilient
        restore walks down. Torn/uncommitted directories never appear."""
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if self._is_committed(p):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    continue
        return out

    def restore(self, step: Optional[int] = None):
        """Load the pytree (elastic: any current host count may read).

        Damaged payloads never load silently: an uncommitted step directory
        (no terminal ``COMMIT`` marker — a torn write), an unparseable
        manifest, an unreadable/truncated shard, a missing leaf, or a leaf
        whose shape/dtype disagrees with the manifest raises
        :class:`CheckpointCorruptError` naming the offending file or leaf.
        """
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            return None
        sdir = self._step_dir(step)
        if not (sdir / COMMIT_NAME).exists():
            if not sdir.exists():
                raise FileNotFoundError(
                    f"checkpoint step {step}: no directory {sdir.name}")
            raise CheckpointCorruptError(
                f"checkpoint step {step}: directory {sdir.name} has no "
                f"{COMMIT_NAME} marker — the write never committed (torn "
                "write or crash mid-commit); refusing to load")
        try:
            manifest = json.loads((sdir / "manifest.json").read_text())
            leaves = dict(manifest["leaves"])
        except FileNotFoundError:
            raise
        except Exception as exc:
            raise CheckpointCorruptError(
                f"checkpoint step {step}: manifest.json is unreadable or "
                f"not valid JSON ({type(exc).__name__}: {exc})") from exc
        flat: Dict[str, np.ndarray] = {}
        for shard in sorted(sdir.glob("shard_*.npz")):
            try:
                with np.load(shard) as z:
                    for k in z.files:
                        flat[k.replace("|", "/")] = z[k]
            except Exception as exc:  # BadZipFile / EOFError / ValueError...
                raise CheckpointCorruptError(
                    f"checkpoint step {step}: shard {shard.name} is "
                    f"corrupt ({type(exc).__name__}: {exc})") from exc
        missing = set(leaves) - set(flat)
        if missing:
            raise CheckpointCorruptError(
                f"checkpoint step {step} missing leaves: "
                f"{sorted(missing)[:5]}")
        for name, info in leaves.items():
            arr = flat[name]
            if (list(arr.shape) != list(info["shape"])
                    or str(arr.dtype) != info["dtype"]):
                raise CheckpointCorruptError(
                    f"checkpoint step {step}: leaf {name!r} has "
                    f"shape={list(arr.shape)} dtype={arr.dtype}, manifest "
                    f"says shape={info['shape']} dtype={info['dtype']}")
        return _unflatten(flat)
