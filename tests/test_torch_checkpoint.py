"""The port's CheckpointManager and session checkpoints on the CPU.

Analogues of ``tests/test_checkpoint.py``: every damage mode a restore can
hit raises a typed error naming the offending file, leaf or field, the
COMMIT-marker protocol and the async latest-wins writer hold, and a crash
at any durable-write offset never restores a torn checkpoint. The format is
the JAX package's: a checkpoint written by either package restores in the
other, and the next chunk is equal bit for bit.
"""
import dataclasses
import json
import threading

import numpy as np
import pytest

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core.config import scenario_config as j_scenario_config
from repro.core.session import Engine as JEngine
from repro_torch.checkpoint.manager import (COMMIT_NAME, FORMAT_VERSION,
                                            CheckpointCorruptError,
                                            CheckpointError,
                                            CheckpointManager,
                                            CheckpointShapeError,
                                            CheckpointVersionError,
                                            session_tree, snapshot_from_tree)
from repro_torch.core.config import MarketConfig, scenario_config
from repro_torch.core.session import Engine
from repro_torch.ops.chaos import corrupt_checkpoint

CFG = MarketConfig(num_markets=4, num_agents=16, num_levels=16, num_steps=12,
                   seed=3)
CPU = {"device": "cpu"}


def _engine(backend="cuda-kinetic", **kw):
    return Engine(backend, **CPU, **kw)


def _saved_manager(tmp_path, cfg=CFG, backend="cuda-kinetic"):
    sess = _engine(backend).open(cfg)
    sess.run(5)
    mgr = CheckpointManager(tmp_path, async_write=False)
    step = sess.save_checkpoint(mgr)
    return mgr, step, sess


# ---- corrupt payloads ----

def test_truncated_shard_raises_typed_error(tmp_path):
    mgr, step, _ = _saved_manager(tmp_path)
    victim = corrupt_checkpoint(mgr.dir, step, "truncate", "shard")
    with pytest.raises(CheckpointCorruptError, match=victim.name):
        mgr.restore(step)


def test_bitflipped_shard_raises_typed_error(tmp_path):
    mgr, step, _ = _saved_manager(tmp_path)
    victim = corrupt_checkpoint(mgr.dir, step, "bitflip", "shard")
    with pytest.raises(CheckpointCorruptError, match=victim.name):
        mgr.restore(step)


def test_corrupt_manifest_raises_typed_error(tmp_path):
    mgr, step, _ = _saved_manager(tmp_path)
    corrupt_checkpoint(mgr.dir, step, "truncate", "manifest")
    with pytest.raises(CheckpointCorruptError, match="manifest"):
        mgr.restore(step)


def test_missing_leaf_raises_typed_error(tmp_path):
    mgr, step, _ = _saved_manager(tmp_path)
    sdir = mgr.dir / f"step_{step:08d}"
    manifest = json.loads((sdir / "manifest.json").read_text())
    manifest["leaves"]["state/not_a_real_leaf"] = {"shape": [1],
                                                   "dtype": "float32"}
    (sdir / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(CheckpointCorruptError, match="not_a_real_leaf"):
        mgr.restore(step)


def test_manifest_shape_mismatch_raises_typed_error(tmp_path):
    mgr, step, _ = _saved_manager(tmp_path)
    sdir = mgr.dir / f"step_{step:08d}"
    manifest = json.loads((sdir / "manifest.json").read_text())
    manifest["leaves"]["state/bid"]["shape"] = [99, 99]
    (sdir / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(CheckpointCorruptError, match="state/bid"):
        mgr.restore(step)


# ---- wrong format version ----

def test_wrong_version_meta_leaf_raises_version_error(tmp_path):
    _, _, sess = _saved_manager(tmp_path)
    tree = session_tree(sess.snapshot())
    meta = json.loads(str(tree["meta"]))
    assert meta["format_version"] == FORMAT_VERSION
    meta["format_version"] = FORMAT_VERSION + 1
    tree["meta"] = np.asarray(json.dumps(meta))
    with pytest.raises(CheckpointVersionError, match="format_version"):
        snapshot_from_tree(tree)


def test_preversioning_meta_still_loads(tmp_path):
    _, _, sess = _saved_manager(tmp_path)
    tree = session_tree(sess.snapshot())
    meta = json.loads(str(tree["meta"]))
    meta.pop("format_version")
    tree["meta"] = np.asarray(json.dumps(meta))
    snap = snapshot_from_tree(tree)
    assert snap["t"] == 5 and "format_version" not in snap


def test_garbage_meta_leaf_raises_corrupt_error(tmp_path):
    _, _, sess = _saved_manager(tmp_path)
    tree = session_tree(sess.snapshot())
    tree["meta"] = np.asarray("{not json")
    with pytest.raises(CheckpointCorruptError, match="JSON"):
        snapshot_from_tree(tree)


# ---- restore-time (M, A, L) shape mismatches name the offending field ----

@pytest.mark.parametrize("field,override", [
    ("num_markets", dict(num_markets=6)),
    ("num_levels", dict(num_levels=32)),
])
def test_shape_mismatch_on_restore_names_field(tmp_path, field, override):
    snap = _engine().open(dataclasses.replace(CFG, **override)).snapshot()
    sess = _engine().open(CFG)
    with pytest.raises(CheckpointShapeError, match=field):
        sess.restore(snap)
    assert sess.step_count == 0        # untouched and usable
    sess.run(2)


def test_num_agents_mismatch_names_field():
    snap = _engine().open(dataclasses.replace(CFG, num_agents=32)).snapshot()
    sess = _engine().open(CFG)
    with pytest.raises(CheckpointShapeError, match="num_agents"):
        sess.restore(snap)
    with pytest.raises(ValueError):
        sess.restore(snap)


def test_params_leaf_shape_mismatch_names_num_markets():
    snap = _engine().open(CFG).snapshot()
    bad = dict(snap)
    bad["params"] = {k: np.vstack([v, v]) for k, v in snap["params"].items()}
    sess = _engine().open(CFG)
    with pytest.raises(CheckpointShapeError, match="num_markets"):
        sess.restore(bad)


def test_error_hierarchy():
    assert issubclass(CheckpointCorruptError, CheckpointError)
    assert issubclass(CheckpointCorruptError, IOError)
    assert issubclass(CheckpointVersionError, ValueError)
    assert issubclass(CheckpointShapeError, ValueError)


# ---- steps() listing ----

def test_steps_lists_committed_checkpoints(tmp_path):
    sess = _engine("torch-scan").open(dataclasses.replace(CFG, num_steps=40))
    mgr = CheckpointManager(tmp_path, async_write=False, keep=10)
    for _ in range(3):
        sess.run(4)
        sess.save_checkpoint(mgr)
    assert mgr.steps() == [4, 8, 12]
    assert mgr.latest_step() == 12
    (mgr.dir / "step_00000099").mkdir()
    assert mgr.steps() == [4, 8, 12]


# ---- the COMMIT-marker protocol ----

def test_uncommitted_dir_skipped_and_restore_refused(tmp_path):
    sess = _engine("torch-scan").open(dataclasses.replace(CFG, num_steps=40))
    mgr = CheckpointManager(tmp_path, async_write=False, keep=10)
    sess.run(4)
    sess.save_checkpoint(mgr)
    sess.run(4)
    sess.save_checkpoint(mgr)
    (mgr.dir / "step_00000008" / COMMIT_NAME).unlink()
    assert mgr.steps() == [4]
    assert mgr.latest_step() == 4    # LATEST is stale -> fallback scan
    with pytest.raises(CheckpointCorruptError, match=COMMIT_NAME):
        mgr.restore(8)


def test_async_latest_wins_mailbox_skips_and_counts(tmp_path):
    """While the writer is mid-commit, newer saves replace the queued
    snapshot (latest wins, counted in .skipped) instead of growing a
    queue."""
    import repro_torch.checkpoint.manager as ckpt_mod

    sess = _engine("torch-scan").open(dataclasses.replace(CFG, num_steps=64))
    trees = {}
    for step in (4, 8, 12, 16):
        sess.run(4)
        trees[step] = session_tree(sess.snapshot())
    gate = threading.Event()
    entered = threading.Event()
    real = ckpt_mod._barrier

    def blocking_barrier(label):
        entered.set()
        gate.wait(30)

    mgr = CheckpointManager(tmp_path, async_write=True, keep=10)
    ckpt_mod._barrier = blocking_barrier
    try:
        assert mgr.save(4, trees[4])
        assert entered.wait(30)      # writer is stalled inside step 4
        mgr.save(8, trees[8])
        mgr.save(12, trees[12])      # replaces 8 (skip-and-count)
        mgr.save(16, trees[16])      # replaces 12
        assert mgr.pending == 2
        gate.set()
        mgr.wait()
    finally:
        ckpt_mod._barrier = real
        mgr.close()
    assert mgr.writes == 2 and mgr.skipped == 2 and mgr.pending == 0
    assert mgr.steps() == [4, 16]
    assert mgr.error is None and mgr.last_write_seconds > 0.0


def test_torn_write_sweep_never_restores_corrupt_state(tmp_path):
    """Crash at EVERY durable-write offset inside a commit: the reopened
    ladder restores the previous committed step or the complete new one,
    never the torn directory."""
    from repro_torch.ops import (SimulatedCrash, count_write_ops,
                                 crash_during_write)

    sess = _engine().open(dataclasses.replace(CFG, num_steps=40))
    sess.run(4)
    tree4 = session_tree(sess.snapshot())
    sess.run(4)
    tree8 = session_tree(sess.snapshot())
    ops = count_write_ops(
        CheckpointManager(tmp_path / "probe", async_write=False), 8, tree8)
    assert ops >= 15
    for k in range(ops):
        mgr = CheckpointManager(tmp_path / f"op{k}", async_write=False)
        mgr.save(4, tree4)
        with crash_during_write(k), pytest.raises(SimulatedCrash):
            mgr.save(8, tree8)
        mgr2 = CheckpointManager(tmp_path / f"op{k}", async_write=False)
        latest = mgr2.latest_step()
        assert latest in (4, 8), (k, latest)
        want = tree4 if latest == 4 else tree8
        got = mgr2.restore(latest)
        for key in ("bid", "ask", "last_price", "prev_mid"):
            assert np.array_equal(got["state"][key], want["state"][key]), \
                (k, key)
        assert str(got["meta"]) == str(want["meta"]), k
        if latest == 4:
            assert 8 not in mgr2.steps()
            if (mgr2.dir / "step_00000008").exists():
                with pytest.raises(CheckpointCorruptError, match=COMMIT_NAME):
                    mgr2.restore(8)


# ---- checkpoints carried across packages ----

XKW = dict(num_markets=3, num_agents=16, num_levels=16, num_steps=40, seed=5)


def _next_chunk_equal(got, want):
    for f in ("price", "volume", "mid"):
        assert (np.asarray(getattr(got, f))
                == np.asarray(getattr(want, f))).all(), f


@pytest.mark.parametrize("saver", ["repro", "repro_torch"])
def test_checkpoint_restores_across_packages(tmp_path, saver):
    """A checkpoint written by one package's manager restores through the
    other's ``Session.restore_checkpoint``, and the next chunk of the
    restored session equals the saving session's next chunk bit for bit."""
    jsess = JEngine("jax-scan").open(j_scenario_config("flash-crash", **XKW),
                                     chunk_size=8)
    tsess = _engine().open(scenario_config("flash-crash", **XKW),
                           chunk_size=8)
    if saver == "repro":
        jsess.run(16)
        jsess.save_checkpoint(JManager(tmp_path, async_write=False))
        step = tsess.restore_checkpoint(
            CheckpointManager(tmp_path, async_write=False))
        saved, restored = jsess, tsess
    else:
        tsess.run(16)
        tsess.save_checkpoint(CheckpointManager(tmp_path, async_write=False))
        step = jsess.restore_checkpoint(JManager(tmp_path, async_write=False))
        saved, restored = tsess, jsess
    assert step == 16 and restored.step_count == 16
    assert restored.spec.scenarios == saved.spec.scenarios
    _next_chunk_equal(restored.run(8).to_numpy(), saved.run(8).to_numpy())
