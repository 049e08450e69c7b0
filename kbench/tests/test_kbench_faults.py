"""A run with the timed path broken underneath comes out not correct.

Each cell is run on the CPU at a tiny size (``tiny``), past the harness's
look for a card, with one fault planted in the program: a step that
returns its state unchanged, half of the batch left out, an answer
altered where it is produced; and in the trainer an update that keeps
its state, minibatches of half their rows, an update counter that does
not advance between updates, and a call that makes one update fewer. The
sound run comes out correct."""
import functools
import time

import pytest
import torch

from kbench import harness
from kbench.manifest import Bench
from kbench.tests import tiny

from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.train import ppo as ppo_mod


def broken_chunk(fault):
    real = kc.kinetic_clearing_chunk

    @functools.wraps(real)
    def chunk(bid, ask, last, pmid, *args, **kw):
        out = list(real(bid, ask, last, pmid, *args, **kw))
        if fault == "unchanged":
            out[:4] = [bid, ask, last, pmid]
        elif fault == "half_batch":
            half = bid.shape[0] // 2
            for k, x in enumerate((bid, ask, last, pmid)):
                out[k] = torch.cat([out[k][:half], x[half:]])
            if kw.get("stats_only"):
                out[4] = type(out[4])(*(torch.cat([a[:half], b[half:]])
                                        for a, b in zip(out[4], kw["stats"])))
            else:
                for k in (4, 5, 6):
                    out[k] = out[k].clone()
                    out[k][half:] = 0.0
        elif fault == "answer":
            if kw.get("stats_only"):
                out[4] = out[4]._replace(sum_volume=out[4].sum_volume + 1.0)
            else:
                out[5] = out[5].clone()
                out[5][:, 0] += 1.0
        return tuple(out)

    return chunk


def run(root, cell):
    return harness.run_cell(Bench(root), cell, 2**31 + 3, 0.2, False,
                            torch.device("cpu"), time.perf_counter())


CELLS = ("sweep.table4", "sweep.wide_book", "train.table4")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("kbench"))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(root, cell):
    r = run(root, cell)
    assert r["correct"] and r["failed"] == 0
    assert all(c["value"] == 0.0 for c in r["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer"])
def test_broken_kernel_is_caught(root, cell, fault, monkeypatch):
    monkeypatch.setattr(kc, "kinetic_clearing_chunk", broken_chunk(fault))
    r = run(root, cell)
    assert not r["correct"], r["checks"]


def test_an_update_that_keeps_its_state_is_caught(root, monkeypatch):
    real = ppo_mod.PPOTrainer.update

    def update(self, ts):
        new, metrics = real(self, ts)
        return new._replace(params=ts.params, opt_state=ts.opt_state), \
            metrics

    monkeypatch.setattr(ppo_mod.PPOTrainer, "update", update)
    r = run(root, "train.table4")
    assert not r["correct"]
    assert r["checks"]["param_change_gap"]["value"] == 1.0


def test_minibatches_of_half_their_rows_are_caught(root, monkeypatch):
    real = ppo_mod.buffers.take

    def take(tree, idx):
        return real(tree, idx[:idx.shape[0] // 2])

    monkeypatch.setattr(ppo_mod.buffers, "take", take)
    r = run(root, "train.table4")
    assert not r["correct"]


def test_an_update_counter_that_stays_is_caught(root, monkeypatch):
    real = ppo_mod.PPOTrainer.update

    def update(self, ts):
        new, metrics = real(self, ts)
        return new._replace(update_idx=ts.update_idx), metrics

    monkeypatch.setattr(ppo_mod.PPOTrainer, "update", update)
    r = run(root, "train.table4")
    assert not r["correct"]
    assert r["checks"]["loss_rel_gap"]["value"] > 0.0


def test_a_call_that_skips_an_update_is_caught(root, monkeypatch):
    real = ppo_mod.PPOTrainer.train

    def train(self, ts, num_updates=None):
        return real(self, ts, num_updates - 1)

    monkeypatch.setattr(ppo_mod.PPOTrainer, "train", train)
    r = run(root, "train.table4")
    assert not r["correct"]
    assert r["checks"]["loss_rel_gap"]["value"] == float("inf")
