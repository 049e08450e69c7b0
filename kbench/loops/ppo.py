"""The ``ppo`` traffic: a PPO training loop over the market-maker env.

The ensemble is the traffic's scenario blocks at the configuration's
widths (agents, levels), its horizon the rollout length. Set-up builds one
trainer (``Engine(backend).trainer(spec, PPOConfig(...), reward=Sum(
(SpreadCapture(), InventoryPenalty(w))), obs=MarketFeatures())``), drives
it from the seed through one call of the window's own
(``tr.train(ts, updates_per_call)``), keeping what the check compares,
makes that call once more and hands the same train state to the window.
The window loops ``ts, m = tr.train(ts, updates_per_call)`` and reads
``m`` to the host after each call, as a training logger does.

``train_transitions_per_s`` is M × rollout_len × the updates completed
over the window's wall, to the end of the last call whose metrics were
read. The check: the plain reference (``kbench/reference/ppo.py``) follows
the first call's ``updates_per_call`` updates from the same seed, and
three numbers are held to the traffic's limits: every update's loss as
the call's metrics report it, Adam's first moment after the call and the
parameters' change over it (see ``kbench.reference.ppo.compare``).
"""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List

import torch

from kbench import trace
from kbench.harness import Check
from kbench.reference import market as mk
from kbench.reference import ppo as ref

MASK = 0xFFFFFFFF


def tree_leaves(tree) -> List[torch.Tensor]:
    """Leaves of a params or moment tree: dict keys sorted, sequences in
    order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def clones(tree) -> List[torch.Tensor]:
    return [x.detach().clone() for x in tree_leaves(tree)]


class Loop:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed = int(seed)
        self.device = device
        self.A = int(config["num_agents"])
        self.L = int(config["num_levels"])
        self.blocks = traffic["blocks"]
        self.M = sum(int(b["markets"]) for b in self.blocks)
        if self.M != int(config["num_markets"]):
            raise ValueError("the traffic's blocks must hold the "
                             "configuration's num_markets")
        self.ppo = dict(traffic["ppo"])
        self.T = int(self.ppo["rollout_len"])
        self.U = int(traffic["updates_per_call"])
        self.attempted = self.failed = 0
        self.info: Dict = {}
        self.prog = None   # the program's readings (ref.Readings)
        self.updates = 0

    def spec_seed(self) -> int:
        return self.seed & MASK

    def market(self, block) -> Dict:
        m = dict(self.config["market"])
        m.update(block["market"])
        return m

    def setup(self) -> None:
        from repro_torch.core.params import EnsembleSpec
        from repro_torch.core.session import Engine
        from repro_torch.env import (InventoryPenalty, MarketFeatures,
                                     SpreadCapture, Sum)
        from repro_torch.train import PPOConfig

        sizes = {int(b["markets"]) for b in self.blocks}
        if len(sizes) != 1:
            raise ValueError("the scenario blocks must be of one size")
        spec = EnsembleSpec.from_scenarios(
            [b["scenario"] for b in self.blocks], num_markets=sizes.pop(),
            num_agents=self.A, num_levels=self.L, num_steps=self.T,
            seed=self.spec_seed())
        cfg = PPOConfig(**{**self.ppo, "hidden": tuple(self.ppo["hidden"]),
                           "seed": self.seed})
        self.engine = Engine(self.traffic["backend"], device=self.device,
                             autotune=self.traffic["autotune"])
        reward = Sum((SpreadCapture(),
                      InventoryPenalty(float(self.traffic["inventory_weight"]
                                             ))))
        self.trainer = self.engine.trainer(spec, cfg, reward=reward,
                                           obs=MarketFeatures())
        ts = self.trainer.init()
        params0 = clones(ts.params)
        ts, m = self.trainer.train(ts, self.U)
        losses = [float(x) for x in m["loss"].cpu()]
        self.prog = ref.Readings(losses, clones(ts.opt_state.mu), params0,
                                 clones(ts.params))
        ts, m = self.trainer.train(ts, self.U)
        {k: v.cpu() for k, v in m.items()}
        self.ts = ts
        self.info["graphs"] = len(self.trainer.graphs())

    def call(self, spans: bool = False) -> None:
        with trace.span("train", spans):
            self.ts, m = self.trainer.train(self.ts, self.U)
        with trace.span("metrics", spans):
            host = {k: v.cpu() for k, v in m.items()}
        self.attempted += self.U
        self.updates += self.U
        self.last_loss = float(host["loss"][-1])

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.call()
        wall = time.perf_counter() - t0
        rate = self.updates * self.M * self.T / wall
        self.info.update(window_s=wall, updates=self.updates,
                         last_loss=self.last_loss)
        return {"train_transitions_per_s": rate}

    def traced(self) -> trace.Slice:
        before = self.updates
        sl = trace.profile(lambda: self.call(spans=True))
        self.slice_updates = self.updates - before
        self.info.update(slice_updates=self.slice_updates, slice_s=sl.wall_s,
                         slice_train_transitions_per_s=self.slice_updates
                         * self.M * self.T / sl.wall_s)
        return sl

    def context(self) -> SimpleNamespace:
        return SimpleNamespace(
            env_steps_in_slice=getattr(self, "slice_updates", 0) * self.T)

    def release(self) -> None:
        self.trainer = self.engine = self.ts = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ----
    def settings(self) -> ref.Settings:
        p = self.ppo
        return ref.Settings(
            num_agents=self.A, num_levels=self.L, horizon=self.T,
            rollout_len=self.T, num_epochs=int(p["num_epochs"]),
            num_minibatches=int(p["num_minibatches"]),
            gamma=float(p["gamma"]), gae_lambda=float(p["gae_lambda"]),
            clip_eps=float(p["clip_eps"]), vf_coef=float(p["vf_coef"]),
            ent_coef=float(p["ent_coef"]), lr=float(p["lr"]),
            max_grad_norm=float(p["max_grad_norm"]),
            hidden=tuple(p["hidden"]), k_max=int(p["k_max"]),
            qty=float(p["qty"]),
            inventory_weight=float(self.traffic["inventory_weight"]),
            seed=self.seed)

    def rows(self) -> mk.Rows:
        cols = mk.stack_columns([
            mk.columns(self.market(b), self.A, self.L, int(b["markets"]),
                       self.device) for b in self.blocks])
        return mk.Rows(
            torch.full((self.M, 1), self.spec_seed(), dtype=torch.int64,
                       device=self.device),
            torch.arange(self.M, device=self.device)[:, None], cols)

    def reference(self, mode: str) -> ref.Readings:
        return ref.train(self.rows(), self.settings(), self.U, mode=mode)

    def readings(self, controls: bool = True) -> Dict[str, Dict[str, float]]:
        """The compared numbers for the program, and with ``controls`` for
        the control (the reference with TF32 products in the program's
        place) and each planted fault (the faulty reference against the
        sound one)."""
        clean = self.reference("float32")
        out = {"program": ref.compare(self.prog, clean)}
        if controls:
            out["control_tf32"] = ref.compare(self.reference("tf32"), clean)
            for mode in ref.MODES[2:]:
                out[f"fault_{mode}"] = ref.compare(self.reference(mode),
                                                   clean)
        return out

    def check(self) -> List[Check]:
        got = ref.compare(self.prog, self.reference("float32"))
        limits = self.traffic["limits"]
        return [Check(k, got[k], float(limits[k])) for k in sorted(limits)]
