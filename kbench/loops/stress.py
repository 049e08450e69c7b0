"""The ``stress`` traffic: a closed loop of one stress-testing client over
a coupled scenario mix.

The configuration's ``blocks`` are scenario presets side by side,
``markets_per_block`` markets each, and its ``coupling`` a ring. The spec
is built once the way a user builds it: ``EnsembleSpec.from_scenarios``
over the preset names with the configuration's ``overrides`` (an
arbitrageur share and its κ), then ``CouplingSpec.ring(M, offset)``
applied. Each ensemble of the window re-seeds that spec (the seed rule of
``sweep``) and runs ``Engine(backend, stats_only=True).open(spec)
.run(num_steps)``, then reads ``Session.stats``, as ``sweep`` does; its
end-to-end metrics are ``sweep``'s.

The check: ``rows_per_block`` markets of every block of every ensemble,
drawn from the seed, are kept. The coupling makes a market's outputs
depend on its peers, so the plain reference
(``kbench/reference/coupled.py``) simulates each kept market with its ring
cone (``coupled.cone``: the peers its outputs read, each as far as they
are read), from the configuration's plain numbers, once the window has
closed; every value has to be equal. The readings add three planted
faults in the reference: the peer read at every step, every market
tracking itself, and block :data:`SHIFTED_BLOCK`'s params starting one row
late (its first row keeps the block before's, and it takes the next
block's first row).

The roofline's count (``kbench/count.py``) is ``count.ensemble_ops`` over
the blocks' summed archetype mix. It leaves out the flash-crash block's
one-step cancel of resting bids, about 4·10^5 operations an ensemble
(1024 markets × 128 levels × a floor, a multiply, a subtract and a
select), under 10^-5 of the count.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np
import torch

from kbench import count
from kbench.loops import sweep
from kbench.reference import coupled
from kbench.reference import market as ref

MASK = sweep.MASK
#: The planted faults of :meth:`Loop.readings`, each in the reference.
FAULTS = ("every_step", "uncoupled", "shifted_block")
#: The block the ``shifted_block`` fault moves. A shift shows only in the
#: two rows at the block's edges, and a kept market sees it only where its
#: cone reaches one of them (at the cell's size in about 3% of the
#: ensembles). At the ``hft`` block both edge rows' mids move otherwise
#: from the first steps; the mids of ``baseline`` and ``flash-crash``
#: markets hardly move, so a shift between those would show only in a kept
#: edge row's own volume.
SHIFTED_BLOCK = 2


class Loop(sweep.Loop):
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed = int(seed)
        self.device = device
        self.M = int(config["num_markets"])
        self.A = int(config["num_agents"])
        self.L = int(config["num_levels"])
        self.S = int(config["num_steps"])
        self.blocks = list(config["blocks"])
        self.per_block = int(config["markets_per_block"])
        if self.per_block * len(self.blocks) != self.M:
            raise ValueError(
                f"{len(self.blocks)} blocks of {self.per_block} markets are "
                f"not num_markets={self.M}")
        if config["coupling"]["kind"] != "ring":
            raise ValueError(f"unknown coupling {config['coupling']!r}")
        self.offset = int(config["coupling"]["offset"])
        self.chunk = int(traffic["chunk"])
        self.stats_only = bool(config.get("stats_only", False))
        self.items: List[sweep.Item] = []
        self.window_items = 0
        self.attempted = self.failed = 0
        self.info: Dict = {}
        self.engine = None
        self.base = None
        self.templates = None

    # ---- the program's side ----
    def build(self):
        """The spec as a user builds it: the presets, the overrides, the
        ring."""
        from repro_torch.core.params import EnsembleSpec
        from repro_torch.scenario import CouplingSpec

        spec = EnsembleSpec.from_scenarios(
            [b["scenario"] for b in self.blocks],
            num_markets=self.per_block, num_agents=self.A,
            num_levels=self.L, num_steps=self.S, seed=0,
            **self.config["overrides"])
        return CouplingSpec.ring(self.M, self.offset).apply(spec)

    def spec(self, i: int):
        if self.base is None:
            self.base = self.build()
        return dataclasses.replace(self.base, seed=self.ensemble_seed(i))

    def kept_rows(self, i: int) -> np.ndarray:
        n = min(self.per_block, int(self.traffic["rows_per_block"]))
        gen = np.random.default_rng([self.seed & MASK,
                                     (self.seed >> 32) & MASK, i])
        return np.sort(np.concatenate([
            b * self.per_block + gen.choice(self.per_block, size=n,
                                            replace=False)
            for b in range(len(self.blocks))]))

    def context(self) -> SimpleNamespace:
        mix: Dict[int, int] = {}
        for b in self.blocks:
            for k, n in count.mix_of(ref.agent_counts(b["market"], self.A),
                                     self.per_block, self.A).items():
                mix[k] = mix.get(k, 0) + n
        win = self.items[:self.window_items]
        return SimpleNamespace(
            ensembles_in_slice=len(self.items) - self.window_items,
            ops_per_ensemble=count.ensemble_ops(
                self.M, self.A, self.L, self.S, mix, self.stats_only),
            bytes_per_ensemble=count.ensemble_bytes(
                self.M, self.L, self.S, self.chunk, self.stats_only),
            host_s_per_ensemble=float(np.mean([it.host_s for it in win])),
            kernel=self.traffic["kernel"])

    # ---- the check ----
    def peer_of(self, m: int) -> int:
        return (m + self.offset) % self.M

    def plan(self, it: sweep.Item, fault: Optional[str]):
        """``(markets, peer, steps, kept)`` of one ensemble: its kept
        markets' cones, and the kept markets' positions among them."""
        need = coupled.cone(it.rows.tolist(), self.peer_of, self.S,
                            self.chunk)
        markets, peer, steps = coupled.rows_of(need, self.peer_of)
        if fault == "uncoupled":
            peer = list(range(len(markets)))
        pos = {m: k for k, m in enumerate(markets)}
        return markets, peer, steps, [pos[m] for m in it.rows.tolist()]

    def block_of(self, ids: torch.Tensor, fault: Optional[str]):
        P, b = self.per_block, SHIFTED_BLOCK
        if fault == "shifted_block":
            ids = ids - ((ids >= b * P) & (ids <= (b + 1) * P)).to(ids.dtype)
        return ids // P

    def reference(self, fdt, fault: Optional[str] = None
                  ) -> List[np.ndarray]:
        """The reference's outputs for the kept rows of every item, in
        batches of whole ensembles of at most ``check_block_rows`` rows, as
        float32 arrays of the kept outputs' shapes; ``fault`` plants one of
        :data:`FAULTS`."""
        if self.templates is None:
            self.templates = ref.stack_columns([
                ref.columns(b["market"], self.A, self.L, 1, self.device)
                for b in self.blocks])
        limit = int(self.traffic["check_block_rows"])
        outs, batch, rows = [], [], 0
        self.info["reference_rows"] = 0
        for it in self.items:
            plan = self.plan(it, fault)
            if batch and rows + len(plan[0]) > limit:
                outs.append(self.run_batch(batch, fdt, fault))
                batch, rows = [], 0
            batch.append((it, plan))
            rows += len(plan[0])
            self.info["reference_rows"] += len(plan[0])
        if batch:
            outs.append(self.run_batch(batch, fdt, fault))
        return outs

    def run_batch(self, batch, fdt, fault: Optional[str]) -> np.ndarray:
        seeds, ids, peer, steps, kept = [], [], [], [], []
        for it, (markets, p, s, k) in batch:
            base = len(ids)
            seeds += [self.ensemble_seed(it.i)] * len(markets)
            ids += markets
            peer += [base + x for x in p]
            steps += s
            kept += [base + x for x in k]

        def col(values):
            return torch.tensor(values, dtype=torch.int64, device=self.device)

        ids_t = col(ids)
        blk = self.block_of(ids_t, fault)
        rows = ref.Rows(col(seeds)[:, None], ids_t[:, None],
                        {k: v[blk] for k, v in self.templates.items()})
        got = coupled.simulate(
            rows, col(peer), col(steps), self.A, self.L, self.S, self.chunk,
            fdt=fdt, stats_only=self.stats_only,
            refresh=1 if fault == "every_step" else None)
        kept_t = col(kept)
        return np.stack([x[kept_t].float().cpu().numpy() for x in got])

    def readings(self, controls: bool = True) -> Dict[str, Dict[str, float]]:
        """The compared number for the program, and with ``controls`` for
        the control (the reference in bfloat16 in the program's place) and
        each planted fault (the faulty reference in the program's place)."""
        out = {"program": {"mismatched_values":
                           self.mismatches(torch.float32)}}
        if controls:
            out["control_bfloat16"] = {"mismatched_values":
                                       self.mismatches(torch.bfloat16)}
            for fault in FAULTS:
                out[f"fault_{fault}"] = {"mismatched_values":
                                         self.mismatches(torch.float32,
                                                         fault)}
        return out

    def mismatches(self, fdt, fault: Optional[str] = None) -> float:
        """Values of the kept rows where the program and the reference in
        ``fdt`` (with ``fault`` planted) differ (NaN equal to NaN)."""
        want = np.concatenate(self.reference(fdt, fault), axis=1)
        got = self.program_outputs()
        same = (got == want) | (np.isnan(got) & np.isnan(want))
        bad = int(same.size - same.sum())
        ends = np.cumsum([len(it.rows) for it in self.items])
        self.failed = sum(not same[:, e - len(it.rows):e].all()
                          for e, it in zip(ends, self.items))
        self.info.update(rows_checked=int(got.shape[1]),
                         values_checked=int(got.size))
        return float(bad)
