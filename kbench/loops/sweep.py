"""The ``sweep`` traffic: a closed loop of one scenario-sweep client.

Each ensemble of the window is a fresh seed ``(seed * seed_stride + i) mod
2**32`` (``i`` from 1; ``i = 0`` warms up in set-up) and runs
``Engine(backend).open(spec).run(num_steps)``, then copies its outputs to
the host: the price, volume and mid paths, or with ``stats_only`` the six
accumulators of ``Session.stats``. Every ensemble has the same shapes, so
the work of a run is fixed by its length alone.

``agent_events_per_s`` is M·A·S of every ensemble completed in the window
over the window's wall, up to the host holding the last one's outputs.
``ensemble_ms_p95`` is the 95th percentile of the ensembles' times from
the ``open`` call to the outputs on the host, each read on the host's
clock.

The check: ``rows_checked`` markets of every ensemble, drawn from the
seed, are kept and simulated again by the plain reference once the window
has closed; every value has to be equal.
"""
from __future__ import annotations

import math
import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from kbench import count, trace
from kbench.harness import Check
from kbench.reference import market as ref

MASK = 0xFFFFFFFF


class Item(SimpleNamespace):
    """One ensemble: its seed, the rows kept, their outputs and times."""


class Loop:
    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed = int(seed)
        self.device = device
        self.M = int(config["num_markets"])
        self.A = int(config["num_agents"])
        self.L = int(config["num_levels"])
        self.S = int(config["num_steps"])
        self.market = dict(config["market"])
        self.stats_only = bool(config.get("stats_only", False))
        self.items: List[Item] = []
        self.window_items = 0
        self.attempted = self.failed = 0
        self.info: Dict = {}
        self.engine = None

    # ---- the program's side ----
    def ensemble_seed(self, i: int) -> int:
        return (self.seed * int(self.traffic["seed_stride"]) + i) & MASK

    def spec(self, i: int):
        from repro_torch.core.config import MarketConfig
        from repro_torch.core.params import EnsembleSpec

        cfg = MarketConfig(num_markets=self.M, num_agents=self.A,
                           num_levels=self.L, num_steps=self.S,
                           seed=self.ensemble_seed(i), **self.market)
        return EnsembleSpec.homogeneous(cfg)

    def kept_rows(self, i: int) -> np.ndarray:
        n = min(self.M, int(self.traffic["rows_checked"]))
        gen = np.random.default_rng([self.seed & MASK,
                                     (self.seed >> 32) & MASK, i])
        return np.sort(gen.choice(self.M, size=n, replace=False))

    def one(self, i: int, spans: bool = False) -> Item:
        """Open, run and copy out ensemble ``i``."""
        t0 = time.perf_counter()
        with trace.span("open", spans):
            sess = self.engine.open(self.spec(i))
        with trace.span("dispatch", spans):
            batch = sess.run(self.S)
        t1 = time.perf_counter()
        with trace.span("to_host", spans):
            out = sess.stats if self.stats_only else batch.to_numpy()
        t2 = time.perf_counter()
        sess.close()
        rows = self.kept_rows(i)
        kept = np.stack([np.asarray(x)[rows] for x in out])
        return Item(i=i, rows=rows, kept=kept, host_s=t1 - t0,
                    wall_s=t2 - t0)

    def setup(self) -> None:
        from repro_torch.core.session import Engine

        t = self.traffic
        self.engine = Engine(t["backend"], device=self.device,
                             chunk_size=int(t["chunk"]),
                             stats_only=self.stats_only,
                             autotune=t["autotune"])
        self.one(0)
        with self.engine.open(self.spec(0)) as sess:
            m = sess.metrics
            self.info["tile"] = None if m is None else {
                k: m.gauge_value(f"tile_{k}") for k in (
                    "warps_per_market", "markets_per_cta", "ctas_per_market",
                    "agents")}

    def window(self, seconds: float) -> Dict[str, float]:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            i += 1
            self.attempted += 1
            self.items.append(self.one(i))
        wall = time.perf_counter() - t0
        self.window_items = len(self.items)
        ms = [1e3 * it.wall_s for it in self.items]
        rate = len(self.items) * self.events() / wall
        self.info.update(window_s=wall, ensembles=len(self.items),
                         ensemble_ms_quantiles=[float(np.percentile(ms, q))
                                                for q in (0, 25, 50, 75, 95,
                                                          100)])
        return {"agent_events_per_s": rate,
                "ensemble_ms_p95": float(np.percentile(ms, 95))}

    def events(self) -> int:
        return self.M * self.A * self.S

    def traced(self) -> trace.Slice:
        median_s = float(np.median([it.wall_s for it in self.items]))
        n = max(2, math.ceil(float(self.traffic["slice_seconds"])
                             / max(median_s, 1e-6)))
        first = len(self.items) + 1

        def run():
            for i in range(first, first + n):
                self.attempted += 1
                self.items.append(self.one(i, spans=True))

        sl = trace.profile(run)
        self.info.update(slice_ensembles=n, slice_s=sl.wall_s,
                         slice_agent_events_per_s=n * self.events()
                         / sl.wall_s)
        return sl

    def context(self) -> SimpleNamespace:
        mix = count.mix_of(ref.agent_counts(self.market, self.A), self.M,
                           self.A)
        win = self.items[:self.window_items]
        return SimpleNamespace(
            ensembles_in_slice=len(self.items) - self.window_items,
            ops_per_ensemble=count.ensemble_ops(
                self.M, self.A, self.L, self.S, mix, self.stats_only),
            bytes_per_ensemble=count.ensemble_bytes(
                self.M, self.L, self.S, int(self.traffic["chunk"]),
                self.stats_only),
            host_s_per_ensemble=float(np.mean([it.host_s for it in win])),
            kernel=self.traffic["kernel"])

    def release(self) -> None:
        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the check ----
    def reference(self, fdt) -> List[np.ndarray]:
        """The reference's outputs for the kept rows of every item, in
        blocks of ``check_block_rows`` rows, as float32 arrays of the kept
        outputs' shapes."""
        seeds = np.concatenate([np.full(len(it.rows), self.ensemble_seed(
            it.i), np.int64) for it in self.items])
        ids = np.concatenate([it.rows for it in self.items]).astype(np.int64)
        block = int(self.traffic["check_block_rows"])
        outs = []
        for lo in range(0, len(ids), block):
            n = min(block, len(ids) - lo)
            rows = ref.Rows(
                torch.from_numpy(seeds[lo:lo + n, None]).to(self.device),
                torch.from_numpy(ids[lo:lo + n, None]).to(self.device),
                ref.columns(self.market, self.A, self.L, n, self.device))
            got = ref.simulate(rows, self.A, self.L, self.S, fdt=fdt,
                               stats_only=self.stats_only)
            outs.append(np.stack([x.float().cpu().numpy() for x in got]))
        return outs

    def program_outputs(self) -> np.ndarray:
        return np.concatenate([it.kept for it in self.items], axis=1)

    def check(self) -> List[Check]:
        return [Check("mismatched_values",
                      self.mismatches(torch.float32), 0.0)]

    def readings(self, controls: bool = True) -> Dict[str, Dict[str, float]]:
        """The compared number for the program, and with ``controls`` for
        the control (the reference in bfloat16 in the program's place)."""
        out = {"program": {"mismatched_values":
                           self.mismatches(torch.float32)}}
        if controls:
            out["control_bfloat16"] = {"mismatched_values":
                                       self.mismatches(torch.bfloat16)}
        return out

    def mismatches(self, fdt) -> float:
        """Values of the kept rows where the program and the reference in
        ``fdt`` differ (NaN equal to NaN)."""
        want = np.concatenate(self.reference(fdt), axis=1)
        got = self.program_outputs()
        same = (got == want) | (np.isnan(got) & np.isnan(want))
        bad = int(same.size - same.sum())
        ends = np.cumsum([len(it.rows) for it in self.items])
        self.failed = sum(not same[:, e - len(it.rows):e].all()
                          for e, it in zip(ends, self.items))
        self.info.update(rows_checked=int(got.shape[1]),
                         values_checked=int(got.size))
        return float(bad)
