"""PyTorch framework baselines: ``torch-scan`` and ``torch-per-step``.

The counterparts of the JAX package's ``jax-scan`` and ``jax-per-step``
(the paper's framework baselines), in eager PyTorch over
:func:`repro_torch.core.step.simulate_step`, with no hand-written kernel:

  * ``scan``     — one runner call loops the chunk's steps; the paths stay
                   on the device.
  * ``per-step`` — one ``simulate_step`` dispatch per step, with the step's
                   outputs copied to the host every step: the deliberate
                   device round trip of the launch-per-step regime.

Both freeze the coupling column once per chunk, inject external orders at
the chunk's first step, and carry the ``stats_only`` accumulators. Orders
are binned with ``scatter_add_`` (the one-hot binning of the JAX package
is not ported). These are baselines a user picks by name; they are not a
fallback of the kernel backends.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Tuple

import numpy as np
import torch

from repro_torch.core import params as params_mod
from repro_torch.core import session
from repro_torch.core import stats as stats_mod
from repro_torch.core.device import resolve_device
from repro_torch.core.params import EnsembleSpec, PackedParams
from repro_torch.core.result import SimResult
from repro_torch.core.step import MarketState, resolve_peer_mids, simulate_step

MODES = {"scan": "torch-scan", "per-step": "torch-per-step"}


class TorchChunkRunner(session.ChunkRunner):
    """Eager chunk executor for the two framework regimes."""

    def __init__(self, spec: EnsembleSpec, chunk: int, device: torch.device,
                 mode: str = "scan", scan: str = "cumsum",
                 stats_only: bool = False):
        super().__init__(device)
        if mode not in MODES:
            raise ValueError(f"unknown mode {mode!r}; have {sorted(MODES)}")
        if scan not in ("cumsum", "hillis-steele"):
            raise ValueError(f"unknown scan {scan!r}")
        self.spec = spec
        self.chunk = int(chunk)
        self.mode = mode
        self.scan = scan
        self.stats_only = bool(stats_only)
        self._market_ids = torch.arange(spec.num_markets, dtype=torch.int32,
                                        device=device)[:, None]

    def step_fn(self, aux) -> Callable:
        """The step a chunk loops, ``f(cfg, state, step, market_ids,
        **simulate_step keywords)``: the call-auction step here; the numpy
        reference family swaps in its RNG stream and clearing mechanism."""
        return functools.partial(simulate_step, scan=self.scan)

    def run(self, state: MarketState, params: PackedParams, step0: int,
            n: int, ext, stats=None, aux=None
            ) -> Tuple[MarketState, session.StepBatch, Any]:
        eb, ea = (None, None) if ext is None else ext
        cols = params.columns()
        # Step-invariant type lattice, and the coupling freeze: one gather
        # of the peer mids at chunk entry.
        atype = params_mod.agent_types(cols, self.spec.num_agents,
                                       self.device)
        peer_mid = resolve_peer_mids(state.prev_mid, cols.coupling_peer)
        per_step = self.mode == "per-step"
        step_fn = self.step_fn(aux)
        paths = ([], [], [])
        for k in range(n):
            first = k == 0
            state, out = step_fn(
                self.spec, state, step0 + k, self._market_ids,
                ext_buy=eb if first else None,
                ext_ask=ea if first else None, params=cols, atype=atype,
                peer_mid=peer_mid)
            if self.stats_only:
                stats = stats_mod.accumulate(stats, out.mid, out.volume)
            else:
                for path, col in zip(paths, out):
                    # per-step: the outputs reach the host every step.
                    path.append(col.cpu().numpy() if per_step else col)
        if self.stats_only:
            return state, session._empty_batch(self.spec.num_markets,
                                               self.device), stats
        if n == 0:
            return state, session._empty_batch(self.spec.num_markets,
                                               self.device), None
        if per_step:
            cols_out = (torch.from_numpy(np.concatenate(p, axis=1))
                        .to(self.device) for p in paths)
        else:
            cols_out = (torch.cat(p, dim=1) for p in paths)
        return state, session.StepBatch(*cols_out), None


def open_chunk_runner(spec, chunk: int, device, mode: str = "scan",
                      scan: str = "cumsum",
                      stats_only: bool = False) -> TorchChunkRunner:
    """Session factory for the PyTorch framework baselines."""
    return TorchChunkRunner(EnsembleSpec.coerce(spec), chunk,
                            resolve_device(device), mode=mode, scan=scan,
                            stats_only=stats_only)


def _factory(mode: str):
    def factory(spec, chunk: int, device, scan: str = "cumsum",
                stats_only: bool = False) -> TorchChunkRunner:
        return open_chunk_runner(spec, chunk, device, mode=mode, scan=scan,
                                 stats_only=stats_only)

    factory.__doc__ = f"The ``{MODES[mode]}`` framework baseline."
    return factory


for _mode, _name in MODES.items():
    session.register_backend(_name)(_factory(_mode))


def simulate(cfg, mode: str = "scan", device="cuda",
             scan: str = "cumsum") -> SimResult:
    """One-session run of a framework baseline over ``num_steps``."""
    spec = EnsembleSpec.coerce(cfg)
    runner = open_chunk_runner(spec, min(session.DEFAULT_CHUNK,
                                         spec.num_steps), device, mode=mode,
                               scan=scan)
    return session.run_runner_to_result(runner, spec)
