"""The ``cuda-kinetic`` session backend over the persistent chunk kernel.

:class:`KineticChunkRunner` hands each session chunk to
:func:`repro_torch.kernels.kinetic_clearing.kinetic_clearing_chunk`: one
kernel launch per chunk on a CUDA device, the plain PyTorch version on the
CPU. The coupling column is frozen at chunk entry inside the wrapper, as on
every backend of the JAX package.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core import session
from repro_torch.core.device import resolve_device
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.result import SimResult
from repro_torch.core.step import MarketState
from repro_torch.kernels import kinetic_clearing as kc

BACKEND = "cuda-kinetic"


class KineticChunkRunner(session.ChunkRunner):
    """One ``kinetic_clearing_chunk`` call per chunk of up to ``chunk`` steps."""

    def __init__(self, spec: EnsembleSpec, chunk: int, device: torch.device,
                 scan: str = "cumsum", stats_only: bool = False):
        super().__init__(device)
        if scan not in ("cumsum", "hillis-steele"):
            raise ValueError(f"unknown scan {scan!r}")
        self.spec = spec
        self.chunk = int(chunk)
        self.scan = scan
        self.stats_only = bool(stats_only)
        if device.type == "cuda":
            # Build (or load) the kernel now, and record why it failed.
            try:
                kc._load_library()
            except (OSError, RuntimeError) as exc:
                session.record_failure(BACKEND, f"{type(exc).__name__}: {exc}")
                raise
        self._market_ids = torch.arange(spec.num_markets, dtype=torch.int32,
                                        device=device)

    def run(self, state: MarketState, params, step0: int, n: int, ext,
            stats=None) -> Tuple[MarketState, session.StepBatch, Any]:
        eb, ea = (None, None) if ext is None else ext
        out = kc.kinetic_clearing_chunk(
            state.bid, state.ask, state.last_price, state.prev_mid, step0, n,
            eb, ea, cfg=self.spec, chunk=self.chunk, scan=self.scan,
            market_ids=self._market_ids, params=params, stats=stats,
            stats_only=self.stats_only)
        new_state = MarketState(*out[:4])
        if self.stats_only:
            return new_state, session._empty_batch(
                self.spec.num_markets, self.device), out[4]
        pp, vp, mp = out[4:]
        return new_state, session.StepBatch(
            price=pp[:, :n], volume=vp[:, :n], mid=mp[:, :n]), None


@session.register_backend(BACKEND)
def open_kinetic_runner(spec, chunk: int, device, scan: str = "cumsum",
                        stats_only: bool = False) -> KineticChunkRunner:
    """The paper's engine: persistent, books on chip, one launch per chunk."""
    return KineticChunkRunner(EnsembleSpec.coerce(spec), chunk,
                              resolve_device(device), scan=scan,
                              stats_only=stats_only)


def simulate_kinetic(cfg, device="cuda", scan: str = "cumsum") -> SimResult:
    """One-session run of the persistent engine over ``num_steps``."""
    spec = EnsembleSpec.coerce(cfg)
    runner = open_kinetic_runner(
        spec, min(session.DEFAULT_CHUNK, spec.num_steps), device, scan=scan)
    return session.run_runner_to_result(runner, spec)
