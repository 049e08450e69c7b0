"""The kernel session backends: ``cuda-kinetic`` and ``cuda-naive``.

:class:`ClearingChunkRunner` hands each session chunk to one chunk
function with the operands of
:func:`repro_torch.kernels.kinetic_clearing.kinetic_clearing_chunk`:

  * ``cuda-kinetic`` (:class:`KineticChunkRunner`) — the paper's engine: the
    persistent kernel, one launch per chunk;
  * ``cuda-naive`` (:class:`NaiveChunkRunner`) — the ablation: the per-step
    kernel, one launch per step (``naive_clearing_chunk``).

On the CPU both run the same plain PyTorch version. The coupling column is
frozen at chunk entry inside the wrappers, as on every backend of the JAX
package. The env step core (:meth:`ClearingChunkRunner.env_step_fn`) is one
``run`` of one step on the engine's chunk-1 runner: one launch of kernel 1
(or 2) per env step, its peer column resolved at every step.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.core import session
from repro_torch.core.device import resolve_device
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.result import SimResult
from repro_torch.core.step import MarketState, StepOutput
from repro_torch.kernels import _build
from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.kernels import naive_clearing as nc

BACKEND = "cuda-kinetic"
NAIVE_BACKEND = "cuda-naive"


class ClearingChunkRunner(session.ChunkRunner):
    """One ``chunk_fn`` call per chunk of up to ``chunk`` steps."""

    compiled = True

    def __init__(self, chunk_fn: Callable, backend: str,
                 load_library: Callable, spec: EnsembleSpec, chunk: int,
                 device: torch.device, scan: str = "cumsum",
                 stats_only: bool = False):
        super().__init__(device)
        if scan not in ("cumsum", "hillis-steele"):
            raise ValueError(f"unknown scan {scan!r}")
        self.spec = spec
        self.chunk = int(chunk)
        self.scan = scan
        self.stats_only = bool(stats_only)
        self._chunk_fn = chunk_fn
        if device.type == "cuda":
            # Build (or load) the kernel now, and record why it failed.
            loads = _build.load_count()
            try:
                load_library()
            except (OSError, RuntimeError) as exc:
                session.record_failure(backend, f"{type(exc).__name__}: {exc}")
                raise
            self._builds += _build.load_count() - loads
        self._market_ids = torch.arange(spec.num_markets, dtype=torch.int32,
                                        device=device)

    def run(self, state: MarketState, params, step0: int, n: int, ext,
            stats=None, aux=None
            ) -> Tuple[MarketState, session.StepBatch, Any]:
        eb, ea = (None, None) if ext is None else ext
        loads = _build.load_count()
        out = self._chunk_fn(
            state.bid, state.ask, state.last_price, state.prev_mid, step0, n,
            eb, ea, cfg=self.spec, chunk=self.chunk, scan=self.scan,
            market_ids=self._market_ids, params=params, stats=stats,
            stats_only=self.stats_only)
        self._builds += _build.load_count() - loads
        self.launched = True
        new_state = MarketState(*out[:4])
        if self.stats_only:
            return new_state, session._empty_batch(
                self.spec.num_markets, self.device), out[4]
        pp, vp, mp = out[4:]
        return new_state, session.StepBatch(
            price=pp[:, :n], volume=vp[:, :n], mid=mp[:, :n]), None

    def env_step_fn(self) -> Callable:
        """One :meth:`run` of one step from ``t``, the env's orders as the
        chunk's external orders (None: no operand at all, which adds
        nothing). The seed is the spec's: the env rejects a runtime one."""
        def step_core(market, params, t, ext_buy, ext_ask, seed, aux):
            ext = None if ext_buy is None else (ext_buy, ext_ask)
            state, batch, _ = self.run(market, params, t, 1, ext)
            return state, StepOutput(*batch), aux

        return step_core


class KineticChunkRunner(ClearingChunkRunner):
    """The persistent kernel: one ``kinetic_clearing_chunk`` launch per
    chunk."""

    def __init__(self, spec: EnsembleSpec, chunk: int, device: torch.device,
                 scan: str = "cumsum", stats_only: bool = False):
        super().__init__(kc.kinetic_clearing_chunk, BACKEND, kc._load_library,
                         spec, chunk, device, scan=scan,
                         stats_only=stats_only)


class NaiveChunkRunner(ClearingChunkRunner):
    """The per-step kernel: ``naive_clearing_chunk``, one launch per step."""

    def __init__(self, spec: EnsembleSpec, chunk: int, device: torch.device,
                 scan: str = "cumsum", stats_only: bool = False):
        super().__init__(nc.naive_clearing_chunk, NAIVE_BACKEND,
                         nc._load_library, spec, chunk, device, scan=scan,
                         stats_only=stats_only)


@session.register_backend(BACKEND)
def open_kinetic_runner(spec, chunk: int, device, scan: str = "cumsum",
                        stats_only: bool = False) -> KineticChunkRunner:
    """The paper's engine: persistent, books on chip, one launch per chunk."""
    return KineticChunkRunner(EnsembleSpec.coerce(spec), chunk,
                              resolve_device(device), scan=scan,
                              stats_only=stats_only)


@session.register_backend(NAIVE_BACKEND)
def open_naive_runner(spec, chunk: int, device, scan: str = "cumsum",
                      stats_only: bool = False) -> NaiveChunkRunner:
    """The ablation: one launch per step, books through device memory."""
    return NaiveChunkRunner(EnsembleSpec.coerce(spec), chunk,
                            resolve_device(device), scan=scan,
                            stats_only=stats_only)


def _simulate_with(factory, cfg, device, scan: str) -> SimResult:
    spec = EnsembleSpec.coerce(cfg)
    runner = factory(spec, min(session.DEFAULT_CHUNK, spec.num_steps), device,
                     scan=scan)
    return session.run_runner_to_result(runner, spec)


def simulate_kinetic(cfg, device="cuda", scan: str = "cumsum") -> SimResult:
    """One-session run of the persistent engine over ``num_steps``."""
    return _simulate_with(open_kinetic_runner, cfg, device, scan)


def simulate_naive(cfg, device="cuda", scan: str = "cumsum") -> SimResult:
    """One-session run of the per-step ablation over ``num_steps``."""
    return _simulate_with(open_naive_runner, cfg, device, scan)
