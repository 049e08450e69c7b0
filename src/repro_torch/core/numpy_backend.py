"""The CPU reference backends: ``numpy``, ``numpy-splitmix64`` and
``numpy-pcg64``.

The port keeps the JAX package's names for its reference family, so a
reader finds the counterpart, but this is not a NumPy reimplementation: it
runs the port's own torch step (:func:`repro_torch.core.step.simulate_step`,
binning with ``scatter_add_``, the counterpart of ``np.add.at``) on CPU
tensors, one step at a time on the host. numpy supplies only the SplitMix64
coordinates and the PCG64 ``Generator``. What measures the paper's CPU
column is for the benchmark slice to decide.

Three RNG modes:
  * ``kinetic``    — the production counter stream: equal bit for bit to
                     every other backend;
  * ``splitmix64`` — the paper's 64-bit generator (another stream): only
                     statistically comparable;
  * ``pcg64``      — numpy's PCG64, the paper's literal CPU reference: one
                     ``Generator`` per session, seeded with ``PCG64(seed)``,
                     five ``[M, A]`` float32 draws per step in channel order.
                     Its state rides in snapshots and checkpoints as
                     ``rng``, in the JAX package's format.

Two clearing mechanisms: ``parallel`` (the call auction) and
``sequential`` (order-by-order matching, :mod:`repro_torch.core.sequential`),
a reference mechanism without external-order injection and without an env
step core.

The env step core takes a runtime seed in the ``kinetic`` and
``splitmix64`` modes; ``pcg64`` draws from the session's generator and
rejects one.

The family runs on the host only: ``Engine("numpy", device="cpu")``; any
other device raises. The kinetic and SplitMix64 streams are pure functions
of the absolute step, and the PCG64 generator persists inside the session,
so chunked runs equal one-shot runs in every mode (without cross-market
coupling, whose peer mid freezes at chunk entry on every backend).
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import rng, session
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.result import SimResult
from repro_torch.core.sequential import simulate_step_sequential
from repro_torch.core.step import simulate_step
from repro_torch.core.torch_backend import TorchChunkRunner

RNG_MODES = {"kinetic": "numpy", "splitmix64": "numpy-splitmix64",
             "pcg64": "numpy-pcg64"}
CLEARING = ("parallel", "sequential")


class NumpyChunkRunner(TorchChunkRunner):
    """Host-loop chunk executor of the reference family (CPU only)."""

    def __init__(self, spec: EnsembleSpec, chunk: int, rng_mode: str,
                 scan: str = "cumsum", stats_only: bool = False,
                 clearing: str = "parallel"):
        if rng_mode not in RNG_MODES:
            raise ValueError(f"unknown rng_mode {rng_mode!r}")
        if clearing not in CLEARING:
            raise ValueError(f"unknown clearing mode {clearing!r}")
        super().__init__(spec, chunk, torch.device("cpu"), mode="scan",
                         scan=scan, stats_only=stats_only)
        self.rng_mode = rng_mode
        self.clearing = clearing
        self.env_runtime_seed = rng_mode != "pcg64"

    def env_step_fn(self) -> Optional[Callable]:
        if self.clearing == "sequential":
            return None  # a reference mechanism: Session/simulate only
        return super().env_step_fn()

    # ---- stateful RNG (PCG64 only) ----
    def init_aux(self, spec: EnsembleSpec) -> Optional[np.random.Generator]:
        if self.rng_mode == "pcg64":
            return np.random.Generator(np.random.PCG64(spec.seed))
        return None

    def aux_state(self, aux) -> Optional[dict]:
        return None if aux is None else aux.bit_generator.state

    def restore_aux(self, payload) -> Optional[np.random.Generator]:
        if self.rng_mode != "pcg64":
            return None
        gen = np.random.Generator(np.random.PCG64(self.spec.seed))
        gen.bit_generator.state = payload
        return gen

    def uniform_fn(self, aux, seed=None) -> Optional[Callable]:
        """The ``decide`` stream override of this mode (None: counter);
        ``seed`` overrides the spec's SplitMix64 seed."""
        if self.rng_mode == "kinetic":
            return None
        if self.rng_mode == "splitmix64":
            seed = self.spec.seed if seed is None else seed
            return lambda gid, step, channel: rng.splitmix64_uniform(
                seed, gid, step, channel)
        return lambda gid, step, channel: torch.from_numpy(
            aux.random(size=tuple(gid.shape), dtype=np.float32))

    def step_fn(self, aux, seed=None) -> Callable:
        uniform_fn = self.uniform_fn(aux, seed)
        if self.clearing == "parallel":
            return functools.partial(simulate_step, scan=self.scan,
                                     uniform_fn=uniform_fn)

        def sequential_step(cfg, state, step, market_ids, ext_buy=None,
                            ext_ask=None, **kw):
            if ext_buy is not None or ext_ask is not None:
                raise ValueError(
                    "sequential clearing is a reference mechanism without "
                    "external-order injection; use the parallel-clearing "
                    "backends for session stepping")
            return simulate_step_sequential(cfg, state, step, market_ids,
                                            uniform_fn=uniform_fn, **kw)
        return sequential_step


def open_chunk_runner(spec, chunk: int, rng_mode: str = "kinetic",
                      scan: str = "cumsum", stats_only: bool = False,
                      clearing: str = "parallel") -> NumpyChunkRunner:
    """Session factory for the CPU reference backends."""
    return NumpyChunkRunner(EnsembleSpec.coerce(spec), chunk,
                            rng_mode=rng_mode, scan=scan,
                            stats_only=stats_only, clearing=clearing)


def _factory(rng_mode: str):
    def factory(spec, chunk: int, device, **opts) -> NumpyChunkRunner:
        # The engine has checked that ``device`` is the CPU (host_only).
        return open_chunk_runner(spec, chunk, rng_mode=rng_mode, **opts)

    factory.__doc__ = f"The ``{RNG_MODES[rng_mode]}`` CPU reference."
    return factory


for _mode, _name in RNG_MODES.items():
    session.register_backend(_name, host_only=True)(_factory(_mode))


def simulate(cfg, rng_mode: str = "kinetic", scan: str = "cumsum",
             clearing: str = "parallel") -> SimResult:
    """One-session run of a CPU reference backend over ``num_steps``."""
    spec = EnsembleSpec.coerce(cfg)
    runner = open_chunk_runner(spec, min(session.DEFAULT_CHUNK,
                                         spec.num_steps),
                               rng_mode=rng_mode, scan=scan,
                               clearing=clearing)
    return session.run_runner_to_result(runner, spec)
