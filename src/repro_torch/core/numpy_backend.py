"""The CPU reference backends: ``numpy``, ``numpy-splitmix64`` and
``numpy-pcg64`` (the paper's baseline 1).

A NumPy program, as the JAX package's is: the host loop drives the NumPy
step of :mod:`repro_torch.core.host` (``np.add.at`` binning, the paper's
CPU implementation), one step at a time, independent of the torch step
that the kernels' plain versions and the ``torch-*`` backends run. The
runner turns the session's CPU tensors into arrays that share their memory
at a chunk's entry, and its arrays into tensors at the exit; the step
never writes into an input, and between the two the loop runs NumPy only.

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
``sequential`` (order-by-order matching,
:mod:`repro_torch.core.host.sequential`), a reference mechanism without
external-order injection and without an env step core.

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

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import session
from repro_torch.core import stats as stats_mod
from repro_torch.core import step as step_mod
from repro_torch.core.host import rng
from repro_torch.core.host import stats as host_stats
from repro_torch.core.host import step as host_step
from repro_torch.core.host.agents import agent_types
from repro_torch.core.host.sequential import simulate_step_sequential
from repro_torch.core.params import (FLOAT_FIELDS, INT_FIELDS, EnsembleSpec,
                                     MarketParams, PackedParams)
from repro_torch.core.result import SimResult

RNG_MODES = {"kinetic": "numpy", "splitmix64": "numpy-splitmix64",
             "pcg64": "numpy-pcg64"}
CLEARING = ("parallel", "sequential")


def _host_params(packed: PackedParams) -> MarketParams:
    """``[M, 1]`` numpy views of the columns of CPU ``packed`` params."""
    floats, ints = packed.floats.numpy(), packed.ints.numpy()
    cols = {f: floats[:, k:k + 1] for k, f in enumerate(FLOAT_FIELDS)}
    cols.update({f: ints[:, k:k + 1] for k, f in enumerate(INT_FIELDS)})
    return MarketParams(**cols)


def _arrays(tensors):
    """numpy views of CPU tensors (None stays None)."""
    return [None if t is None else t.numpy() for t in tensors]


def _tensors(arrays):
    return [torch.from_numpy(a) for a in arrays]


class NumpyChunkRunner(session.ChunkRunner):
    """Host-loop chunk executor of the reference family (CPU only)."""

    xp = np

    def __init__(self, spec: EnsembleSpec, chunk: int, rng_mode: str,
                 scan: str = "cumsum", stats_only: bool = False,
                 clearing: str = "parallel"):
        if rng_mode not in RNG_MODES:
            raise ValueError(f"unknown rng_mode {rng_mode!r}")
        if clearing not in CLEARING:
            raise ValueError(f"unknown clearing mode {clearing!r}")
        if scan not in ("cumsum", "hillis-steele"):
            raise ValueError(f"unknown scan {scan!r}")
        super().__init__(torch.device("cpu"))
        self.spec = spec
        self.chunk = int(chunk)
        self.rng_mode = rng_mode
        self.scan = scan
        self.stats_only = bool(stats_only)
        self.clearing = clearing
        # Runtime seed overrides rebuild the counter/SplitMix64 stream per
        # step; the sequential PCG64 stream is fixed at init.
        self.env_runtime_seed = rng_mode != "pcg64"
        self._market_ids = np.arange(spec.num_markets, dtype=np.int32)[:, None]

    def init_state(self, spec: EnsembleSpec) -> step_mod.MarketState:
        return step_mod.MarketState(*_tensors(host_step.initial_state(spec)))

    def init_stats(self, spec: EnsembleSpec):
        if not self.stats_only:
            return None
        return stats_mod.MarketStats(
            *_tensors(host_stats.init_stats(spec.num_markets)))

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

    def _uniform_fn(self, aux, seed=None) -> Optional[Callable]:
        """The ``decide`` stream override of this mode (None: the counter
        stream, whose ``seed`` goes through the step); ``seed`` overrides
        the spec's SplitMix64 seed."""
        if self.rng_mode == "kinetic":
            return None
        if self.rng_mode == "splitmix64":
            seed = self.spec.seed if seed is None else seed
            return lambda gid, step, channel: rng.splitmix64_uniform(
                seed, gid, step, channel)
        return lambda gid, step, channel: aux.random(size=gid.shape,
                                                     dtype=np.float32)

    def env_step_fn(self) -> Optional[Callable]:
        """One NumPy step a call, the peer column gathered from
        ``market.prev_mid``; None under sequential clearing (a reference
        mechanism: Session/simulate only)."""
        if self.clearing == "sequential":
            return None
        spec = self.spec
        # The type lattice is step-invariant and the env threads the same
        # params object through every step of a rollout: a one-slot
        # identity-keyed memo hoists it as the chunked ``run`` does.
        memo = []

        def step_core(market, params, t, ext_buy, ext_ask, seed, aux):
            if not (memo and memo[0] is params):
                cols = _host_params(params)
                memo[:] = [params, cols, agent_types(cols, spec.num_agents)]
            _, cols, atype = memo
            state = host_step.MarketState(*_arrays(market))
            eb, ea = _arrays((ext_buy, ext_ask))
            new_state, out = host_step.simulate_step(
                spec, state, np.int32(t), self._market_ids, cols,
                scan=self.scan, uniform_fn=self._uniform_fn(aux, seed=seed),
                ext_buy=eb, ext_ask=ea, atype=atype, seed=seed,
                peer_mid=host_step.resolve_peer_mids(state.prev_mid,
                                                     cols.coupling_peer))
            return (step_mod.MarketState(*_tensors(new_state)),
                    step_mod.StepOutput(*_tensors(out)), aux)

        return step_core

    def run(self, state: step_mod.MarketState, params: PackedParams,
            step0: int, n: int, ext, stats=None, aux=None,
            ) -> Tuple[step_mod.MarketState, session.StepBatch, Any]:
        spec = self.spec
        M = spec.num_markets
        cols = _host_params(params)
        hstate = host_step.MarketState(*_arrays(state))
        hstats = None if stats is None else \
            host_stats.MarketStats(*_arrays(stats))
        eb, ea = _arrays(ext) if ext is not None else (None, None)
        uniform_fn = self._uniform_fn(aux)
        # The type lattice is step-invariant: built once a chunk.
        atype = agent_types(cols, spec.num_agents)
        # Coupling freeze: arbitrageurs see the peer's mid as of the chunk
        # boundary (the freeze points of every other backend).
        peer_mid = host_step.resolve_peer_mids(hstate.prev_mid,
                                               cols.coupling_peer)
        width = 0 if self.stats_only else n
        pp = np.zeros((M, width), dtype=np.float32)
        vp = np.zeros((M, width), dtype=np.float32)
        mp = np.zeros((M, width), dtype=np.float32)
        for k in range(n):
            first = k == 0
            if self.clearing == "sequential":
                if first and (eb is not None or ea is not None):
                    raise ValueError(
                        "sequential clearing is a reference mechanism "
                        "without external-order injection; use the "
                        "parallel-clearing backends for session stepping")
                hstate, out = simulate_step_sequential(
                    spec, hstate, np.int32(step0 + k), self._market_ids,
                    cols, uniform_fn=uniform_fn, atype=atype,
                    peer_mid=peer_mid)
            else:
                hstate, out = host_step.simulate_step(
                    spec, hstate, np.int32(step0 + k), self._market_ids,
                    cols, scan=self.scan, uniform_fn=uniform_fn,
                    ext_buy=eb if first else None,
                    ext_ask=ea if first else None, atype=atype,
                    peer_mid=peer_mid)
            if self.stats_only:
                hstats = host_stats.accumulate(hstats, out.mid, out.volume,
                                               True)
            else:
                pp[:, k] = out.price[:, 0]
                vp[:, k] = out.volume[:, 0]
                mp[:, k] = out.mid[:, 0]
        return (step_mod.MarketState(*_tensors(hstate)),
                session.StepBatch(*_tensors((pp, vp, mp))),
                None if hstats is None
                else stats_mod.MarketStats(*_tensors(hstats)))


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
