#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py        # needs one CUDA card; takes no arguments

Every run drives every phase at full width. Phases, each printing one JSON
line:

  build    build the CUDA kernels from ``src/repro_torch/kernels/csrc``, one
           ``nvcc`` per source, all started together; each kernel's
           registers and spills from ptxas (``-Xptxas -v``), the persistent
           kernels once per agent mode (``<0>`` shared, ``<1>`` registers,
           ``<2>`` fresh); any spill fails.
  kernel   ``kinetic_clearing_chunk`` (CUDA) == its plain PyTorch version,
           field by field, at the paper's width A=256, L=128 on a
           heterogeneous ensemble populating all eight archetypes: a chunk
           holding the shock step, a partial tail, external orders,
           ``stats_only``, and ``scan="hillis-steele"``.
  edges    the same check at L=1024, A=300, at L=8, A=5 and at L=4, A=16,
           the last two with 15 markets (a ragged last CTA); then kernels 1
           and 3 in the fresh agent mode (populations past shared memory:
           L=128, A=50,000 and L=1024, A=45,000, 10 markets, 6 steps)
           against their plain versions, with each shape's ``TileChoice``
           and times.
  naive    ``naive_clearing_chunk`` (one launch per step) == its plain
           version over the five cases of ``kernel``.
  legacy   the legacy one-shot ``kinetic_clearing`` and ``naive_clearing``
           == ``ref.simulate_reference`` on the card at M=1024, A=256,
           L=128, S=64 (baseline, arbitrageur, flash-crash, informed) and
           at the L=1024, L=8 and L=4 edges.
  session  ``Engine(b).open(spec).run(500)`` in chunks of 64 for the four
           backends: ``cuda-kinetic`` (the main path) == a plain run over
           the same chunks, one launch per chunk; ``cuda-naive`` (one launch
           per step), ``torch-scan`` and ``torch-per-step`` == the
           ``cuda-kinetic`` run; ``stats_only`` stats likewise.
  parity   the paper's parity matrix (section IV-B) as
           ``tests/test_parity_matrix.py`` builds it: 9 presets x 4 mixtures
           x 3 shapes = 108 configurations. For each, ``cuda-kinetic``
           (kernel 1), ``cuda-naive`` (kernel 2) and ``torch-scan`` on the
           card equal the host ``numpy`` reference field by field, and the
           ``cuda-kinetic`` statistics (mean clearing price, volume per
           market, trade count, volatility) are within 0.1% of it. Prints
           the configurations held and the mismatches; any mismatch fails.
  scenario the scenario tier on kernel 1: ``validate_pinned`` on the four
           pinned mixtures (M=64, A=256, L=128, S=500, stats cross-check)
           on ``cuda-kinetic`` and ``torch-scan``, every report passing
           with equal facts; then ``EnsembleSpec.product`` of the baseline
           preset (A=256, L=128, S=500, 10% arbitrageurs) over 4 momentum
           shares x 2 marketable shares x 1024 markets, ring-coupled over
           all 8192, through ``Engine.open(...).run(500)`` in chunks of 64:
           ``cuda-kinetic`` (8 launches a run) == ``torch-scan``, paths and
           ``stats_only`` stats, then ``validate_spec`` on it (its
           statistics cross-check must pass; the facts are printed).
  timing   CUDA-event times of the chunk kernels and their plain version at
           M=8192, A=256, L=128, chunk 64, against the bound.
  agent_sweep  kernels 1 and 2 over the paper's agent sweep (L=128,
           A in {16, 64, 256, 1024}, one 64-step chunk): each A held bit for
           bit against the plain version at M=1024 (every archetype, a
           shock, coupled peers), then timed at M=8192 against the bound.
  legacy_path  the legacy entries at M=8192, A=256, L=128, S=64: one call
           each with the counts at 0, then times against the bound.
  fixed_workload  the paper's Table IV shape (M=8192, A=256, L=128, S=500)
           as warm ``Session.run(500)`` of each backend: time, agent-events/s,
           peak memory and the ratio to ``cuda-kinetic``; then the two
           chunk kernels alone at M=8192, A=32, L=1024 (books beyond L2).
  env      the RL environment (``repro_torch.env``) at the Table IV width:
           a zero-action rollout of 64 steps on ``cuda-kinetic`` (64
           launches of kernel 1) == ``Session.run(64)`` (one launch), paths
           and books; the scripted maker's closed loop for 64 steps with
           composite observations (market, book window, portfolio, stats)
           and a summed reward on ``cuda-kinetic``, ``cuda-naive`` and
           ``torch-scan``, equal in obs, reward, done, fills, paths and
           final state, kernel 1 (kernel 2) launched once per env step and
           no runner built for a second env; auto-reset at horizon 16 over
           40 steps, every episode replaying the first; a checkpoint at
           step 24 restored into a fresh env, continuing as the straight
           rollout; then 500 timed maker steps: steps/s, agent-events/s,
           kernel 1 at ``chunk=1`` (its device time, CUDA events around
           launches queued behind a sleep; and the wrapper's time a call
           back to back), the card's busy share, the ratio to
           ``Session.run(500)``, and a ``torch.profiler`` window of 50
           steps (CUDA kernels and device time a step).
  train    the PPO trainer (``repro_torch.train``) at the Table IV width
           over 4096 ``flash-crash`` and 4096 ``high-vol`` markets (rollout
           64, 2 epochs of 8 minibatches, hidden (32, 32)): 2 updates on
           ``cuda-kinetic``, ``cuda-naive`` and ``torch-scan``, equal in
           params, Adam state, key, metrics and final env state, kernel 1
           (kernel 2) launched once per env step, nothing built, and no
           synchronizing call inside ``train()`` on the kernel backends
           (torch's sync debug mode set to error); 2 updates, a checkpoint
           restored into a fresh trainer and 2 more == 4 straight updates;
           the flagship gate at ``benchmarks/train_bench.py --full``'s
           shape on ``torch-scan`` (the learned maker must beat the
           scripted one on the held-out mixture); then 8 timed updates:
           env (market-)steps/s, agent-events/s, the wall of rollout, GAE
           and update, ``torch.profiler`` windows over one update and one
           rollout (busy share, CUDA kernels a step), and the learned
           against the scripted maker at full width (reported).
  serve    the serving gateway (``repro_torch.serve.Gateway``) over an
           8192-slot template at A=256, L=128, chunk 64: 256 clients
           round-robin over the nine presets, 8 more at chunk 6 (after the
           checkpoint at chunk 4), 8 detached at chunk 10, one
           ``DeviceLoss`` after chunk 10 (restore at chunk 8, the detach
           replayed from the journal), 16 chunks, in a child process that
           then kills itself
           (SIGKILL); a second child restarts over the same ``ckpt_dir``
           and streams 4 chunks. Every frame equals the frame at the same
           (slot, step) of the same schedule through a ``torch-scan``
           gateway on the card (no kernel); ``traces_delta`` is 0 and kernel
           1 launches once per chunk dispatched (warm-ups and replays
           included). A 4-chunk ``cuda-naive`` gateway with 32 clients
           launches kernel 2 once per step and gives the same frames. Then
           fault-free runs for served agent-events/s (against a bare
           ``Session.run`` of the same 16 chunks), chunk latency at chunk 64
           and 16, and the card's busy share.

Each path is driven with every launch count at 0 just before it and read
just after; the ``kernels`` line's launches are the ``session`` phase's
(and the ``legacy_path`` phase's), plus the ``train`` phase's 2 updates. The ``timing``, ``agent_sweep``, ``legacy_path`` and
``fixed_workload`` lines give each timed shape's launch shape
(``autotune.auto_tile``) and resident CTAs per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). The line before the
last two lists every kernel with its launches on its path; the last line
is the device record. Any mismatch or exception
exits non-zero before those lines. Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

MARKETS_PER_BLOCK = 1024  # of each of the 11 blocks of the full-width spec
# The paper's Table IV shape (benchmarks/common.py at FULL_SCALE): M, A, L.
TABLE_IV = (8192, 256, 128)
LEGACY_MARKETS = 1024     # markets of the legacy phase's wide configs
# Few agents and many levels: 2·M·L·4 = 67 MB of books, beyond the 50 MB L2.
PERSISTENCE = (8192, 32, 1024)
# H100 SXM data sheet: 67 TFLOP/s in f32 counts an FMA as two operations.
# One instruction per FP32 lane per clock (132 SMs x 128 lanes x 1.98 GHz)
# is half that. kc.op_count counts FP32-lane issue slots: each instruction
# class weighted by 128 over its per-SM rate on compute capability 9.0
# (FP32 x1, 32-bit integer x2, conversion x8, shuffle x4).
PEAK_LANE_OPS = 67e12 / 2
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
SEED = 20260611
CARD = ("cuda", 0)        # the one card every phase runs on
# The serve phase: slots of the template, clients before the first chunk,
# chunk length, chunks streamed before the crash and after the restart.
SERVE_SHAPE = (8192, 256, 128)
SERVE_CLIENTS = 256
SERVE_CHUNK = 64
SERVE_CHUNKS = 16
RESTART_CHUNKS = 4
# The lead client's frame counts that trigger the schedule's events. Frame
# n arrives while chunk n+1 runs, so each event lands before chunk n+2: the
# 8 late attaches at chunk 6 (after the checkpoint at chunk 4), the 8
# detaches at chunk 10 and the DeviceLoss after chunk 10, which restores
# the checkpoint at chunk 8 and replays the detach from the journal.
LATE_AFTER, DETACH_AFTER, FAULT_AFTER = 4, 8, 9
LATE_CLIENTS = DETACHED_CLIENTS = 8
CHECKPOINT_EVERY = 4
NAIVE_CLIENTS, NAIVE_CHUNKS = 32, 4
LATENCY_CHUNK, LATENCY_CHUNKS = 16, 64
PRESETS = ("baseline", "flash-crash", "high-vol", "low-vol", "whale", "hft",
           "informed", "wide-book", "thin-book")
# The paper's parity matrix (section IV-B) as tests/test_parity_matrix.py
# builds it: the 9 presets (in registry order) x 4 archetype mixtures x 3
# shapes (M, A, L, S), each case seeded with its index in the matrix.
PARITY_MIXTURES = {
    "paper": dict(alpha_maker=0.15, alpha_momentum=0.15,
                  alpha_fundamentalist=0.0),
    "fundamental": dict(alpha_maker=0.10, alpha_momentum=0.10,
                        alpha_fundamentalist=0.30),
    "mom-heavy": dict(alpha_maker=0.10, alpha_momentum=0.50,
                      alpha_fundamentalist=0.05),
    "noise-only": dict(alpha_maker=0.0, alpha_momentum=0.0,
                       alpha_fundamentalist=0.0),
}
PARITY_SHAPES = [(4, 16, 16, 6), (8, 32, 32, 10), (5, 48, 64, 12)]
PARITY_MATRIX = [(sc, mix, shape) for sc in sorted(PRESETS)
                 for mix in PARITY_MIXTURES for shape in PARITY_SHAPES]
# Its tier-1 subset: the smallest shape, every preset and mixture.
PARITY_TIER1 = [(sc, mix, PARITY_SHAPES[0]) for sc, mix in (
    ("baseline", "paper"), ("baseline", "noise-only"),
    ("flash-crash", "fundamental"), ("flash-crash", "paper"),
    ("high-vol", "mom-heavy"), ("low-vol", "fundamental"),
    ("thin-book", "mom-heavy"), ("wide-book", "noise-only"),
    ("whale", "paper"), ("hft", "fundamental"), ("informed", "noise-only"))]
# Claim 2: these statistics within 0.1% of the host reference.
PARITY_STATS = ("mean_clearing_price", "volume_per_market", "trade_count",
                "volatility")
PARITY_TOL = 1e-3
# The scenario phase: the pinned mixtures' steps, and the full-width coupled
# sweep (the paper's Table IV width): (A, L, S), markets per configuration
# and the sweep, 8 configurations x 1024 = 8192 ring-coupled markets.
PINNED_STEPS = 500
PRODUCT_SHAPE = (256, 128, 500)
PRODUCT_MARKETS_PER_CONFIG = 1024
PRODUCT_SWEEP = {"alpha_momentum": (0.15, 0.3, 0.5, 0.7),
                 "p_marketable": (0.1, 0.2)}
# The edges phase's fresh agent mode: (M per block of small_spec, A, L)
# past shared memory at L=128 and L=1024, and the steps of each call.
FRESH_SHAPES = ((2, 50000, 128), (2, 45000, 1024))
FRESH_STEPS = 6
# The env phase (at TABLE_IV): the checked rollouts' steps, the auto-reset
# horizon and steps, the checkpoint step, and the timed maker rollout.
ENV_STEPS = 64
ENV_HORIZON, ENV_RESET_STEPS, ENV_CHECKPOINT = 16, 40, 24
ENV_TIMED_STEPS = 500
ENV_PROFILED_STEPS = 50
# The train phase: benchmarks/train_bench.py's TRAIN_MIX at Table IV
# width, TRAIN_BLOCK markets a scenario, the PPO config it trains with,
# and the updates timed after one warm update.
TRAIN_MIX, HELDOUT_MIX = ("flash-crash", "high-vol"), ("flash-crash",
                                                       "baseline")
TRAIN_BLOCK = 4096
TRAIN_CONFIG = dict(rollout_len=64, num_envs=1, num_epochs=2,
                    num_minibatches=8, hidden=(32, 32), lr=1e-3, seed=7)
TRAIN_TIMED_UPDATES = 8
# benchmarks/train_bench.py --full's defaults: markets a block, agents,
# levels, rollout length (= num_steps), updates, seed-envs, seed.
GATE = dict(markets=2, agents=16, levels=16, steps=16, updates=48,
            num_envs=2, seed=7)
# Clock cycles of the sleep that timed launches queue behind (about 0.1 s).
QUEUE_SLEEP_CYCLES = 200_000_000


class Mismatch(AssertionError):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def outputs(out, n_valid: int):
    """Flat list of a chunk call's outputs, paths cut to ``n_valid``
    columns (later columns are never written)."""
    if isinstance(out[4], tuple):  # stats_only: books + MarketStats
        return list(out[:4]) + list(out[4])
    return list(out[:4]) + [p[:, :n_valid] for p in out[4:]]


def compare(name: str, got, want) -> float:
    """Field-by-field ``==`` of two flat output lists; returns max
    |got - want| (0 when equal). Raises Mismatch on the first difference."""
    import torch

    if len(got) != len(want):
        raise Mismatch(f"{name}: {len(got)} outputs vs {len(want)}")
    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise Mismatch(f"{name}[{k}]: {tuple(g.shape)}/{g.dtype} vs "
                           f"{tuple(w.shape)}/{w.dtype}")
        same = g == w
        if not bool(same.all()):
            bad = torch.nonzero(~same)[0].tolist()
            raise Mismatch(f"{name}[{k}] differs first at {bad}: "
                           f"{g[tuple(bad)].item()} vs {w[tuple(bad)].item()}")
        diff = torch.where(same, 0.0, (g - w).abs())
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def full_width_spec(num_markets_per_block: int, num_steps: int = 500):
    """The nine presets plus a fundamentalist block and a ring-coupled
    arbitrageur block, so all eight archetypes are populated."""
    import numpy as np
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec

    B = num_markets_per_block
    common = dict(num_markets=B, num_agents=256, num_levels=128,
                  num_steps=num_steps, seed=SEED)
    presets = ["baseline", "flash-crash", "high-vol", "low-vol", "whale",
               "hft", "informed", "wide-book", "thin-book"]
    fund = MarketConfig(alpha_fundamentalist=0.2, fundamental_price=60.0,
                        scenario="fundamentalist", **common)
    arb = MarketConfig(alpha_arbitrageur=0.2, arb_kappa=0.5,
                       scenario="arbitrageur", **common)
    spec = EnsembleSpec.concatenate(
        [EnsembleSpec.from_scenarios(presets, **common),
         EnsembleSpec.homogeneous(fund), EnsembleSpec.homogeneous(arb)])
    M = spec.num_markets
    peer = np.full(M, -1, np.int32)
    arb_rows = np.arange(M - B, M)
    peer[arb_rows] = (arb_rows + 1 - (M - B)) % B + (M - B)  # ring in block
    return spec.with_values(coupling_peer=peer)


def small_spec(num_markets: int, num_agents: int, num_levels: int,
               num_steps: int):
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec

    blocks = [MarketConfig(num_markets=num_markets, num_agents=num_agents,
                           num_levels=num_levels, num_steps=num_steps,
                           seed=SEED + num_levels, **mix)
              for mix in ({"alpha_fundamentalist": 0.2},
                          {"alpha_arbitrageur": 0.2},
                          {"alpha_whale": 0.2, "whale_period": 3},
                          {"alpha_hft": 0.2, "hft_threshold": 0.1},
                          {"alpha_informed": 0.2, "shock_step": 6,
                           "shock_intensity": 0.5, "shock_cancel": 0.5})]
    return EnsembleSpec.concatenate([EnsembleSpec.homogeneous(b)
                                     for b in blocks])


def opening(spec, device):
    from repro_torch.core.step import initial_state

    return tuple(initial_state(spec, device))


def chunk_entries(entry: str):
    """(kernel wrapper, plain version) of a chunk entry."""
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    if entry == "kinetic":
        return kc.kinetic_clearing_chunk, kc.kinetic_clearing_chunk_plain
    return nc.naive_clearing_chunk, nc.naive_clearing_chunk_plain


def counters():
    """Every kernel wrapper of the port, by the name the kernels line uses."""
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    return {"kinetic_clearing_chunk": kc.kinetic_clearing_chunk,
            "naive_clearing_chunk": nc.naive_clearing_chunk,
            "kinetic_clearing": kc.kinetic_clearing,
            "naive_clearing": nc.naive_clearing}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def expect_counts(label: str, want) -> dict:
    """Read the counts after a path and check them: ``want`` names the
    kernels the path must launch (and how often); every other kernel must
    not have launched."""
    got = read_counts()
    for name, n in got.items():
        if n != want.get(name, 0):
            raise Mismatch(f"{label}: {name} launched {n} times, expected "
                           f"{want.get(name, 0)}")
    return got


def kernel_vs_plain(label, spec, device, *, step0, n_valid, chunk,
                    ext=False, stats_only=False, scan="cumsum", state=None,
                    entry="kinetic"):
    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.stats import init_stats

    kernel, plain = chunk_entries(entry)
    M, L = spec.num_markets, spec.num_levels
    state = opening(spec, device) if state is None else state
    params = params_mod.pack_params(spec.params, device)
    gen = torch.Generator(device="cpu").manual_seed(SEED + step0)
    eb = ea = None
    if ext:
        eb, ea = ((torch.randint(0, 4, (M, L), generator=gen)
                   * (torch.rand((M, L), generator=gen) < 0.1))
                  .to(torch.float32).to(device) for _ in range(2))
    # Neither version writes its inputs, so both read the same stats.
    kw = dict(cfg=spec, chunk=chunk, scan=scan, params=params,
              stats=init_stats(M, device) if stats_only else None,
              stats_only=stats_only)
    got = kernel(*state, step0, n_valid, eb, ea, **kw)
    want = plain(*state, step0, n_valid, eb, ea, **kw)
    torch.cuda.synchronize()
    err = compare(label, outputs(got, n_valid), outputs(want, n_valid))
    vol = float(want[4].sum_volume.sum()) if stats_only else \
        float(want[5][:, :n_valid].sum())
    return err, vol


def phase_build():
    import time
    from repro_torch.kernels import _build, autotune
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    t0 = time.perf_counter()
    _build.build(["kinetic_clearing", "naive_clearing"])
    kc._load_library()
    nc._load_library()
    ptxas = {**_build.ptxas_report("kinetic_clearing"),
             **_build.ptxas_report("naive_clearing")}
    # The persistent kernels once per agent mode (<code>: AGENT_MODES).
    kernels = tuple(f"kinetic_{k}_kernel<{code}>" for k in ("chunk", "legacy")
                    for code in range(len(autotune.AGENT_MODES))) + (
        "naive_chunk_step_kernel", "naive_legacy_step_kernel")
    for name in kernels:
        got = ptxas.get(name, {})
        if "registers" not in got or got.get("spill_stores", 1) or \
                got.get("spill_loads", 1):
            raise Mismatch(f"ptxas reports {name}: {got} (spills or missing)")
    emit("build", ok=True, seconds=time.perf_counter() - t0,
         flags=" ".join(_build.NVCC_FLAGS), ptxas=ptxas)


CHUNK_CASES = (
    ("shock_chunk", dict(step0=224, n_valid=64, chunk=64)),
    ("partial_tail", dict(step0=448, n_valid=52, chunk=64)),
    ("ext_orders", dict(step0=0, n_valid=64, chunk=64, ext=True)),
    ("stats_only", dict(step0=224, n_valid=64, chunk=64, stats_only=True)),
    ("hillis_steele", dict(step0=224, n_valid=64, chunk=64,
                           scan="hillis-steele")),
)


def phase_kernel(device, B, entry="kinetic"):
    spec = full_width_spec(B)
    errs, volumes = {}, {}
    for label, kw in CHUNK_CASES:
        errs[label], volumes[label] = kernel_vs_plain(
            f"{entry} {label}", spec, device, entry=entry, **kw)
    emit("kernel" if entry == "kinetic" else entry, ok=True,
         markets=spec.num_markets, agents=256, levels=128,
         cases=list(errs), max_abs_err=max(errs.values()),
         traded_volume=volumes)
    return max(errs.values())


def phase_edges(device):
    """Kernel 1 at the launch rule's edges, then kernels 1 and 3 in the
    fresh agent mode (populations past shared memory) against their plain
    versions, bit for bit, with their times."""
    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.config import MarketConfig
    from repro_torch.kernels import autotune
    from repro_torch.kernels import kinetic_clearing as kc

    errs = []
    shapes = ((8, 300, 1024), (3, 5, 8), (3, 16, 4))  # 5·M markets
    for M, A, L in shapes:
        spec = small_spec(M, A, L, num_steps=20)
        for step0, n_valid in ((0, 12), (4, 9)):
            e, _ = kernel_vs_plain(f"edge L={L} A={A} step0={step0}", spec,
                                   device, step0=step0, n_valid=n_valid,
                                   chunk=12, ext=True)
            errs.append(e)
        e, _ = kernel_vs_plain(f"edge L={L} A={A} stats", spec, device,
                               step0=2, n_valid=12, chunk=12, stats_only=True)
        errs.append(e)
    fresh = []
    for M, A, L in FRESH_SHAPES:
        shape = autotune.auto_tile(L, A)
        if shape.agents != "fresh":
            raise Mismatch(f"L={L}, A={A} took {shape.agents}, not fresh")
        spec = small_spec(M, A, L, num_steps=20)
        e, _ = kernel_vs_plain(f"fresh L={L} A={A}", spec, device, step0=4,
                               n_valid=FRESH_STEPS, chunk=FRESH_STEPS,
                               ext=True)
        cfg = MarketConfig(num_markets=spec.num_markets, num_agents=A,
                           num_levels=L, num_steps=FRESH_STEPS, seed=SEED,
                           alpha_arbitrageur=0.2, alpha_whale=0.1,
                           whale_period=3)
        state = opening(cfg, device)
        got = list(kc.kinetic_clearing(*state, cfg=cfg))
        want = list(kc.kinetic_clearing_plain(*state, cfg=cfg))
        torch.cuda.synchronize()
        e = max(e, compare(f"fresh legacy L={L} A={A}", got, want))
        errs.append(e)
        cstate = opening(spec, device)
        kw = dict(cfg=spec, chunk=FRESH_STEPS,
                  params=params_mod.pack_params(spec.params, device))
        chunk_ms = _time(lambda: kc.kinetic_clearing_chunk(
            *cstate, 0, FRESH_STEPS, **kw), 5)
        legacy_ms = _time(lambda: kc.kinetic_clearing(*state, cfg=cfg), 5)
        n = spec.num_markets
        chunk_bound = bound(
            kc.op_count(n, A, L, FRESH_STEPS, kc.agent_mix(spec.params, A)),
            kc.byte_count(n, L, FRESH_STEPS, ext=False, stats_only=False))
        legacy_bound = bound(
            kc.op_count(n, A, L, FRESH_STEPS, kc.agent_mix(
                params_mod.params_from_config(cfg, n), A)),
            kc.legacy_byte_count(n, L, FRESH_STEPS))
        fresh.append(dict(markets=n, agents=A, levels=L,
                          steps=FRESH_STEPS, tile=shape._asdict(),
                          max_abs_err=e, chunk_ms=chunk_ms,
                          legacy_ms=legacy_ms, chunk_bound=chunk_bound,
                          legacy_bound=legacy_bound,
                          bound_share={
                              "chunk": chunk_bound["bound_ms"] / chunk_ms,
                              "legacy": legacy_bound["bound_ms"] / legacy_ms},
                          launch=launch_facts(n, A, L)))
    emit("edges", ok=True, shapes=[list(x) for x in shapes], fresh=fresh,
         max_abs_err=max(errs))
    return max(errs)


def legacy_configs():
    """(label, MarketConfig) of the legacy phase: the paper's width with an
    arbitrageur config (the peer is the own mid at every step), flash-crash
    and informed configs (every broadcast params column matters), and the
    L=1024, L=8 and L=4 edges."""
    from repro_torch.core.config import MarketConfig, scenario_config

    wide = dict(num_markets=LEGACY_MARKETS, num_agents=256, num_levels=128,
                num_steps=64, seed=SEED)
    arb = dict(alpha_arbitrageur=0.2, arb_kappa=0.5)
    return [
        ("baseline", MarketConfig(**wide)),
        ("arbitrageur", MarketConfig(**wide, **arb)),
        ("flash-crash", scenario_config("flash-crash", **wide)),
        ("informed", scenario_config("informed", **wide)),
        ("edge L=1024", MarketConfig(num_markets=8, num_agents=300,
                                     num_levels=1024, num_steps=20,
                                     seed=SEED + 1, **arb)),
        ("edge L=8", MarketConfig(num_markets=16, num_agents=5,
                                  num_levels=8, num_steps=20, seed=SEED + 2,
                                  **arb)),
        ("edge L=4", MarketConfig(num_markets=15, num_agents=16,
                                  num_levels=4, num_steps=20, seed=SEED + 3,
                                  **arb)),
    ]


def phase_legacy(device):
    """Kernels 3 and 4 against the oracle on the card."""
    import torch
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc
    from repro_torch.kernels import ref

    errs, volumes = [], {}
    for label, cfg in legacy_configs():
        want = list(ref.simulate_reference(cfg, device=device))
        state = opening(cfg, device)
        for fn, per_call in ((kc.kinetic_clearing, 1),
                             (nc.naive_clearing, cfg.num_steps)):
            before = fn.launches
            got = list(fn(*state, cfg=cfg))
            torch.cuda.synchronize()
            if fn.launches - before != per_call:
                raise Mismatch(f"legacy {label}: {fn.__name__} launched "
                               f"{fn.launches - before} times, expected "
                               f"{per_call}")
            errs.append(compare(f"legacy {label} {fn.__name__}", got, want))
        volumes[label] = float(want[5].sum())
    emit("legacy", ok=True, configs=list(volumes), max_abs_err=max(errs),
         traded_volume=volumes)
    return max(errs)


def drive_session(backend, spec, device, chunk, **opts):
    """Open a session, run the horizon, return the flat outputs: books,
    then the three paths or the six stats."""
    import torch
    from repro_torch.core.session import Engine

    with Engine(backend, device=device, **opts).open(
            spec, chunk_size=chunk) as sess:
        batch = sess.run(spec.num_steps)
        out = list(sess.state)
        out += list(sess._stats) if sess._stats is not None else list(batch)
        torch.cuda.synchronize()
    return out


def phase_session(device, B):
    """The session paths: cuda-kinetic (the main path), cuda-naive,
    torch-scan and torch-per-step, each driven with the counts at 0."""
    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.stats import init_stats
    from repro_torch.kernels import kinetic_clearing as kc

    spec = full_width_spec(B)
    S, chunk = spec.num_steps, 64
    n_chunks = -(-S // chunk)
    expected = {"cuda-kinetic": {"kinetic_clearing_chunk": n_chunks},
                "cuda-naive": {"naive_clearing_chunk": S},
                "torch-scan": {}, "torch-per-step": {}}
    runs, launches = {}, {}
    for backend, want in expected.items():
        for stats_only in (False, True):
            reset_counts()
            runs[backend, stats_only] = drive_session(
                backend, spec, device, chunk, stats_only=stats_only)
            counts = expect_counts(f"session {backend}", want)
            if not stats_only:
                launches[backend] = counts

    # The plain version driven over the same 64-step chunks: arbitrageurs
    # see their peer's mid frozen at each chunk entry (as on every backend
    # of the JAX package), so the freeze points must match.
    params = params_mod.pack_params(spec.params, device)

    def plain_run(stats_only):
        state = opening(spec, device)
        stats = init_stats(spec.num_markets, device) if stats_only else None
        paths = []
        for t in range(0, S, chunk):
            n = min(chunk, S - t)
            out = kc.kinetic_clearing_chunk_plain(
                *state, t, n, cfg=spec, chunk=chunk, params=params,
                stats=stats, stats_only=stats_only)
            state = out[:4]
            if stats_only:
                stats = out[4]
            else:
                paths.append([p[:, :n] for p in out[4:]])
        if stats_only:
            return list(state) + list(stats)
        return list(state) + [torch.cat(p, dim=1) for p in zip(*paths)]

    errs = {"cuda-kinetic": max(
        compare("session paths", runs["cuda-kinetic", False],
                plain_run(False)),
        compare("session stats", runs["cuda-kinetic", True],
                plain_run(True)))}
    for backend in ("cuda-naive", "torch-scan", "torch-per-step"):
        errs[backend] = max(
            compare(f"session {backend} paths", runs[backend, False],
                    runs["cuda-kinetic", False]),
            compare(f"session {backend} stats", runs[backend, True],
                    runs["cuda-kinetic", True]))
    got = runs["cuda-kinetic", False]
    price, volume, mid = got[4:]
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    on_grid = bool(((price >= 0) & (price <= spec.num_levels - 1)
                    & (price == torch.round(price))).all())
    if not (finite and on_grid and tuple(price.shape) == (spec.num_markets, S)):
        raise Mismatch(f"session output malformed: finite={finite} "
                       f"on_grid={on_grid} shape={tuple(price.shape)}")
    emit("session", ok=True, markets=spec.num_markets, steps=S, chunk=chunk,
         launches={b: {k: n for k, n in c.items() if n}
                   for b, c in launches.items()},
         chunks_per_run=n_chunks, total_volume=float(volume.sum()),
         max_abs_err=errs)
    return ({"kinetic_clearing_chunk":
             launches["cuda-kinetic"]["kinetic_clearing_chunk"],
             "naive_clearing_chunk":
             launches["cuda-naive"]["naive_clearing_chunk"]},
            {"kinetic_clearing_chunk": errs["cuda-kinetic"],
             "naive_clearing_chunk": errs["cuda-naive"]})


def parity_config(case):
    """The MarketConfig of one parity case."""
    from repro_torch.core.config import scenario_config

    sc, mix, (M, A, L, S) = case
    return scenario_config(sc, num_markets=M, num_agents=A, num_levels=L,
                           num_steps=S, seed=PARITY_MATRIX.index(case),
                           **PARITY_MIXTURES[mix])


def parity_faults(results, reference) -> list:
    """Claim 1 (every card result equals the host ``numpy`` reference,
    field by field) and claim 2 (the ``cuda-kinetic`` statistics within
    0.1% of the reference's, NaN matching NaN) for one configuration;
    returns what failed."""
    import math

    faults = []
    for backend, got in results.items():
        for field, g, w in zip(got._fields, got, reference):
            if g.shape != w.shape or g.dtype != w.dtype or \
                    not (g == w).all():
                faults.append(f"{backend} {field}")
    for stat in PARITY_STATS:
        got = getattr(results["cuda-kinetic"], stat)()
        want = getattr(reference, stat)()
        if math.isnan(want) or math.isnan(got):
            ok = math.isnan(want) and math.isnan(got)
        else:
            ok = abs(got - want) / max(abs(want), 1e-9) <= PARITY_TOL
        if not ok:
            faults.append(f"{stat} {got} vs {want}")
    return faults


def phase_parity(device):
    """The paper's parity matrix on the card: for each of the 108
    configurations, kernels 1 and 2 (``cuda-kinetic``, ``cuda-naive``) and
    ``torch-scan`` on the card equal the host ``numpy`` reference field by
    field (so each other too), and the statistics are within 0.1%."""
    import time

    from repro_torch.core import engine

    t0 = time.perf_counter()
    card = ("cuda-kinetic", "cuda-naive", "torch-scan")
    reset_counts()
    results = {case: {b: engine.simulate(parity_config(case), backend=b,
                                         device=device).to_numpy()
                      for b in card}
               for case in PARITY_MATRIX}
    steps = [case[2][3] for case in PARITY_MATRIX]
    counts = expect_counts("parity", {
        "kinetic_clearing_chunk": len(steps),  # S <= 64: one chunk a run
        "naive_clearing_chunk": sum(steps)})
    card_s = time.perf_counter() - t0
    mismatches, worst = {}, 0.0
    for case, got in results.items():
        cfg = parity_config(case)
        want = engine.simulate(cfg, backend="numpy", device="cpu").to_numpy()
        faults = parity_faults(got, want)
        if faults:
            mismatches["/".join(map(str, case))] = faults
        worst = max(worst, max(float(abs(g - w).max()) if g.size else 0.0
                               for g, w in zip(got["cuda-kinetic"], want)))
    emit("parity", ok=not mismatches, configurations=len(PARITY_MATRIX),
         held=len(PARITY_MATRIX) - len(mismatches),
         mismatches=len(mismatches), first=dict(list(mismatches.items())[:4]),
         launches={k: n for k, n in counts.items() if n},
         card_seconds=card_s, seconds=time.perf_counter() - t0,
         max_abs_err=worst)
    if mismatches:
        raise Mismatch(f"parity: {len(mismatches)} of {len(PARITY_MATRIX)} "
                       "configurations differ")
    return counts, worst


def same_facts(label, got, want) -> None:
    """``==`` on every fact and check of two validation reports (NaN
    matching NaN)."""
    import math

    if set(got.facts) != set(want.facts):
        raise Mismatch(f"{label}: facts {sorted(got.facts)} vs "
                       f"{sorted(want.facts)}")
    for k, w in want.facts.items():
        g = got.facts[k]
        if not (g == w or (math.isnan(g) and math.isnan(w))):
            raise Mismatch(f"{label}: fact {k} {g!r} vs {w!r}")
    if [c.passed for c in got.checks] != [c.passed for c in want.checks]:
        raise Mismatch(f"{label}: checks differ")


def timed_session(backend, spec, device, **opts):
    """``drive_session`` with the kernel counts at 0 just before it; returns
    the outputs, the counts and the seconds of the open and run(S) (the
    card synchronised)."""
    import time

    reset_counts()
    t0 = time.perf_counter()
    out = drive_session(backend, spec, device, 64, **opts)
    return out, read_counts(), time.perf_counter() - t0


def phase_scenario(device):
    """The scenario tier on kernel 1: (a) the four pinned mixtures through
    ``validate_pinned`` on ``cuda-kinetic`` and on ``torch-scan``, every
    report passing with equal facts; (b) the Table IV-width coupled product
    sweep (8192 ring-coupled markets) through ``cuda-kinetic``, bit for bit
    against ``torch-scan`` (paths and ``stats_only`` stats), then
    ``validate_spec`` on it."""
    import time

    from repro_torch.core.config import scenario_config
    from repro_torch.core.params import EnsembleSpec
    from repro_torch.scenario import (CouplingSpec, coupled_ensemble,
                                      validate_pinned, validate_spec)

    out = {}
    # (a) The pinned mixtures (M=64, A=256, L=128, seed 1).
    n_chunks = -(-PINNED_STEPS // 64)
    reports, seconds = {}, {}
    for backend, want in (("cuda-kinetic", {
            "kinetic_clearing_chunk": 4 * 3 * n_chunks}),
            ("torch-scan", {})):
        reset_counts()
        t0 = time.perf_counter()
        reports[backend] = validate_pinned(backend, num_steps=PINNED_STEPS,
                                           stats_check=True, device=device)
        seconds[backend] = time.perf_counter() - t0
        expect_counts(f"scenario pinned {backend}", want)
    for name, rep in reports["cuda-kinetic"].items():
        for backend in reports:
            if not reports[backend][name].passed:
                raise Mismatch(f"scenario: pinned {name} fails on {backend}:"
                               f"\n{reports[backend][name].summary()}")
        same_facts(f"scenario pinned {name}", rep,
                   reports["torch-scan"][name])
    out["pinned"] = {name: {"passed": rep.passed, "facts": rep.facts}
                     for name, rep in reports["cuda-kinetic"].items()}
    out["pinned_seconds"] = seconds

    # (b) The coupled product sweep at the paper's Table IV width.
    A, L, S = PRODUCT_SHAPE
    base = scenario_config("baseline", num_agents=A, num_levels=L,
                           num_steps=S, alpha_arbitrageur=0.1, seed=SEED)
    spec = EnsembleSpec.product(base, PRODUCT_SWEEP,
                                markets_per_config=PRODUCT_MARKETS_PER_CONFIG)
    spec = coupled_ensemble(spec, CouplingSpec.ring(spec.num_markets))
    n_chunks = -(-S // 64)
    runs, secs, launches = {}, {}, {}
    for backend, want in (("cuda-kinetic",
                           {"kinetic_clearing_chunk": n_chunks}),
                          ("torch-scan", {})):
        for stats_only in (False, True):
            runs[backend, stats_only], counts, secs[backend, stats_only] = \
                timed_session(backend, spec, device, stats_only=stats_only)
            for name, n in counts.items():
                if n != want.get(name, 0):
                    raise Mismatch(f"scenario product {backend}: {name} "
                                   f"launched {n} times, expected "
                                   f"{want.get(name, 0)}")
            if backend == "cuda-kinetic":
                launches[stats_only] = counts["kinetic_clearing_chunk"]
    err = max(compare(f"scenario product {'stats' if so else 'paths'}",
                      runs["cuda-kinetic", so], runs["torch-scan", so])
              for so in (False, True))
    reset_counts()
    report = validate_spec(spec, "cuda-kinetic", scenario="table-iv-sweep",
                           stats_check=True, device=device)
    validate_launches = expect_counts(
        "scenario validate_spec", {"kinetic_clearing_chunk": 3 * n_chunks})
    stats_checks = [c for c in report.checks if c.name.startswith("stats_")]
    if not all(c.passed for c in stats_checks):
        raise Mismatch(f"scenario: stats cross-check fails\n"
                       f"{report.summary()}")
    print(report.summary(), flush=True)
    out["product"] = dict(
        markets=spec.num_markets, agents=A, levels=L, steps=S, chunk=64,
        sweep={k: list(v) for k, v in PRODUCT_SWEEP.items()},
        markets_per_config=PRODUCT_MARKETS_PER_CONFIG,
        coupling=f"ring({spec.num_markets})",
        seconds={f"{b}{' stats_only' if so else ''}": t
                 for (b, so), t in secs.items()},
        kernel1_launches_per_run={"paths": launches[False],
                                  "stats_only": launches[True],
                                  "validate_spec (3 runs)": validate_launches[
                                      "kinetic_clearing_chunk"]},
        total_volume=float(runs["cuda-kinetic", False][5].sum()),
        max_abs_err=err, report=report.to_dict(), card=card_line())
    emit("scenario", ok=True, **out)
    return err


def _time(fn, reps: int) -> float:
    import torch

    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    fn()
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _queued_ms(fn, reps: int) -> float:
    """Device time of one ``fn`` call: ``reps`` calls queued behind a
    sleeping kernel, so the host's time between launches does not count.
    Raises if the host did not finish queueing before the sleep ended."""
    import time

    import torch

    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    fn()
    torch.cuda.synchronize()
    events[0].record()
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
    events[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_ms = (time.perf_counter() - t0) * 1e3
    events[2].record()
    torch.cuda.synchronize()
    if queued_ms >= events[0].elapsed_time(events[1]):
        raise Mismatch(f"queueing took {queued_ms} ms, longer than the "
                       "sleep it hides behind")
    return events[1].elapsed_time(events[2]) / reps


def profile_window(fn, steps: int) -> dict:
    """A ``torch.profiler`` window over ``fn()``: its CUDA kernels (in all
    and a step of ``steps``), their device time a step, the card's busy
    share and the six kernels of most device time (None where the profiler
    records no device activity)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return dict(steps=steps, wall_s=wall, kernels=None,
                    kernels_per_step=None, device_ms_per_step=None,
                    busy_share=None)
    device_us = sum(e.self_device_time_total for e in kernels)
    count = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(
        steps=steps, wall_s=wall, kernels=count,
        kernels_per_step=count / steps,
        device_ms_per_step=device_us / 1e3 / steps,
        busy_share=device_us * 1e-6 / wall,
        top={e.key[:100]: e.self_device_time_total / 1e3 / steps
             for e in top})


def bound(ops: int, nbytes: int) -> dict:
    """The least time for ``ops`` issue slots and ``nbytes`` bytes."""
    ops_ms, bytes_ms = ops / PEAK_LANE_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return dict(ops=ops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
                bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def launch_facts(M, A, L) -> dict:
    """The kernels' launch shape at (M, A, L) and each kernel's resident
    CTAs per SM there."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    shape = autotune.auto_tile(L, A)
    return dict(
        warps_per_market=shape.warps_per_market,
        markets_per_cta=shape.markets_per_cta,
        agents=shape.agents,
        threads_per_cta=shape.threads_per_cta, grid=shape.grid(M),
        smem_bytes={"persistent": shape.smem_bytes(True),
                    "per_step": shape.smem_bytes(False)},
        resident_ctas_per_sm={
            "kinetic_clearing_chunk": kc.resident_ctas(False, shape),
            "naive_clearing_chunk": nc.resident_ctas(False, shape),
            "kinetic_clearing": kc.resident_ctas(True, shape),
            "naive_clearing": nc.resident_ctas(True, shape)})


def homogeneous(M, A, L, S):
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec

    return EnsembleSpec.homogeneous(MarketConfig(
        num_markets=M, num_agents=A, num_levels=L, num_steps=S, seed=SEED))


def phase_timing(device):
    from repro_torch.core import params as params_mod
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    (M, A, L), chunk = TABLE_IV, 64
    spec = homogeneous(M, A, L, 500)
    state = opening(spec, device)
    params = params_mod.pack_params(spec.params, device)
    kw = dict(cfg=spec, chunk=chunk, params=params)

    def kernel():
        kc.kinetic_clearing_chunk(*state, 0, chunk, **kw)

    def naive():
        nc.naive_clearing_chunk(*state, 0, chunk, **kw)

    def plain():
        kc.kinetic_clearing_chunk_plain(*state, 0, chunk, **kw)

    # In turns (plain, kernel, naive, naive, kernel, plain) in one call.
    plain_ms = [_time(plain, 2)]
    kernel_ms, naive_ms = [_time(kernel, 20)], []
    naive_ms += [_time(naive, 20), _time(naive, 20)]
    kernel_ms.append(_time(kernel, 20))
    plain_ms.append(_time(plain, 2))
    ms, pms = statistics.median(kernel_ms), statistics.median(plain_ms)
    nms = statistics.median(naive_ms)
    # Both kernels compute the same function: one bound serves both.
    b = bound(kc.op_count(M, A, L, chunk, kc.agent_mix(spec.params, A)),
              kc.byte_count(M, L, chunk, ext=False, stats_only=False))
    naive_bytes = nc.byte_count(M, L, chunk, ext=False, stats_only=False)
    timing = dict(markets=M, agents=A, levels=L, chunk=chunk, ms=ms,
                  kernel_ms_runs=kernel_ms, naive_ms=nms,
                  naive_ms_runs=naive_ms, naive_over_kernel=nms / ms,
                  plain_ms=pms, plain_ms_runs=plain_ms,
                  agent_events_per_s=M * A * chunk / (ms * 1e-3),
                  naive_design_bytes=naive_bytes,
                  naive_design_bytes_ms=naive_bytes / PEAK_BYTES * 1e3,
                  bound_share=b["bound_ms"] / ms,
                  naive_bound_share=b["bound_ms"] / nms,
                  launch=launch_facts(M, A, L), **b)
    emit("timing", ok=True, **timing)
    return timing


AGENT_SWEEP = (16, 64, 256, 1024)  # benchmarks/common.py at FULL_SCALE
SWEEP_CHECK_MARKETS = 1024         # markets of the sweep's bitwise check


def sweep_spec(M, A):
    """Every archetype at L=128, a shock inside the first chunk and a ring
    of arbitrageur peers."""
    import numpy as np
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec

    spec = EnsembleSpec.homogeneous(MarketConfig(
        num_markets=M, num_agents=A, num_levels=128, num_steps=500,
        seed=SEED + A, alpha_fundamentalist=0.1, alpha_whale=0.05,
        whale_period=3, alpha_hft=0.1, hft_threshold=0.1,
        alpha_informed=0.05, shock_step=20, shock_intensity=0.5,
        shock_cancel=0.5, alpha_arbitrageur=0.1))
    return spec.with_values(coupling_peer=(np.arange(M) + 1) % M)


def phase_agent_sweep(device):
    """Kernels 1 and 2 over the paper's agent sweep at L=128: bit for bit
    against the plain version at M=1024, then timed at M=8192 (the plain
    version is not timed there)."""
    from repro_torch.core import params as params_mod
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    M, L, chunk = TABLE_IV[0], 128, 64
    errs, rows = [], []
    for A in AGENT_SWEEP:
        for entry in ("kinetic", "naive"):
            e, _ = kernel_vs_plain(f"agent_sweep A={A} {entry}",
                                   sweep_spec(SWEEP_CHECK_MARKETS, A),
                                   device, step0=0,
                                   n_valid=chunk, chunk=chunk, entry=entry)
            errs.append(e)
        spec = homogeneous(M, A, L, 500)
        state = opening(spec, device)
        kw = dict(cfg=spec, chunk=chunk,
                  params=params_mod.pack_params(spec.params, device))

        def kernel():
            kc.kinetic_clearing_chunk(*state, 0, chunk, **kw)

        def naive():
            nc.naive_clearing_chunk(*state, 0, chunk, **kw)

        kernel_ms, naive_ms = [_time(kernel, 10)], []
        naive_ms += [_time(naive, 10), _time(naive, 10)]
        kernel_ms.append(_time(kernel, 10))
        ms, nms = statistics.median(kernel_ms), statistics.median(naive_ms)
        b = bound(kc.op_count(M, A, L, chunk, kc.agent_mix(spec.params, A)),
                  kc.byte_count(M, L, chunk, ext=False, stats_only=False))
        rows.append(dict(agents=A, ms=ms, kernel_ms_runs=kernel_ms,
                         naive_ms=nms, naive_ms_runs=naive_ms,
                         naive_over_kernel=nms / ms,
                         bound_share=b["bound_ms"] / ms,
                         launch=launch_facts(M, A, L), **b))
    emit("agent_sweep", ok=True, markets=M, levels=L, chunk=chunk,
         checked_markets=SWEEP_CHECK_MARKETS, max_abs_err=max(errs),
         rows=rows)
    return max(errs)


def phase_legacy_path(device):
    """The legacy entries as a user calls them, at M=8192, A=256, L=128,
    S=64: one call each with the counts at 0, checked against the plain
    version, then timed against the bound."""
    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.config import MarketConfig
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    (M, A, L), S = TABLE_IV, 64
    cfg = MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                       num_steps=S, seed=SEED)
    state = opening(cfg, device)
    reset_counts()
    got_k = list(kc.kinetic_clearing(*state, cfg=cfg))
    got_n = list(nc.naive_clearing(*state, cfg=cfg))
    torch.cuda.synchronize()
    counts = expect_counts("legacy path",
                           {"kinetic_clearing": 1, "naive_clearing": S})
    want = list(kc.kinetic_clearing_plain(*state, cfg=cfg))
    errs = {"kinetic_clearing": compare("legacy path kinetic", got_k, want),
            "naive_clearing": compare("legacy path naive", got_n, want)}

    def kernel():
        kc.kinetic_clearing(*state, cfg=cfg)

    def naive():
        nc.naive_clearing(*state, cfg=cfg)

    def plain():
        kc.kinetic_clearing_plain(*state, cfg=cfg)

    plain_ms = [_time(plain, 2)]
    kernel_ms, naive_ms = [_time(kernel, 10)], []
    naive_ms += [_time(naive, 10), _time(naive, 10)]
    kernel_ms.append(_time(kernel, 10))
    plain_ms.append(_time(plain, 2))
    mix = kc.agent_mix(params_mod.params_from_config(cfg, M), A)
    b = bound(kc.op_count(M, A, L, S, mix), kc.legacy_byte_count(M, L, S))
    out = dict(markets=M, agents=A, levels=L, steps=S,
               launches={k: counts[k] for k in errs}, max_abs_err=errs,
               kinetic_ms=statistics.median(kernel_ms),
               kinetic_ms_runs=kernel_ms,
               naive_ms=statistics.median(naive_ms), naive_ms_runs=naive_ms,
               plain_ms=statistics.median(plain_ms), plain_ms_runs=plain_ms,
               launch=launch_facts(M, A, L), **b)
    emit("legacy_path", ok=True, **out)
    return out


def phase_fixed_workload(device):
    """The paper's Table IV shape through warm sessions of every backend,
    then the two chunk kernels alone where the books outgrow L2."""
    import time

    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.session import Engine
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    (M, A, L), S = TABLE_IV, 500
    spec = homogeneous(M, A, L, S)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    rows = {}
    # The eager baselines take seconds a run: one warm-up and two runs.
    for backend, runs in (("cuda-kinetic", 5), ("cuda-naive", 5),
                          ("torch-scan", 2), ("torch-per-step", 2)):
        eng = Engine(backend, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        ms, wall = [], []
        for k in range(runs + 1):  # the first run warms the runner up
            with eng.open(spec) as sess:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                sess.run(S)
                stop.record()
                torch.cuda.synchronize()
                if k:
                    wall.append((time.perf_counter() - t0) * 1e3)
                    ms.append(start.elapsed_time(stop))
        rows[backend] = dict(
            ms=statistics.median(ms), ms_runs=ms,
            wall_ms=statistics.median(wall),
            agent_events_per_s=M * A * S / (statistics.median(ms) * 1e-3),
            peak_bytes=torch.cuda.max_memory_allocated(device))
    base = rows["cuda-kinetic"]
    for row in rows.values():
        row["ratio_to_cuda_kinetic"] = row["ms"] / base["ms"]
        row["peak_ratio_to_cuda_kinetic"] = \
            row["peak_bytes"] / base["peak_bytes"]

    # Persistence where it pays: few agents, 1024 levels, 67 MB of books.
    (pM, pA, pL), chunk = PERSISTENCE, 64
    pspec = homogeneous(pM, pA, pL, 500)
    state = opening(pspec, device)
    params = params_mod.pack_params(pspec.params, device)
    kw = dict(cfg=pspec, chunk=chunk, params=params)
    err = compare("persistence shape",
                  outputs(kc.kinetic_clearing_chunk(*state, 0, chunk, **kw),
                          chunk),
                  outputs(nc.naive_clearing_chunk(*state, 0, chunk, **kw),
                          chunk))

    def kernel():
        kc.kinetic_clearing_chunk(*state, 0, chunk, **kw)

    def naive():
        nc.naive_clearing_chunk(*state, 0, chunk, **kw)

    kernel_ms, naive_ms = [_time(kernel, 10)], []
    naive_ms += [_time(naive, 10), _time(naive, 10)]
    kernel_ms.append(_time(kernel, 10))
    naive_bytes = nc.byte_count(pM, pL, chunk, ext=False, stats_only=False)
    persistence = dict(
        markets=pM, agents=pA, levels=pL, chunk=chunk,
        book_bytes=2 * pM * pL * 4, max_abs_err=err,
        kinetic_ms=statistics.median(kernel_ms), kinetic_ms_runs=kernel_ms,
        naive_ms=statistics.median(naive_ms), naive_ms_runs=naive_ms,
        naive_over_kinetic=statistics.median(naive_ms)
        / statistics.median(kernel_ms),
        naive_design_bytes=naive_bytes,
        naive_design_bytes_ms=naive_bytes / PEAK_BYTES * 1e3,
        launch=launch_facts(pM, pA, pL),
        **bound(kc.op_count(pM, pA, pL, chunk,
                            kc.agent_mix(pspec.params, pA)),
                kc.byte_count(pM, pL, chunk, ext=False, stats_only=False)))
    emit("fixed_workload", ok=True, markets=M, agents=A, levels=L, steps=S,
         launch=launch_facts(M, A, L), backends=rows,
         persistence=persistence)
    return rows, persistence


# ---------------------------------------------------------------------------
# env: the RL environment on kernel 1 at full width
# ---------------------------------------------------------------------------

def env_outputs(state, batch) -> list:
    """A rollout's batch and final state, flat, for ``compare``."""
    import torch

    parts = list(batch[:8]) + list(state.market) + list(state.last_out) \
        + list(state.portfolio) + list(state.stats or ())
    return [p.float() if p.dtype == torch.bool else p for p in parts]


def phase_env(device):
    """``repro_torch.env`` at the Table IV width (the ``fixed_workload``
    mix): a zero-action rollout == ``Session.run``; the maker's closed loop
    on ``cuda-kinetic``, ``cuda-naive`` and ``torch-scan`` with composite
    observations and rewards, equal, and again over ring-coupled markets
    with arbitrageurs; auto-reset; a checkpoint restored into a fresh env;
    one launch of kernel 1 per env step and no wait for the card inside
    the loop; then timing."""
    import tempfile
    import time
    import warnings

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core import params as params_mod
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec
    from repro_torch.core.session import Engine
    from repro_torch.env import (BookWindow, Composite, InventoryPenalty,
                                 MarketFeatures, PnLReward,
                                 PortfolioFeatures, SpreadCapture,
                                 StatsFeatures, Sum, rollout)
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.scenario import CouplingSpec, coupled_ensemble
    from repro_torch.train import make_market_maker

    M, A, L = TABLE_IV
    spec = homogeneous(M, A, L, ENV_TIMED_STEPS)
    maker = make_market_maker(L)
    obs = Composite((MarketFeatures(), BookWindow(4), PortfolioFeatures(),
                     StatsFeatures()))
    reward = Sum((PnLReward(), SpreadCapture(), InventoryPenalty(0.01)))
    eng = Engine("cuda-kinetic", device=device)
    errs = []

    # 1. Zero actions: ENV_STEPS launches == one Session.run launch.
    reset_counts()
    final, batch = rollout(eng.env(spec, auto_reset=False), None, ENV_STEPS)
    torch.cuda.synchronize()
    zero_counts = expect_counts("env zero-action rollout",
                                {"kinetic_clearing_chunk": ENV_STEPS})
    reset_counts()
    with eng.open(spec, chunk_size=ENV_STEPS) as sess:
        ref = sess.run(ENV_STEPS)
        run_state = list(sess.state)
    torch.cuda.synchronize()
    expect_counts("env reference run", {"kinetic_clearing_chunk": 1})
    errs.append(compare("env zero actions vs Session.run",
                        list(batch[3:6]) + list(final.market),
                        list(ref) + run_state))

    # 2-3, 6. The maker's closed loop on three backends, composite obs and
    # rewards; kernel 1 (kernel 2) launched once per env step.
    builds = eng.trace_count
    runs, counts = {}, {}
    for backend, want in (
            ("cuda-kinetic", {"kinetic_clearing_chunk": ENV_STEPS}),
            ("cuda-naive", {"naive_clearing_chunk": ENV_STEPS}),
            ("torch-scan", {})):
        e = eng if backend == "cuda-kinetic" else Engine(backend,
                                                         device=device)
        env = e.env(spec, obs=obs, reward=reward)
        reset_counts()
        runs[backend] = rollout(env, maker, ENV_STEPS)
        torch.cuda.synchronize()
        counts[backend] = expect_counts(f"env maker {backend}", want)
    if eng.trace_count != builds:
        raise Mismatch(f"a second env of one shape built "
                       f"{eng.trace_count - builds} more runners")
    want = env_outputs(*runs["torch-scan"])
    for backend in ("cuda-kinetic", "cuda-naive"):
        errs.append(compare(f"env maker {backend} vs torch-scan",
                            env_outputs(*runs[backend]), want))
        if runs[backend][0].t != runs["torch-scan"][0].t:
            raise Mismatch(f"env maker {backend}: cursor differs")
    mbatch = runs["cuda-kinetic"][1]
    fills = float(mbatch.fill_buy.sum() + mbatch.fill_ask.sum())
    finite = bool(torch.isfinite(mbatch.obs).all()) and \
        bool(torch.isfinite(mbatch.reward).all())
    if not finite or fills <= 0 or tuple(mbatch.obs.shape) != (
            ENV_STEPS, M, obs.size(spec)):
        raise Mismatch(f"env maker output malformed: finite={finite} "
                       f"fills={fills} obs={tuple(mbatch.obs.shape)}")

    # The coupling freeze: ring-coupled markets with arbitrageurs read their
    # peer's mid of the step before at every env step, on every backend.
    cspec = coupled_ensemble(EnsembleSpec.homogeneous(MarketConfig(
        num_markets=M, num_agents=A, num_levels=L, num_steps=ENV_TIMED_STEPS,
        seed=SEED, alpha_arbitrageur=0.2, arb_kappa=0.5)),
        CouplingSpec.ring(M))
    coupled = {}
    for backend, want in (
            ("cuda-kinetic", {"kinetic_clearing_chunk": ENV_STEPS}),
            ("cuda-naive", {"naive_clearing_chunk": ENV_STEPS}),
            ("torch-scan", {})):
        e = eng if backend == "cuda-kinetic" else Engine(backend,
                                                         device=device)
        reset_counts()
        coupled[backend] = env_outputs(*rollout(e.env(cspec), maker,
                                                ENV_STEPS))
        torch.cuda.synchronize()
        counts[f"coupled {backend}"] = expect_counts(
            f"env coupled maker {backend}", want)
    for backend in ("cuda-kinetic", "cuda-naive"):
        errs.append(compare(f"env coupled maker {backend} vs torch-scan",
                            coupled[backend], coupled["torch-scan"]))
    _, uncoupled = rollout(eng.env(CouplingSpec.none(M).apply(cspec)), maker,
                           ENV_STEPS)
    if bool((uncoupled.price == coupled["cuda-kinetic"][3]).all()):
        raise Mismatch("env coupled maker: the coupling was inert")

    # 4. Auto-reset at ENV_HORIZON: every episode replays the first.
    env = eng.env(spec, horizon=ENV_HORIZON)
    _, rb = rollout(env, None, ENV_RESET_STEPS)
    dones = [t for t, d in enumerate(rb.done.tolist()) if d]
    if dones != list(range(ENV_HORIZON - 1, ENV_RESET_STEPS, ENV_HORIZON)):
        raise Mismatch(f"env auto-reset: done at steps {dones}")
    for k in range(ENV_HORIZON, ENV_RESET_STEPS, ENV_HORIZON):
        n = min(ENV_HORIZON, ENV_RESET_STEPS - k)
        errs.append(compare(
            f"env episode from step {k}",
            [p[:, k:k + n] for p in rb[3:6]], [p[:, :n] for p in rb[3:6]]))

    # 5. A checkpoint at ENV_CHECKPOINT into a fresh env on a fresh engine.
    env = eng.env(spec, obs=obs, reward=reward, horizon=ENV_HORIZON)
    straight = rollout(env, maker, ENV_RESET_STEPS)
    head, _ = rollout(env, maker, ENV_CHECKPOINT)
    with tempfile.TemporaryDirectory() as tmp:
        env.save_checkpoint(CheckpointManager(tmp, async_write=False), head,
                            step=ENV_CHECKPOINT)
        fresh = Engine("cuda-kinetic", device=device).env(
            spec, obs=obs, reward=reward, horizon=ENV_HORIZON)
        restored = fresh.restore_checkpoint(
            CheckpointManager(tmp, async_write=False))
    tail = rollout(fresh, maker, ENV_RESET_STEPS - ENV_CHECKPOINT,
                   state=restored)
    got, want = env_outputs(*tail), env_outputs(*straight)
    cut = ENV_CHECKPOINT
    want = [want[0][cut:], want[1][cut:], want[2][cut:]] + \
        [p[:, cut:] for p in want[3:8]] + want[8:]
    errs.append(compare("env checkpoint continuation", got, want))

    # Nothing waits for the card inside the loop: the lines of the
    # synchronizing calls torch reports over a maker rollout (its reset
    # outside).
    env = eng.env(spec)
    state0, _ = env.reset()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            rollout(env, maker, ENV_STEPS, state=state0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # torch's one-time notice that the mode is a prototype is not a sync.
    syncs = [f"{Path(w.filename).name}:{w.lineno}: {w.message}"
             for w in caught if "synchroniz" in str(w.message).lower()
             and "prototype" not in str(w.message)]
    if syncs:
        raise Mismatch(f"env rollout waited for the card: {syncs}")

    # 7. Timing: the maker's closed loop against Session.run on the card.
    rollout(env, maker, 8)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    rollout(env, maker, ENV_TIMED_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed_counts = expect_counts("env timed rollout",
                                 {"kinetic_clearing_chunk": ENV_TIMED_STEPS})
    with eng.open(spec) as sess:  # a warm run, then the timed one
        sess.run(ENV_TIMED_STEPS)
    torch.cuda.synchronize()
    with eng.open(spec) as sess:
        t0 = time.perf_counter()
        sess.run(ENV_TIMED_STEPS)
        torch.cuda.synchronize()
        run_wall = time.perf_counter() - t0
    # Kernel 1 at chunk=1 on an env step's operands: its device time (the
    # launches queued behind a sleep, the peer column given, so nothing
    # else runs), and the wrapper's time a call back to back (host-bound).
    state = opening(spec, device)
    eb, ea = env._lower(maker(env.observe(env.reset()[0]), 0), False)
    kw = dict(cfg=spec, chunk=1, peer_mid=state[3].clone(),
              market_ids=torch.arange(M, dtype=torch.int32, device=device),
              params=params_mod.pack_params(spec.params, device))

    def kernel():
        kc.kinetic_clearing_chunk(*state, 0, 1, eb, ea, **kw)

    kernel_ms = _queued_ms(kernel, 50)
    wrapper_ms = _time(kernel, 200)
    steps_per_s = ENV_TIMED_STEPS / wall
    timing = dict(
        steps=ENV_TIMED_STEPS, wall_s=wall, steps_per_s=steps_per_s,
        agent_events_per_s=M * A * steps_per_s,
        kernel_ms_chunk1=kernel_ms, wrapper_ms_chunk1=wrapper_ms,
        busy_share=kernel_ms * 1e-3 * ENV_TIMED_STEPS / wall,
        session_run_wall_s=run_wall, over_session_run=wall / run_wall,
        launches=timed_counts["kinetic_clearing_chunk"],
        profile=profile_window(
            lambda: rollout(env, maker, ENV_PROFILED_STEPS, state=state0),
            ENV_PROFILED_STEPS))
    emit("env", ok=True, markets=M, agents=A, levels=L,
         launches={"zero_action_rollout": zero_counts["kinetic_clearing_chunk"],
                   "maker": {b: {k: n for k, n in c.items() if n}
                             for b, c in counts.items()}},
         fills=fills, synchronizing_calls=syncs, max_abs_err=max(errs),
         timing=timing)
    return max(errs)


# ---------------------------------------------------------------------------
# train: the PPO trainer on kernel 1 at full width
# ---------------------------------------------------------------------------

def train_spec(mix, markets, agents, levels, steps, seed):
    """``benchmarks/train_bench.py``'s spec: ``markets`` a scenario."""
    from repro_torch.core.params import EnsembleSpec

    return EnsembleSpec.from_scenarios(
        list(mix), num_markets=markets, num_agents=agents,
        num_levels=levels, num_steps=steps, seed=seed)


def train_outputs(ts, metrics) -> list:
    """A trainer's params, Adam state, key, metrics and final env state,
    flat, for ``compare``."""
    import torch
    from repro_torch.train.buffers import tree_leaves

    env = ts.env_state
    return tree_leaves(ts.params) + tree_leaves(ts.opt_state) + [
        ts.key.to(torch.int64)] + [metrics[k] for k in sorted(metrics)] \
        + list(env.market) + list(env.last_out) + list(env.portfolio)


def flagship_gate(device) -> dict:
    """``benchmarks/train_bench.py --full --require-win`` at its defaults on
    ``torch-scan`` with 2 seed-envs: train 48 updates on the TRAIN_MIX,
    then the greedy learned maker against the scripted maker on the
    held-out mixture (spread-capture reward, mean a step and market)."""
    from repro_torch.core.session import Engine
    from repro_torch.env import (InventoryPenalty, MarketFeatures,
                                 SpreadCapture, Sum, rollout)
    from repro_torch.train import PPOConfig, fit, make_market_maker

    g = GATE
    shape = (g["markets"], g["agents"], g["levels"], g["steps"], g["seed"])
    cfg = PPOConfig(rollout_len=g["steps"], num_updates=g["updates"],
                    num_envs=g["num_envs"], num_epochs=2, num_minibatches=4,
                    lr=1e-3, ent_coef=0.003, hidden=(32, 32),
                    seed=g["seed"])
    eng = Engine("torch-scan", device=device)
    tr = eng.trainer(train_spec(TRAIN_MIX, *shape), cfg,
                     reward=Sum((SpreadCapture(), InventoryPenalty(0.001))),
                     obs=MarketFeatures())
    out = fit(tr, total_updates=g["updates"],
              updates_per_call=max(1, g["updates"] // 4))
    held = eng.env(train_spec(HELDOUT_MIX, *shape), reward=SpreadCapture(),
                   obs=MarketFeatures())
    learned = float(tr.evaluate(out["ts"].params, env=held,
                                n_steps=g["steps"]).reward.mean())
    _, scripted = rollout(held, make_market_maker(g["levels"]), g["steps"])
    rewards = out["history"]["reward"]
    return dict(learned=learned, scripted=float(scripted.reward.mean()),
                updates=out["updates"], seconds=out["seconds"],
                reward_first=float(rewards[0]),
                reward_last=float(rewards[-1]))


def phase_train(device):
    """``repro_torch.train`` at the Table IV width over the TRAIN_MIX: equal
    trainers on three backends, no synchronizing call inside ``train()``,
    one launch a step, a checkpointed resume equal to straight updates, the
    flagship gate at the reference's bench shape, then timing."""
    import tempfile
    import time

    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.core.session import Engine
    from repro_torch.env import (InventoryPenalty, MarketFeatures,
                                 SpreadCapture, Sum, rollout)
    from repro_torch.train import (PPOConfig, TrainState, make_market_maker,
                                   restore_train_checkpoint,
                                   save_train_checkpoint)

    _, A, L = TABLE_IV
    T = TRAIN_CONFIG["rollout_len"]
    spec = train_spec(TRAIN_MIX, TRAIN_BLOCK, A, L, T, TRAIN_CONFIG["seed"])
    M = spec.num_markets
    cfg = PPOConfig(**TRAIN_CONFIG)
    reward = Sum((SpreadCapture(), InventoryPenalty(0.001)))

    def trainer(eng):
        return eng.trainer(spec, cfg, reward=reward, obs=MarketFeatures())

    # 1. Equal trainers: 2 updates on each backend, kernel 1 (kernel 2)
    # launched once per env step, nothing built, no synchronizing call.
    errs, runs, counts = [], {}, {}
    for backend, counter in (("cuda-kinetic", "kinetic_clearing_chunk"),
                             ("cuda-naive", "naive_clearing_chunk"),
                             ("torch-scan", None)):
        eng = Engine(backend, device=device)
        tr = trainer(eng)
        ts = tr.init()
        torch.cuda.synchronize()
        builds = eng.trace_count
        reset_counts()
        if counter is not None:
            torch.cuda.set_sync_debug_mode("error")
        try:
            ts, metrics = tr.train(ts, 2)
        except RuntimeError as exc:
            if "synchroniz" not in str(exc):
                raise
            raise Mismatch(f"train on {backend} waited for the card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        counts[backend] = expect_counts(
            f"train {backend}", {counter: 2 * T} if counter else {})
        if eng.trace_count != builds:
            raise Mismatch(f"train {backend} built "
                           f"{eng.trace_count - builds} runners")
        runs[backend] = (eng, tr, ts, metrics)
    want = train_outputs(*runs["torch-scan"][2:])
    for backend in ("cuda-kinetic", "cuda-naive"):
        errs.append(compare(f"train {backend} vs torch-scan",
                            train_outputs(*runs[backend][2:]), want))
    eng, tr, ts2, metrics = runs["cuda-kinetic"]
    loss = metrics["loss"]
    if tuple(loss.shape) != (2,) or not bool(torch.isfinite(
            torch.stack(list(metrics.values()))).all()):
        raise Mismatch(f"train metrics malformed: {metrics}")
    builds = eng.trace_count

    # 2. A checkpoint after 2 updates restored into a fresh trainer on a
    # fresh engine: 2 more updates equal 4 straight ones.
    ts4, m4 = tr.train(ts2, 2)
    with tempfile.TemporaryDirectory() as tmp:
        save_train_checkpoint(CheckpointManager(tmp, async_write=False), tr,
                              ts2)
        fresh = trainer(Engine("cuda-kinetic", device=device))
        restored = restore_train_checkpoint(CheckpointManager(tmp), fresh)
    resumed, m_resumed = fresh.train(restored, 2)
    errs.append(compare("train resume 2 + 2 vs 4",
                        train_outputs(resumed, m_resumed),
                        train_outputs(ts4, m4)))

    # 3. The flagship gate at the reference's bench shape.
    gate = flagship_gate(device)
    if not gate["learned"] > gate["scripted"]:
        raise Mismatch(f"the learned maker does not beat the scripted maker "
                       f"at the bench shape: {gate}")

    # 4. Timing at full width: a warm update, then TRAIN_TIMED_UPDATES.
    ts, _ = tr.train(ts4, 1)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    ts, metrics = tr.train(ts, TRAIN_TIMED_UPDATES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed_counts = expect_counts("train timed", {
        "kinetic_clearing_chunk": TRAIN_TIMED_UPDATES * T})
    split = dict(rollout_s=0.0, gae_s=0.0, update_s=0.0)
    for _ in range(TRAIN_TIMED_UPDATES):
        t0 = time.perf_counter()
        env_state, batch = tr.collect(ts)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        flat = tr.advantages(ts, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        params, opt_state, _ = tr.optimize(ts, flat)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ts = TrainState(params, opt_state, ts.key, env_state,
                        ts.update_idx + 1)
        split["rollout_s"] += t1 - t0
        split["gae_s"] += t2 - t1
        split["update_s"] += t3 - t2
    profile = dict(update=profile_window(lambda: tr.train(ts, 1), T),
                   rollout=profile_window(lambda: tr.collect(ts), T))
    env_steps = TRAIN_TIMED_UPDATES * T * M
    # The learned maker against the scripted one on the held-out mixture at
    # full width (reported, not gated).
    held = eng.env(train_spec(HELDOUT_MIX, TRAIN_BLOCK, A, L, T,
                              TRAIN_CONFIG["seed"]),
                   reward=SpreadCapture(), obs=MarketFeatures())
    reset_counts()
    learned = float(tr.evaluate(ts.params, env=held, n_steps=T)
                    .reward.mean())
    eval_counts = expect_counts("train evaluate",
                                {"kinetic_clearing_chunk": T})
    scripted = float(rollout(held, make_market_maker(L), T)[1].reward.mean())
    if eng.trace_count != builds:
        raise Mismatch(f"the trainer built {eng.trace_count - builds} "
                       "runners after its first train()")
    emit("train", ok=True, markets=M, agents=A, levels=L,
         config=TRAIN_CONFIG, launches={
             "train_2_updates": {b: {k: n for k, n in c.items() if n}
                                 for b, c in counts.items()},
             "timed": timed_counts["kinetic_clearing_chunk"],
             "evaluate": eval_counts["kinetic_clearing_chunk"]},
         sync_debug_mode={"cuda-kinetic": "error", "cuda-naive": "error"},
         max_abs_err=max(errs), gate=gate,
         timing=dict(
             updates=TRAIN_TIMED_UPDATES, wall_s=wall,
             env_steps_per_s=env_steps / wall,
             agent_events_per_s=env_steps * A / wall,
             s_per_update=wall / TRAIN_TIMED_UPDATES,
             split_s_per_update={k: v / TRAIN_TIMED_UPDATES
                                 for k, v in split.items()},
             profile=profile),
         full_width_eval=dict(learned=learned, scripted=scripted),
         card=card_line())
    return max(errs), {
        "kinetic_clearing_chunk": counts["cuda-kinetic"][
            "kinetic_clearing_chunk"],
        "naive_clearing_chunk": counts["cuda-naive"][
            "naive_clearing_chunk"]}


# ---------------------------------------------------------------------------
# serve: the gateway at full width
# ---------------------------------------------------------------------------

def serve_template():
    from repro_torch.serve import parked_template

    M, A, L = SERVE_SHAPE
    return parked_template(slots=M, num_agents=A, num_levels=L,
                           num_steps=4096, seed=SEED)


def new_gateway(backend, device, chunks, ckpt_dir=None, chunk=None):
    from repro_torch.serve import Gateway

    return Gateway(serve_template(), backend=backend,
                   chunk_size=chunk or SERVE_CHUNK,
                   queue_maxsize=chunks + 8, ckpt_dir=ckpt_dir,
                   checkpoint_every=CHECKPOINT_EVERY if ckpt_dir else 0,
                   engine_opts={"device": str(device)})


async def drain(cs):
    out = []
    while (frame := await cs.next_frame()) is not None:
        out.append(frame)
    return out


async def serve_schedule(gw, chunks, *, clients=None, events=True):
    """Open ``clients`` sessions round-robin over the presets before the
    first chunk, then follow the lead client's frames: 8 late attaches, 8
    detaches and one DeviceLoss at its LATE_AFTER-th, DETACH_AFTER-th and
    FAULT_AFTER-th frame (with ``events``). Returns every client's frames,
    the wall seconds from the first chunk (after the warm start; the
    clients' admission included) to the last frame, and the steady period:
    the mean seconds between the lead client's frames."""
    import asyncio
    import time

    from repro_torch.ops import DeviceLoss

    await gw.start(chunks=chunks)
    t0 = time.perf_counter()
    opened = [gw.open_session(PRESETS[i % len(PRESETS)], client=f"c{i}")
              for i in range(clients or SERVE_CLIENTS)]
    lead, seen, late, arrivals = opened[0], [], [], []
    while (frame := await lead.next_frame()) is not None:
        seen.append(frame)
        arrivals.append(time.perf_counter())
        if not events:
            continue
        if len(seen) == LATE_AFTER:
            late = [gw.open_session(PRESETS[k % len(PRESETS)],
                                    client=f"late{k}")
                    for k in range(LATE_CLIENTS)]
        elif len(seen) == DETACH_AFTER:
            for cs in opened[-DETACHED_CLIENTS:]:
                cs.close()
        elif len(seen) == FAULT_AFTER:
            gw.inject_fault(DeviceLoss(at_step=0))
    rest = await asyncio.gather(*(drain(cs) for cs in opened[1:] + late))
    wall = time.perf_counter() - t0
    period = (arrivals[-1] - arrivals[0]) / max(1, len(arrivals) - 1)
    return [seen] + list(rest), wall, period


def frame_table(streams):
    """{(slot, step0): float32[3, n] of mid, price, volume}."""
    import numpy as np

    return {(f.slot, f.step0): np.stack([f.mid, f.price, f.volume])
            for frames in streams for f in frames}


def save_table(path, table):
    import numpy as np

    keys = sorted(table)
    np.savez(path, keys=np.asarray(keys, np.int64).reshape(-1, 2),
             data=np.stack([table[k] for k in keys]))


def load_table(path):
    import numpy as np

    with np.load(path) as z:
        return {tuple(int(x) for x in k): d for k, d in zip(z["keys"],
                                                             z["data"])}


def compare_tables(label, got, want) -> None:
    """``got`` must hold only keys of ``want``, each equal bit for bit."""
    missing = set(got) - set(want)
    if missing:
        raise Mismatch(f"{label}: frames {sorted(missing)[:4]} have no "
                       "reference frame")
    for key, frame in got.items():
        if frame.shape != want[key].shape or not (frame == want[key]).all():
            raise Mismatch(f"{label}: frame (slot, step0)={key} differs "
                           "from the torch-scan gateway's")


def gateway_report(gw) -> dict:
    """The gateway's own measurements (its metrics registry)."""
    snap = gw.metrics.snapshot()
    windows, timings = snap["windows"], snap["timings"]

    def win(name):
        w = windows.get(name)
        return None if w is None else {k: w[k] for k in
                                       ("count", "p50", "p99", "max")}

    def agg(name):
        t = timings.get(name)
        return None if t is None else {k: t[k] for k in
                                       ("count", "total", "max")}

    return dict(
        chunk_latency_seconds=win("chunk_latency_seconds"),
        checkpoint_snapshot_seconds=win("checkpoint_snapshot_seconds"),
        checkpoint_write_seconds=win("checkpoint_write_seconds"),
        recovery_seconds=win("recovery_seconds"),
        conversion_seconds=agg("conversion_seconds"),
        swap_seconds=agg("swap_seconds"),
        restore_seconds=agg("restore_seconds"),
        chunks_dispatched=int(snap["counters"].get("chunks_total", 0)),
        recoveries=int(snap["counters"].get("recoveries_total", 0)),
        frames_published=int(snap["counters"].get("frames_published_total",
                                                  0)),
        frames_dropped=int(snap["counters"].get("frames_dropped_total", 0)),
        traces_delta=gw.traces_delta, resumed_from=gw.resumed_from,
        restart_errors=list(gw.restart_errors))


def serve_child(phase: str, ckpt_dir: str, out_dir: str) -> int:
    """One ``cuda-kinetic`` gateway process of the serve phase. ``crash``
    streams the schedule, writes its frames and report, and kills itself
    with SIGKILL (the checkpoint writer may be mid-commit); ``restart``
    restarts over ``ckpt_dir`` and streams RESTART_CHUNKS chunks."""
    import asyncio

    import torch

    device = torch.device(*CARD)

    async def crash():
        gw = new_gateway("cuda-kinetic", device, SERVE_CHUNKS, ckpt_dir)
        streams, wall, period = await serve_schedule(gw, SERVE_CHUNKS)
        return gw, streams, {"wall_s": wall, "period_s": period}

    async def restart():
        import time

        t0 = time.perf_counter()
        gw = new_gateway("cuda-kinetic", device, RESTART_CHUNKS, ckpt_dir)
        await gw.start(chunks=RESTART_CHUNKS)
        start_s = time.perf_counter() - t0   # restore, journal, warm-up
        resumed = [gw.resume_session(slot, client=f"r{slot}")
                   for slot in gw.scheduler.attached]
        streams = await asyncio.gather(*(drain(cs) for cs in resumed))
        await gw.stop()
        return gw, streams, {"start_s": start_s}

    reset_counts()
    gw, streams, extra = asyncio.run(crash() if phase == "crash"
                                     else restart())
    torch.cuda.synchronize()
    report = dict(gateway_report(gw), launches=read_counts(), **extra)
    save_table(Path(out_dir) / f"{phase}.npz", frame_table(streams))
    (Path(out_dir) / f"{phase}.json").write_text(json.dumps(report))
    if phase == "crash":
        os.kill(os.getpid(), signal.SIGKILL)
    return 0


def run_child(phase, ckpt_dir, out_dir):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py"), "serve-child", phase,
         str(ckpt_dir), str(out_dir)], capture_output=True, text=True,
        timeout=300)
    want_rc = -signal.SIGKILL if phase == "crash" else 0
    if proc.returncode != want_rc:
        raise Mismatch(f"serve {phase} child exited {proc.returncode}, "
                       f"expected {want_rc}:\n{proc.stderr[-4000:]}")
    report = json.loads((Path(out_dir) / f"{phase}.json").read_text())
    return report, load_table(Path(out_dir) / f"{phase}.npz")


def check_child(label, report) -> int:
    """traces_delta 0; kernel 1 once per chunk dispatched (a warm-up per
    engine opened, replays included), kernel 2 and the legacy kernels
    never. Returns the chunks dispatched."""
    if report["traces_delta"] != 0:
        raise Mismatch(f"{label}: traces_delta {report['traces_delta']}")
    dispatched = report["chunks_dispatched"] + 1 + report["recoveries"]
    want = {"kinetic_clearing_chunk": dispatched}
    for name, n in report["launches"].items():
        if n != want.get(name, 0):
            raise Mismatch(f"{label}: {name} launched {n} times, expected "
                           f"{want.get(name, 0)}")
    return dispatched


def serving_spec():
    """The template with the schedule's first SERVE_CLIENTS clients."""
    from repro_torch.core.config import scenario_config
    from repro_torch.core.params import EnsembleSpec

    tpl = serve_template()
    M, A, L = SERVE_SHAPE
    rows = EnsembleSpec.concatenate([EnsembleSpec.homogeneous(
        scenario_config(PRESETS[i % len(PRESETS)], num_markets=1,
                        num_agents=A, num_levels=L, num_steps=4096,
                        seed=SEED)) for i in range(SERVE_CLIENTS)])
    return tpl.replace_markets(list(range(SERVE_CLIENTS)), rows)


def phase_serve(device):
    """The serving gateway on the card: see the module docstring."""
    import asyncio
    import time

    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.session import Engine
    from repro_torch.kernels import kinetic_clearing as kc

    M, A, _ = SERVE_SHAPE
    tmp = tempfile.TemporaryDirectory()
    base = Path(tmp.name)

    # The reference: the same schedule through torch-scan, one chunk past
    # the restart's reach, launching no kernel.
    reset_counts()
    ref_gw = new_gateway("torch-scan", device, SERVE_CHUNKS + RESTART_CHUNKS,
                         base / "ref")

    async def reference():
        streams, _, _ = await serve_schedule(ref_gw,
                                             SERVE_CHUNKS + RESTART_CHUNKS)
        await ref_gw.stop()
        return streams

    ref = frame_table(asyncio.run(reference()))
    expect_counts("serve torch-scan", {})

    # The crash and the restart, each a cuda-kinetic process of its own.
    crash, crash_frames = run_child("crash", base / "ckpt", base)
    restart, restart_frames = run_child("restart", base / "ckpt", base)
    horizon = SERVE_CHUNKS * SERVE_CHUNK
    resumed = restart["resumed_from"]
    want_crash = {k for k in ref if k[1] < horizon}
    want_restart = {k for k in ref
                    if resumed <= k[1] < resumed + RESTART_CHUNKS
                    * SERVE_CHUNK}
    for label, frames, want in (("serve crash", crash_frames, want_crash),
                                ("serve restart", restart_frames,
                                 want_restart)):
        if set(frames) != want:
            raise Mismatch(f"{label}: {len(frames)} frames, the reference "
                           f"has {len(want)} at those steps")
        compare_tables(label, frames, ref)
    dispatched = {"crash": check_child("serve crash", crash),
                  "restart": check_child("serve restart", restart)}
    if (crash["recoveries"] != 1 or resumed is None
            or restart["restart_errors"]):
        raise Mismatch(f"serve: recoveries {crash['recoveries']}, resumed "
                       f"{resumed}, errors {restart['restart_errors']}")

    # cuda-naive: kernel 2 once per step (warm-up included), same frames.
    reset_counts()
    naive_gw = new_gateway("cuda-naive", device, NAIVE_CHUNKS)

    async def naive():
        streams, _, _ = await serve_schedule(naive_gw, NAIVE_CHUNKS,
                                             clients=NAIVE_CLIENTS,
                                             events=False)
        await naive_gw.stop()
        return streams

    naive_frames = frame_table(asyncio.run(naive()))
    torch.cuda.synchronize()
    naive_launches = expect_counts("serve cuda-naive", {
        "naive_clearing_chunk": (NAIVE_CHUNKS + 1) * SERVE_CHUNK})
    if len(naive_frames) != NAIVE_CLIENTS * NAIVE_CHUNKS:
        raise Mismatch(f"serve cuda-naive: {len(naive_frames)} frames")
    compare_tables("serve cuda-naive", naive_frames, ref)

    # Fault-free cuda-kinetic: served agent-events/s and latency at chunk
    # 64, then latency at chunk 16.
    def fault_free(chunk, chunks):
        reset_counts()
        gw = new_gateway("cuda-kinetic", device, chunks, chunk=chunk)

        async def go():
            out = await serve_schedule(gw, chunks, events=False)
            await gw.stop()
            return out

        streams, wall, period = asyncio.run(go())
        torch.cuda.synchronize()
        rep = gateway_report(gw)
        expect_counts(f"serve fault-free chunk {chunk}",
                      {"kinetic_clearing_chunk": chunks + 1})
        if len(frame_table(streams)) != SERVE_CLIENTS * chunks:
            raise Mismatch(f"serve fault-free chunk {chunk}: frames lost")
        return dict(rep, wall_s=wall, period_s=period)

    served = fault_free(SERVE_CHUNK, SERVE_CHUNKS)
    latency = fault_free(LATENCY_CHUNK, LATENCY_CHUNKS)

    # A bare Session.run of the same 16 chunks, and kernel 1's time at the
    # serving mix (CUDA events), for the busy share.
    spec = serving_spec()
    eng = Engine("cuda-kinetic", device=device)
    eng.warm(spec, include_step=False)
    with eng.open(spec, chunk_size=SERVE_CHUNK) as sess:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run(SERVE_CHUNKS * SERVE_CHUNK)
        torch.cuda.synchronize()
        bare_wall = time.perf_counter() - t0
    state = opening(spec, device)
    params = params_mod.pack_params(spec.params, device)
    kernel_ms = {}
    for chunk in (SERVE_CHUNK, LATENCY_CHUNK):
        kw = dict(cfg=spec, chunk=chunk, params=params)
        kernel_ms[chunk] = _time(
            lambda: kc.kinetic_clearing_chunk(*state, 0, chunk, **kw), 10)
    reset_counts()
    steps = SERVE_CHUNKS * SERVE_CHUNK
    out = dict(
        slots=M, agents=A, levels=SERVE_SHAPE[2], chunk=SERVE_CHUNK,
        clients=SERVE_CLIENTS, chunks=SERVE_CHUNKS,
        frames_checked={"crash": len(crash_frames),
                        "restart": len(restart_frames),
                        "naive": len(naive_frames)},
        reference_frames=len(ref), max_abs_err=0.0,
        launches={"crash": crash["launches"], "restart": restart["launches"],
                  "naive": naive_launches},
        chunks_dispatched=dispatched, resumed_from=resumed,
        crash=crash, restart=restart,
        served_agent_events_per_s=M * A * steps / served["wall_s"],
        steady_agent_events_per_s=M * A * SERVE_CHUNK / served["period_s"],
        bare_session_agent_events_per_s=M * A * steps / bare_wall,
        bare_session_wall_s=bare_wall,
        kernel_ms={str(k): v for k, v in kernel_ms.items()},
        device_busy_share=kernel_ms[SERVE_CHUNK] * 1e-3 * SERVE_CHUNKS
        / served["wall_s"],
        steady_device_busy_share=kernel_ms[SERVE_CHUNK] * 1e-3
        / served["period_s"],
        served=served,
        latency_chunk=LATENCY_CHUNK, latency_chunks=LATENCY_CHUNKS,
        latency=latency,
        latency_device_busy_share=kernel_ms[LATENCY_CHUNK] * 1e-3
        * LATENCY_CHUNKS / latency["wall_s"],
        latency_steady_device_busy_share=kernel_ms[LATENCY_CHUNK] * 1e-3
        / latency["period_s"])
    emit("serve", ok=True, **out)
    tmp.cleanup()
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "serve-child":
        return serve_child(*sys.argv[2:])
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import time

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    t0 = time.perf_counter()
    device = torch.device(*CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    err_k = max(phase_kernel(device, MARKETS_PER_BLOCK), phase_edges(device))
    err_n = phase_kernel(device, MARKETS_PER_BLOCK, entry="naive")
    err_l = phase_legacy(device)
    launches, session_errs = phase_session(device, MARKETS_PER_BLOCK)
    _, err_p = phase_parity(device)
    err_sc = phase_scenario(device)
    timing = phase_timing(device)
    err_s = phase_agent_sweep(device)
    legacy = phase_legacy_path(device)
    phase_fixed_workload(device)
    err_env = phase_env(device)
    err_train, train_launches = phase_train(device)
    serve = phase_serve(device)
    launches.update(legacy["launches"])
    for name, n in train_launches.items():
        launches[name] += n
    errs = {"kinetic_clearing_chunk":
            max(err_k, err_s, session_errs["kinetic_clearing_chunk"],
                err_p, err_sc, err_env, err_train, serve["max_abs_err"]),
            "naive_clearing_chunk":
            max(err_n, err_s, session_errs["naive_clearing_chunk"],
                err_p, err_env, err_train, serve["max_abs_err"]),
            "kinetic_clearing":
            max(err_l, legacy["max_abs_err"]["kinetic_clearing"]),
            "naive_clearing":
            max(err_l, legacy["max_abs_err"]["naive_clearing"])}
    times = {"kinetic_clearing_chunk": (timing["ms"], timing["plain_ms"],
                                        timing),
             "naive_clearing_chunk": (timing["naive_ms"], timing["plain_ms"],
                                      timing),
             "kinetic_clearing": (legacy["kinetic_ms"], legacy["plain_ms"],
                                  legacy),
             "naive_clearing": (legacy["naive_ms"], legacy["plain_ms"],
                                legacy)}
    sources = {"kinetic_clearing_chunk": (kc.SOURCE, kc.REPLACES),
               "naive_clearing_chunk": (nc.SOURCE, nc.REPLACES),
               "kinetic_clearing": (kc.SOURCE, kc.LEGACY_REPLACES),
               "naive_clearing": (nc.SOURCE, nc.LEGACY_REPLACES)}
    kernels = []
    for name, (source, replaces) in sources.items():
        if launches[name] <= 0:
            raise Mismatch(f"{name} was not launched on its path")
        ms, plain_ms, b = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "library_ms": None})
    emit("done", ok=True, seconds=time.perf_counter() - t0)
    print(card_line(), flush=True)  # the card's name and power limit
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
