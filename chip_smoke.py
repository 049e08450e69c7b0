#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py        # needs one CUDA card; takes no arguments
    python3 chip_smoke.py env-rates SRC   # the sharded env's rates, with
                                          # the port of the tree SRC
    python3 chip_smoke.py host-column     # the CPU column alone (no card)

Every run drives every phase at full width. Phases, each printing one JSON
line:

  build    build the CUDA kernels from ``src/repro_torch/kernels/csrc``, one
           ``nvcc`` per source, all started together; each kernel's
           registers and spills from ptxas (``-Xptxas -v``), the persistent
           kernels once per agent mode (``<0, ...>`` shared, ``<1, ...>``
           registers, ``<2, ...>`` fresh) at one CTA a market
           (``<code, false>``) and on a market cluster (``<code, true>``),
           the per-step kernels likewise (``<false>``, ``<true>``); any
           spill fails.
  kernel   ``kinetic_clearing_chunk`` (CUDA) == its plain PyTorch version,
           field by field, at the paper's width A=256, L=128 on a
           heterogeneous ensemble populating all eight archetypes: a chunk
           holding the shock step, a partial tail, external orders,
           ``stats_only``, and ``scan="hillis-steele"``.
  edges    the same check at L=1024, A=300, at L=8, A=5 and at L=4, A=16,
           the last two with 15 markets (a ragged last CTA); then kernels 1
           and 3 on a few large markets (10 markets, 6 steps: L=128,
           A=50,000 and L=1024, A=45,000 past shared memory; B1 L=128,
           A=46,080, the last population one CTA's shared memory holds; B2
           L=1024, A=20,000) against their plain versions at one CTA a
           market, at the earlier rule's shape (pinned in ``FRESH_SHAPES``)
           and on the rule's market cluster (16 CTAs a market), with
           each shape's ``TileChoice`` (mode, W, C), grid and its share of
           the SMs, resident clusters, times and share of the bound; and
           kernel 2 there at one CTA a market and on its own rule's
           cluster, == its plain version, timed in turns beside kernel 1
           (the ablation at equal layouts).
  population  large populations through the main path: P1 one market of
           100,000 agents (L=128, S=16), P2 16 markets of 50,000 (L=1024,
           S=32), P3 128 markets of 50,000 (L=128, S=32), Q1 one market of
           40,000, Q2 64 of 30,000 and Q3 264 of 30,000 (L=128, S=32),
           every archetype, a shock, ring-coupled arbitrageurs. For each,
           ``Engine("cuda-kinetic").open(spec).run(S)`` in one chunk (its
           tile sweep included) and the legacy ``kinetic_clearing``, each
           with the counts at 0, == their plain versions on the card (P1
           also == the host ``numpy`` reference); then kernels 1 and 3 at
           one CTA a market (C = 1, pinned), at the earlier rule's shape
           (pinned in ``POPULATION``) and at the rule's shape, each == the
           plain versions, in turns: ms, the
           bound and its share, the mode, W and C, the grid, its share of
           the SMs, the resident clusters and agent-events/s. Then the
           ablation at P1, Q1 and B1 (10 markets of 46,080, L=128, S=6):
           ``Engine("cuda-naive").open(spec).run(S)`` (S launches of
           kernel 2 on its rule's market cluster, its sweep included) with
           the counts at 0, == the plain version (P1 also == the host
           ``numpy`` reference), the legacy ``naive_clearing`` at P1; and
           kernel 2 at one CTA a market and on its rule's cluster, timed
           in turns beside kernel 1: tile, grid, SM share, clusters held,
           ms, the bound's share and the ratios to kernel 1 at one CTA a
           market and on both rules' clusters.
  exact_2_24  exactness past 2^24 (M=2, A=100,000, L=8, S=120: books of
           3·10^7 a level): ``cuda-kinetic`` and ``cuda-naive`` on their
           rules' clusters of 16 CTAs equal each other (the gate); where
           each first differs from its plain version and from the host
           ``numpy`` reference, and the largest gap (no gate).
  naive    ``naive_clearing_chunk`` (one launch per step) == its plain
           version over the five cases of ``kernel``, then on a market
           cluster of C = 2, 4, 8, 16 CTAs at A=3,001 (one and eight warps
           at L=128, eight at L=1024): external orders over the shock, a
           partial chunk, ``stats_only``.
  legacy   the legacy one-shot ``kinetic_clearing`` and ``naive_clearing``
           == ``ref.simulate_reference`` on the card at M=1024, A=256,
           L=128, S=64 (baseline, arbitrageur, flash-crash, informed) and
           at the L=1024, L=8 and L=4 edges; then ``naive_clearing`` on a
           market cluster of C = 2, 4, 8, 16 CTAs at ``naive``'s shapes.
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
           market, trade count, volatility) are within 0.1% of it. The
           reference is the NumPy program of ``repro_torch.core.host``,
           independent of the torch step. Prints the configurations held,
           the mismatches and the reference's seconds; any mismatch fails.
  cross_stream  the paper's statistical equivalence at scale (M=4096,
           A=64, L=64, S=100): ``cuda-kinetic`` on the card == the host
           ``numpy`` reference field by field (the gate), then the relative
           gaps of the mean clearing price and the volume per market of
           ``numpy-splitmix64`` and ``numpy-pcg64`` (other streams) to it
           (a measurement: no gate).
  open_fill the open fill (``kernels/open_fill.py``, one launch of
           ``open_fill_kernel`` from each library) at the sweeps' shapes:
           Table IV, ``table3_a1024`` and ``wide_book`` (M=8192, one
           block, L=128 and 1024), ``stress_mix`` (9 x 1024 presets,
           ring-coupled: a block a market) and nine ragged blocks of 111:
           params, books, mids and stats bit for bit equal to its plain
           version and to the host open (``pack_params`` +
           ``initial_state`` + ``init_stats``), the host int block equal to
           ``pack_params``' copy, one launch a call; then the kernel's
           device time against the bound (bytes written), and the open's
           host wall through the fill against the host open's.
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
           peak memory and the ratio to ``cuda-kinetic``; the CPU column:
           the ``numpy`` reference's steps at Table IV (one warm-up, then
           4 timed; ms a step, agent-events/s, the 500-step time from the
           rate, ``cuda-kinetic``'s agent-events/s over it) beside the same
           steps through ``torch-scan`` on the CPU, with the host's CPU
           model, cores, NumPy's version and torch's threads; then the two
           chunk kernels alone at M=8192, A=32, L=1024 (books beyond L2).
  env      the RL environment (``repro_torch.env``) at the Table IV width,
           every rollout run twice from one state: the first call of its
           key (the eager body, captured into a CUDA graph) and a replay,
           equal bit for bit, with the counts at 0 before each (one launch
           of kernel 1 or 2 a step at replay): a zero-action rollout of 64
           steps on ``cuda-kinetic`` == ``Session.run(64)`` (one launch),
           paths and books; the scripted maker's closed loop for 64 steps
           with composite observations (market, book window, portfolio,
           stats) and a summed reward on ``cuda-kinetic``, ``cuda-naive``,
           ``torch-scan`` and ``torch-per-step``, equal in obs, reward,
           done, fills, paths and final state, and again over ring-coupled
           markets with arbitrageurs (and ``cuda-kinetic`` uncoupled); no
           runner built and one graph captured for a second env; auto-reset
           at horizon 16 over 40 steps, every episode replaying the first;
           a checkpoint at step 24 restored into a fresh env, continuing as
           the straight rollout; a first 500-step call captures one graph
           (its wall and the bytes it keeps) and a warm one captures nothing
           under torch's sync debug mode at error; then 500 maker steps,
           the graph and the eager body (the host loop) in turns: steps/s,
           agent-events/s, kernel 1 at ``chunk=1`` (its device time, CUDA
           events around launches queued behind a sleep; and the wrapper's
           time a call back to back), the card's busy share, the ratio to
           ``Session.run(500)``, and ``torch.profiler`` windows of 50 steps
           of each (CUDA kernels and device time a step).
  train    the PPO trainer (``repro_torch.train``) at the Table IV width
           over 4096 ``flash-crash`` and 4096 ``high-vol`` markets (rollout
           64, 2 epochs of 8 minibatches, hidden (32, 32)): on
           ``cuda-kinetic``, ``cuda-naive`` and ``torch-scan`` 2 updates
           (the first captures the update's CUDA graph) and 2 warm ones
           (replays, nothing captured, torch's sync debug mode at error),
           equal to the eager body's 2 + 2 in params, Adam state, key,
           metrics and final env state, the backends equal, kernel 1
           (kernel 2) launched once per env step; 2 updates, a checkpoint
           restored into a fresh trainer and into the warm one (no capture)
           and 2 more == 4 straight updates; at most two graphs a trainer
           (its update and its greedy rollout); the flagship gate at
           ``benchmarks/train_bench.py --full``'s shape on ``torch-scan``
           (the learned maker must beat the scripted one on the held-out
           mixture); then 8 timed updates, the graph and the eager body in
           turns: env (market-)steps/s, agent-events/s, the eager wall of
           rollout, GAE and update, ``torch.profiler`` windows over one
           update (graph and eager) and one rollout (busy share, CUDA
           kernels a step), and the learned against the scripted maker at
           full width (reported).
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
  autotune every launch shape ``autotune.candidate_tiles`` gives the four
           kernels (every (warps a market, markets a CTA, agent mode) the C
           entries accept), each held bit for bit against one plain output
           per shape at 264 markets (two waves of 132 SMs at one market a
           CTA; cut from 8192): kernels 1 and 2 at Table IV, A=16 and
           A=1024 (L=128) and A=32, L=1024 (chunk 64, every archetype, a
           shock, ring peers), kernels 3 and 4 at Table IV (S=64); then
           kernels 1 and 2's candidates timed at M=8192 against the bound
           (the rule's tile first, the winner against it). Then
           ``Engine(autotune="auto")`` sweeps once and a second open hits
           the cache, ``run(500)`` at Table IV through the rule's tile and
           the sweep's winner in turns (equal, timed), and ``AutotuneOOM``
           through ``run_plan``: the restart's sweep falls back to the
           rule's tile, the stream bitwise.
  sharded  the market axis over meshes naming the one card twice and three
           times (``MarketsMesh.of``): ``Session.run(500)`` at Table IV
           (homogeneous; ring-coupled across all 8192 markets with every
           archetype, paths and ``stats_only``), ``cuda-naive``, a snapshot
           from 2 shards restored onto 1 and 3, 64 env steps on 2 and 3
           shards (every ``EnvState`` leaf its shards' own rows after every
           step) and 2 trainer updates on 2 shards (torch's sync debug mode
           at error; the env state resident after them) equal the
           unsharded runs, with launches = shards x chunks (x steps for
           kernel 2); the bytes 50 maker env steps move on 2 shards
           (``scatter`` of the order triple, the ring, ``gather`` of the
           observation, reward and info) equal to their closed form to the
           byte; a 2-shard env checkpoint restored onto 1 and 3 shards
           continues the straight rollout; the maker's env at Table IV on
           1, 2 and 3 shards (one shard a CUDA graph, the meshes the host
           loop): steps/s, CUDA kernels and bytes moved a step;
           ``DeviceLoss(devices_after=1)``
           from 2 shards in ``run_plan`` and under a gateway of 8 clients,
           bitwise; ``devices=2`` on one card raises the mesh's
           ``ValueError``; each shard's rows on its device after every
           chunk of ``run(500)`` (state, params, market ids, stats), in
           storage of their own; the bytes ``run(500)`` moves under a
           ``Roofline`` equal to the resident closed form (no ``scatter``,
           (n-1)·M·4 ``collective-permute`` bytes a chunk, the joined
           paths' ``gather``); peak device bytes, the wall and device
           time of ``run(500)`` on 1, 2 and 3 shards, and one 64-step
           kernel-1 call on every row against one on each shard's rows.
  roofline ``repro_torch.launch.roofline``: ``Session.run(500)`` at Table
           IV with and without a ``Roofline``, equal; its kernel records
           equal to the launches counted (8) and to ``op_count``/
           ``byte_count`` over the eight chunks, its bound and the bound
           over the run's wall; the same run on a mesh naming the card
           twice: per-device totals summing to the unsharded ones, the
           ring's and the joins' bytes equal to their closed form; then one
           64-step ``torch-scan`` chunk, 50 maker env steps (the first call,
           the eager body, and a replay of its graph recording the same
           kernels, aten ops and bytes) and one trainer update (a replay,
           torch's sync debug mode at error) under the recorder, each equal
           to its unrecorded run: aten ops a step, flops, bytes and the
           bound, beside ``torch.profiler``'s CUDA kernels a step; the
           update's backward dots 1.5-2x its forward dots.

Each path is driven with every launch count at 0 just before it and read
just after; the ``kernels`` line's launches are the ``session`` phase's
(and the ``legacy_path`` phase's), plus the ``train`` phase's 2 warm
updates (replays of the update's CUDA graph),
the ``autotune`` phase's candidate checks and the ``sharded``,
``roofline``, ``population``, ``exact_2_24`` and ``open_fill`` phases'
paths. Every
launch is counted where it is made, the runners' own tile sweeps
included (a ``cuda-kinetic``/``cuda-naive`` runner opened on the card
times each candidate once per key, ``autotune.TRIALS`` + 1 calls, each
one launch of kernel 1 or one a step of kernel 2, on a market cluster
too): each window
expects its path's launches plus those its sweeps record, and a sweep
that lost a candidate fails the run. Each session such a runner opens on
one card (no mesh) launches the open fill once; every window counts
those sessions and expects as many fills. The ``open_fill`` entry of the
``kernels`` line gives the kernel's device ms at Table IV and, as its
``plain_ms``, the host open it replaces (host wall, card synchronised).
The ``timing``, ``agent_sweep``, ``legacy_path`` and
``fixed_workload`` lines give each timed shape's launch shape
(``autotune.auto_tile``) and resident CTAs per SM
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor``). The line before the
last two lists every kernel with its launches on its path; the last line
is the device record. Any mismatch or exception
exits non-zero before those lines. Imports nothing of JAX or of the JAX
package.
"""
from __future__ import annotations

import contextlib
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
# The CPU column: the numpy reference's steps at Table IV, after a warm-up.
HOST_STEPS = 4
# The paper's CPU-vs-card statistical equivalence (tests/test_cross_backend
# .py's A and L at the paper's M = 4096).
CROSS_SHAPE = (4096, 64, 64, 100)
CROSS_SEED = 11
PRODUCT_SWEEP = {"alpha_momentum": (0.15, 0.3, 0.5, 0.7),
                 "p_marketable": (0.1, 0.2)}
# The edges phase's large markets: (M per block of small_spec, A, L, the
# earlier rule's shape) past shared memory at L=128 and L=1024, B1 the
# last population one CTA's shared memory holds at L=128, B2 a wide book;
# and the steps of each call. The earlier rule's shape (warps a market,
# markets a CTA, agent mode, CTAs a market) is what the rule launched for
# these markets (10) on an H100 before the hoisted agent modes took market
# clusters, pinned beside the rule's.
FRESH_SHAPES = ((2, 50000, 128, (8, 1, "fresh", 16)),
                (2, 45000, 1024, (8, 1, "fresh", 16)),
                (2, 46080, 128, (1, 1, "shared", 1)),
                (2, 20000, 1024, (8, 1, "shared", 1)))
FRESH_STEPS = 6
#: The population phase's shapes (label, M, A, L, S, the earlier rule's
#: shape as in ``FRESH_SHAPES``): past shared memory one deep market, a few
#: assets with wide books, and as many markets as the card has SMs; within
#: it one exchange, half the SMs' markets and two markets an SM. A·8·S
#: stays below 2^24 in each (whales add 2% of agents at 32 lots every 4th
#: step), so books, bins and scans stay exact-integer float32.
POPULATION = (("P1", 1, 100000, 128, 16, (8, 1, "fresh", 16)),
              ("P2", 16, 50000, 1024, 32, (8, 1, "fresh", 16)),
              ("P3", 128, 50000, 128, 32, (8, 1, "fresh", 2)),
              ("Q1", 1, 40000, 128, 32, (1, 1, "shared", 1)),
              ("Q2", 64, 30000, 128, 32, (1, 1, "shared", 1)),
              ("Q3", 264, 30000, 128, 32, (1, 1, "shared", 1)))
#: The open fill's cases: (markets, agents, levels, stats_only, blocks),
#: blocks "one" (``homogeneous``), "nine" (the presets, ``from_scenarios``)
#: or "ring" (the presets ring-coupled: a block a market). The first four
#: are the sweep cells' specs; the last leaves the last CTA ragged.
FILL_CASES = {"table_iv": (8192, 256, 128, False, "one"),
              "table3_a1024": (8192, 1024, 128, False, "one"),
              "wide_book": (8192, 32, 1024, True, "one"),
              "stress_mix": (9216, 256, 128, True, "ring"),
              "nine_ragged": (999, 256, 128, True, "nine")}
#: Team shapes (W, L) at which the naive and legacy phases hold kernels 2
#: and 4 on a market cluster of every C > 1, at a population past the
#: registers mode (8·32·W agents).
STEP_CLUSTERS = ((1, 128), (8, 128), (8, 1024))
CLUSTER_AGENTS = 3001
#: Past 2^24: two markets of 100,000 agents at L=8 whose resting books
#: reach 3.08·10^7 a level in 120 steps (``exact_2_24``).
EXACT_CONFIG = dict(num_markets=2, num_agents=100000, num_levels=8,
                    num_steps=120, seed=5, q_max=20, p_marketable=0.0,
                    initial_quote_qty=1000.0)
#: The ablation's large populations through ``cuda-naive`` (label, M, A,
#: L, S): P1 and Q1 as in ``POPULATION``, and B1 (``FRESH_SHAPES``' last
#: population one CTA's shared memory holds) with ``POPULATION_MIX``.
NAIVE_POPULATION = (("P1", 1, 100000, 128, 16), ("Q1", 1, 40000, 128, 32),
                    ("B1", 10, 46080, 128, 6))
POPULATION_MIX = dict(alpha_fundamentalist=0.1, alpha_whale=0.02,
                      whale_period=4, alpha_hft=0.1, alpha_informed=0.05,
                      alpha_arbitrageur=0.1, shock_intensity=0.3,
                      shock_cancel=0.5)
POPULATION_REPS = 5
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
    from repro_torch.kernels import open_fill

    return {"kinetic_clearing_chunk": kc.kinetic_clearing_chunk,
            "naive_clearing_chunk": nc.naive_clearing_chunk,
            "kinetic_clearing": kc.kinetic_clearing,
            "naive_clearing": nc.naive_clearing,
            "open_fill": open_fill.open_fill}


#: The tile sweeps already on record when the counts were last reset.
_SWEEPS_SEEN: list = []
#: Sessions a kernel runner opened on one card since the counts were last
#: reset (each opens through one launch of the open fill).
_CARD_OPENS = [0]


def count_card_opens() -> None:
    """Count, from now on, every ``Session`` whose runner is a kernel
    runner on one card (``cuda-kinetic`` or ``cuda-naive``, no mesh)."""
    from repro_torch.core import session
    from repro_torch.kernels.ops import ClearingChunkRunner

    init = session.Session.__init__
    if getattr(init, "counts_card_opens", False):
        return

    def counted(self, engine, spec, runner, *args, **kwargs):
        init(self, engine, spec, runner, *args, **kwargs)
        if (isinstance(runner, ClearingChunkRunner)
                and runner.device.type == "cuda" and runner.mesh.size == 1):
            _CARD_OPENS[0] += 1

    counted.counts_card_opens = True
    session.Session.__init__ = counted


def reset_counts() -> None:
    from repro_torch.kernels import autotune

    count_card_opens()
    for fn in counters().values():
        fn.launches = 0
    _SWEEPS_SEEN[:] = autotune.sweep_reports()
    _CARD_OPENS[0] = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def sweep_launches() -> dict:
    """The launches of the runners' tile sweeps since the counts were
    reset, by kernel: a runner opened on the card times each candidate
    with 1 + ``autotune.TRIALS`` calls of its wrapper, each one launch of
    kernel 1 or one a step of kernel 2 (the key's chunk), whatever the
    candidate's CTAs a market."""
    from repro_torch.kernels import autotune

    seen = {id(r) for r in _SWEEPS_SEEN}
    out = {}
    for rep in autotune.sweep_reports():
        if id(rep) in seen:
            continue
        kernel = dict(rep.key[4:])["kernel"]
        per_call = 1 if kernel == "kinetic_clearing_chunk" else rep.key[3]
        out[kernel] = out.get(kernel, 0) + \
            (1 + autotune.TRIALS) * per_call * len(rep.times)
    return out


def check_sweeps(label: str) -> None:
    """A candidate the card refused in a runner's sweep is a kernel fault,
    not a shape to drop: no sweep on record may hold a failure."""
    from repro_torch.kernels import autotune

    for rep in autotune.sweep_reports():
        if rep.failures:
            raise Mismatch(f"{label}: the tile sweep of {rep.key} lost "
                           f"{len(rep.failures)} candidates: "
                           f"{list(rep.failures)}")


def expect_counts(label: str, want) -> dict:
    """Read the counts after a path and check them: ``want`` names the
    kernels the path must launch (and how often), to which the tile sweeps
    of the runners it opened add theirs, and the open fill one launch for
    each session a kernel runner opened on one card; every other kernel
    must not have launched. Returns every launch counted, sweeps and fills
    included."""
    check_sweeps(label)
    got, swept = read_counts(), sweep_launches()
    swept["open_fill"] = _CARD_OPENS[0]
    for name, n in got.items():
        need = want.get(name, 0) + swept.get(name, 0)
        if n != need:
            raise Mismatch(f"{label}: {name} launched {n} times, expected "
                           f"{want.get(name, 0)} on the path and "
                           f"{swept.get(name, 0)} in tile sweeps or "
                           f"opens on one card")
    return got


def kernel_vs_plain(label, spec, device, *, step0, n_valid, chunk,
                    ext=False, stats_only=False, scan="cumsum", state=None,
                    entry="kinetic", tile=None):
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
    got = kernel(*state, step0, n_valid, eb, ea, tile=tile, **kw)
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
    # The persistent kernels once per agent mode (the AGENT_MODES index) at
    # one CTA a market (<code, false, 4>) and on a market cluster
    # (<code, true, 4>), four levels a lane, and in the registers mode at
    # one CTA a market at 8, 16 and 32 levels a lane (<1, false, lpl>);
    # the per-step kernels at one CTA a market (<false>) and on a market
    # cluster (<true>).
    registers = autotune.AGENT_MODES.index("registers")
    kernels = tuple(f"kinetic_{k}_kernel<{code}, {cluster}, 4>"
                    for k in ("chunk", "legacy")
                    for code in range(len(autotune.AGENT_MODES))
                    for cluster in ("false", "true")) + tuple(
        f"kinetic_{k}_kernel<{registers}, false, {lpl}>"
        for k in ("chunk", "legacy") for lpl in (8, 16, 32)) + tuple(
        f"naive_{k}_step_kernel<{cluster}>" for k in ("chunk", "legacy")
        for cluster in ("false", "true"))
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
    clusters = naive_cluster_cases(device) if entry == "naive" else {}
    emit("kernel" if entry == "kinetic" else entry, ok=True,
         markets=spec.num_markets, agents=256, levels=128,
         cases=list(errs), max_abs_err=max(errs.values()),
         traded_volume=volumes, clusters=clusters)
    return max([*errs.values(), *clusters.values()])


def step_cluster_tiles():
    """(W, L, C, tile) of every market cluster at which the naive and
    legacy phases hold kernels 2 and 4: each team shape of
    ``STEP_CLUSTERS`` at every C > 1, at ``CLUSTER_AGENTS`` agents."""
    from repro_torch.kernels import autotune

    A = CLUSTER_AGENTS
    return [(W, L, C, autotune.TileChoice(
        L, A, W, 1, autotune.auto_tile(L, A).agents, C))
        for W, L in STEP_CLUSTERS for C in autotune.CTAS_PER_MARKET[1:]]


def naive_cluster_cases(device) -> dict:
    """Kernel 2 on a market cluster (:func:`step_cluster_tiles`) ==
    its plain version: a chunk holding the shock step with external
    orders and a partial tail, and ``stats_only``; max error by case."""
    errs = {}
    for W, L, C, tile in step_cluster_tiles():
        spec = small_spec(3, CLUSTER_AGENTS, L, num_steps=20)
        for case, kw in (("ext", dict(step0=4, n_valid=9, chunk=12,
                                      ext=True)),
                         ("stats", dict(step0=2, n_valid=12, chunk=12,
                                        stats_only=True))):
            label = f"W={W} L={L} C={C} {case}"
            errs[label], _ = kernel_vs_plain(
                f"naive cluster {label}", spec, device, entry="naive",
                tile=tile, **kw)
    return errs


def phase_edges(device):
    """Kernel 1 at the launch rule's edges, then kernels 1 and 3 on a few
    large markets (``FRESH_SHAPES``) against their plain versions, bit for
    bit, at one CTA a market, at the earlier rule's shape and on the rule's
    market cluster, with their times; and kernel 2 there at one CTA a
    market and on its own rule's cluster, equal to the plain version and
    timed in turns beside kernel 1 (:func:`ablation`). Returns the worst
    error of kernel 1 and of kernel 2."""
    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.config import MarketConfig
    from repro_torch.kernels import autotune
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc
    from repro_torch.launch import bound

    errs, naive_errs = [], []
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
    large = []
    for M, A, L, earlier in FRESH_SHAPES:
        spec = small_spec(M, A, L, num_steps=20)
        n = spec.num_markets
        rule = autotune.auto_tile(L, A, n)
        if rule.ctas_per_market == 1:
            raise Mismatch(f"L={L}, A={A}, M={n}: the rule took {rule}, "
                           f"not a market cluster")
        tiles = (("one_cta", autotune.auto_tile(L, A)),
                 ("parent", autotune.TileChoice(L, A, *earlier)),
                 ("rule", rule))
        cfg = MarketConfig(num_markets=n, num_agents=A, num_levels=L,
                           num_steps=FRESH_STEPS, seed=SEED,
                           alpha_arbitrageur=0.2, alpha_whale=0.1,
                           whale_period=3)
        state, cstate = opening(cfg, device), opening(spec, device)
        want = list(kc.kinetic_clearing_plain(*state, cfg=cfg))
        kw = dict(cfg=spec, chunk=FRESH_STEPS,
                  params=params_mod.pack_params(spec.params, device))
        chunk_bound = bound(
            kc.op_count(n, A, L, FRESH_STEPS, kc.agent_mix(spec.params, A)),
            kc.byte_count(n, L, FRESH_STEPS, ext=False, stats_only=False))
        legacy_bound = bound(
            kc.op_count(n, A, L, FRESH_STEPS, kc.agent_mix(
                params_mod.params_from_config(cfg, n), A)),
            kc.legacy_byte_count(n, L, FRESH_STEPS))
        row = dict(markets=n, agents=A, levels=L, steps=FRESH_STEPS,
                   chunk_bound=chunk_bound, legacy_bound=legacy_bound,
                   launch=launch_facts(n, A, L))
        for name, tile in tiles:
            e, _ = kernel_vs_plain(f"large {name} L={L} A={A}", spec, device,
                                   step0=4, n_valid=FRESH_STEPS,
                                   chunk=FRESH_STEPS, ext=True, tile=tile)
            got = list(kc.kinetic_clearing(*state, cfg=cfg, tile=tile))
            torch.cuda.synchronize()
            e = max(e, compare(f"large {name} legacy L={L} A={A}", got,
                               want))
            errs.append(e)
            # Device times (the calls queued behind a sleep: at a tenth
            # of a millisecond the wrappers' host work would count).
            chunk_ms = _queued_ms(lambda: kc.kinetic_clearing_chunk(
                *cstate, 0, FRESH_STEPS, tile=tile, **kw), 5)
            legacy_ms = _queued_ms(lambda: kc.kinetic_clearing(
                *state, cfg=cfg, tile=tile), 5)
            row[name] = dict(
                tile=tile._asdict(), max_abs_err=e,
                chunk_ms=chunk_ms, legacy_ms=legacy_ms,
                bound_share={
                    "chunk": chunk_bound["bound_ms"] / chunk_ms,
                    "legacy": legacy_bound["bound_ms"] / legacy_ms},
                **cluster_facts(tile, n))
        row["parent_over_rule"] = {
            "chunk": row["parent"]["chunk_ms"] / row["rule"]["chunk_ms"],
            "legacy": row["parent"]["legacy_ms"] / row["rule"]["legacy_ms"]}
        # Kernel 2 at one CTA a market and on its own rule's cluster.
        naive = {"one": autotune.auto_tile(L, A),
                 "rule": autotune.auto_tile(L, A, n, hoisted=False),
                 "kernel1_rule": rule}
        if naive["rule"].ctas_per_market == 1:
            raise Mismatch(f"L={L}, A={A}, M={n}: the per-step rule took "
                           f"{naive['rule']}, not a market cluster")
        for name in ("one", "rule"):
            e, _ = kernel_vs_plain(f"large naive {name} L={L} A={A}", spec,
                                   device, step0=4, n_valid=FRESH_STEPS,
                                   chunk=FRESH_STEPS, ext=True,
                                   tile=naive[name], entry="naive")
            naive_errs.append(e)
        row["naive"] = ablation(
            n, lambda t: kc.kinetic_clearing_chunk(
                *cstate, 0, FRESH_STEPS, tile=t, **kw),
            lambda t: nc.naive_clearing_chunk(
                *cstate, 0, FRESH_STEPS, tile=t, **kw),
            naive, chunk_bound, 5)
        large.append(row)
    emit("edges", ok=True, shapes=[list(x) for x in shapes], large=large,
         max_abs_err=max(errs), naive_max_abs_err=max(naive_errs))
    return max(errs), max(naive_errs)


def population_case(M, A, L, S):
    """The population phase's config and spec at (M, A, L, S): every
    archetype, a shock halfway, arbitrageurs on a ring of peers."""
    import numpy as np
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec

    cfg = MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                       num_steps=S, seed=SEED, shock_step=S // 2,
                       **POPULATION_MIX)
    spec = EnsembleSpec.homogeneous(cfg)
    if M > 1:
        spec = spec.with_values(coupling_peer=(np.arange(M) + 1) % M)
    return cfg, spec


def phase_population(device):
    """Large populations at full width through the main path: for each of
    ``POPULATION``, ``Engine("cuda-kinetic").open(spec).run(S)`` in one
    chunk (the runner's sweep included) and the legacy
    ``kinetic_clearing``, each with the counts at 0, equal bit for bit to
    their plain versions on the card (P1 also to the host ``numpy``
    reference); then kernels 1 and 3 at one CTA a market (C = 1), at the
    earlier rule's shape and at the rule's shape, each pinned and equal to
    the plain versions, timed on the device in turns against the bound.
    Returns the launches and the worst error."""
    import time

    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.session import Engine
    from repro_torch.kernels import autotune
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.launch import bound

    launches = {name: 0 for name in counters()}
    rows, worst, host_refs = [], 0.0, {}
    for label, M, A, L, S, earlier in POPULATION:
        cfg, spec = population_case(M, A, L, S)
        tiles = {"one_cta": autotune.auto_tile(L, A),
                 "parent": autotune.TileChoice(L, A, *earlier),
                 "rule": autotune.auto_tile(L, A, M)}
        if tiles["one_cta"].agents == "registers":
            raise Mismatch(f"population {label}: mode registers")
        # The main path: a session over the horizon in one chunk.
        reset_counts()
        t0 = time.perf_counter()
        with Engine("cuda-kinetic", device=device).open(
                spec, chunk_size=S) as sess:
            batch = sess.run(S)
            got = list(sess.state) + list(batch)
            session_tile = sess._runner.tile
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = expect_counts(f"population {label} session",
                               {"kinetic_clearing_chunk": 1})
        params = params_mod.pack_params(spec.params, device)
        want = list(kc.kinetic_clearing_chunk_plain(
            *opening(spec, device), 0, S, cfg=spec, chunk=S, params=params))
        err = compare(f"population {label} session", got, want)
        if label == "P1":
            with Engine("numpy", device="cpu").open(
                    spec, chunk_size=S) as host:
                ref = list(host.run(S))
                ref = list(host.state) + ref
            host_refs[label] = ref
            err = max(err, compare(f"population {label} numpy",
                                   [x.cpu() for x in got], ref))
        # The legacy entry, the rule's shape.
        state = opening(cfg, device)
        reset_counts()
        legacy = list(kc.kinetic_clearing(*state, cfg=cfg))
        torch.cuda.synchronize()
        lcounts = expect_counts(f"population {label} legacy",
                                {"kinetic_clearing": 1})
        lwant = list(kc.kinetic_clearing_plain(*state, cfg=cfg))
        err = max(err, compare(f"population {label} legacy", legacy, lwant))
        for name in launches:
            launches[name] += counts[name] + lcounts[name]
        price, volume = got[4], got[5]
        if not (bool(torch.isfinite(torch.stack([price, volume])).all())
                and float(volume.sum()) > 0):
            raise Mismatch(f"population {label}: no finite trading")

        mix = kc.agent_mix(spec.params, A)
        b1 = bound(kc.op_count(M, A, L, S, mix),
                   kc.byte_count(M, L, S, ext=False, stats_only=False))
        b3 = bound(kc.op_count(M, A, L, S, kc.agent_mix(
            params_mod.params_from_config(cfg, M), A)),
            kc.legacy_byte_count(M, L, S))
        cstate = opening(spec, device)
        # Each pinned shape == the plain versions (kernel 1 from the same
        # opening books as the session), uncounted.
        for name, tile in tiles.items():
            k1 = kc.kinetic_clearing_chunk(*cstate, 0, S, cfg=spec, chunk=S,
                                           params=params, tile=tile)
            k3 = kc.kinetic_clearing(*state, cfg=cfg, tile=tile)
            torch.cuda.synchronize()
            err = max(err, compare(f"population {label} {name}",
                                   list(k1), want),
                      compare(f"population {label} {name} legacy",
                              list(k3), lwant))
        worst = max(worst, err)
        times = {}
        order = ("one_cta", "parent", "rule", "rule", "parent", "one_cta")
        for name in order:
            tile = tiles[name]
            # Device times: the calls queued behind a sleep.
            k1 = _queued_ms(lambda: kc.kinetic_clearing_chunk(
                *cstate, 0, S, cfg=spec, chunk=S, params=params,
                tile=tile), POPULATION_REPS)
            k3 = _queued_ms(lambda: kc.kinetic_clearing(*state, cfg=cfg,
                                                        tile=tile),
                            POPULATION_REPS)
            times.setdefault(name, []).append((k1, k3))
        row = dict(label=label, markets=M, agents=A, levels=L, steps=S,
                   agents_x_8_x_steps=A * 8 * S, session_wall_s=wall,
                   session_tile=session_tile._asdict(),
                   launches={k: n for k, n in counts.items() if n},
                   chunk_bound=b1, legacy_bound=b3, max_abs_err=err,
                   traded_volume=float(volume.sum()))
        for name, tile in tiles.items():
            k1 = statistics.median(t[0] for t in times[name])
            k3 = statistics.median(t[1] for t in times[name])
            row[name] = dict(
                tile=tile._asdict(), **cluster_facts(tile, M),
                chunk_ms=k1, legacy_ms=k3,
                chunk_ms_runs=[t[0] for t in times[name]],
                legacy_ms_runs=[t[1] for t in times[name]],
                bound_share={"chunk": b1["bound_ms"] / k1,
                             "legacy": b3["bound_ms"] / k3},
                agent_events_per_s={"chunk": M * A * S / (k1 * 1e-3),
                                    "legacy": M * A * S / (k3 * 1e-3)})
        for name in ("one_cta", "parent"):
            row[f"rule_over_{name}"] = {
                k: row["rule"][f"{k}_ms"] / row[name][f"{k}_ms"]
                for k in ("chunk", "legacy")}
        rows.append(row)
    naive_rows, naive_worst = [], 0.0
    for label, M, A, L, S in NAIVE_POPULATION:
        row, err = naive_population(device, label, M, A, L, S,
                                    host_refs.get(label), launches)
        naive_rows.append(row)
        naive_worst = max(naive_worst, err)
    emit("population", ok=True, shapes=rows, naive=naive_rows,
         max_abs_err=worst, naive_max_abs_err=naive_worst)
    return launches, worst, naive_worst


def naive_population(device, label, M, A, L, S, host_ref, launches):
    """The ablation at a large population through the main path:
    ``Engine("cuda-naive").open(spec).run(S)`` in one chunk (S launches
    of kernel 2 on its rule's market cluster, the runner's sweep
    included) with the counts at 0, equal to the plain version on the
    card and, given ``host_ref``, to the host ``numpy`` reference; at P1
    the legacy ``naive_clearing`` likewise; then kernel 2 at one CTA a
    market and on its rule's cluster, each == the plain version, timed in
    turns beside kernel 1 (:func:`ablation`). Adds the windows' launches
    to ``launches``; returns the row and the worst error."""
    import time

    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.session import Engine
    from repro_torch.kernels import autotune
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc
    from repro_torch.launch import bound

    cfg, spec = population_case(M, A, L, S)
    tiles = {"one": autotune.auto_tile(L, A),
             "rule": autotune.auto_tile(L, A, M, hoisted=False),
             "kernel1_rule": autotune.auto_tile(L, A, M)}
    if tiles["rule"].ctas_per_market == 1:
        raise Mismatch(f"population {label}: the per-step rule took "
                       f"{tiles['rule']}, not a market cluster")
    reset_counts()
    t0 = time.perf_counter()
    with Engine("cuda-naive", device=device).open(spec,
                                                  chunk_size=S) as sess:
        batch = sess.run(S)
        got = list(sess.state) + list(batch)
        session_tile = sess._runner.tile
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = expect_counts(f"population {label} cuda-naive session",
                           {"naive_clearing_chunk": S})
    params = params_mod.pack_params(spec.params, device)
    cstate = opening(spec, device)
    want = list(kc.kinetic_clearing_chunk_plain(
        *cstate, 0, S, cfg=spec, chunk=S, params=params))
    err = compare(f"population {label} cuda-naive session", got, want)
    if host_ref is not None:
        err = max(err, compare(f"population {label} cuda-naive numpy",
                               [x.cpu() for x in got], host_ref))
    for name in launches:
        launches[name] += counts[name]
    if label == "P1":
        state = opening(cfg, device)
        reset_counts()
        legacy = list(nc.naive_clearing(*state, cfg=cfg))
        torch.cuda.synchronize()
        lcounts = expect_counts(f"population {label} legacy naive",
                                {"naive_clearing": S})
        err = max(err, compare(f"population {label} legacy naive", legacy,
                               list(kc.kinetic_clearing_plain(*state,
                                                              cfg=cfg))))
        for name in launches:
            launches[name] += lcounts[name]
    kw = dict(cfg=spec, chunk=S, params=params)

    def k1(tile):
        return kc.kinetic_clearing_chunk(*cstate, 0, S, tile=tile, **kw)

    def k2(tile):
        return nc.naive_clearing_chunk(*cstate, 0, S, tile=tile, **kw)

    # Each pinned shape == the plain version, uncounted.
    for name in ("one", "rule"):
        out = list(k2(tiles[name]))
        torch.cuda.synchronize()
        err = max(err, compare(f"population {label} naive {name}", out,
                               want))
    price, volume = got[4], got[5]
    if not (bool(torch.isfinite(torch.stack([price, volume])).all())
            and float(volume.sum()) > 0):
        raise Mismatch(f"population {label} cuda-naive: no finite trading")
    b = bound(kc.op_count(M, A, L, S, kc.agent_mix(spec.params, A)),
              kc.byte_count(M, L, S, ext=False, stats_only=False))
    row = dict(label=label, markets=M, agents=A, levels=L, steps=S,
               session_wall_s=wall, session_tile=session_tile._asdict(),
               launches={k: n for k, n in counts.items() if n},
               chunk_bound=b, max_abs_err=err,
               traded_volume=float(volume.sum()),
               **ablation(M, k1, k2, tiles, b, POPULATION_REPS))
    return row, err


def first_gap(got, want, fields) -> dict:
    """Where two runs' flat outputs (final state, then [M, S] paths) first
    differ: the first step and path field (the final state's fields
    where only they differ), and the largest gap over every field; an
    empty dict when they are equal."""
    import torch

    first, state_field, worst = None, None, 0.0
    for name, g, w in zip(fields, got, want):
        gap = (g.double().cpu() - w.double().cpu()).abs()
        worst = max(worst, float(gap.max()))
        if not bool((gap > 0).any()):
            continue
        if name.endswith("_path"):
            step = int(torch.nonzero((gap > 0).any(dim=0))[0])
            if first is None or step < first[0]:
                first = (step, name)
        elif state_field is None:
            state_field = name
    if first is None and state_field is None:
        return {}
    step, name = first if first is not None else (None, state_field)
    return {"first_step": step, "first_field": name, "max_gap": worst}


def phase_exact(device):
    """Exactness past 2^24 (``EXACT_CONFIG``: books of 3·10^7 a level):
    ``cuda-kinetic`` and ``cuda-naive`` on their rules' market clusters
    of 16 CTAs, one chunk of the whole horizon, with the counts at 0. The
    gate: the two kernels equal each other bit for bit at the same team
    width (one device step, int bins, the same reduction order). The
    measurement, no gate: where each first differs from its plain version
    on the card and from the host ``numpy`` reference, and the largest
    gap. Returns the launches."""
    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec
    from repro_torch.core.session import Engine
    from repro_torch.kernels import kinetic_clearing as kc

    cfg = MarketConfig(**EXACT_CONFIG)
    spec = EnsembleSpec.homogeneous(cfg)
    S = cfg.num_steps
    fields = ("bid", "ask", "last_price", "prev_mid", "price_path",
              "volume_path", "mid_path")
    launches = {name: 0 for name in counters()}
    runs, tiles = {}, {}
    for backend, kernel, n in (("cuda-kinetic", "kinetic_clearing_chunk", 1),
                               ("cuda-naive", "naive_clearing_chunk", S)):
        reset_counts()
        with Engine(backend, device=device, autotune=False).open(
                spec, chunk_size=S) as sess:
            batch = sess.run(S)
            runs[backend] = list(sess.state) + list(batch)
            tiles[backend] = sess._runner.tile
            torch.cuda.synchronize()
        for name, k in expect_counts(f"exact_2_24 {backend}",
                                     {kernel: n}).items():
            launches[name] += k
        if tiles[backend].ctas_per_market != 16:
            raise Mismatch(f"exact_2_24 {backend}: tile {tiles[backend]}, "
                           f"not a cluster of 16")
    if tiles["cuda-kinetic"].warps_per_market != \
            tiles["cuda-naive"].warps_per_market:
        raise Mismatch(f"exact_2_24: team widths differ: {tiles}")
    compare("exact_2_24 kernel 1 vs kernel 2", runs["cuda-naive"],
            runs["cuda-kinetic"])
    plain = list(kc.kinetic_clearing_chunk_plain(
        *opening(spec, device), 0, S, cfg=spec, chunk=S,
        params=params_mod.pack_params(spec.params, device)))
    with Engine("numpy", device="cpu").open(spec, chunk_size=S) as host:
        batch = host.run(S)
        numpy_ref = list(host.state) + list(batch)
    got = runs["cuda-kinetic"]
    books = max(float(got[0].max()), float(got[1].max()))
    emit("exact_2_24", ok=True, config=EXACT_CONFIG,
         tiles={b: t._asdict() for b, t in tiles.items()},
         launches={k: n for k, n in launches.items() if n},
         kernels_equal=True, largest_book_level=books,
         past_2_24=books > 2 ** 24,
         kernel_vs_plain=first_gap(got, plain, fields),
         kernel_vs_numpy=first_gap([x.cpu() for x in got], numpy_ref,
                                   fields),
         plain_vs_numpy=first_gap([x.cpu() for x in plain], numpy_ref,
                                  fields))
    return launches


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
    """Kernels 3 and 4 against the oracle on the card; then kernel 4 on a
    market cluster of every C > 1 (:func:`step_cluster_tiles`)."""
    import torch
    from repro_torch.core.config import MarketConfig
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
    # Kernel 4 on a market cluster of every C > 1, past the registers mode.
    clusters, wants = {}, {}
    for W, L, C, tile in step_cluster_tiles():
        cfg = MarketConfig(num_markets=16, num_agents=CLUSTER_AGENTS,
                           num_levels=L, num_steps=20, seed=SEED + 4,
                           alpha_arbitrageur=0.2, arb_kappa=0.5,
                           alpha_whale=0.05, whale_period=3,
                           shock_step=7, shock_intensity=0.3)
        if L not in wants:
            wants[L] = list(ref.simulate_reference(cfg, device=device))
        state = opening(cfg, device)
        before = nc.naive_clearing.launches
        got = list(nc.naive_clearing(*state, cfg=cfg, tile=tile))
        torch.cuda.synchronize()
        if nc.naive_clearing.launches - before != cfg.num_steps:
            raise Mismatch(f"legacy cluster C={C}: naive_clearing launched "
                           f"{nc.naive_clearing.launches - before} times")
        label = f"W={W} L={L} C={C}"
        clusters[label] = compare(f"legacy cluster {label}", got, wants[L])
    emit("legacy", ok=True, configs=list(volumes), max_abs_err=max(errs),
         traded_volume=volumes, clusters=clusters)
    return max([*errs, *clusters.values()])


def drive_session(backend, spec, device, chunk, **opts):
    """Open a session, run the horizon, return the flat outputs: books,
    then the three paths or the six stats."""
    import torch
    from repro_torch.core.session import Engine

    with Engine(backend, device=device, **opts).open(
            spec, chunk_size=chunk) as sess:
        batch = sess.run(spec.num_steps)
        out = list(sess.state)
        stats = sess._joined_stats()
        out += list(stats) if stats is not None else list(batch)
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
            opens = int(backend.startswith("cuda"))
            if _CARD_OPENS[0] != opens:
                raise Mismatch(f"session {backend}: {_CARD_OPENS[0]} "
                               f"sessions opened on one card, not {opens}")
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
             launches["cuda-naive"]["naive_clearing_chunk"],
             "open_fill": launches["cuda-kinetic"]["open_fill"]
             + launches["cuda-naive"]["open_fill"]},
            {"kinetic_clearing_chunk": errs["cuda-kinetic"],
             "naive_clearing_chunk": errs["cuda-naive"]})


def fill_spec(M, A, L, blocks):
    """A ``FILL_CASES`` spec."""
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec
    from repro_torch.scenario import CouplingSpec

    common = dict(num_agents=A, num_levels=L, num_steps=500, seed=SEED)
    if blocks == "one":
        return EnsembleSpec.homogeneous(MarketConfig(num_markets=M,
                                                     **common))
    spec = EnsembleSpec.from_scenarios(
        list(PRESETS), num_markets=M // len(PRESETS), **common)
    return CouplingSpec.ring(M).apply(spec) if blocks == "ring" else spec


def phase_open_fill(device):
    """The open fill on the card: see the module docstring. Returns the
    launches, the worst error, and Table IV's kernel ms, host-open ms and
    bound."""
    import time

    import numpy as np
    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.stats import init_stats
    from repro_torch.core.step import initial_state
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc
    from repro_torch.kernels import open_fill
    from repro_torch.launch import bound

    libs = {"kinetic": kc._load_library, "naive": nc._load_library}

    def flat(opened):
        state, packed, stats = opened
        return list(state) + list(packed) + (
            [] if stats is None else list(stats))

    def bits(leaves):
        return [x.cpu().view(torch.int32) if x.dtype == torch.float32
                else x.cpu() for x in leaves]

    def wall_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    rows, launches, worst = {}, 0, 0.0
    for label, (M, A, L, stats_only, kind) in FILL_CASES.items():
        spec = fill_spec(M, A, L, kind)
        B = spec.num_blocks
        if (B, spec.num_markets) != ({"one": 1, "nine": 9}.get(kind, M), M):
            raise Mismatch(f"open_fill {label}: {B} blocks of "
                           f"{spec.num_markets} markets")

        def host_open():
            packed = params_mod.pack_params(spec.params, device)
            stats = init_stats(M, device) if stats_only else None
            return initial_state(spec, device), packed, stats

        host = host_open()
        table = params_mod.block_table(spec.blocks)
        plain = bits(flat(open_fill.open_fill_plain(
            torch.from_numpy(table), M, L, stats_only)))
        want = bits(flat(host))
        for name, (g, w) in enumerate(zip(plain, want)):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise Mismatch(f"open_fill {label}: the plain fill's leaf "
                               f"{name} differs from the host open's")
        times = {}
        for lib, load in libs.items():
            reset_counts()
            got = open_fill.open_fill(spec.blocks, L, stats_only, device,
                                      load)
            torch.cuda.synchronize()
            launches += expect_counts(f"open_fill {label} {lib}",
                                      {"open_fill": 1})["open_fill"]
            worst = max(worst, compare(f"open_fill {label} {lib}",
                                       bits(flat(got)), plain))
            if not np.array_equal(params_mod.host_ints(got[1]),
                                  params_mod.host_ints(host[1])):
                raise Mismatch(f"open_fill {label} {lib}: the host int "
                               "block differs from pack_params'")
            table_d = torch.from_numpy(table).to(device)
            times[f"{lib}_kernel_ms"] = _queued_ms(
                lambda: open_fill._launch(load(), table_d, M, L,
                                          stats_only), 50)
        times["fill_open_ms"] = wall_ms(lambda: open_fill.open_fill(
            spec.blocks, L, stats_only, device, libs["kinetic"]))
        times["host_open_ms"] = wall_ms(host_open)
        # Written: books, params, mids and stats; read: the table.
        nbytes = 4 * (M * (2 * L + len(params_mod.FLOAT_FIELDS)
                           + len(params_mod.INT_FIELDS) + 2
                           + (6 if stats_only else 0))
                      + B * params_mod.FILL_COLS)
        b = bound(0, nbytes)
        rows[label] = dict(markets=M, levels=L, blocks=B,
                           stats_only=stats_only, bytes=nbytes,
                           bound_ms=b["bound_ms"],
                           bound_share=b["bound_ms"]
                           / times["kinetic_kernel_ms"], **times)
    # Its timed launches went through the wrapper's launch alone: counted
    # are the checked calls, one a library and case.
    emit("open_fill", ok=True, cases=rows, launches=launches,
         max_abs_err=worst, card=card_line())
    t4 = rows["table_iv"]
    return launches, worst, dict(ms=t4["kinetic_kernel_ms"],
                                 plain_ms=t4["host_open_ms"],
                                 bound_ms=t4["bound_ms"], bound_by="bytes")


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
    mismatches, worst, ref_s = {}, 0.0, 0.0
    for case, got in results.items():
        cfg = parity_config(case)
        t1 = time.perf_counter()
        want = engine.simulate(cfg, backend="numpy", device="cpu").to_numpy()
        ref_s += time.perf_counter() - t1
        faults = parity_faults(got, want)
        if faults:
            mismatches["/".join(map(str, case))] = faults
        worst = max(worst, max(float(abs(g - w).max()) if g.size else 0.0
                               for g, w in zip(got["cuda-kinetic"], want)))
    emit("parity", ok=not mismatches, configurations=len(PARITY_MATRIX),
         held=len(PARITY_MATRIX) - len(mismatches),
         mismatches=len(mismatches), first=dict(list(mismatches.items())[:4]),
         launches={k: n for k, n in counts.items() if n},
         card_seconds=card_s, reference="numpy", reference_seconds=ref_s,
         seconds=time.perf_counter() - t0, max_abs_err=worst)
    if mismatches:
        raise Mismatch(f"parity: {len(mismatches)} of {len(PARITY_MATRIX)} "
                       "configurations differ")
    return counts, worst


def phase_cross_stream(device):
    """The paper's "aggregate statistics match the CPU reference to within
    0.1%" at its M: ``cuda-kinetic`` on the card equals the host ``numpy``
    reference bit for bit (the gate); ``numpy-splitmix64`` and
    ``numpy-pcg64`` draw other streams, so their gaps to it are measured,
    not gated."""
    import time

    from repro_torch.core import engine
    from repro_torch.core.config import MarketConfig

    M, A, L, S = CROSS_SHAPE
    cfg = MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                       num_steps=S, seed=CROSS_SEED)
    reset_counts()
    card = engine.simulate(cfg, backend="cuda-kinetic", device=device)
    card = card.to_numpy()
    chunk = min(64, S)
    counts = expect_counts("cross_stream", {
        "kinetic_clearing_chunk": -(-S // chunk)})
    rows, seconds = {}, {}
    for backend in ("numpy", "numpy-splitmix64", "numpy-pcg64"):
        t0 = time.perf_counter()
        rows[backend] = engine.simulate(cfg, backend=backend,
                                        device="cpu").to_numpy()
        seconds[backend] = time.perf_counter() - t0
    ref = rows["numpy"]
    worst = 0.0
    for field, g, w in zip(card._fields, card, ref):
        if g.shape != w.shape or g.dtype != w.dtype or not (g == w).all():
            raise Mismatch(f"cross_stream: cuda-kinetic {field} differs "
                           "from the numpy reference")
        worst = max(worst, float(abs(g - w).max()) if g.size else 0.0)
    # The noise floor of the price gap: the standard error of the mean
    # over markets of each market's mean clearing price, relative.
    traded = ref.volume_path > 0
    per_market = (ref.price_path * traded).sum(1) / traded.sum(1).clip(1)
    floor = float(per_market.std() / M ** 0.5 / per_market.mean())
    gaps = {}
    for backend in ("numpy-splitmix64", "numpy-pcg64"):
        gaps[backend] = {}
        for stat in ("mean_clearing_price", "volume_per_market"):
            got, want = getattr(rows[backend], stat)(), getattr(ref, stat)()
            gaps[backend][stat] = dict(value=got, reference=want,
                                       rel_gap=abs(got - want) / abs(want))
    emit("cross_stream", ok=True, markets=M, agents=A, levels=L, steps=S,
         seed=CROSS_SEED, bitwise="cuda-kinetic == numpy",
         launches={k: n for k, n in counts.items() if n}, gaps=gaps,
         within_0_1_percent={b: all(v["rel_gap"] <= PARITY_TOL
                                    for v in g.values())
                             for b, g in gaps.items()},
         price_rel_stderr=floor, host_seconds=seconds, max_abs_err=worst)
    return worst


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
    the outputs and the seconds of the open and run(S) (the card
    synchronised)."""
    import time

    reset_counts()
    t0 = time.perf_counter()
    out = drive_session(backend, spec, device, 64, **opts)
    return out, time.perf_counter() - t0


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
            runs[backend, stats_only], secs[backend, stats_only] = \
                timed_session(backend, spec, device, stats_only=stats_only)
            counts = expect_counts(f"scenario product {backend}", want)
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


def card_sms() -> int:
    import torch

    return torch.cuda.get_device_properties(
        torch.device(*CARD)).multi_processor_count


def cluster_facts(tile, M, hoisted: bool = True) -> dict:
    """A launch shape at M markets: CTAs a market, the grid, the share of
    the card's SMs it can occupy, and what kernels 1 and 3 (2 and 4 where
    not ``hoisted``) hold on the card at once (at C > 1 the clusters on
    the card, else the CTAs per SM). A cluster the card cannot place
    fails."""
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    sms, grid = card_sms(), tile.grid(M)
    lib, names = (kc, ("kinetic_clearing_chunk", "kinetic_clearing")) \
        if hoisted else (nc, ("naive_clearing_chunk", "naive_clearing"))
    held = {name: lib.resident_ctas(legacy, tile)
            for name, legacy in zip(names, (False, True))}
    if min(held.values()) < 1:
        raise Mismatch(f"the card holds none of {tile}: {held}")
    key = "resident_clusters" if tile.ctas_per_market > 1 else \
        "resident_ctas_per_sm"
    return {"ctas_per_market": tile.ctas_per_market, "grid": grid,
            "sms": sms, "sm_share": min(grid, sms) / sms, key: held}


def ablation(M, k1, k2, tiles, b, reps) -> dict:
    """Kernel 2 (``k2(tile)``, or kernel 4) at one CTA a market
    (``tiles["one"]``) and on its rule's shape (``tiles["rule"]``), timed
    in turns beside kernel 1 (kernel 3) at one CTA a market and on kernel
    1's rule's shape (``tiles["kernel1_rule"]``): device ms (calls queued
    behind a sleep), each shape's grid, SM share and clusters held, the
    share of the bound ``b`` and the ratios to kernel 1 at equal layouts:
    ``over_kernel1_rule`` on both rules' clusters, ``over_kernel1_one`` at
    one CTA a market."""
    runs = {"one": [], "rule": []}
    for which in ("one", "rule", "rule", "one"):
        tile = tiles[which]
        beside = tiles["one" if which == "one" else "kernel1_rule"]
        runs[which].append((_queued_ms(lambda: k2(tile), reps),
                            _queued_ms(lambda: k1(beside), reps)))
    out = {}
    for which in ("one", "rule"):
        ms = statistics.median(t[0] for t in runs[which])
        k1_ms = statistics.median(t[1] for t in runs[which])
        out[which] = dict(
            tile=tiles[which]._asdict(),
            **cluster_facts(tiles[which], M, hoisted=False),
            ms=ms, ms_runs=[t[0] for t in runs[which]],
            kernel1_ms=k1_ms, kernel1_ms_runs=[t[1] for t in runs[which]],
            bound_share=b["bound_ms"] / ms)
    out["kernel1_rule_tile"] = tiles["kernel1_rule"]._asdict()
    out["over_kernel1_rule"] = out["rule"]["ms"] / out["rule"]["kernel1_ms"]
    out["over_kernel1_one"] = out["one"]["ms"] / out["one"]["kernel1_ms"]
    out["one_over_rule"] = out["one"]["ms"] / out["rule"]["ms"]
    return out


def launch_facts(M, A, L) -> dict:
    """The kernels' launch shape at (M, A, L), one CTA a market (the
    persistent rule's narrow team where it takes one; the per-step
    kernels' shape under ``step`` then), and each kernel's resident CTAs
    per SM there."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    step = autotune.auto_tile(L, A)
    shape = autotune.auto_tile(L, A, M)
    if shape.ctas_per_market > 1:
        shape = step
    facts = dict(
        warps_per_market=shape.warps_per_market,
        markets_per_cta=shape.markets_per_cta,
        levels_per_lane=shape.levels_per_lane,
        agents=shape.agents,
        threads_per_cta=shape.threads_per_cta, grid=shape.grid(M),
        smem_bytes={"persistent": shape.smem_bytes(True),
                    "per_step": step.smem_bytes(False)},
        resident_ctas_per_sm={
            "kinetic_clearing_chunk": kc.resident_ctas(False, shape),
            "naive_clearing_chunk": nc.resident_ctas(False, step),
            "kinetic_clearing": kc.resident_ctas(True, shape),
            "naive_clearing": nc.resident_ctas(True, step)})
    if step != shape:
        facts["step"] = list(step[2:])
    return facts


def homogeneous(M, A, L, S):
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec

    return EnsembleSpec.homogeneous(MarketConfig(
        num_markets=M, num_agents=A, num_levels=L, num_steps=S, seed=SEED))


def phase_timing(device):
    from repro_torch.core import params as params_mod
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc
    from repro_torch.launch import HW, bound

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
                  naive_design_bytes_ms=naive_bytes / HW["hbm_bw"] * 1e3,
                  bound_share=b["bound_ms"] / ms,
                  naive_bound_share=b["bound_ms"] / nms,
                  launch=launch_facts(M, A, L), **b)
    emit("timing", ok=True, **timing)
    return timing


AGENT_SWEEP = (16, 64, 256, 1024)  # benchmarks/common.py at FULL_SCALE
SWEEP_CHECK_MARKETS = 1024         # markets of the sweep's bitwise check
#: The autotune phase's shapes (A, L), at M = TABLE_IV[0]: Table IV, the
#: sweep's two far ends at L=128, and the persistence shape.
AUTOTUNE_SHAPES = ((256, 128), (16, 128), (1024, 128), (32, 1024))
#: Markets of its bitwise checks: two full waves of 132 SMs at one market
#: a CTA (cut from 8192 so the plain version stays short).
AUTOTUNE_CHECK_MARKETS = 264
AUTOTUNE_REPS = 10
#: The sharded phase's gateway: clients (one preset each) and chunks.
SHARDED_CLIENTS = 8
SHARDED_SERVE_CHUNKS = 12
# The sharded env at Table IV: the maker steps of each timed rollout (in
# turns over 1, 2 and 3 shards), and the turns.
SHARDED_ENV_STEPS = 100
SHARDED_ENV_TURNS = (1, 2, 3, 3, 2, 1)


def sweep_spec(M, A, L=128):
    """Every archetype at L levels, a shock inside the first chunk and a
    ring of arbitrageur peers."""
    import numpy as np
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec

    spec = EnsembleSpec.homogeneous(MarketConfig(
        num_markets=M, num_agents=A, num_levels=L, num_steps=500,
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
    from repro_torch.launch import bound

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
    from repro_torch.launch import bound

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
    from repro_torch.launch import HW, bound

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
        tile = getattr(sess._runner, "tile", None)   # the sweep's winner
        rows[backend] = dict(
            tile=None if tile is None else list(tile[2:]),
            ms=statistics.median(ms), ms_runs=ms,
            wall_ms=statistics.median(wall),
            agent_events_per_s=M * A * S / (statistics.median(ms) * 1e-3),
            peak_bytes=torch.cuda.max_memory_allocated(device))
    base = rows["cuda-kinetic"]
    for row in rows.values():
        row["ratio_to_cuda_kinetic"] = row["ms"] / base["ms"]
        row["peak_ratio_to_cuda_kinetic"] = \
            row["peak_bytes"] / base["peak_bytes"]
    cpu = host_column(spec)
    for row in cpu["backends"].values():
        row["cuda_kinetic_over_this"] = \
            base["agent_events_per_s"] / row["agent_events_per_s"]

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
        naive_design_bytes_ms=naive_bytes / HW["hbm_bw"] * 1e3,
        launch=launch_facts(pM, pA, pL),
        **bound(kc.op_count(pM, pA, pL, chunk,
                            kc.agent_mix(pspec.params, pA)),
                kc.byte_count(pM, pL, chunk, ext=False, stats_only=False)))
    emit("fixed_workload", ok=True, markets=M, agents=A, levels=L, steps=S,
         launch=launch_facts(M, A, L), backends=rows, cpu_column=cpu,
         persistence=persistence)
    return rows, persistence


def host_facts() -> dict:
    """The host the CPU column ran on: CPU model and cpuid fields, cores,
    NumPy's version and torch's intra-op threads."""
    import platform

    import numpy as np
    import torch

    info = {}
    try:  # the first processor's "key : value" lines
        for line in Path("/proc/cpuinfo").read_text().split("\n\n")[0] \
                .splitlines():
            key, _, value = line.partition(":")
            info.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    # Some hosts hide the model name ("unknown"); the cpuid fields remain.
    cpuid = " ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family",
                                                  "model", "stepping",
                                                  "cpu mhz") if k in info)
    return dict(cpu_model=info.get("model name") or platform.processor(),
                cpuid=cpuid, machine=platform.machine(),
                cores=os.cpu_count(), numpy=np.__version__,
                torch_threads=torch.get_num_threads())


def host_column(spec) -> dict:
    """The paper's CPU column at ``spec``'s shape: the ``numpy`` reference
    (a NumPy program) and, for comparison, ``torch-scan`` on the CPU, each
    one warm-up step and then ``HOST_STEPS`` timed steps of a session.
    ``ms`` is the 500-step time from the measured rate (500 steps are not
    run)."""
    import time

    from repro_torch.core.session import Engine

    M, A = spec.num_markets, spec.num_agents
    rows = {}
    for backend in ("numpy", "torch-scan"):
        with Engine(backend, device="cpu").open(spec) as sess:
            sess.run(1)
            t0 = time.perf_counter()
            sess.run(HOST_STEPS)
            step_ms = (time.perf_counter() - t0) * 1e3 / HOST_STEPS
        rows[backend] = dict(device="cpu", steps=HOST_STEPS,
                             ms_per_step=step_ms, ms=step_ms * 500,
                             agent_events_per_s=M * A / (step_ms * 1e-3))
    rows["numpy"]["ms_ratio_to_torch_cpu"] = \
        rows["numpy"]["ms_per_step"] / rows["torch-scan"]["ms_per_step"]
    return dict(host=host_facts(), backends=rows)


def host_column_child() -> int:
    """``python3 chip_smoke.py host-column``: the CPU column at Table IV
    alone, as one JSON line (needs no card)."""
    (M, A, L), S = TABLE_IV, 500
    emit("host_column", markets=M, agents=A, levels=L,
         **host_column(homogeneous(M, A, L, S)))
    return 0


# ---------------------------------------------------------------------------
# autotune: every launch shape of the four kernels, and the timed sweep
# ---------------------------------------------------------------------------

def phase_autotune(device):
    """Every candidate launch shape (``autotune.candidate_tiles``) of the
    four kernels held bit for bit against one plain output per shape at
    ``AUTOTUNE_CHECK_MARKETS`` markets, the chunk kernels' candidates timed
    at full width against the bound; then the runner's sweep
    (``Engine(autotune="auto")``: once, then a cache hit), ``run(500)``
    through the rule's tile and the sweep's winner in turns, and
    ``AutotuneOOM`` through ``run_plan``."""
    import tempfile
    import time

    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.session import Engine
    from repro_torch.kernels import autotune
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc
    from repro_torch.launch import bound
    from repro_torch.ops import AutotuneOOM, FaultPlan, run_plan

    M, chunk = TABLE_IV[0], 64
    Mc = AUTOTUNE_CHECK_MARKETS
    entries = (("kinetic_clearing_chunk", kc.kinetic_clearing_chunk, True),
               ("naive_clearing_chunk", nc.naive_clearing_chunk, False))
    errs = {name: 0.0 for name in counters()}
    launches = {name: 0 for name in counters()}
    candidates, shapes = {}, []
    for A, L in AUTOTUNE_SHAPES:
        # 1. Every candidate == one plain output, with the counts at 0.
        spec = sweep_spec(Mc, A, L)
        state = opening(spec, device)
        kw = dict(cfg=spec, chunk=chunk,
                  params=params_mod.pack_params(spec.params, device))
        want = outputs(kc.kinetic_clearing_chunk_plain(*state, 0, chunk,
                                                       **kw), chunk)
        reset_counts()
        for name, fn, hoisted in entries:
            cands = autotune.candidate_tiles(L, A, hoisted=hoisted)
            candidates[name, A, L] = cands
            for c in cands:
                label = f"autotune {name} A={A} L={L} {tuple(c[2:])}"
                try:
                    got = outputs(fn(*state, 0, chunk, tile=c, **kw), chunk)
                except RuntimeError as exc:
                    raise Mismatch(f"{label}: {exc}") from exc
                errs[name] = max(errs[name], compare(label, got, want))
        torch.cuda.synchronize()
        counts = expect_counts(f"autotune A={A} L={L}", {
            "kinetic_clearing_chunk": len(candidates[entries[0][0], A, L]),
            "naive_clearing_chunk":
            chunk * len(candidates[entries[1][0], A, L])})
        for name, n in counts.items():
            launches[name] += n

        # 2. Each candidate timed at full width against the bound.
        spec = homogeneous(M, A, L, 500)
        state = opening(spec, device)
        kw = dict(cfg=spec, chunk=chunk,
                  params=params_mod.pack_params(spec.params, device))
        b = bound(kc.op_count(M, A, L, chunk, kc.agent_mix(spec.params, A)),
                  kc.byte_count(M, L, chunk, ext=False, stats_only=False))
        for name, fn, hoisted in entries:
            rows = []
            for c in candidates[name, A, L]:
                ms = _time(lambda: fn(*state, 0, chunk, tile=c, **kw),
                           AUTOTUNE_REPS)
                resident = (kc if hoisted else nc).resident_ctas(False, c)
                rows.append(dict(
                    tile=list(c[2:]),
                    ms=ms, bound_share=b["bound_ms"] / ms,
                    resident_ctas_per_sm=resident,
                    smem_bytes=c.smem_bytes(hoisted)))
            rule, best = rows[0], min(rows, key=lambda r: r["ms"])
            shapes.append(dict(
                kernel=name, markets=M, agents=A, levels=L, chunk=chunk,
                bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                rule=rule["tile"], rule_ms=rule["ms"], winner=best["tile"],
                winner_ms=best["ms"], winner_over_rule=best["ms"]
                / rule["ms"], candidates=rows))

    # 3. Kernels 3 and 4: every candidate at the Table IV width.
    _, A, L = TABLE_IV
    cfg = MarketConfig(num_markets=Mc, num_agents=A, num_levels=L,
                       num_steps=chunk, seed=SEED)
    state = opening(cfg, device)
    want = list(kc.kinetic_clearing_plain(*state, cfg=cfg))
    reset_counts()
    legacy = {}
    for name, fn, hoisted in (("kinetic_clearing", kc.kinetic_clearing, True),
                              ("naive_clearing", nc.naive_clearing, False)):
        legacy[name] = autotune.candidate_tiles(L, A, hoisted=hoisted)
        for c in legacy[name]:
            label = f"autotune {name} {tuple(c[2:])}"
            try:
                got = list(fn(*state, cfg=cfg, tile=c))
            except RuntimeError as exc:
                raise Mismatch(f"{label}: {exc}") from exc
            errs[name] = max(errs[name], compare(label, got, want))
    torch.cuda.synchronize()
    counts = expect_counts("autotune legacy", {
        "kinetic_clearing": len(legacy["kinetic_clearing"]),
        "naive_clearing": chunk * len(legacy["naive_clearing"])})
    for name, n in counts.items():
        launches[name] += n

    # 4. The runner's sweep: once, then a cache hit; run(500) through the
    # rule's tile and the winner, in turns; the same bits.
    spec = homogeneous(M, A, L, 500)
    check_sweeps("before the autotune phase's own sweep")
    autotune.clear_tune_cache()
    engines = {"winner": Engine("cuda-kinetic", device=device),
               "rule": Engine("cuda-kinetic", device=device,
                              autotune=False)}
    t0 = time.perf_counter()
    engines["winner"].open(spec).close()
    sweep_s = time.perf_counter() - t0
    with Engine("cuda-kinetic", device=device).open(spec) as again:
        reports = autotune.sweep_reports()
        if len(reports) != 1 or again._runner.tile != reports[0].winner:
            raise Mismatch(f"the sweep ran {len(reports)} times for a key")
    report = reports[0]
    if report.fell_back:
        raise Mismatch(f"the sweep fell back: {report.failures}")
    ms = {"rule": [], "winner": []}
    outs = {}
    for label in ("rule", "winner") + ("rule", "winner", "winner",
                                       "rule") * 2:
        with engines[label].open(spec) as sess:
            torch.cuda.synchronize()
            start = time.perf_counter()
            batch = sess.run(500)
            torch.cuda.synchronize()
            ms[label].append((time.perf_counter() - start) * 1e3)
            outs[label] = list(sess.state) + list(batch)
    for label in ms:
        ms[label] = ms[label][1:]     # the first run of each warms it up
    err = compare("run(500) winner vs rule", outs["winner"], outs["rule"])
    errs["kinetic_clearing_chunk"] = max(errs["kinetic_clearing_chunk"], err)

    # 5. AutotuneOOM: the restart's sweep falls back, the stream is bitwise.
    check_sweeps("autotune")      # the fault's own failures come next
    oom_spec = homogeneous(M, A, L, 2 * chunk)
    with Engine("cuda-kinetic", device=device,
                chunk_size=chunk).open(oom_spec) as sess:
        clean = [x.cpu() for x in sess.run(2 * chunk)]
    with tempfile.TemporaryDirectory() as tmp:
        rep = run_plan(FaultPlan([AutotuneOOM(at_step=chunk)],
                                 checkpoint_every=chunk), oom_spec,
                       backend="cuda-kinetic", ckpt_dir=tmp,
                       chunk_size=chunk, engine_opts={"device": device})
    oom = autotune.last_sweep_report()
    if not (rep.replay_matched and oom.fell_back
            and oom.winner == autotune.auto_tile(L, A)
            and len(oom.failures) == len(oom.tried)):
        raise Mismatch(f"AutotuneOOM: {rep.events} {oom}")
    err = compare("AutotuneOOM stream",
                  [torch.as_tensor(x) for x in rep.batch], clean)
    autotune.clear_tune_cache()    # later phases sweep for themselves
    emit("autotune", ok=True, checked_markets=Mc, steps=chunk,
         candidates={f"{n} A={a} L={l}": len(c)
                     for (n, a, l), c in candidates.items()},
         legacy_candidates={n: len(c) for n, c in legacy.items()},
         launches=launches, max_abs_err=errs, shapes=shapes,
         sweep=dict(key=list(map(str, report.key)),
                    winner=list(report.winner[2:]),
                    rule=list(autotune.auto_tile(L, A)[2:]),
                    candidates=len(report.tried),
                    failures=list(report.failures), seconds=sweep_s,
                    times_ms={"/".join(map(str, c[2:])): t * 1e3
                              for c, t in report.times}),
         run500_ms=ms, run500_rule_ms=statistics.median(ms["rule"]),
         run500_winner_ms=statistics.median(ms["winner"]),
         autotune_oom=dict(detail=rep.events[0].detail,
                           failures=len(oom.failures), max_abs_err=err))
    return errs, launches


# ---------------------------------------------------------------------------
# sharded: the market axis cut over a mesh that names the one card twice
# ---------------------------------------------------------------------------

def frames_equal(label, got, want) -> None:
    """Every client's frames of two ``run_serve_plan`` reports, ``==``."""
    if set(got.frames) != set(want.frames):
        raise Mismatch(f"{label}: clients {sorted(got.frames)} vs "
                       f"{sorted(want.frames)}")
    for client, fs in want.frames.items():
        gs = got.frames[client]
        if len(gs) != len(fs):
            raise Mismatch(f"{label}: {client} got {len(gs)} frames, "
                           f"want {len(fs)}")
        for f0, f1 in zip(fs, gs):
            for field in ("mid", "price", "volume"):
                a, b = getattr(f0, field), getattr(f1, field)
                if f0.step0 != f1.step0 or not (a == b).all():
                    raise Mismatch(f"{label}: {client} {field} differs at "
                                   f"step {f0.step0}")


def check_resident(sess, mesh, M) -> int:
    """Every leaf a sharded session holds (state, params, market ids,
    stats) is its shards' own rows (``check_rows``). Returns the number of
    leaves checked."""
    return check_rows(list(sess._state) + list(sess._params)
                      + [sess._runner._market_ids] + list(sess._stats or ()),
                      mesh, M)


def check_env_resident(state, mesh, M) -> int:
    """Every ``[M, ...]`` leaf of a sharded env's ``EnvState`` (books,
    scalars, last output, opening books, params, portfolio, stats) is its
    shards' own rows (``check_rows``): nothing of the env's state is
    canonical on the first device. Returns the number of leaves checked."""
    return check_rows(list(state.market) + list(state.last_out)
                      + list(state.reset_market) + list(state.params)
                      + list(state.portfolio) + list(state.stats or ()),
                      mesh, M)


def check_rows(leaves, mesh, M) -> int:
    """Each leaf is a ``RowShards`` whose part k holds exactly shard k's
    rows on shard k's device, in storage of its own: no canonical copy is
    held. Returns the number of leaves checked."""
    from repro_torch.launch import market_sharding
    from repro_torch.launch.sharding import RowShards

    rows = market_sharding(mesh, M)
    for k, leaf in enumerate(leaves):
        if not isinstance(leaf, RowShards) or leaf.rows != rows:
            raise Mismatch(f"leaf {k} is not row-sharded over {rows}")
        for part, r, dev in zip(leaf.parts, rows, mesh.devices):
            n = r.stop - r.start
            if part.shape[0] != n or part.device != dev or (
                    n and part.untyped_storage().nbytes()
                    != n * part.stride(0) * part.element_size()):
                raise Mismatch(f"leaf {k}: a part of {part.shape[0]} rows "
                               f"on {part.device} is not shard {r}'s own "
                               f"rows on {dev}")
    return len(leaves)


def phase_sharded(device):
    """``devices=``/``mesh=`` on the card: meshes naming ``cuda:0`` twice
    and three times. Sharded ``Session.run(500)`` at the Table IV width
    (homogeneous, and ring-coupled across every market with every
    archetype, paths and ``stats_only``), ``cuda-naive``, a snapshot across
    shard counts, 64 env steps (2 and 3 shards, the env state resident
    after every step), an env checkpoint across shard counts and 2
    trainer updates (no synchronizing call) all equal the unsharded runs;
    an env step's moves equal their closed form; the env's steps/s, CUDA
    kernels and bytes a step on 1, 2 and 3 shards;
    launches = shards x chunks (x steps for kernel 2);
    ``DeviceLoss(devices_after=1)`` from two shards in ``run_plan`` and
    under the gateway, bitwise; ``devices=2`` on one card raises; the wall
    of a sharded ``run(500)`` against the unsharded one. The meshes' envs
    and trainers keep the host loop (a CUDA graph belongs to one device),
    as before; the unsharded runs they are held against take graphs."""
    import tempfile
    import time

    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import params as params_mod
    from repro_torch.core.params import PackedParams
    from repro_torch.core.session import Engine
    from repro_torch.env import MarketFeatures, rollout
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.launch import (MarketsMesh, Roofline, make_markets_mesh,
                                    market_sharding)
    from repro_torch.ops import (DeviceLoss, FaultPlan, run_plan,
                                 run_serve_plan)
    from repro_torch.train import PPOConfig, make_market_maker

    (M, A, L), S, chunk = TABLE_IV, 500, 64
    n_chunks = -(-S // chunk)
    meshes = {1: None, 2: MarketsMesh.of([device] * 2),
              3: MarketsMesh.of([device] * 3)}
    errs = {"kinetic_clearing_chunk": 0.0, "naive_clearing_chunk": 0.0}
    launches = {"kinetic_clearing_chunk": 0, "naive_clearing_chunk": 0}

    def note(name, err):
        errs[name] = max(errs[name], err)

    def counted(label, want, fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        for name, n in expect_counts(label, want).items():
            if name in launches:
                launches[name] += n
        return out

    # 1. Session.run(500): homogeneous and ring-coupled, paths and stats.
    specs = {"table_iv": homogeneous(M, A, L, S), "ring": sweep_spec(M, A)}
    for label, spec in specs.items():
        for stats_only in (False, True) if label == "ring" else (False,):
            base = drive_session("cuda-kinetic", spec, device, chunk,
                                 stats_only=stats_only)
            if label == "table_iv":
                base_iv = base
            for n in (2, 3):
                got = counted(
                    f"sharded {label} {n}",
                    {"kinetic_clearing_chunk": n * n_chunks},
                    lambda: drive_session("cuda-kinetic", spec, device,
                                          chunk, mesh=meshes[n],
                                          stats_only=stats_only))
                note("kinetic_clearing_chunk", compare(
                    f"sharded {label} {n} shards stats={stats_only}", got,
                    base))
    ring = specs["ring"]
    base = drive_session("cuda-kinetic", ring, device, chunk)
    got = counted("sharded naive", {"naive_clearing_chunk": 2 * S},
                  lambda: drive_session("cuda-naive", ring, device, chunk,
                                        mesh=meshes[2]))
    note("naive_clearing_chunk", compare("sharded naive", got, base))

    # 2. A snapshot across shard counts: 2 shards for 256 steps, restored
    # onto 1 and onto 3, continues the straight run.
    with Engine("cuda-kinetic", device=device,
                mesh=meshes[2]).open(ring) as sess:
        sess.run(256)
        snap = sess.snapshot()
    for n in (1, 3):
        with Engine("cuda-kinetic", device=device,
                    mesh=meshes[n]).open(ring) as sess:
            sess.restore(snap)
            batch = sess.run(S - 256)
            got = list(sess.state) + [x for x in batch]
        want = base[:4] + [p[:, 256:] for p in base[4:]]
        note("kinetic_clearing_chunk", compare(f"snapshot 2 -> {n}", got,
                                               want))

    # 3. 64 env steps of the scripted maker over the ring on 2 and 3
    # shards, one step a rollout call, every leaf of the EnvState on its
    # shard after every step; equal to the unsharded rollout.
    maker = make_market_maker(L)
    env1 = Engine("cuda-kinetic", device=device).env(ring)
    envs = {n: Engine("cuda-kinetic", device=device, mesh=meshes[n])
            .env(ring) for n in (2, 3)}
    if any(env._graphed for env in envs.values()):
        raise Mismatch("a sharded env took the CUDA graph path, not the "
                       "host loop")
    straight = rollout(env1, maker, ENV_STEPS)
    want = env_outputs(*straight)
    env_checks = {}
    for n, env in envs.items():
        def stepwise():
            state, _ = env.reset()
            checks = check_env_resident(state, meshes[n], M)
            batches = []
            for _ in range(ENV_STEPS):
                state, batch = rollout(env, maker, 1, state=state)
                checks += check_env_resident(state, meshes[n], M)
                batches.append(batch)
            return checks, env_outputs(state, join_batches(batches))

        env_checks[f"{n} shards"], got = counted(
            f"sharded env {n}", {"kinetic_clearing_chunk": n * ENV_STEPS},
            stepwise)
        note("kinetic_clearing_chunk", compare(f"sharded env {n}", got,
                                               want))

    # 3a. The bytes 50 maker steps move on 2 shards, to the byte.
    state, _ = envs[2].reset()
    with Roofline() as rf:
        counted("sharded env moves",
                {"kinetic_clearing_chunk": 2 * ENV_PROFILED_STEPS},
                lambda: rollout(envs[2], maker, ENV_PROFILED_STEPS,
                                state=state))
    got = rf.summarize()
    env_moved = {k: v for k, v in got["collective_breakdown"].items() if v}
    want_moved = env_moves(M, 2, ENV_PROFILED_STEPS,
                           envs[2].obs_size())
    if env_moved != want_moved or \
            got["wire_no_link"] != sum(want_moved.values()):
        raise Mismatch(f"sharded env moves: {env_moved}, no link "
                       f"{got['wire_no_link']}; the closed form gives "
                       f"{want_moved}")

    # 3b. A 2-shard env checkpoint after 32 steps, restored onto 1 shard
    # and onto 3, continues the straight rollout.
    half = ENV_STEPS // 2
    tail = env_outputs(straight[0], batch_tail(straight[1], half))
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(tmp, async_write=False)

        def first_half():
            state, _ = rollout(envs[2], maker, half)
            envs[2].save_checkpoint(mgr, state, step=half)

        counted("env checkpoint on 2",
                {"kinetic_clearing_chunk": 2 * half}, first_half)
        for n, env in ((1, env1), (3, envs[3])):
            got = counted(
                f"env checkpoint 2 -> {n}",
                {"kinetic_clearing_chunk": n * half},
                lambda: env_outputs(*rollout(
                    env, maker, half, state=env.restore_checkpoint(mgr,
                                                                   half))))
            note("kinetic_clearing_chunk", compare(
                f"env checkpoint 2 -> {n}", got, tail))

    # 3c. The maker's env at Table IV on 1, 2 and 3 shards: steps/s, CUDA
    # kernels and bytes moved a step.
    env_rates = counted("sharded env rates",
                        {"kinetic_clearing_chunk": env_rate_launches()},
                        lambda: env_mesh_rates(device, specs["table_iv"]))

    # 4. Two trainer updates on 2 shards, torch's sync debug mode at
    # "error" (no synchronizing call), equal to the unsharded trainer; the
    # env state it carries stays on its shards.
    T = TRAIN_CONFIG["rollout_len"]
    tspec = train_spec(TRAIN_MIX, TRAIN_BLOCK, A, L, T, TRAIN_CONFIG["seed"])
    cfg = PPOConfig(**TRAIN_CONFIG)
    runs = {}
    for n in (1, 2):
        tr = Engine("cuda-kinetic", device=device, mesh=meshes[n]).trainer(
            tspec, cfg, obs=MarketFeatures())
        ts = tr.init()

        def train2():
            torch.cuda.synchronize()
            if n > 1:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return tr.train(ts, 2)
            finally:
                torch.cuda.set_sync_debug_mode("default")

        ts, metrics = counted(f"sharded train {n}",
                              {"kinetic_clearing_chunk": 2 * T * n}, train2)
        if n > 1:
            env_checks["trainer 2 shards"] = check_env_resident(
                ts.env_state, meshes[n], tr.env.num_markets)
        runs[n] = train_outputs(ts, metrics)
    note("kinetic_clearing_chunk", compare("sharded train", runs[2],
                                           runs[1]))

    # 5. DeviceLoss(devices_after=1) from 2 shards: run_plan and a gateway.
    with tempfile.TemporaryDirectory() as tmp:
        rep = run_plan(FaultPlan([DeviceLoss(at_step=2 * chunk,
                                             devices_after=1)],
                                 checkpoint_every=chunk), ring,
                       backend="cuda-kinetic", ckpt_dir=tmp,
                       chunk_size=chunk, n_steps=4 * chunk,
                       engine_opts={"device": device, "mesh": meshes[2]})
    if not rep.replay_matched or \
            rep.events[0].detail != "rebuilt on devices=1":
        raise Mismatch(f"sharded DeviceLoss: {rep.events}")
    note("kinetic_clearing_chunk", compare(
        "sharded DeviceLoss stream", [torch.as_tensor(x) for x in rep.batch],
        [p[:, :4 * chunk].cpu() for p in base[4:]]))
    serve_kw = dict(scenarios=list(PRESETS[:SHARDED_CLIENTS]),
                    backend="cuda-kinetic", chunk_size=chunk,
                    chunks=SHARDED_SERVE_CHUNKS, checkpoint_every=2,
                    num_agents=A, num_levels=L, fault_after=2)
    with tempfile.TemporaryDirectory() as tmp:
        clean = run_serve_plan(ckpt_dir=Path(tmp) / "clean",
                               engine_opts={"device": device}, **serve_kw)
        lost = run_serve_plan(ckpt_dir=Path(tmp) / "lost",
                              engine_opts={"device": device,
                                           "mesh": meshes[2]},
                              fault=DeviceLoss(at_step=0, devices_after=1),
                              **serve_kw)
    if lost.reconnects != 1 or lost.traces_delta != 0:
        raise Mismatch(f"sharded gateway: reconnects={lost.reconnects} "
                       f"traces_delta={lost.traces_delta}")
    frames_equal("sharded gateway DeviceLoss", lost, clean)

    # 6. One card is one device: devices=2 raises the mesh's ValueError.
    for make in (lambda: make_markets_mesh(2, device=device),
                 lambda: Engine("cuda-kinetic", device=device, devices=2)
                 .open(ring)):
        try:
            make()
        except ValueError as exc:
            refusal = str(exc)
        else:
            raise Mismatch("devices=2 on one card did not raise")

    # 7. Residency: after opening and after every chunk of run(500), each
    # shard's rows of the state, params, market ids and stats are on its
    # device, in storage of their own; a joined copy equals the unsharded.
    spec = specs["table_iv"]
    checked = {}
    for n in (2, 3):
        for stats_only in (False, True):
            def drive():
                eng = Engine("cuda-kinetic", device=device, mesh=meshes[n],
                             stats_only=stats_only)
                with eng.open(spec, chunk_size=chunk) as sess:
                    checks = check_resident(sess, meshes[n], M)
                    for _ in sess.stream(S):
                        checks += check_resident(sess, meshes[n], M)
                    return checks, list(sess.state)

            checks, books = counted(
                f"resident {n} stats={stats_only}",
                {"kinetic_clearing_chunk": n * n_chunks}, drive)
            checked[f"{n} shards stats={stats_only}"] = checks
            if not stats_only:
                note("kinetic_clearing_chunk", compare(
                    f"resident {n} shards", books, base_iv[:4]))

    # 8. The bytes run(500) moves, recorded, against the closed form.
    moves = {}
    for n, stats_only in ((2, False), (3, False), (2, True)):
        eng = Engine("cuda-kinetic", device=device, mesh=meshes[n],
                     stats_only=stats_only)
        with eng.open(spec, chunk_size=chunk) as sess:
            with Roofline() as rf:
                counted(f"moves {n} stats={stats_only}",
                        {"kinetic_clearing_chunk": n * n_chunks},
                        lambda: sess.run(S))
        got = rf.summarize()
        want = resident_moves(M, n, S, chunk, stats_only=stats_only)
        moved = {k: got["collective_breakdown"][k] for k in want}
        if moved != want or got["wire_no_link"] != sum(want.values()):
            raise Mismatch(f"sharded moves {n} stats={stats_only}: "
                           f"{moved}, no link {got['wire_no_link']}; the "
                           f"closed form gives {want}")
        moves[f"{n} shards stats={stats_only}"] = dict(
            moved, per_chunk_ring=want["collective-permute"] / n_chunks,
            routes={f"{a}->{b}": v
                    for (a, b), v in got["collective_routes"].items()})

    # 9. The wall of run(500) at Table IV on 1, 2 and 3 shards, in turns,
    # then each one's peak device bytes above what the process held.
    engines = {n: Engine("cuda-kinetic", device=device, mesh=meshes[n])
               for n in meshes}
    wall = {n: [] for n in meshes}
    device_ms = {n: [] for n in meshes}
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for n in (1, 2, 3) + (1, 2, 3, 3, 2, 1) * 2:
        with engines[n].open(spec) as sess:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            sess.run(S)
            stop.record()
            torch.cuda.synchronize()
            wall[n].append((time.perf_counter() - t0) * 1e3)
            device_ms[n].append(start.elapsed_time(stop))
    wall = {n: w[1:] for n, w in wall.items()}   # the first run warms up
    device_ms = {n: w[1:] for n, w in device_ms.items()}
    peak, tiles = {}, {}
    for n in meshes:
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        with engines[n].open(spec) as sess:
            sess.run(S)
            torch.cuda.synchronize()
            tiles[n] = sess._runner.tile
        peak[str(n)] = dict(
            run_bytes=torch.cuda.max_memory_allocated(device) - held,
            held_before=held)

    # The grid split alone: one 64-step kernel-1 call on every row against
    # one call on each shard's rows, through the sessions' launch shape
    # (device time, in turns).
    state = opening(spec, device)
    packed = params_mod.pack_params(spec.params, device)

    def split(n):
        cuts = market_sharding(meshes[n] or MarketsMesh.of([device]), M)

        def fn():
            for r in cuts:
                kc.kinetic_clearing_chunk(
                    *(x[r] for x in state), 0, chunk, cfg=spec, chunk=chunk,
                    params=PackedParams(*(p[r] for p in packed)),
                    tile=tiles[n])
        return fn

    split_ms = {n: [] for n in meshes}
    for n in (1, 2, 3, 3, 2, 1):
        split_ms[n].append(_time(split(n), 20))
    emit("sharded", ok=True, markets=M, agents=A, levels=L, steps=S,
         chunk=chunk, launches=launches, max_abs_err=errs,
         devices_2_refusal=refusal,
         run500_wall_ms={str(n): statistics.median(w)
                         for n, w in wall.items()},
         run500_wall_ms_runs={str(n): w for n, w in wall.items()},
         run500_wall_ratio={str(n): statistics.median(w)
                            / statistics.median(wall[1])
                            for n, w in wall.items()},
         run500_device_ms={str(n): statistics.median(w)
                           for n, w in device_ms.items()},
         chunk_split_ms={str(n): w for n, w in split_ms.items()},
         chunk_split_ratio={str(n): statistics.median(w)
                            / statistics.median(split_ms[1])
                            for n, w in split_ms.items()},
         tiles={str(n): list(t[2:]) for n, t in tiles.items()},
         resident_checks=checked, moves=moves, peak=peak,
         env_resident_checks=env_checks, env_moves=env_moved,
         env_moves_per_step={k: v / ENV_PROFILED_STEPS
                             for k, v in env_moved.items()},
         env_rates=env_rates, host_loop_on_meshes=True,
         serve=dict(clients=SHARDED_CLIENTS, chunks=SHARDED_SERVE_CHUNKS,
                    steps=lost.steps, recoveries=lost.recoveries))
    return errs, launches


# ---------------------------------------------------------------------------
# roofline: repro_torch.launch.roofline on the card
# ---------------------------------------------------------------------------

def resident_moves(M, shards, steps, chunk, *, stats_only) -> dict:
    """The bytes a sharded ``run(steps)`` moves with the rows resident:
    nothing placed, the ring's (n-1)·M·4 bytes a chunk, and the paths of
    shards 1.. joined (12 bytes a row and step; none with ``stats_only``)."""
    chunks = -(-steps // chunk)
    joined = M - -(-M // shards) if shards > 1 else 0  # rows of shards 1..
    return {"scatter": 0,
            "collective-permute": chunks * (shards - 1) * M * 4,
            "gather": 0 if stats_only else joined * steps * 12}


def _record(label, fn, want_launches, sync_error=False):
    """``fn()`` under a ``Roofline`` with the counts at 0 (and torch's sync
    debug mode at "error" when ``sync_error``): its result, the summary,
    and the launches counted, which must equal the recorded ones."""
    import torch
    from repro_torch.launch import Roofline

    torch.cuda.synchronize()
    reset_counts()
    if sync_error:
        torch.cuda.set_sync_debug_mode("error")
    try:
        with Roofline() as rf:
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    counts = expect_counts(label, want_launches)
    summary = rf.summarize()
    recorded = {k: e["launches"] for k, e in summary["kernels"].items()}
    # The recorder records the clearing kernels; the fill's launches are
    # held to the sessions opened (expect_counts).
    if recorded != {k: n for k, n in counts.items()
                    if n and k != "open_fill"}:
        raise Mismatch(f"{label}: recorded launches {recorded}, counted "
                       f"{counts}")
    return out, summary, rf


def _per_step(summary, steps: int, wall_s: float) -> dict:
    """A recorded window's counts a step and its bound against a wall."""
    from repro_torch.launch import bound

    b = bound(summary["operations"], summary["hbm_bytes"],
              summary["collective_wire_bytes"])
    return dict(steps=steps, aten_ops_per_step=summary["aten_calls"] / steps,
                flops=summary["flops"], operations=summary["operations"],
                bytes=summary["hbm_bytes"], kernels=summary["kernels"],
                bound=b, wall_s=wall_s,
                bound_share=b["bound_ms"] * 1e-3 / wall_s)


def phase_roofline(device):
    """``repro_torch.launch.roofline`` on the card: ``Session.run(500)`` at
    Table IV with and without the recorder, equal, its kernel records equal
    to the launches and to ``op_count``/``byte_count`` over the chunks, and
    its bound against the run's wall; the same over a mesh naming the card
    twice (per-device sums, the cut's closed form); then one ``torch-scan``
    chunk, 50 maker env steps (the eager body's records equal to its
    graph's at replay) and one trainer update (no synchronizing call
    under the recorder at replay), each with its aten ops a step beside
    ``torch.profiler``'s CUDA kernels a step."""
    import time

    import torch
    from repro_torch.core.session import Engine
    from repro_torch.env import (InventoryPenalty, MarketFeatures,
                                 SpreadCapture, Sum, rollout)
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.launch import MarketsMesh, Roofline, bound
    from repro_torch.train import PPOConfig, make_market_maker

    (M, A, L), S, chunk = TABLE_IV, 500, 64
    spec = homogeneous(M, A, L, S)
    steps = [min(chunk, S - s) for s in range(0, S, chunk)]
    mix = kc.agent_mix(spec.params, A)
    want = {"kinetic_clearing_chunk": dict(
        calls=len(steps), launches=len(steps),
        operations=sum(kc.op_count(M, A, L, n, mix) for n in steps),
        bytes=sum(kc.byte_count(M, L, n, ext=False, stats_only=False)
                  for n in steps))}
    errs, launches = [], 0

    def run500(eng, label=None, want_launches=None):
        """(outputs, wall s, summary) of ``run(500)`` on a fresh session;
        with ``label`` the run (not the opening) is recorded."""
        with eng.open(spec, chunk_size=chunk) as sess:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            summary = None
            if label is None:
                batch = sess.run(S)
            else:
                batch, summary, _ = _record(label, lambda: sess.run(S),
                                            want_launches)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return list(sess.state) + list(batch), wall, summary

    # 1. run(500) at Table IV: a warm run, timed runs, then the recorded one.
    eng = Engine("cuda-kinetic", device=device)
    plain = run500(eng)[0]
    walls = [run500(eng)[1] for _ in range(5)]
    got, _, one = run500(eng, "roofline run(500)",
                         {"kinetic_clearing_chunk": len(steps)})
    launches += len(steps)
    errs.append(compare("roofline run(500) recorded vs plain", got, plain))
    if one["kernels"] != want:
        raise Mismatch(f"roofline run(500): kernel records {one['kernels']}"
                       f", op_count/byte_count give {want}")
    wall = statistics.median(walls)
    run_bound = bound(one["operations"], one["hbm_bytes"])
    chunk_bound = bound(kc.op_count(M, A, L, chunk, mix),
                        kc.byte_count(M, L, chunk, ext=False,
                                      stats_only=False))

    # 2. The same run over a mesh naming the card twice.
    n = 2
    mesh_eng = Engine("cuda-kinetic", device=device,
                      mesh=MarketsMesh.of([device] * n))
    run500(mesh_eng)                        # builds the runner
    got, _, two = run500(mesh_eng, "roofline run(500) on 2 shards",
                         {"kinetic_clearing_chunk": n * len(steps)})
    launches += n * len(steps)
    errs.append(compare("roofline 2 shards vs unsharded", got, plain))
    for key, total in (("flops", "flops"), ("operations", "operations"),
                       ("bytes", "hbm_bytes")):
        split = sum(d[key] for d in two["per_device"].values())
        if split != one[total] or two[total] != one[total]:
            raise Mismatch(f"roofline 2 shards: per-device {key} sum to "
                           f"{split}, unsharded {one[total]}")
    want_moved = resident_moves(M, n, S, chunk, stats_only=False)
    moved = {k: two["collective_breakdown"][k] for k in want_moved}
    if moved != want_moved or two["wire_no_link"] != sum(moved.values()):
        raise Mismatch(f"roofline 2 shards: moved {moved}, no link "
                       f"{two['wire_no_link']}; the resident closed form "
                       f"gives {want_moved}")
    ring = want_moved["collective-permute"] / len(steps)
    sharded = dict(
        shards=n, per_device=two["per_device"],
        moved=moved, ring_bytes_per_chunk=ring,
        routes={f"{a}->{b}": v
                for (a, b), v in two["collective_routes"].items()},
        nvlink_ms_per_chunk=bound(0, 0, ring)["bound_ms"],
        wire_no_link=two["wire_no_link"])

    # 3. One torch-scan chunk, 50 maker env steps, one trainer update.
    eager = Engine("torch-scan", device=device)
    eager_runs = {}
    for mode in ("warm", "plain", "recorded", "profiled"):
        with eager.open(spec, chunk_size=chunk) as sess:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "recorded":
                out, eager_sum, _ = _record(
                    "roofline torch-scan chunk",
                    lambda: list(sess.run(chunk)), {})
            elif mode == "profiled":
                out = profile_window(lambda: sess.run(chunk), chunk)
            else:
                out = list(sess.run(chunk))
                torch.cuda.synchronize()
            eager_runs[mode] = (out, time.perf_counter() - t0)
    errs.append(compare("roofline torch-scan recorded vs plain",
                        eager_runs["recorded"][0], eager_runs["plain"][0]))
    eager_line = dict(_per_step(eager_sum, chunk, eager_runs["plain"][1]),
                      profile=eager_runs["profiled"][0])

    # The env: its first call (the eager body, captured) and a replay of
    # its graph record the same kernels and aten ops.
    env = eng.env(spec)
    maker = make_market_maker(L)
    state0, _ = env.reset()

    def env_run():
        return env_outputs(*rollout(env, maker, ENV_PROFILED_STEPS,
                                    state=state0))

    env_first, first_sum, _ = _record(
        "roofline env first call", env_run,
        {"kinetic_clearing_chunk": ENV_PROFILED_STEPS})
    launches += ENV_PROFILED_STEPS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    env_plain = env_run()
    torch.cuda.synchronize()
    env_wall = time.perf_counter() - t0
    env_got, env_sum, _ = _record(
        "roofline env", env_run,
        {"kinetic_clearing_chunk": ENV_PROFILED_STEPS}, sync_error=True)
    launches += ENV_PROFILED_STEPS
    errs.append(compare("roofline env recorded vs plain", env_got,
                        env_plain))
    errs.append(compare("roofline env replay vs first call", env_got,
                        env_first))
    for key in ("kernels", "aten_calls", "operations", "hbm_bytes"):
        if env_sum[key] != first_sum[key]:
            raise Mismatch(f"roofline env: a replay records {key} "
                           f"{env_sum[key]}, the eager body "
                           f"{first_sum[key]}")
    env_line = dict(_per_step(env_sum, ENV_PROFILED_STEPS, env_wall),
                    profile=profile_window(lambda: rollout(
                        env, maker, ENV_PROFILED_STEPS, state=state0),
                        ENV_PROFILED_STEPS))

    T = TRAIN_CONFIG["rollout_len"]
    tr = eng.trainer(train_spec(TRAIN_MIX, TRAIN_BLOCK, A, L, T,
                                TRAIN_CONFIG["seed"]),
                     PPOConfig(**TRAIN_CONFIG),
                     reward=Sum((SpreadCapture(), InventoryPenalty(0.001))),
                     obs=MarketFeatures())
    ts = tr.init()
    tr.train(ts, 1)                          # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_plain = train_outputs(*tr.train(ts, 1))
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_got, train_sum, train_rf = _record(
        "roofline train", lambda: tr.train(ts, 1),
        {"kinetic_clearing_chunk": T}, sync_error=True)
    launches += T
    errs.append(compare("roofline train recorded vs plain",
                        train_outputs(*train_got), train_plain))
    # The update's backward dots, counted on autograd's threads: about
    # twice its forward dots (the first layer's input gradient is skipped).
    _, batch = tr.collect(ts)
    flat = tr.advantages(ts, batch)
    with Roofline() as opt:
        tr.optimize(ts, flat)
    dots = {"forward": 0, "backward": 0}
    for flops, _, name, _ in opt.top_contributors("flops", 10 ** 6):
        if name.split(".")[1] in ("mm", "addmm", "bmm", "baddbmm"):
            dots["backward" if "(backward)" in name else "forward"] += flops
    if not 1.5 <= dots["backward"] / max(dots["forward"], 1) <= 2.0:
        raise Mismatch(f"roofline train: backward dots {dots['backward']} "
                       f"against forward {dots['forward']}")
    train_line = dict(_per_step(train_sum, T, train_wall),
                      backward_over_forward_dots=dots["backward"]
                      / dots["forward"],
                      top_bytes=train_rf.top_contributors("bytes", 6),
                      profile=profile_window(lambda: tr.train(ts, 1), T))
    emit("roofline", ok=True, markets=M, agents=A, levels=L, steps=S,
         chunk=chunk,
         run500=dict(kernels=one["kernels"], aten_calls=one["aten_calls"],
                     operations=one["operations"], bytes=one["hbm_bytes"],
                     bound=run_bound, chunk_bound=chunk_bound,
                     wall_ms=wall * 1e3, wall_ms_runs=[w * 1e3 for w in walls],
                     bound_share=run_bound["bound_ms"] * 1e-3 / wall),
         sharded=sharded, torch_scan_chunk=eager_line, env=env_line,
         train=train_line, max_abs_err=max(errs), card=card_line())
    return max(errs), {"kinetic_clearing_chunk": launches}


# ---------------------------------------------------------------------------
# env: the RL environment on kernel 1 at full width
# ---------------------------------------------------------------------------

def whole(x):
    """A plain tensor as it is; a ``RowShards`` joined on its first
    shard's device."""
    from repro_torch.launch.sharding import RowShards

    return x.join(x.parts[0].device) if isinstance(x, RowShards) else x


def env_outputs(state, batch) -> list:
    """A rollout's batch and final state (sharded leaves joined), flat,
    for ``compare``."""
    import torch

    parts = list(batch[:8]) + [whole(x) for x in list(state.market)
                               + list(state.last_out)
                               + list(state.portfolio)
                               + list(state.stats or ())]
    return [p.float() if p.dtype == torch.bool else p for p in parts]


def join_batches(batches):
    """One-step ``RolloutBatch``es as the batch of one rollout."""
    import torch
    from repro_torch.env.core import RolloutBatch

    cat = [torch.cat(parts, dim=0 if k < 3 else -1)
           for k, parts in enumerate(zip(*(b[:8] for b in batches)))]
    return RolloutBatch(*cat)


def batch_tail(batch, k):
    """A ``RolloutBatch`` from its step ``k`` on."""
    from repro_torch.env.core import RolloutBatch

    return RolloutBatch(*(x[k:] for x in batch[:3]),
                        *(p[:, k:] for p in batch[3:8]))


def env_moves(M, shards, steps, D) -> dict:
    """The bytes a resumed ``steps``-step maker rollout moves on
    ``shards`` shards with the env's state resident: each step places the
    [M] order triple (bool side, int32 tick, f32 lots: 9 bytes a market),
    sends the entry mids round the ring ((n-1)·M·4), and joins shards 1..'s
    rows of the [M, D] observation, the [M] reward and the five StepInfo
    columns; the rollout also joins its opening observation once."""
    joined = M - -(-M // shards)                    # rows of shards 1..
    return {"scatter": steps * M * 9,
            "collective-permute": steps * (shards - 1) * M * 4,
            "gather": joined * 4 * D + steps * joined * (4 * D + 4 + 5 * 4)}


def env_mesh_rates(device, spec) -> dict:
    """The scripted maker's env at ``spec`` on meshes naming ``device`` 1,
    2 and 3 times, from the same opening state: steps/s of
    ``SHARDED_ENV_STEPS``-step rollouts in the turns of
    ``SHARDED_ENV_TURNS`` (after an 8-step warm rollout each), CUDA
    kernels and device ms a step over ``ENV_PROFILED_STEPS`` steps
    (``torch.profiler``), and the bytes moved a step (a ``Roofline``
    window of as many steps). One shard runs the rollout's CUDA graph (a
    warm-up of each length captures it), two and three the host loop.
    Public API only, so it measures any tree of the port; its kernel-1
    launches are ``env_rate_launches()``."""
    import time

    import torch
    from repro_torch.core.session import Engine
    from repro_torch.env import rollout
    from repro_torch.launch import MarketsMesh, Roofline
    from repro_torch.train import make_market_maker

    maker = make_market_maker(spec.num_levels)
    shards = sorted(set(SHARDED_ENV_TURNS))
    envs = {n: Engine("cuda-kinetic", device=device,
                      mesh=MarketsMesh.of([device] * n)).env(spec)
            for n in shards}
    starts = {n: env.reset()[0] for n, env in envs.items()}

    def run(n, steps):
        return rollout(envs[n], maker, steps, state=starts[n])

    for n in shards:    # one shard captures these keys' graphs here
        run(n, SHARDED_ENV_STEPS)
        run(n, ENV_PROFILED_STEPS)
    rates = {n: [] for n in shards}
    for n in SHARDED_ENV_TURNS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(n, SHARDED_ENV_STEPS)
        torch.cuda.synchronize()
        rates[n].append(SHARDED_ENV_STEPS / (time.perf_counter() - t0))
    out = {}
    for n in shards:
        profile = profile_window(lambda: run(n, ENV_PROFILED_STEPS),
                                 ENV_PROFILED_STEPS)
        with Roofline() as rf:
            run(n, ENV_PROFILED_STEPS)
            torch.cuda.synchronize()
        moved = rf.summarize()["collective_breakdown"]
        moved = {k: v for k, v in moved.items() if v}
        out[str(n)] = dict(
            steps_per_s=statistics.median(rates[n]),
            steps_per_s_runs=rates[n],
            kernels_per_step=profile["kernels_per_step"],
            device_ms_per_step=profile["device_ms_per_step"],
            busy_share=profile["busy_share"], moved=moved,
            bytes_per_step=sum(moved.values()) / ENV_PROFILED_STEPS)
    return out


def env_rate_launches() -> int:
    """Kernel-1 launches of ``env_mesh_rates``: a launch a shard and step
    of every rollout it runs (warm, timed, profiled, recorded)."""
    shards = sorted(set(SHARDED_ENV_TURNS))
    return (sum(shards) * (SHARDED_ENV_STEPS + 3 * ENV_PROFILED_STEPS)
            + sum(SHARDED_ENV_TURNS) * SHARDED_ENV_STEPS)


def env_rates_child(src: str) -> int:
    """``python3 chip_smoke.py env-rates SRC``: ``env_mesh_rates`` at
    Table IV with the port of the tree ``SRC`` (a ``src`` directory, say
    a ``git archive`` of another commit), printed as one JSON line, so two
    commits can be measured in turns in one chip call."""
    import torch

    sys.path.insert(0, str(Path(src).resolve()))
    import repro_torch

    where = str(Path(repro_torch.__file__).resolve())
    if not where.startswith(str(Path(src).resolve())):
        raise Mismatch(f"env-rates imported {where}, not the tree {src}")
    M, A, L = TABLE_IV
    print(json.dumps({"env_rates": env_mesh_rates(
        torch.device(*CARD), homogeneous(M, A, L, 500)), "src": src,
        "card": card_line()}), flush=True)
    return 0


@contextlib.contextmanager
def eager_body(env, on: bool = True):
    """The env's rollouts (and its trainer's updates) run as the host loop
    on the card inside the block (with ``on``): the eager body its CUDA
    graphs are held against and timed beside."""
    graphed = env._graphed
    env._graphed = graphed and not on
    try:
        yield
    finally:
        env._graphed = graphed


def memory_now():
    """(reserved, allocated) device bytes with the allocator's free cache
    released, so that what a CUDA graph's private pool keeps shows in the
    reserved bytes (a capture releases the cache itself)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(), torch.cuda.memory_allocated()


def memory_since(reserved, allocated) -> dict:
    """The growth of ``memory_now()``'s two counts since a reading."""
    now = memory_now()
    return dict(reserved=now[0] - reserved, allocated=now[1] - allocated)


def graph_vs_eager(label, fn, want_launches, errs):
    """``fn()`` (a rollout or training call) as the first call of its key
    (the eager body, captured) and again (a replay), each with the counts
    at 0 and ``want_launches`` expected, equal bit for bit; returns the
    first call's result and the replay's counts."""
    import torch

    reset_counts()
    first = fn()
    torch.cuda.synchronize()
    expect_counts(label, want_launches)
    reset_counts()
    again = fn()
    torch.cuda.synchronize()
    counts = expect_counts(f"{label} replay", want_launches)
    errs.append(compare(f"{label}: graph vs eager body", again[0], first[0]))
    return first, counts


def phase_env(device):
    """``repro_torch.env`` at the Table IV width (the ``fixed_workload``
    mix): a zero-action rollout == ``Session.run``; the maker's closed loop
    on ``cuda-kinetic``, ``cuda-naive``, ``torch-scan`` and
    ``torch-per-step`` with composite observations and rewards, each
    rollout's CUDA graph == its eager body, the backends equal, and again
    over ring-coupled markets with arbitrageurs and without; auto-reset; a
    checkpoint restored into a fresh env; one launch of kernel 1 a step at
    replay, one graph captured by a first call and no synchronizing call
    in a warm one; then the eager body and the graph timed in turns."""
    import tempfile
    import time

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
    backends = (("cuda-kinetic", {"kinetic_clearing_chunk": ENV_STEPS}),
                ("cuda-naive", {"naive_clearing_chunk": ENV_STEPS}),
                ("torch-scan", {}), ("torch-per-step", {}))

    def closed_loop(label, env, policy, want):
        """(eager body, replay's counts) of a maker rollout from reset."""
        state0, _ = env.reset()
        (out, _), counts = graph_vs_eager(
            label, lambda: (env_outputs(*rollout(
                env, policy, ENV_STEPS, state=state0)), None), want, errs)
        return out, counts

    # 1. Zero actions: ENV_STEPS launches == one Session.run launch.
    zenv = eng.env(spec, auto_reset=False)
    zstate, _ = zenv.reset()
    (zero, _), zero_counts = graph_vs_eager(
        "env zero-action rollout",
        lambda: (env_outputs(*rollout(zenv, None, ENV_STEPS, state=zstate)),
                 None), {"kinetic_clearing_chunk": ENV_STEPS}, errs)
    reset_counts()
    with eng.open(spec, chunk_size=ENV_STEPS) as sess:
        ref = sess.run(ENV_STEPS)
        run_state = list(sess.state)
    torch.cuda.synchronize()
    expect_counts("env reference run", {"kinetic_clearing_chunk": 1})
    errs.append(compare("env zero actions vs Session.run",
                        zero[3:6] + zero[8:12], list(ref) + run_state))

    # 2-3, 6. The maker's closed loop on four backends, composite obs and
    # rewards: each graph == its eager body, one launch of kernel 1
    # (kernel 2) a step at replay, the backends equal.
    builds = eng.trace_count
    runs, counts = {}, {}
    for backend, want in backends:
        e = eng if backend == "cuda-kinetic" else Engine(backend,
                                                         device=device)
        runs[backend], counts[backend] = closed_loop(
            f"env maker {backend}", e.env(spec, obs=obs, reward=reward),
            maker, want)
    if eng.trace_count != builds + 1:
        raise Mismatch(f"a second env of one shape built "
                       f"{eng.trace_count - builds - 1} more runners or "
                       "graphs than its one capture")
    want = runs["torch-scan"]
    for backend, _ in backends:
        if backend != "torch-scan":
            errs.append(compare(f"env maker {backend} vs torch-scan",
                                runs[backend], want))
    mbatch = runs["cuda-kinetic"]
    fills = float(mbatch[6].sum() + mbatch[7].sum())
    finite = bool(torch.isfinite(mbatch[0]).all()) and \
        bool(torch.isfinite(mbatch[1]).all())
    if not finite or fills <= 0 or tuple(mbatch[0].shape) != (
            ENV_STEPS, M, obs.size(spec)):
        raise Mismatch(f"env maker output malformed: finite={finite} "
                       f"fills={fills} obs={tuple(mbatch[0].shape)}")

    # The coupling freeze: ring-coupled markets with arbitrageurs read their
    # peer's mid of the step before at every env step, on every backend,
    # in the graph as in the eager body; and without the coupling.
    cspec = coupled_ensemble(EnsembleSpec.homogeneous(MarketConfig(
        num_markets=M, num_agents=A, num_levels=L, num_steps=ENV_TIMED_STEPS,
        seed=SEED, alpha_arbitrageur=0.2, arb_kappa=0.5)),
        CouplingSpec.ring(M))
    coupled = {}
    for backend, want in backends:
        e = eng if backend == "cuda-kinetic" else Engine(backend,
                                                         device=device)
        coupled[backend], counts[f"coupled {backend}"] = closed_loop(
            f"env coupled maker {backend}", e.env(cspec), maker, want)
    for backend, _ in backends:
        if backend != "torch-scan":
            errs.append(compare(f"env coupled maker {backend} vs "
                                "torch-scan", coupled[backend],
                                coupled["torch-scan"]))
    uncoupled, counts["uncoupled cuda-kinetic"] = closed_loop(
        "env uncoupled maker", eng.env(CouplingSpec.none(M).apply(cspec)),
        maker, backends[0][1])
    if bool((uncoupled[3] == coupled["cuda-kinetic"][3]).all()):
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

    # A first call captures one graph; a warm one captures nothing and
    # makes no synchronizing call (torch's sync debug mode at "error").
    env = eng.env(spec)
    state0, _ = env.reset()
    keys = len(eng.graph_keys())
    reserved, allocated = memory_now()
    t0 = time.perf_counter()
    first = rollout(env, maker, ENV_TIMED_STEPS, state=state0)
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    del first
    graph_bytes = memory_since(reserved, allocated)
    captured = len(eng.graph_keys()) - keys
    if captured != 1:
        raise Mismatch(f"env: a first call captured {captured} graphs")
    builds = eng.trace_count
    torch.cuda.set_sync_debug_mode("error")
    try:
        rollout(env, maker, ENV_TIMED_STEPS, state=state0)
    except RuntimeError as exc:
        raise Mismatch(f"a warm env rollout waited for the card: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if eng.trace_count != builds:
        raise Mismatch("a warm env rollout captured again")

    # 7. Timing: the maker's closed loop, the graph and the eager body in
    # turns, against Session.run on the card.
    walls = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        with eager_body(env, mode == "eager"):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            rollout(env, maker, ENV_TIMED_STEPS, state=state0)
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            timed_counts = expect_counts(
                f"env timed {mode}",
                {"kinetic_clearing_chunk": ENV_TIMED_STEPS})
    wall = statistics.median(walls["graph"])
    eager_wall = statistics.median(walls["eager"])
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
    rollout(env, maker, ENV_PROFILED_STEPS, state=state0)  # its capture
    profiles = {}
    for mode in ("graph", "eager"):
        with eager_body(env, mode == "eager"):
            profiles[mode] = profile_window(
                lambda: rollout(env, maker, ENV_PROFILED_STEPS,
                                state=state0), ENV_PROFILED_STEPS)
    steps_per_s = ENV_TIMED_STEPS / wall
    timing = dict(
        steps=ENV_TIMED_STEPS, wall_s=wall, steps_per_s=steps_per_s,
        graph_steps_per_s=[ENV_TIMED_STEPS / w for w in walls["graph"]],
        eager_steps_per_s=[ENV_TIMED_STEPS / w for w in walls["eager"]],
        graph_over_eager=eager_wall / wall,
        agent_events_per_s=M * A * steps_per_s,
        first_call_s=first_wall, capture_s=first_wall - eager_wall,
        graph_bytes=graph_bytes,
        kernel_ms_chunk1=kernel_ms, wrapper_ms_chunk1=wrapper_ms,
        busy_share=kernel_ms * 1e-3 * ENV_TIMED_STEPS / wall,
        eager_busy_share=kernel_ms * 1e-3 * ENV_TIMED_STEPS / eager_wall,
        session_run_wall_s=run_wall, over_session_run=wall / run_wall,
        launches=timed_counts["kinetic_clearing_chunk"], profile=profiles)
    emit("env", ok=True, markets=M, agents=A, levels=L,
         launches={"zero_action_rollout": zero_counts["kinetic_clearing_chunk"],
                   "maker_replay": {b: {k: n for k, n in c.items() if n}
                                    for b, c in counts.items()}},
         graphs_captured_by_first_call=captured, sync_debug_mode="error",
         fills=fills, max_abs_err=max(errs), timing=timing, card=card_line())
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
        + [whole(x) for x in list(env.market) + list(env.last_out)
           + list(env.portfolio)]


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
    """``repro_torch.train`` at the Table IV width over the TRAIN_MIX: on
    three backends the update's CUDA graph == its eager body over 2 + 2
    updates, one launch a step at replay, one graph captured and no
    synchronizing call in a warm ``train()``, the backends equal; a
    checkpointed resume equal to straight updates, into a fresh trainer
    and into a warm one (no new capture); at most two graphs a trainer;
    the flagship gate at the reference's bench shape; then the eager body
    and the graph timed in turns."""
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

    # 1. On each backend: 2 updates (the first the eager body, captured;
    # the second a replay) and 2 warm ones under torch's sync debug mode
    # "error", capturing nothing, against the eager body's 2 + 2 on the
    # card; kernel 1 (kernel 2) launched once per env step.
    errs, runs, counts = [], {}, {}
    first_s, warm_s, graph_bytes = {}, {}, {}
    for backend, counter in (("cuda-kinetic", "kinetic_clearing_chunk"),
                             ("cuda-naive", "naive_clearing_chunk"),
                             ("torch-scan", None)):
        eng = Engine(backend, device=device)
        tr = trainer(eng)
        ts = tr.init()
        want = {counter: 2 * T} if counter else {}
        builds = eng.trace_count
        reserved, allocated = memory_now()
        reset_counts()
        t0 = time.perf_counter()
        ts2, m2 = tr.train(ts, 2)
        torch.cuda.synchronize()
        first_s[backend] = time.perf_counter() - t0
        graph_bytes[backend] = memory_since(reserved, allocated)
        expect_counts(f"train {backend}", want)
        if eng.trace_count != builds + 1:
            raise Mismatch(f"train {backend}: the first train() captured "
                           f"{eng.trace_count - builds} graphs, not 1")
        reset_counts()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            ts4, m4 = tr.train(ts2, 2)
        except RuntimeError as exc:
            raise Mismatch(f"train on {backend} waited for the card: {exc}")
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        warm_s[backend] = time.perf_counter() - t0
        counts[backend] = expect_counts(f"train {backend} replay", want)
        if eng.trace_count != builds + 1:
            raise Mismatch(f"a warm train() on {backend} captured again")
        with eager_body(tr.env):
            e2, em2 = tr.train(ts, 2)
            e4, em4 = tr.train(e2, 2)
        errs.append(compare(f"train {backend}: graph vs eager body, 2",
                            train_outputs(ts2, m2), train_outputs(e2, em2)))
        errs.append(compare(f"train {backend}: graph vs eager body, 2 + 2",
                            train_outputs(ts4, m4), train_outputs(e4, em4)))
        runs[backend] = (eng, tr, ts2, m2, ts4, m4)
    want = train_outputs(*runs["torch-scan"][2:4])
    for backend in ("cuda-kinetic", "cuda-naive"):
        errs.append(compare(f"train {backend} vs torch-scan",
                            train_outputs(*runs[backend][2:4]), want))
    eng, tr, ts2, metrics, ts4, m4 = runs["cuda-kinetic"]
    trainer_builds = eng.trace_count
    loss = metrics["loss"]
    if tuple(loss.shape) != (2,) or not bool(torch.isfinite(
            torch.stack(list(metrics.values()))).all()):
        raise Mismatch(f"train metrics malformed: {metrics}")

    # 2. A checkpoint after 2 updates restored into a fresh trainer on a
    # fresh engine, and into the warm trainer (a replay, no capture): 2
    # more updates equal 4 straight ones.
    with tempfile.TemporaryDirectory() as tmp:
        save_train_checkpoint(CheckpointManager(tmp, async_write=False), tr,
                              ts2)
        fresh = trainer(Engine("cuda-kinetic", device=device))
        restored = restore_train_checkpoint(CheckpointManager(tmp), fresh)
        warm = restore_train_checkpoint(CheckpointManager(tmp), tr)
    resumed, m_resumed = fresh.train(restored, 2)
    errs.append(compare("train resume 2 + 2 vs 4",
                        train_outputs(resumed, m_resumed),
                        train_outputs(ts4, m4)))
    builds = eng.trace_count
    resumed, m_resumed = tr.train(warm, 2)
    if eng.trace_count != builds:
        raise Mismatch("a restored checkpoint captured the update again")
    errs.append(compare("train warm resume 2 + 2 vs 4",
                        train_outputs(resumed, m_resumed),
                        train_outputs(ts4, m4)))

    # 3. The flagship gate at the reference's bench shape.
    gate = flagship_gate(device)
    if not gate["learned"] > gate["scripted"]:
        raise Mismatch(f"the learned maker does not beat the scripted maker "
                       f"at the bench shape: {gate}")

    # 4. Timing at full width: TRAIN_TIMED_UPDATES updates, the graph and
    # the eager body in turns.
    ts = ts4
    walls = {"graph": [], "eager": []}
    for mode in ("graph", "eager", "eager", "graph"):
        with eager_body(tr.env, mode == "eager"):
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            ts, metrics = tr.train(ts, TRAIN_TIMED_UPDATES)
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t0)
            timed_counts = expect_counts(f"train timed {mode}", {
                "kinetic_clearing_chunk": TRAIN_TIMED_UPDATES * T})
    wall = statistics.median(walls["graph"])
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
    profile = dict(rollout_eager=profile_window(lambda: tr.collect(ts), T))
    for mode in ("graph", "eager"):
        with eager_body(tr.env, mode == "eager"):
            profile[f"update_{mode}"] = profile_window(
                lambda: tr.train(ts, 1), T)
    env_steps = TRAIN_TIMED_UPDATES * T * M
    # The greedy rollout on the trainer's env (its second graph), then
    # the learned maker against the scripted one on the held-out mixture
    # at full width (reported, not gated).
    reset_counts()
    tr.evaluate(ts.params, n_steps=T)
    tr.evaluate(ts.params, n_steps=T)
    expect_counts("train evaluate", {"kinetic_clearing_chunk": 2 * T})
    graphs = len(tr.graphs())
    if graphs > 2:
        raise Mismatch(f"the trainer holds {graphs} graphs, more than its "
                       "update and its greedy rollout")
    held = eng.env(train_spec(HELDOUT_MIX, TRAIN_BLOCK, A, L, T,
                              TRAIN_CONFIG["seed"]),
                   reward=SpreadCapture(), obs=MarketFeatures())
    reset_counts()
    learned = float(tr.evaluate(ts.params, env=held, n_steps=T)
                    .reward.mean())
    eval_counts = expect_counts("train evaluate held-out",
                                {"kinetic_clearing_chunk": T})
    scripted = float(rollout(held, make_market_maker(L), T)[1].reward.mean())
    if eng.trace_count != trainer_builds + 3:
        raise Mismatch(f"after its first train() the trainer's engine built "
                       f"{eng.trace_count - trainer_builds} runners or graphs"
                       ", not the 3 rollouts' graphs (greedy, held-out "
                       "greedy, held-out scripted)")
    emit("train", ok=True, markets=M, agents=A, levels=L,
         config=TRAIN_CONFIG, launches={
             "train_2_warm_updates": {b: {k: n for k, n in c.items() if n}
                                      for b, c in counts.items()},
             "timed": timed_counts["kinetic_clearing_chunk"],
             "evaluate": eval_counts["kinetic_clearing_chunk"]},
         sync_debug_mode="error", trainer_graphs=graphs,
         first_2_updates_s=first_s, warm_2_updates_s=warm_s,
         graph_bytes=graph_bytes,
         max_abs_err=max(errs), gate=gate,
         timing=dict(
             updates=TRAIN_TIMED_UPDATES, wall_s=wall,
             graph_s_per_update=[w / TRAIN_TIMED_UPDATES
                                 for w in walls["graph"]],
             eager_s_per_update=[w / TRAIN_TIMED_UPDATES
                                 for w in walls["eager"]],
             graph_over_eager=statistics.median(walls["eager"]) / wall,
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
    check_sweeps(f"serve {phase} child")
    report = dict(gateway_report(gw), launches=read_counts(),
                  swept=dict(sweep_launches(), open_fill=_CARD_OPENS[0]),
                  **extra)
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
    engine opened, replays included) plus the child's tile sweeps, the
    open fill once per session opened, kernel 2 and the legacy kernels
    never. Returns the chunks dispatched."""
    if report["traces_delta"] != 0:
        raise Mismatch(f"{label}: traces_delta {report['traces_delta']}")
    dispatched = report["chunks_dispatched"] + 1 + report["recoveries"]
    want = {"kinetic_clearing_chunk": dispatched}
    for name, n in report["launches"].items():
        need = want.get(name, 0) + report["swept"].get(name, 0)
        if n != need:
            raise Mismatch(f"{label}: {name} launched {n} times, expected "
                           f"{want.get(name, 0)} on the path and "
                           f"{report['swept'].get(name, 0)} in tile sweeps "
                           f"or opens")
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
    if len(sys.argv) == 3 and sys.argv[1] == "env-rates":
        return env_rates_child(sys.argv[2])
    if len(sys.argv) == 2 and sys.argv[1] == "host-column":
        return host_column_child()
    if len(sys.argv) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    import time

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: the port is not beside this script (no "
              f"{ROOT / 'src' / 'repro_torch'}): run it from a checkout",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc
    from repro_torch.kernels import open_fill

    t0 = time.perf_counter()
    device = torch.device(*CARD)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    err_edges, err_edges_n = phase_edges(device)
    err_k = max(phase_kernel(device, MARKETS_PER_BLOCK), err_edges)
    pop_launches, err_pop, err_pop_n = phase_population(device)
    exact_launches = phase_exact(device)
    err_n = max(phase_kernel(device, MARKETS_PER_BLOCK, entry="naive"),
                err_edges_n)
    err_l = phase_legacy(device)
    launches, session_errs = phase_session(device, MARKETS_PER_BLOCK)
    fill_launches, err_fill, fill_time = phase_open_fill(device)
    _, err_p = phase_parity(device)
    err_x = phase_cross_stream(device)
    err_sc = phase_scenario(device)
    timing = phase_timing(device)
    err_s = phase_agent_sweep(device)
    legacy = phase_legacy_path(device)
    phase_fixed_workload(device)
    err_tune, tune_launches = phase_autotune(device)
    err_shard, shard_launches = phase_sharded(device)
    err_roof, roof_launches = phase_roofline(device)
    err_env = phase_env(device)
    err_train, train_launches = phase_train(device)
    serve = phase_serve(device)
    check_sweeps("the last phase")
    launches.update(legacy["launches"])
    for extra in (train_launches, tune_launches, shard_launches,
                  roof_launches, pop_launches, exact_launches,
                  {"open_fill": fill_launches}):
        for name, n in extra.items():
            launches[name] += n
    errs = {"kinetic_clearing_chunk":
            max(err_k, err_s, session_errs["kinetic_clearing_chunk"],
                err_p, err_x, err_sc, err_env, err_train,
                serve["max_abs_err"], err_pop),
            "naive_clearing_chunk":
            max(err_n, err_s, session_errs["naive_clearing_chunk"],
                err_p, err_env, err_train, serve["max_abs_err"], err_pop_n),
            "kinetic_clearing":
            max(err_l, legacy["max_abs_err"]["kinetic_clearing"], err_pop),
            "naive_clearing":
            max(err_l, legacy["max_abs_err"]["naive_clearing"], err_pop_n),
            "open_fill": err_fill}
    for extra in (err_tune, err_shard,
                  {"kinetic_clearing_chunk": err_roof}):
        for name, e in extra.items():
            errs[name] = max(errs[name], e)
    times = {"kinetic_clearing_chunk": (timing["ms"], timing["plain_ms"],
                                        timing),
             "naive_clearing_chunk": (timing["naive_ms"], timing["plain_ms"],
                                      timing),
             "kinetic_clearing": (legacy["kinetic_ms"], legacy["plain_ms"],
                                  legacy),
             "naive_clearing": (legacy["naive_ms"], legacy["plain_ms"],
                                legacy),
             "open_fill": (fill_time["ms"], fill_time["plain_ms"],
                           fill_time)}
    sources = {"kinetic_clearing_chunk": (kc.SOURCE, kc.REPLACES),
               "naive_clearing_chunk": (nc.SOURCE, nc.REPLACES),
               "kinetic_clearing": (kc.SOURCE, kc.LEGACY_REPLACES),
               "naive_clearing": (nc.SOURCE, nc.LEGACY_REPLACES),
               "open_fill": (open_fill.SOURCE, None)}
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
