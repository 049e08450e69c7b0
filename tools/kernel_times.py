#!/usr/bin/env python3
"""Time the port's four clearing kernels on one CUDA card, for the
``repro_torch`` of a given source tree.

    python3 tools/kernel_times.py [--src DIR] [--label X] [--matrix]
                                  [--fresh-only] [--only LABEL,...]
                                  [--holds]

``--src`` (default: this checkout's ``src``) selects the tree, so two
commits, or a commit and a variant of it, can be compared in one call on
one card: unpack the other tree (``git archive``) into a git-ignored
directory and run the script for each tree in turns (parent, change,
change, parent).

Shapes (homogeneous baseline markets from the opening books, one call of 64
steps each, CUDA events over several calls after a warm-up):

  * kernels 1 and 2 (``kinetic_clearing_chunk``, ``naive_clearing_chunk``)
    at M=8192, L=128 and the paper's agent sweep A in {16, 64, 256, 1024},
    and at M=8192, A=32, L=1024;
  * kernels 3 and 4 (``kinetic_clearing``, ``naive_clearing``) at M=8192,
    A=256, L=128, S=64;
  * the main path: ``Session.run(500)`` of ``cuda-kinetic`` and of
    ``cuda-naive`` at M=8192, A=256, L=128 (chunk 64, the rule's launch
    shape on a tree that has a tile sweep), its wall around the run and a
    ``torch.cuda.synchronize``;
  * large populations (``POPULATIONS``): the fresh mode's shapes
    (populations past shared memory) and the hoisted modes' on few
    markets. Kernels 1 and 3 at one CTA a market (``auto_tile(L, A)``,
    C = 1) and at the rule's shape for the markets (``auto_tile(L, A,
    M)``, a market cluster on a tree that has them), in turns (C = 1,
    rule, rule, C = 1), each output equal to the other's; where ``NAIVE``
    names the shape, kernels 2 and 4 likewise at C = 1 and at their own
    rule's shape (``auto_tile(L, A, M, hoisted=False)``, a market cluster
    on a tree whose per-step kernels have one), each equal to kernel 1's
    (kernel 3's) output, with their ratios to kernels 1 and 3 at equal
    layouts; device times (calls queued behind a sleeping kernel, so the
    wrappers' host work does not count), with the bound, the share of the
    SMs the grid can occupy and the agent-events/s. ``--matrix`` adds kernels 1 and 3 at the rule's shape
    and at every candidate shape of one team a CTA that the sweep may
    offer for some number of markets (``candidate_tiles`` without one):
    every (warps a market, agent mode) at C = 1 and every market cluster,
    each with what the card holds of it at once (``resident_ctas``:
    clusters on the card at C > 1, else CTAs an SM). ``--only`` keeps
    the ``POPULATIONS`` shapes of the given labels;
  * ``--holds``: what the card holds at once of every persistent agent
    mode, team width and C at L=128 (``resident_ctas``, the fewer of
    kernels 1 and 3) beside ``autotune.h100_holds``, the rule's count
    without a card, on a tree that has it; then the same of the per-step
    kernels (the fewer of kernels 2 and 4) at every team width and C.

Prints one JSON line per shape, then the card's name and power limit.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

SWEEP = [(8192, A, 128) for A in (16, 64, 256, 1024)] + [(8192, 32, 1024)]
LEGACY = (8192, 256, 128)
STEPS = 64
SEED = 20260611
RUN500_REPS = 7
#: Large-population shapes (label, M, A, L, steps, mix): the ``edges``
#: phase's two fresh shapes (10 markets, 6 steps) and the ``population``
#: phase's P1-P3 as homogeneous baseline markets (``mix`` False); then,
#: with ``MIX``, populations inside shared memory on few markets: B1 the
#: last population the shared mode holds at one CTA a market, B2 a wide
#: book, Q1 one exchange, Q2 half the SMs' markets, Q3 two markets an SM;
#: W1-W3 many more markets than the card holds at once (the hoisted and
#: fresh modes in many waves), R1 and R2 a registers-mode cluster the card
#: holds. A·8·S < 2^24 in each, so the books stay exact-integer float32.
POPULATIONS = [("edges", 10, 50000, 128, 6, False),
               ("edges", 10, 45000, 1024, 6, False),
               ("P1", 1, 100000, 128, 16, False),
               ("P2", 16, 50000, 1024, 32, False),
               ("P3", 128, 50000, 128, 32, False),
               ("B1", 10, 46080, 128, 6, True),
               ("B2", 10, 20000, 1024, 6, True),
               ("Q1", 1, 40000, 128, 32, True),
               ("Q2", 64, 30000, 128, 32, True),
               ("Q3", 264, 30000, 128, 32, True),
               ("W1", 8192, 20000, 1024, 16, True),
               ("W2", 2048, 30000, 128, 32, True),
               ("W3", 1024, 40000, 1024, 16, True),
               ("R1", 1, 30000, 128, 32, True),
               ("R2", 4, 20000, 1024, 16, True)]
#: ``chip_smoke.POPULATION_MIX``: every archetype, whales of 32 lots every
#: 4th step.
MIX = dict(alpha_fundamentalist=0.1, alpha_whale=0.02, whale_period=4,
           alpha_hft=0.1, alpha_informed=0.05, alpha_arbitrageur=0.1,
           shock_intensity=0.3, shock_cancel=0.5)
#: Shapes (label, A) at which kernels 2 and 4 are timed beside kernels 1
#: and 3.
NAIVE = {("edges", 50000), ("B1", 46080), ("P1", 100000), ("Q1", 40000)}
FRESH_REPS = 5
QUEUE_SLEEP_CYCLES = 200_000_000


def time_ms(fn, reps: int) -> float:
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


def queued_ms(fn, reps: int) -> float:
    """Device time of one ``fn`` call: ``reps`` calls queued behind a
    sleeping kernel, so the host's work between launches does not count.
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
    queued = (time.perf_counter() - t0) * 1e3
    events[2].record()
    torch.cuda.synchronize()
    if queued >= events[0].elapsed_time(events[1]):
        raise RuntimeError(f"queueing took {queued} ms, longer than the "
                           "sleep it hides behind")
    return events[1].elapsed_time(events[2]) / reps


def session_run_ms(shape, device, backend="cuda-kinetic") -> float:
    """Wall of one ``Session.run(500)`` of ``backend``, ms."""
    import time

    import torch
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec
    from repro_torch.core.session import Engine
    from repro_torch.kernels import ops

    M, A, L = shape
    spec = EnsembleSpec.homogeneous(MarketConfig(
        num_markets=M, num_agents=A, num_levels=L, num_steps=500,
        seed=SEED))
    knobs = inspect.signature(ops.open_kinetic_runner).parameters
    opts = {"autotune": False} if "autotune" in knobs else {}
    with Engine(backend, device=device, chunk_size=64,
                **opts).open(spec) as sess:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.run(500)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3


#: (mode, A at C = 1) of ``--holds``: A grows with C so that each shape
#: keeps its CTAs' shared memory; the second shared population fills half
#: an SM's.
HOLDS = [("registers", 256), ("shared", 2000), ("shared", 24000),
         ("fresh", 100000)]


def holds_line(base: dict) -> None:
    """One JSON line: [W, mode, A, C, card, h100_holds] for each shape of
    ``HOLDS`` at every team width and C the kernels take at L=128."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    static = getattr(autotune, "h100_holds", lambda t, hoisted=True: None)
    rows = []
    for W in autotune.WARPS_PER_MARKET:
        for mode, A0 in HOLDS:
            for C in autotune.CTAS_PER_MARKET:
                A = A0 * (W if mode == "registers" else 1) * C
                tile = autotune.TileChoice(128, A, W, 1, mode, C)
                try:
                    autotune.check_tile(tile, 128, A, True)
                except ValueError:
                    continue
                rows.append([W, mode, A, C,
                             min(kc.resident_ctas(legacy, tile)
                                 for legacy in (False, True)),
                             static(tile)])
    print(json.dumps(dict(base, holds=rows)), flush=True)
    # The per-step kernels: fresh, so A does not change what they hold.
    steps = []
    step_rule = "hoisted" in inspect.signature(autotune.auto_tile).parameters
    for W in autotune.WARPS_PER_MARKET:
        for C in autotune.CTAS_PER_MARKET if step_rule else (1,):
            tile = autotune.TileChoice(128, 100000 * C, W, 1, "fresh", C)
            steps.append([W, "step", tile.num_agents, C,
                          min(nc.resident_ctas(legacy, tile)
                              for legacy in (False, True)),
                          static(tile, False) if step_rule else None])
    print(json.dumps(dict(base, step_holds=steps)), flush=True)


def naive_times(out: dict, M: int, A: int, L: int, fns, want,
                one) -> None:
    """Kernels 2 and 4 at one CTA a market (``one``) and at their rule's
    shape (a cluster where the tree's per-step kernels take one), in turns
    beside kernels 1 and 3 at ``one`` and at their own rule's shape, into
    ``out``: ms, each output equal to kernel 1's (kernel 3's), and the
    ratios to kernels 1 and 3 (at equal layouts where both rules take the
    same cluster)."""
    import torch
    from repro_torch.kernels import autotune

    k1, k2, k3, k4 = fns
    step_rule = "hoisted" in inspect.signature(autotune.auto_tile).parameters
    rule = autotune.auto_tile(L, A, M, hoisted=False) if step_rule else one
    # Beside it, kernels 1 and 3 at their own rule's shape.
    kin = autotune.auto_tile(L, A, M)
    for name, fn, ref, base in (("kernel2", k2, k1, k1),
                                ("kernel4", k4, k3, k3)):
        runs = {}
        for which in ("one", "rule", "rule", "one"):
            tile, ktile = (one, one) if which == "one" else (rule, kin)
            runs.setdefault(which, []).append(
                (queued_ms(lambda: fn(tile), FRESH_REPS),
                 queued_ms(lambda: base(ktile), FRESH_REPS)))
        for which, tile in (("one", one), ("rule", rule)):
            ms = statistics.median(t[0] for t in runs[which])
            base_ms = statistics.median(t[1] for t in runs[which])
            grid = tile.grid(M)
            out[f"{name}_{which}"] = dict(
                ms=ms, ms_runs=[t[0] for t in runs[which]],
                tile=list(tile), grid=grid,
                beside=base_ms, beside_runs=[t[1] for t in runs[which]],
                over_beside=ms / base_ms,
                equal=all(bool(torch.equal(x, y))
                          for x, y in zip(fn(tile), want[ref])))
        out[name] = dict(
            over_kernel1_rule=out[f"{name}_rule"]["over_beside"],
            over_kernel1_one=out[f"{name}_one"]["over_beside"])


def population_times(device, base: dict, matrix: bool,
                     only=None) -> None:
    """One JSON line per ``POPULATIONS`` shape: kernels 1 and 3 at C = 1
    and at the rule's shape, and where ``NAIVE`` names the shape kernels 2
    and 4 (:func:`naive_times`; see the module docstring); with ``matrix``
    a second line per shape."""
    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec
    from repro_torch.core.step import initial_state
    from repro_torch.kernels import autotune
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc
    from repro_torch.launch import bound

    clusters = "ctas_per_market" in autotune.TileChoice._fields
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for label, M, A, L, S, mixed in POPULATIONS:
        if only is not None and label not in only:
            continue
        cfg = MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                           num_steps=S, seed=SEED, **(MIX if mixed else {}))
        spec = EnsembleSpec.homogeneous(cfg)
        state = tuple(initial_state(spec, device))
        kw = dict(cfg=spec, chunk=S,
                  params=params_mod.pack_params(spec.params, device))
        one = autotune.auto_tile(L, A)
        rule = autotune.auto_tile(L, A, M) if clusters else one

        def k1(tile):
            return kc.kinetic_clearing_chunk(*state, 0, S, tile=tile, **kw)

        def k3(tile):
            return kc.kinetic_clearing(*state, cfg=cfg, tile=tile)

        def k2(tile):
            return nc.naive_clearing_chunk(*state, 0, S, tile=tile, **kw)

        def k4(tile):
            return nc.naive_clearing(*state, cfg=cfg, tile=tile)

        want = {fn: fn(one) for fn in (k1, k3)}

        def equal(fn, tile):
            return all(bool(torch.equal(x, y))
                       for x, y in zip(fn(tile), want[fn]))

        same = equal(k1, rule) and equal(k3, rule)
        mix = kc.agent_mix(spec.params, A)
        b1 = bound(kc.op_count(M, A, L, S, mix),
                   kc.byte_count(M, L, S, ext=False, stats_only=False))
        b3 = bound(kc.op_count(M, A, L, S, mix),
                   kc.legacy_byte_count(M, L, S))
        out = dict(base, shape=label, markets=M, agents=A, levels=L,
                   steps=S, mix=mixed, rule=list(rule), sms=sms, equal=same)
        for name, fn, b in (("kernel1", k1, b1), ("kernel3", k3, b3)):
            runs = {"one": [], "rule": []}
            for which in ("one", "rule", "rule", "one"):
                tile = one if which == "one" else rule
                runs[which].append(queued_ms(lambda: fn(tile), FRESH_REPS))
            for which, tile in (("one", one), ("rule", rule)):
                ms = statistics.median(runs[which])
                grid = tile.grid(M)
                out[f"{name}_{which}"] = dict(
                    ms=ms, ms_runs=runs[which], grid=grid,
                    sm_share=min(grid, sms) / sms,
                    bound_ms=b["bound_ms"], bound_share=b["bound_ms"] / ms,
                    agent_events_per_s=M * A * S / (ms * 1e-3))
        if (label, A) in NAIVE:
            naive_times(out, M, A, L, (k1, k2, k3, k4), want, one)
        print(json.dumps(out), flush=True)
        if not matrix:
            continue
        cells = []
        for cand in [rule] + [
                c for c in autotune.candidate_tiles(L, A, hoisted=True)
                if c.markets_per_cta == 1 and c != rule]:
            cells.append(dict(
                tile=list(cand[2:]),
                resident=min(kc.resident_ctas(legacy, cand)
                             for legacy in (False, True)),
                equal=equal(k1, cand) and equal(k3, cand),
                kernel1_ms=queued_ms(lambda: k1(cand), FRESH_REPS),
                kernel3_ms=queued_ms(lambda: k3(cand), FRESH_REPS)))
        print(json.dumps(dict(base, shape=label, markets=M, agents=A,
                              levels=L, steps=S, matrix=cells)), flush=True)


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[1]
                                         / "src"))
    ap.add_argument("--label", default="")
    ap.add_argument("--matrix", action="store_true",
                    help="also time kernels 1 and 3 at every candidate "
                    "shape of one team a CTA of the large populations")
    ap.add_argument("--fresh-only", action="store_true",
                    help="time the large populations' shapes alone")
    ap.add_argument("--only", default=None,
                    help="comma-separated labels of POPULATIONS to time")
    ap.add_argument("--holds", action="store_true",
                    help="print what the card holds at once of each "
                    "persistent shape at L=128")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core import params as params_mod
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec
    from repro_torch.core.step import initial_state
    from repro_torch.kernels import _build
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    device = torch.device("cuda", 0)
    base = dict(label=args.label, src=args.src)
    kc._load_library()
    nc._load_library()
    if hasattr(_build, "ptxas_report"):  # registers and spills, where kept
        print(json.dumps(dict(base, ptxas={
            **_build.ptxas_report(kc._LIB_NAME),
            **_build.ptxas_report(nc._LIB_NAME)})),
            flush=True)

    only = None if args.only is None else set(args.only.split(","))
    if args.holds:
        holds_line(base)
    if args.fresh_only:
        population_times(device, base, args.matrix, only)
        print(card_line(), flush=True)
        return 0
    for M, A, L in SWEEP:
        spec = EnsembleSpec.homogeneous(MarketConfig(
            num_markets=M, num_agents=A, num_levels=L, num_steps=500,
            seed=SEED))
        state = tuple(initial_state(spec, device))
        params = params_mod.pack_params(spec.params, device)
        kw = dict(cfg=spec, chunk=STEPS, params=params)
        one = kc.kinetic_clearing_chunk(*state, 0, STEPS, **kw)
        two = nc.naive_clearing_chunk(*state, 0, STEPS, **kw)
        same = all(bool(torch.equal(a, b)) for a, b in zip(one, two))
        k1 = [time_ms(lambda: kc.kinetic_clearing_chunk(
            *state, 0, STEPS, **kw), 10)]
        k2 = [time_ms(lambda: nc.naive_clearing_chunk(
            *state, 0, STEPS, **kw), 10) for _ in range(2)]
        k1.append(time_ms(lambda: kc.kinetic_clearing_chunk(
            *state, 0, STEPS, **kw), 10))
        print(json.dumps(dict(
            base, markets=M, agents=A, levels=L, steps=STEPS,
            kernel1_ms=statistics.median(k1), kernel1_ms_runs=k1,
            kernel2_ms=statistics.median(k2), kernel2_ms_runs=k2,
            kernel2_over_kernel1=statistics.median(k2)
            / statistics.median(k1), kernels_agree=same)), flush=True)

    M, A, L = LEGACY
    cfg = MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                       num_steps=STEPS, seed=SEED)
    state = tuple(initial_state(cfg, device))
    k3 = [time_ms(lambda: kc.kinetic_clearing(*state, cfg=cfg), 10)]
    k4 = [time_ms(lambda: nc.naive_clearing(*state, cfg=cfg), 10)
          for _ in range(2)]
    k3.append(time_ms(lambda: kc.kinetic_clearing(*state, cfg=cfg), 10))
    print(json.dumps(dict(
        base, markets=M, agents=A, levels=L, steps=STEPS,
        kernel3_ms=statistics.median(k3), kernel3_ms_runs=k3,
        kernel4_ms=statistics.median(k4), kernel4_ms_runs=k4)), flush=True)
    for backend in ("cuda-kinetic", "cuda-naive"):
        run500 = []
        for _ in range(RUN500_REPS + 1):
            run500.append(session_run_ms(LEGACY, device, backend))
        run500 = run500[1:]                   # the first run warms up
        print(json.dumps(dict(
            base, backend=backend, markets=LEGACY[0], agents=LEGACY[1],
            levels=LEGACY[2], steps=500,
            run500_wall_ms=statistics.median(run500),
            run500_wall_ms_runs=run500)), flush=True)
    population_times(device, base, args.matrix, only)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
