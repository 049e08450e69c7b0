#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py        # needs one CUDA card; takes no arguments

Every run drives every phase at full width. Phases, each printing one JSON
line:

  build    build the CUDA kernels from ``src/repro_torch/kernels/csrc``, one
           ``nvcc`` per source, all started together; each kernel's
           registers and spills from ptxas (``-Xptxas -v``); any spill
           fails.
  kernel   ``kinetic_clearing_chunk`` (CUDA) == its plain PyTorch version,
           field by field, at the paper's width A=256, L=128 on a
           heterogeneous ensemble populating all eight archetypes: a chunk
           holding the shock step, a partial tail, external orders,
           ``stats_only``, and ``scan="hillis-steele"``.
  edges    the same check at L=1024, A=300, at L=8, A=5 and at L=4, A=16,
           the last two with 15 markets (a ragged last CTA).
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

Each path is driven with every launch count at 0 just before it and read
just after. The ``timing``, ``agent_sweep``, ``legacy_path`` and
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
import statistics
import subprocess
import sys
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
    from repro_torch.kernels import _build
    from repro_torch.kernels import kinetic_clearing as kc
    from repro_torch.kernels import naive_clearing as nc

    t0 = time.perf_counter()
    _build.build(["kinetic_clearing", "naive_clearing"])
    kc._load_library()
    nc._load_library()
    ptxas = {**_build.ptxas_report("kinetic_clearing"),
             **_build.ptxas_report("naive_clearing")}
    kernels = ("kinetic_chunk_kernel<true>", "kinetic_chunk_kernel<false>",
               "kinetic_legacy_kernel<true>", "kinetic_legacy_kernel<false>",
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
    emit("edges", ok=True, shapes=[list(x) for x in shapes],
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
        agents_in_registers=shape.agents_in_registers,
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
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
    timing = phase_timing(device)
    err_s = phase_agent_sweep(device)
    legacy = phase_legacy_path(device)
    phase_fixed_workload(device)
    launches.update(legacy["launches"])
    errs = {"kinetic_clearing_chunk":
            max(err_k, err_s, session_errs["kinetic_clearing_chunk"]),
            "naive_clearing_chunk":
            max(err_n, err_s, session_errs["naive_clearing_chunk"]),
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
