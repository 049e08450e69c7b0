#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py        # needs one CUDA card; takes no arguments

Every run drives every phase at full width. Phases, each printing one JSON
line:

  build    build the CUDA kernels from ``src/repro_torch/kernels/csrc``.
  kernel   ``kinetic_clearing_chunk`` (CUDA) == its plain PyTorch version,
           field by field, at the paper's width A=256, L=128 on a
           heterogeneous ensemble populating all eight archetypes: a chunk
           holding the shock step, a partial tail, external orders,
           ``stats_only``, and ``scan="hillis-steele"``.
  edges    the same check at L=1024, A=300 and at L=8, A=5.
  session  ``Engine("cuda-kinetic").open(spec).run(500)`` in chunks of 64 ==
           a one-shot plain run on the card; ``stats_only`` stats == the
           plain accumulation; one kernel launch per chunk.
  timing   CUDA-event times of the kernel and the plain version at M=8192,
           A=256, L=128, chunk 64, against the kernel's bound.

The second-to-last line lists every kernel with its launches on the main
path; the last line is the device record. Any mismatch or exception exits
non-zero before those lines. Imports nothing of JAX or of the JAX package.
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
# H100 SXM data sheet: 67 TFLOP/s in f32 counts an FMA as two operations.
# One instruction per FP32 lane per clock (132 SMs x 128 lanes x 1.98 GHz)
# is half that; kc.op_count counts issue slots at this rate.
PEAK_LANE_OPS = 67e12 / 2
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
SEED = 20260611


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


def kernel_vs_plain(label, spec, device, *, step0, n_valid, chunk,
                    ext=False, stats_only=False, scan="cumsum", state=None):
    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.stats import init_stats
    from repro_torch.kernels import kinetic_clearing as kc

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
    got = kc.kinetic_clearing_chunk(*state, step0, n_valid, eb, ea, **kw)
    want = kc.kinetic_clearing_chunk_plain(*state, step0, n_valid, eb, ea,
                                           **kw)
    torch.cuda.synchronize()
    err = compare(label, outputs(got, n_valid), outputs(want, n_valid))
    vol = float(want[4].sum_volume.sum()) if stats_only else \
        float(want[5][:, :n_valid].sum())
    return err, vol


def phase_build():
    import time
    from repro_torch.kernels import _build
    from repro_torch.kernels import kinetic_clearing as kc

    t0 = time.perf_counter()
    _build.build(["kinetic_clearing"])
    kc._load_library()
    emit("build", ok=True, seconds=time.perf_counter() - t0,
         flags=" ".join(_build.NVCC_FLAGS))


def phase_kernel(device, B):
    spec = full_width_spec(B)
    errs = {}
    cases = (
        ("shock_chunk", dict(step0=224, n_valid=64, chunk=64)),
        ("partial_tail", dict(step0=448, n_valid=52, chunk=64)),
        ("ext_orders", dict(step0=0, n_valid=64, chunk=64, ext=True)),
        ("stats_only", dict(step0=224, n_valid=64, chunk=64,
                            stats_only=True)),
        ("hillis_steele", dict(step0=224, n_valid=64, chunk=64,
                               scan="hillis-steele")),
    )
    volumes = {}
    for label, kw in cases:
        errs[label], volumes[label] = kernel_vs_plain(label, spec, device, **kw)
    emit("kernel", ok=True, markets=spec.num_markets, agents=256, levels=128,
         cases=list(errs), max_abs_err=max(errs.values()),
         traded_volume=volumes)
    return max(errs.values())


def phase_edges(device):
    errs = []
    for M, A, L in ((8, 300, 1024), (16, 5, 8)):
        spec = small_spec(M, A, L, num_steps=20)
        for step0, n_valid in ((0, 12), (4, 9)):
            e, _ = kernel_vs_plain(f"edge L={L} A={A} step0={step0}", spec,
                                   device, step0=step0, n_valid=n_valid,
                                   chunk=12, ext=True)
            errs.append(e)
        e, _ = kernel_vs_plain(f"edge L={L} A={A} stats", spec, device,
                               step0=2, n_valid=12, chunk=12, stats_only=True)
        errs.append(e)
    emit("edges", ok=True, shapes=[[8, 300, 1024], [16, 5, 8]],
         max_abs_err=max(errs))
    return max(errs)


def phase_session(device, B):
    """The main path: Engine("cuda-kinetic").open(spec).run(500)."""
    import torch
    from repro_torch.core import params as params_mod
    from repro_torch.core.session import Engine
    from repro_torch.core.stats import init_stats
    from repro_torch.kernels import kinetic_clearing as kc

    spec = full_width_spec(B)
    S, chunk = spec.num_steps, 64
    n_chunks = -(-S // chunk)

    def drive(**opts):
        kc.kinetic_clearing_chunk.launches = 0
        with Engine("cuda-kinetic", device=device, **opts).open(
                spec, chunk_size=chunk) as sess:
            batch = sess.run(S)
            out = list(sess.state) + list(batch) + list(sess._stats or ())
            torch.cuda.synchronize()
        launches = kc.kinetic_clearing_chunk.launches
        if launches != n_chunks:
            raise Mismatch(f"session launched the kernel {launches} times, "
                           f"expected {n_chunks} (one per chunk)")
        return out, launches

    got, launches = drive()                     # the main path
    got_stats, _ = drive(stats_only=True)

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

    err = compare("session paths", got, plain_run(False))
    # A stats_only batch has zero-width paths: drop them before comparing.
    err = max(err, compare("session stats", got_stats[:4] + got_stats[7:],
                           plain_run(True)))
    price, volume, mid = got[4:]
    finite = all(bool(torch.isfinite(x).all()) for x in got)
    on_grid = bool(((price >= 0) & (price <= spec.num_levels - 1)
                    & (price == torch.round(price))).all())
    if not (finite and on_grid and tuple(price.shape) == (spec.num_markets, S)):
        raise Mismatch(f"session output malformed: finite={finite} "
                       f"on_grid={on_grid} shape={tuple(price.shape)}")
    emit("session", ok=True, markets=spec.num_markets, steps=S, chunk=chunk,
         launches=launches, chunks_per_run=n_chunks,
         total_volume=float(volume.sum()), max_abs_err=err)
    return launches, err


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


def phase_timing(device):
    from repro_torch.core import params as params_mod
    from repro_torch.core.config import MarketConfig
    from repro_torch.core.params import EnsembleSpec
    from repro_torch.kernels import kinetic_clearing as kc

    M, A, L, chunk = 8192, 256, 128, 64
    spec = EnsembleSpec.homogeneous(MarketConfig(
        num_markets=M, num_agents=A, num_levels=L, num_steps=500, seed=SEED))
    state = opening(spec, device)
    params = params_mod.pack_params(spec.params, device)

    def kernel():
        kc.kinetic_clearing_chunk(*state, 0, chunk, cfg=spec, chunk=chunk,
                                  params=params)

    def plain():
        kc.kinetic_clearing_chunk_plain(*state, 0, chunk, cfg=spec,
                                        chunk=chunk, params=params)

    # In turns (plain, kernel, kernel, plain) inside one call.
    plain_ms = [_time(plain, 2)]
    kernel_ms = [_time(kernel, 20), _time(kernel, 20)]
    plain_ms.append(_time(plain, 2))
    ms, pms = statistics.median(kernel_ms), statistics.median(plain_ms)
    ops = kc.op_count(M, A, L, chunk)
    nbytes = kc.byte_count(M, L, chunk, ext=False, stats_only=False)
    ops_ms, bytes_ms = ops / PEAK_LANE_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    timing = dict(markets=M, agents=A, levels=L, chunk=chunk, ms=ms,
                  kernel_ms_runs=kernel_ms, plain_ms=pms,
                  plain_ms_runs=plain_ms,
                  agent_events_per_s=M * A * chunk / (ms * 1e-3),
                  ops=ops, bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
                  bound_by="operations" if ops_ms >= bytes_ms else "bytes",
                  bound_share=max(ops_ms, bytes_ms) / ms)
    emit("timing", ok=True, **timing)
    return timing


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
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    from repro_torch.kernels import kinetic_clearing as kc

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    err = max(phase_kernel(device, MARKETS_PER_BLOCK), phase_edges(device))
    launches, e = phase_session(device, MARKETS_PER_BLOCK)
    err = max(err, e)
    timing = phase_timing(device)
    print(card_line(), flush=True)  # the card's name and power limit
    print(json.dumps({"kernels": [{
        "name": "kinetic_clearing_chunk", "route": "cuda",
        "source": kc.SOURCE, "replaces": kc.REPLACES,
        "launches": launches, "max_abs_err": err,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
