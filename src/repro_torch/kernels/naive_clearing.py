"""The per-step clearing kernels (the naive ablation): wrappers, CUDA
launches, plain versions.

:func:`naive_clearing_chunk` takes the operands and returns the outputs of
:func:`repro_torch.kernels.kinetic_clearing.kinetic_clearing_chunk`, but
launches one single-step kernel per step (``csrc/naive_clearing.cu``, the
persistent kernels' device step and launch shapes, a market cluster
included), so the books, scalars and stats cross device memory between
steps. It is the
counterpart of ``repro.kernels.naive_clearing.naive_clearing_chunk`` and
serves the ``cuda-naive`` session backend. :func:`naive_clearing` is the
legacy one-shot entry (``repro.kernels.naive_clearing.naive_clearing``):
``cfg.num_steps`` launches of one step of a scalar ``MarketConfig``.

On CUDA tensors a wrapper launches its kernels (or raises); on CPU tensors
it runs the plain version, which is the persistent kernels' plain version:
the two regimes compute the same function and differ only in where the
state lives between steps.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import stats as stats_mod
from repro_torch.core.config import MarketConfig
from repro_torch.core.params import MarketParams, PackedParams
from repro_torch.kernels import _build, autotune, open_fill
from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.launch import roofline

#: The source of the CUDA kernels and the TPU kernels they replace.
SOURCE = "src/repro_torch/kernels/csrc/naive_clearing.cu"
REPLACES = "src/repro/kernels/naive_clearing.py:217"
LEGACY_REPLACES = "src/repro/kernels/naive_clearing.py:97"

_LIB_NAME = "naive_clearing"
_c_ptr, _c_int, _c_u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
#: C entries of the library and their argument types.
_ENTRIES = {
    "kc_naive_clearing_chunk": [_c_ptr] * 24 + [_c_int] * 9 + [_c_u32,
                                                               _c_ptr],
    "kc_naive_clearing": [_c_ptr] * 16 + [_c_int] * 7 + [_c_u32, _c_ptr],
    "kc_occupancy": [_c_int] * 6 + [_c_ptr],
    **open_fill.ENTRIES,
}

#: The plain versions: the same function as the persistent entries'.
naive_clearing_chunk_plain = kc.kinetic_clearing_chunk_plain
naive_clearing_plain = kc.kinetic_clearing_plain


def _load_library() -> ctypes.CDLL:
    return _build.load(_LIB_NAME, _ENTRIES)


def _c_shape(shape: autotune.TileChoice) -> Tuple[int, int, int]:
    """``(warps_per_market, markets_per_cta, ctas_per_market)``: the C
    entries' shape (no agent mode: a per-step kernel keeps no agents)."""
    return (shape.warps_per_market, shape.markets_per_cta,
            shape.ctas_per_market)


def resident_ctas(legacy: bool, shape: autotune.TileChoice) -> int:
    """CTAs of the chunk (or legacy) step kernel resident on one SM at
    ``shape`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), or at
    ``ctas_per_market`` > 1 the clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters``; 0: it cannot place one)."""
    out = ctypes.c_int(0)
    _build.check_launch(
        _load_library(), _load_library().kc_occupancy(
            int(legacy), shape.num_agents, shape.num_levels,
            *_c_shape(shape), ctypes.byref(out)), "kc_occupancy")
    return out.value


def naive_clearing_chunk(
        bid: torch.Tensor, ask: torch.Tensor, last: torch.Tensor,
        pmid: torch.Tensor, step0: int, n_valid: int,
        ext_buy: Optional[torch.Tensor] = None,
        ext_ask: Optional[torch.Tensor] = None, *, cfg, chunk: int,
        scan: str = "cumsum", market_ids: Optional[torch.Tensor] = None,
        params: Union[PackedParams, MarketParams, None] = None,
        peer_mid: Optional[torch.Tensor] = None,
        stats: Optional[stats_mod.MarketStats] = None,
        stats_only: bool = False,
        tile: Optional[autotune.TileChoice] = None) -> Tuple:
    """Advance ``n_valid <= chunk`` steps from absolute step ``step0`` with
    ``n_valid`` launches of the single-step kernel.

    Operands and returns are those of ``kinetic_clearing_chunk``: external
    orders join the first step, the peer column is frozen once per call,
    and ``stats_only`` carries the six stats through every launch. ``tile``
    is the launch shape (its agent mode is not read: a per-step kernel
    keeps no agents), default ``autotune.auto_tile(L, A, M,
    hoisted=False)``, which may spread a market over a cluster. With
    ``n_valid == 0`` nothing is launched and the state comes back as
    copies; the caller's tensors are never written.
    """
    with roofline.uncounted():    # the operands' defaults join the call
        step0, n_valid, chunk, market_ids, params, peer_mid = \
            kc.check_chunk_operands(
                "naive_clearing_chunk", bid, ask, last, pmid, step0,
                n_valid, ext_buy, ext_ask, cfg=cfg, chunk=chunk, scan=scan,
                market_ids=market_ids, params=params, peer_mid=peer_mid,
                stats=stats, stats_only=stats_only)
    shape = autotune.resolve_tile(tile, bid.shape[1], cfg.num_agents,
                                  hoisted=False, num_markets=bid.shape[0])
    M, L = bid.shape
    with roofline.kernel_call("naive_clearing_chunk", bid.device, lambda: (
            op_count(M, cfg.num_agents, L, n_valid,
                     kc.packed_mix(params, cfg.num_agents)) if n_valid else 0,
            byte_count(M, L, n_valid, ext=ext_buy is not None,
                       stats_only=stats_only) if n_valid else 0, n_valid)):
        if bid.device.type == "cpu":
            return naive_clearing_chunk_plain(
                bid, ask, last, pmid, step0, n_valid, ext_buy, ext_ask,
                cfg=cfg, chunk=chunk, scan=scan, market_ids=market_ids,
                params=params, peer_mid=peer_mid, stats=stats,
                stats_only=stats_only)
        state = [t.contiguous() for t in (bid, ask, last, pmid)]
        stats_in = (torch.cat(list(stats), dim=1).contiguous() if stats_only
                    else None)
        if n_valid == 0:
            out = [t.clone() for t in state]
            stats_out = None if stats_in is None else stats_in.clone()
            paths = [torch.zeros((M, chunk), dtype=torch.float32,
                                 device=bid.device) for _ in range(3)]
        else:
            out, stats_out, paths = _launch_chunk(
                state, stats_in, ext_buy, ext_ask, step0, n_valid, cfg=cfg,
                chunk=chunk, market_ids=market_ids.contiguous(),
                params=params, peer_mid=peer_mid.contiguous(), shape=shape)
            naive_clearing_chunk.launches += n_valid
    if stats_only:
        return tuple(out) + (stats_mod.MarketStats(
            *(stats_out[:, k:k + 1] for k in range(6))),)
    return tuple(out) + tuple(paths)


#: Kernel launches since the count was last reset, one per step (CPU calls
#: never count; a CUDA graph's capture counts nothing, each replay its
#: launches: :mod:`repro_torch.core.graphs`).
naive_clearing_chunk.launches = 0


def _launch_chunk(state, stats_in, ext_buy, ext_ask, step0, n_valid, *, cfg,
                  chunk, market_ids, params, peer_mid, shape):
    lib = _load_library()
    bid = state[0]
    M, L = bid.shape
    ext_buy = None if ext_buy is None else ext_buy.contiguous()
    ext_ask = None if ext_ask is None else ext_ask.contiguous()
    floats, ints = params.floats.contiguous(), params.ints.contiguous()
    # The final state lands in `out`; `tmp` is the other half of the
    # ping-pong between launches.
    out = [torch.empty_like(t) for t in state]
    tmp = [torch.empty_like(t) for t in state]
    stats_out = stats_tmp = None
    if stats_in is not None:
        stats_out, stats_tmp = (torch.empty_like(stats_in) for _ in range(2))
        paths = [None] * 3
    else:
        paths = [torch.empty((M, chunk), dtype=torch.float32,
                             device=bid.device) for _ in range(3)]
    ptr = _build.ptr
    with torch.cuda.device(bid.device):
        rc = lib.kc_naive_clearing_chunk(
            ptr(market_ids), *map(ptr, state), ptr(ext_buy), ptr(ext_ask),
            ptr(peer_mid), ptr(floats), ptr(ints), ptr(stats_in),
            *map(ptr, out), ptr(stats_out), *map(ptr, tmp), ptr(stats_tmp),
            *map(ptr, paths), M, cfg.num_agents, L, chunk, step0, n_valid,
            *_c_shape(shape), int(cfg.seed) & 0xFFFFFFFF,
            torch.cuda.current_stream(bid.device).cuda_stream)
    _build.check_launch(lib, rc, "naive_clearing_chunk")
    return out, stats_out, paths


def naive_clearing(bid: torch.Tensor, ask: torch.Tensor, last: torch.Tensor,
                   pmid: torch.Tensor, *, cfg: MarketConfig,
                   scan: str = "cumsum",
                   tile: Optional[autotune.TileChoice] = None) -> Tuple:
    """Run ``cfg.num_steps`` steps of a scalar ``MarketConfig`` with one
    launch per step (the legacy one-shot entry of the ablation).

    Market ids are the rows, and arbitrageurs see their own market's
    previous mid at every step. ``tile`` (the counterpart of ``mb``) is the
    launch shape, default ``autotune.auto_tile(L, A, M, hoisted=False)``.
    Returns ``(bid,
    ask, last, pmid, price_path, volume_path)`` with ``[M, S]`` paths.
    """
    kc.check_legacy_operands("naive_clearing", bid, ask, last, pmid,
                             cfg=cfg, scan=scan)
    shape = autotune.resolve_tile(tile, bid.shape[1], cfg.num_agents,
                                  hoisted=False, num_markets=bid.shape[0])
    M, L = bid.shape
    S = cfg.num_steps
    with roofline.kernel_call("naive_clearing", bid.device, lambda: (
            kc.legacy_op_count(cfg, M) if S else 0,
            legacy_byte_count(M, L, S), S)):
        if bid.device.type == "cpu":
            return naive_clearing_plain(bid, ask, last, pmid, cfg=cfg,
                                        scan=scan)
        state = [t.contiguous() for t in (bid, ask, last, pmid)]
        paths = [torch.empty((M, S), dtype=torch.float32, device=bid.device)
                 for _ in range(2)]
        if S == 0:
            return tuple(t.clone() for t in state) + tuple(paths)
        out = _launch_legacy(state, paths, cfg, shape)
        naive_clearing.launches += S
    return out


#: Kernel launches since the count was last reset, one per step (CPU calls
#: never count).
naive_clearing.launches = 0


def _launch_legacy(state, paths, cfg, shape):
    bid = state[0]
    M, L = bid.shape
    S = cfg.num_steps
    lib = _load_library()
    params = kc.legacy_params(cfg, bid.device)
    out = [torch.empty_like(t) for t in state]
    tmp = [torch.empty_like(t) for t in state]
    with torch.cuda.device(bid.device):
        rc = lib.kc_naive_clearing(
            *map(_build.ptr, state + [params.floats, params.ints] + out + tmp
                 + paths), M, cfg.num_agents, L, S, *_c_shape(shape),
            int(cfg.seed) & 0xFFFFFFFF,
            torch.cuda.current_stream(bid.device).cuda_stream)
    _build.check_launch(lib, rc, "naive_clearing")
    return tuple(out + paths)


#: Operations per step are the persistent kernels' (the same device step);
#: only where the state lives differs.
op_count = kc.op_count


def byte_count(num_markets: int, num_levels: int, steps: int, *, ext: bool,
               stats_only: bool) -> int:
    """Bytes the per-step kernels move through device memory in one chunk
    call of ``steps`` launches: every launch reads and writes the books and
    the last/mid scalars, reads its params row, id and peer, and writes one
    column of each path (or reads and writes the six stats); the first
    launch also reads the external orders.

    This is the traffic of the design, not the floor of the function,
    which is :func:`repro_torch.kernels.kinetic_clearing.byte_count`.
    """
    M, L = num_markets, num_levels
    per_launch = (2 * 2 * M * L * 4                      # bid/ask in, out
                  + 2 * 2 * M * 4                        # last/pmid in, out
                  + M * kc.NUM_PARAM_OPERANDS * 4 + 2 * M * 4  # params, id, peer
                  + (2 * 6 * M * 4 if stats_only else 3 * M * 4))
    return steps * per_launch + (2 * M * L * 4 if ext else 0)


def legacy_byte_count(num_markets: int, num_levels: int, steps: int) -> int:
    """Bytes the legacy per-step kernel moves in ``steps`` launches: books
    and scalars in and out, the one params row, two path columns."""
    M, L = num_markets, num_levels
    per_launch = (2 * 2 * M * L * 4 + 2 * 2 * M * 4
                  + kc.NUM_PARAM_OPERANDS * 4 + 2 * M * 4)
    return steps * per_launch
