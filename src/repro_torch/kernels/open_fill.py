"""The open fill: a session's opening leaves written on the device from its
spec's distinct rows.

A spec holds its markets as blocks of equal rows
(:class:`~repro_torch.core.params.SpecBlocks`). :func:`open_fill` writes the
B rows as one int32 table (:func:`~repro_torch.core.params.block_table`),
crosses them to the device in one copy that does not block
(:func:`~repro_torch.core.device.upload`), and writes, for every market of
its block, what a session opens with:

  * the packed params (``floats`` and ``ints``, ``[M, 11]`` each, in
    ``FLOAT_FIELDS`` and ``INT_FIELDS`` order), as ``pack_params`` packs
    them;
  * the opening books (``bid``, ``ask``, ``[M, L]``), as ``seed_books``
    seeds them, and ``last_price`` and ``prev_mid`` at ``L // 2``;
  * with ``stats_only``, the six accumulators of ``init_stats``.

On a card it is one launch of the CUDA kernel in
``csrc/open_fill.cuh`` (the C entry ``kc_open_fill`` of each kernel
library, loaded when a runner is built); on the CPU it runs the plain
version, :func:`open_fill_plain`. The two give the same bits, and both give
the bits of ``pack_params`` + ``initial_state`` + ``init_stats``. The
packed params' host copy (:func:`~repro_torch.core.params.host_ints`) is
built from the same table only when first read.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import params as params_mod
from repro_torch.core import stats as stats_mod
from repro_torch.core.config import seed_books
from repro_torch.core.device import upload
from repro_torch.core.params import (FILL_QUOTE, FILL_SPREAD, FILL_START,
                                     FLOAT_FIELDS, INT_FIELDS, PackedParams,
                                     SpecBlocks, block_table)
from repro_torch.core.step import MarketState
from repro_torch.kernels import _build

_NF, _NI = len(FLOAT_FIELDS), len(INT_FIELDS)
_NS = len(stats_mod.MarketStats._fields)
_c_ptr, _c_int = ctypes.c_void_p, ctypes.c_int
#: The fill's C entry in each kernel library, and its argument types.
ENTRIES = {"kc_open_fill": [_c_ptr] * 8 + [_c_int] * 3 + [_c_ptr]}
SOURCE = "src/repro_torch/kernels/csrc/open_fill.cuh"

Opened = Tuple[MarketState, PackedParams, Optional[stats_mod.MarketStats]]


def open_fill(blocks: SpecBlocks, num_levels: int, stats_only: bool,
              device: torch.device,
              load_library: Optional[Callable] = None) -> Opened:
    """The opening ``(state, packed params, stats or None)`` of the
    markets of ``blocks`` on ``device``: on a card one copy of their
    table and one launch through ``load_library()``'s ``kc_open_fill``,
    both on the current stream; on the CPU the plain version."""
    M, table = blocks.num_markets, block_table(blocks)
    if device.type == "cpu":
        state, packed, stats = open_fill_plain(
            torch.from_numpy(table), M, num_levels, stats_only)
    else:
        state, packed, stats = _launch(
            load_library(), upload(torch.from_numpy(table), device), M,
            num_levels, stats_only)
        open_fill.launches += 1
    params_mod.with_host_ints(packed, lambda: _host_ints(table, M))
    return state, packed, stats


#: Kernel launches since the count was last reset (CPU calls never count).
open_fill.launches = 0


def _host_ints(table: np.ndarray, num_markets: int) -> np.ndarray:
    """The packed int32 ``[M, 11]`` block of ``table``'s rows, on the
    host: what ``pack_params`` keeps as its host copy."""
    ints = table[:, _NF:_NF + _NI]
    if len(table) == num_markets:      # a row a market
        return np.ascontiguousarray(ints)
    counts = np.diff(np.append(table[:, FILL_START], num_markets))
    return np.repeat(ints, counts, axis=0)


def open_fill_plain(table: torch.Tensor, num_markets: int, num_levels: int,
                    stats_only: bool) -> Opened:
    """The plain PyTorch version on the CPU: the table's rows repeated
    over their blocks, then ``pack_params``'s, ``initial_state``'s and
    ``init_stats``'s own expressions."""
    M, L = num_markets, num_levels
    counts = torch.diff(table[:, FILL_START].long(),
                        append=torch.tensor([M]))
    rows = torch.repeat_interleave(table, counts, dim=0)
    packed = PackedParams(
        floats=rows[:, :_NF].contiguous().view(torch.float32),
        ints=rows[:, _NF:_NF + _NI].contiguous())
    bid, ask = seed_books(L, rows[:, FILL_QUOTE].view(torch.float32),
                          rows[:, FILL_SPREAD], device="cpu")
    m0 = torch.full((M, 1), float(L // 2), dtype=torch.float32)
    state = MarketState(bid=bid, ask=ask, last_price=m0, prev_mid=m0.clone())
    stats = stats_mod.init_stats(M, "cpu") if stats_only else None
    return state, packed, stats


def _launch(lib: ctypes.CDLL, table: torch.Tensor, M: int, L: int,
            stats_only: bool) -> Opened:
    device = table.device

    def empty(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    packed = PackedParams(floats=empty(M, _NF),
                          ints=empty(M, _NI, dtype=torch.int32))
    state = MarketState(bid=empty(M, L), ask=empty(M, L),
                        last_price=empty(M, 1), prev_mid=empty(M, 1))
    stats = empty(M, _NS) if stats_only else None
    ptr = _build.ptr
    with torch.cuda.device(device):
        rc = lib.kc_open_fill(
            ptr(table), ptr(packed.floats), ptr(packed.ints), ptr(state.bid),
            ptr(state.ask), ptr(state.last_price), ptr(state.prev_mid),
            ptr(stats), table.shape[0], M, L,
            torch.cuda.current_stream(device).cuda_stream)
    _build.check_launch(lib, rc, "open_fill")
    return state, packed, None if stats is None else stats_mod.MarketStats(
        *(stats[:, k:k + 1] for k in range(_NS)))
