"""The persistent clearing kernels: wrappers, CUDA launches, plain versions.

:func:`kinetic_clearing_chunk` advances every market up to ``chunk`` steps
from absolute step ``step0``, keeping the books on chip (the CUDA kernel in
``csrc/kinetic_clearing.cu``, launched in the shape ``tile=``, by default
:func:`repro_torch.kernels.autotune.auto_tile`'s). It is the counterpart of
``repro.kernels.kinetic_clearing.kinetic_clearing_chunk`` and takes the same
operands: the books, ``step0``/``n_valid`` (host ints), external orders added
at local step 0, the chunk-frozen coupling column, the per-market params, and
in ``stats_only`` mode the six carried :class:`MarketStats` columns.

:func:`kinetic_clearing` is the legacy one-shot entry, the counterpart of
``repro.kernels.kinetic_clearing.kinetic_clearing``: all ``cfg.num_steps``
steps of a scalar ``MarketConfig`` in one launch, market ids equal to the
rows, arbitrageurs coupled to their own market's previous mid at every step.

On CUDA tensors a wrapper launches its kernel (or raises); on CPU tensors
it runs its plain version (:func:`kinetic_clearing_chunk_plain`,
:func:`kinetic_clearing_plain`), a loop of ``simulate_step`` with the same
gating, external-order injection and stats carry. It never moves work
between devices.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core import params as params_mod
from repro_torch.core import stats as stats_mod
from repro_torch.core.config import (ARBITRAGEUR, FUNDAMENTALIST, HFT,
                                     INFORMED, MAKER, MOMENTUM, NOISE, WHALE,
                                     MarketConfig)
from repro_torch.core.params import (FLOAT_FIELDS, INT_FIELDS, EnsembleSpec,
                                     MarketParams, PackedParams)
from repro_torch.core.step import (MarketState, resolve_peer_mids,
                                   simulate_step)
from repro_torch.kernels import _build, autotune, ref
from repro_torch.launch import roofline

#: Per-market parameter operands (11 float32 + 11 int32 columns).
NUM_PARAM_OPERANDS = len(MarketParams._fields)
#: The source of the CUDA kernels and the TPU kernels they replace.
SOURCE = "src/repro_torch/kernels/csrc/kinetic_clearing.cu"
REPLACES = "src/repro/kernels/kinetic_clearing.py:402"
LEGACY_REPLACES = "src/repro/kernels/kinetic_clearing.py:459"

_LIB_NAME = "kinetic_clearing"
_c_ptr, _c_int, _c_u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
#: C entries of the library and their argument types.
_ENTRIES = {
    "kc_kinetic_clearing_chunk": [_c_ptr] * 19 + [_c_int] * 10 + [_c_u32,
                                                                  _c_ptr],
    "kc_kinetic_clearing": [_c_ptr] * 12 + [_c_int] * 8 + [_c_u32, _c_ptr],
    "kc_occupancy": [_c_int] * 7 + [_c_ptr],
}


def resolve_params(cfg, num_markets: int,
                   params: Union[PackedParams, MarketParams, None],
                   device) -> PackedParams:
    """The params operand: explicit (packed or columns) > the spec's own >
    a broadcast of a scalar ``MarketConfig``."""
    if isinstance(params, PackedParams):
        return params
    if params is None:
        params = (cfg.params if isinstance(cfg, EnsembleSpec)
                  else params_mod.params_from_config(cfg, num_markets))
    return params_mod.pack_params(params, device)


def _load_library() -> ctypes.CDLL:
    return _build.load(_LIB_NAME, _ENTRIES)


def resident_ctas(legacy: bool, shape: autotune.TileChoice) -> int:
    """CTAs of the chunk (or legacy) kernel resident on one SM at
    ``shape`` (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); at a
    cluster shape (``ctas_per_market > 1``), the clusters the card holds at
    once (``cudaOccupancyMaxActiveClusters``; 0: it cannot place one)."""
    out = ctypes.c_int(0)
    _build.check_launch(
        _load_library(), _load_library().kc_occupancy(
            int(legacy), shape.num_agents, shape.num_levels,
            *shape.as_c_args(), ctypes.byref(out)), "kc_occupancy")
    return out.value


def _expect(t, name: str, shape, dtype, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def check_chunk_operands(
        what: str, bid, ask, last, pmid, step0, n_valid, ext_buy, ext_ask, *,
        cfg, chunk, scan, market_ids, params, peer_mid, stats, stats_only):
    """Check a chunk call's operands and resolve its defaults; returns
    ``(step0, n_valid, chunk, market_ids, params, peer_mid)``."""
    device = bid.device
    M, L = bid.shape
    if M == 0:
        raise ValueError(f"{what} needs at least one market")
    if L < 4 or L > 1024 or L & (L - 1):
        raise ValueError(f"num_levels must be a power of two in [4, 1024], "
                         f"got {L}")
    if L != cfg.num_levels:
        raise ValueError(f"books have {L} levels but cfg.num_levels is "
                         f"{cfg.num_levels}")
    step0, n_valid, chunk = int(step0), int(n_valid), int(chunk)
    if step0 < 0 or not 0 <= n_valid <= chunk:
        raise ValueError(f"need step0 >= 0 and 0 <= n_valid <= chunk; got "
                         f"step0={step0}, n_valid={n_valid}, chunk={chunk}")
    if scan not in ("cumsum", "hillis-steele"):
        raise ValueError(f"unknown scan {scan!r}")
    f32 = torch.float32
    for name, t, shape in (("bid", bid, (M, L)), ("ask", ask, (M, L)),
                           ("last", last, (M, 1)), ("pmid", pmid, (M, 1))):
        _expect(t, name, shape, f32, device)
    for name, t in (("ext_buy", ext_buy), ("ext_ask", ext_ask)):
        if t is not None:
            _expect(t, name, (M, L), f32, device)
    if market_ids is None:
        market_ids = torch.arange(M, dtype=torch.int32, device=device)
    market_ids = market_ids.reshape(M, 1)
    _expect(market_ids, "market_ids", (M, 1), torch.int32, device)
    params = resolve_params(cfg, M, params, device)
    _expect(params.floats, "params.floats", (M, len(FLOAT_FIELDS)), f32, device)
    _expect(params.ints, "params.ints", (M, len(INT_FIELDS)), torch.int32,
            device)
    if peer_mid is None:
        peer_mid = resolve_peer_mids(pmid, params.ints[:, INT_FIELDS.index(
            "coupling_peer")])
    _expect(peer_mid, "peer_mid", (M, 1), f32, device)
    if stats_only:
        if stats is None:
            raise ValueError("stats_only=True requires the carried `stats` "
                             "accumulators (see repro_torch.core.stats)")
        for name, t in zip(stats_mod.MarketStats._fields, stats):
            _expect(t, f"stats.{name}", (M, 1), f32, device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return step0, n_valid, chunk, market_ids, params, peer_mid


def kinetic_clearing_chunk(
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
    """Advance ``n_valid <= chunk`` steps from absolute step ``step0``.

    ``cfg`` (an ``EnsembleSpec`` or ``MarketConfig``) supplies A, L and the
    seed. ``market_ids`` (int32[M] or [M, 1], default ``arange(M)``) are the
    rows' global ids. ``peer_mid`` defaults to the gather of the entry
    ``pmid`` at ``coupling_peer``. ``scan`` selects the plain version's scan
    (the kernel always runs its raking scan; all give the same bits for
    exact-integer books). The launch shape is ``tile`` (a
    :class:`~repro_torch.kernels.autotune.TileChoice` for the operands' L
    and A, checked here on every device), or ``autotune.auto_tile(L, A,
    M)`` when None (a market cluster past the registers mode where the
    markets alone leave SMs idle); the plain version ignores it, as every
    shape gives the same bits.

    Returns ``(bid, ask, last, pmid, price_path, volume_path, mid_path)``
    with ``[M, chunk]`` paths of which the first ``n_valid`` columns are
    written, or ``(bid, ask, last, pmid, MarketStats)`` with ``stats_only``.
    """
    with roofline.uncounted():    # the operands' defaults join the call
        step0, n_valid, chunk, market_ids, params, peer_mid = \
            check_chunk_operands(
                "kinetic_clearing_chunk", bid, ask, last, pmid, step0,
                n_valid, ext_buy, ext_ask, cfg=cfg, chunk=chunk, scan=scan,
                market_ids=market_ids, params=params, peer_mid=peer_mid,
                stats=stats, stats_only=stats_only)
    shape = autotune.resolve_tile(tile, bid.shape[1], cfg.num_agents,
                                  hoisted=True, num_markets=bid.shape[0])
    args = (bid, ask, last, pmid, step0, n_valid, ext_buy, ext_ask)
    kw = dict(cfg=cfg, chunk=chunk, scan=scan, market_ids=market_ids,
              params=params, peer_mid=peer_mid, stats=stats,
              stats_only=stats_only)
    M, L = bid.shape
    # The paths are charged n_valid columns: later ones are never written.
    with roofline.kernel_call("kinetic_clearing_chunk", bid.device, lambda: (
            op_count(M, cfg.num_agents, L, n_valid,
                     packed_mix(params, cfg.num_agents)),
            byte_count(M, L, n_valid, ext=ext_buy is not None,
                       stats_only=stats_only), 1)):
        if bid.device.type == "cpu":
            return kinetic_clearing_chunk_plain(*args, **kw)
        out = _launch(*args, shape=shape, **kw)
        kinetic_clearing_chunk.launches += 1
    return out


#: Kernel launches since the count was last reset (CPU calls never count;
#: a CUDA graph's capture counts nothing, each replay its launches:
#: :mod:`repro_torch.core.graphs`).
kinetic_clearing_chunk.launches = 0


def _launch(bid, ask, last, pmid, step0, n_valid, ext_buy, ext_ask, *, cfg,
            chunk, scan, market_ids, params, peer_mid, stats, stats_only,
            shape):
    del scan  # the kernel's raking scan serves both modes (same bits)
    lib = _load_library()
    M, L = bid.shape
    c = [t.contiguous() for t in (bid, ask, last, pmid, market_ids, peer_mid)]
    bid, ask, last, pmid, market_ids, peer_mid = c
    ext_buy = None if ext_buy is None else ext_buy.contiguous()
    ext_ask = None if ext_ask is None else ext_ask.contiguous()
    floats, ints = params.floats.contiguous(), params.ints.contiguous()
    out_bid, out_ask = torch.empty_like(bid), torch.empty_like(ask)
    out_last, out_pmid = torch.empty_like(last), torch.empty_like(pmid)
    if stats_only:
        stats_in = torch.cat(list(stats), dim=1).contiguous()
        stats_out = torch.empty_like(stats_in)
        paths = (None, None, None)
    else:
        stats_in = stats_out = None
        paths = tuple(torch.empty((M, chunk), dtype=torch.float32,
                                  device=bid.device) for _ in range(3))

    ptr = _build.ptr
    # The <<<>>> launch goes to the current device: make it the tensors'.
    with torch.cuda.device(bid.device):
        rc = lib.kc_kinetic_clearing_chunk(
            ptr(market_ids), ptr(bid), ptr(ask), ptr(last), ptr(pmid),
            ptr(ext_buy), ptr(ext_ask), ptr(peer_mid), ptr(floats), ptr(ints),
            ptr(stats_in), ptr(out_bid), ptr(out_ask), ptr(out_last),
            ptr(out_pmid), *(ptr(p) for p in paths), ptr(stats_out), M,
            cfg.num_agents, L, chunk, step0, n_valid, *shape.as_c_args(),
            int(cfg.seed) & 0xFFFFFFFF,
            torch.cuda.current_stream(bid.device).cuda_stream)
    _build.check_launch(lib, rc, "kinetic_clearing_chunk")
    state = (out_bid, out_ask, out_last, out_pmid)
    if stats_only:
        return state + (stats_mod.MarketStats(
            *(stats_out[:, k:k + 1] for k in range(6))),)
    return state + paths


def kinetic_clearing_chunk_plain(
        bid, ask, last, pmid, step0: int, n_valid: int, ext_buy=None,
        ext_ask=None, *, cfg, chunk: int, scan: str = "cumsum",
        market_ids=None, params=None, peer_mid=None, stats=None,
        stats_only: bool = False, tile=None) -> Tuple:
    """The plain PyTorch version: ``n_valid`` steps of ``simulate_step`` with
    the kernel's gating, external orders at local step 0 and stats carry
    (``tile`` is accepted and ignored: every launch shape gives these
    bits)."""
    M = bid.shape[0]
    device = bid.device
    if market_ids is None:
        market_ids = torch.arange(M, dtype=torch.int32, device=device)
    market_ids = market_ids.reshape(M, 1)
    cols = resolve_params(cfg, M, params, device).columns()
    if peer_mid is None:
        peer_mid = resolve_peer_mids(pmid, cols.coupling_peer)
    atype = params_mod.agent_types(cols, cfg.num_agents, device)
    state = MarketState(bid, ask, last, pmid)
    paths = [torch.zeros((M, chunk), dtype=torch.float32, device=device)
             for _ in range(3)]
    for s in range(n_valid):
        first = s == 0
        state, out = simulate_step(
            cfg, state, step0 + s, market_ids, scan=scan,
            ext_buy=ext_buy if first else None,
            ext_ask=ext_ask if first else None,
            params=cols, atype=atype, peer_mid=peer_mid)
        if stats_only:
            stats = stats_mod.accumulate(stats, out.mid, out.volume)
        else:
            for path, col in zip(paths, out):
                path[:, s] = col[:, 0]
    if stats_only:
        return tuple(state) + (stats_mod.MarketStats(*stats),)
    return tuple(state) + tuple(paths)


def check_legacy_operands(what: str, bid, ask, last, pmid, *, cfg,
                          scan) -> None:
    """Check a legacy one-shot call's operands."""
    if not isinstance(cfg, MarketConfig):
        raise TypeError(f"{what} takes a scalar MarketConfig, got "
                        f"{type(cfg).__name__} (sessions take EnsembleSpecs)")
    if bid.dim() != 2 or bid.shape[0] == 0:
        raise ValueError(f"{what} needs bid of shape [M >= 1, L], got "
                         f"{tuple(bid.shape)}")
    M, L = bid.shape
    if L != cfg.num_levels:
        raise ValueError(f"books have {L} levels but cfg.num_levels is "
                         f"{cfg.num_levels}")
    if scan not in ("cumsum", "hillis-steele"):
        raise ValueError(f"unknown scan {scan!r}")
    for name, t, shape in (("bid", bid, (M, L)), ("ask", ask, (M, L)),
                           ("last", last, (M, 1)), ("pmid", pmid, (M, 1))):
        _expect(t, name, shape, torch.float32, bid.device)
    if bid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {bid.device}")


@functools.lru_cache(maxsize=32)
def legacy_params(cfg: MarketConfig, device: torch.device) -> PackedParams:
    """The legacy entries' params operand: the one packed row of
    ``params_from_config(cfg, 1)``, which every team reads (the values of
    ``scalar_params(cfg)``, which the plain version broadcasts).

    Cached per config and device: packing copies a host row to the card,
    and a copy from pageable memory waits for the stream, which would stall
    every call behind the previous kernel."""
    return params_mod.pack_params(params_mod.params_from_config(cfg, 1),
                                  device)


def kinetic_clearing(bid: torch.Tensor, ask: torch.Tensor,
                     last: torch.Tensor, pmid: torch.Tensor, *,
                     cfg: MarketConfig, scan: str = "cumsum",
                     tile: Optional[autotune.TileChoice] = None) -> Tuple:
    """Run all ``cfg.num_steps`` steps of a scalar ``MarketConfig`` in one
    persistent launch (the legacy one-shot entry).

    Market ids are the rows, and arbitrageurs see their own market's
    previous mid at every step. ``tile`` (the counterpart of ``mb``) is the
    launch shape, default ``autotune.auto_tile(L, A, M)``; a ragged last
    CTA is masked, so the TPU entry's rule that the tile divide M does not
    apply. Returns ``(bid, ask, last, pmid, price_path, volume_path)`` with
    ``[M, S]`` paths.
    """
    check_legacy_operands("kinetic_clearing", bid, ask, last, pmid, cfg=cfg,
                          scan=scan)
    shape = autotune.resolve_tile(tile, bid.shape[1], cfg.num_agents,
                                  hoisted=True, num_markets=bid.shape[0])
    M, L = bid.shape
    with roofline.kernel_call("kinetic_clearing", bid.device, lambda: (
            legacy_op_count(cfg, M),
            legacy_byte_count(M, L, cfg.num_steps), 1)):
        if bid.device.type == "cpu":
            return kinetic_clearing_plain(bid, ask, last, pmid, cfg=cfg,
                                          scan=scan)
        out = _launch_legacy(bid, ask, last, pmid, cfg, shape)
        kinetic_clearing.launches += 1
    return out


#: Kernel launches since the count was last reset (CPU calls never count).
kinetic_clearing.launches = 0


def _launch_legacy(bid, ask, last, pmid, cfg, shape):
    lib = _load_library()
    M, L = bid.shape
    S = cfg.num_steps
    state = [t.contiguous() for t in (bid, ask, last, pmid)]
    params = legacy_params(cfg, bid.device)
    out = [torch.empty_like(t) for t in state]
    paths = [torch.empty((M, S), dtype=torch.float32, device=bid.device)
             for _ in range(2)]
    with torch.cuda.device(bid.device):
        rc = lib.kc_kinetic_clearing(
            *map(_build.ptr, state + [params.floats, params.ints] + out
                 + paths), M, cfg.num_agents, L, S, *shape.as_c_args(),
            int(cfg.seed) & 0xFFFFFFFF,
            torch.cuda.current_stream(bid.device).cuda_stream)
    _build.check_launch(lib, rc, "kinetic_clearing")
    return tuple(out + paths)


def kinetic_clearing_plain(bid, ask, last, pmid, *, cfg: MarketConfig,
                           scan: str = "cumsum", tile=None) -> Tuple:
    """The plain PyTorch version: the oracle's loop
    (:func:`repro_torch.kernels.ref.run_reference`) from the given books
    (``tile`` is accepted and ignored)."""
    state, prices, volumes = ref.run_reference(
        cfg, MarketState(bid, ask, last, pmid), scan)
    return tuple(state) + (prices, volumes)


#: Issue-slot weight of each instruction class on compute capability 9.0:
#: 128 over the class's results per SM per clock in the arithmetic
#: instruction throughput table of the CUDA C++ Programming Guide (FP32 add
#: and multiply 128; 32-bit integer add, shift, logic, compare and multiply
#: 64; type conversions 16; warp shuffles 32).
PIPE_WEIGHTS = {"fp32": 1, "int32": 2, "conversion": 8, "shuffle": 4}


class OpMix(NamedTuple):
    """Instructions of a unit of work, by class (see ``PIPE_WEIGHTS``)."""

    fp32: int = 0
    int32: int = 0
    conversion: int = 0
    shuffle: int = 0

    @property
    def slots(self) -> int:
        """FP32-lane issue slots: each class weighted by its rate."""
        return sum(n * PIPE_WEIGHTS[k] for k, n in zip(self._fields, self))


# The counts below are read from the reference's definition of one step
# (repro/core/rng.py:47-75 kinetic_hash32/uniform32, agents.py decide,
# step.py binning, auction.py best_quotes/clear), whatever implements it.
#: One agent at one step, besides its hash channels. Integer: the step
#: round (the add and lowbias32's 3 shifts, 3 xors, 2 multiplies: 9), the
#: archetype's side and price selects (3), the marketable and panic
#: overlays' selects (2), the whale cadence select, the bin address and the
#: bin add (3). FP32: the coin, the jitter (2), the archetype's price (2)
#: and side test, the marketable and panic compares (2), the clip (2), the
#: quantity's multiply and add (2). Conversions: the round, the floor, the
#: float→int cast.
AGENT_STEP = OpMix(fp32=12, int32=17, conversion=3)
#: One uniform draw: the channel round (add, lowbias32, the >> 8: 10
#: integer), the uint→float conversion and the 2^-24 scaling.
CHANNEL = OpMix(fp32=1, int32=10, conversion=1)
#: Channels each archetype's decision reads (agents.py): noise side, price,
#: marketable, quantity; momentum marketable, quantity; HFT its side coin
#: (read whenever |imbalance| <= hft_threshold, the usual case, so always
#: counted), marketable, quantity; a maker its quantity; a fundamentalist
#: and an arbitrageur price, marketable, quantity; a whale its side (its
#: price is already an edge, its quantity whale_size); an informed agent,
#: outside its pre-shock window, all four of a noise agent. Not counted: the
#: coin a momentum, fundamentalist or arbitrageur agent reads only at a zero
#: signal (an unmoved mid, the mid at the fundamental, the peer's mid at the
#: own), and the panic draw read only at the shock step; with those
#: archetypes in the mix the count is below the work.
CHANNELS_READ = {NOISE: 4, MOMENTUM: 2, MAKER: 1, FUNDAMENTALIST: 3, WHALE: 1,
                 HFT: 3, INFORMED: 4, ARBITRAGEUR: 3}
#: One agent once per call: the step-invariant (seed, gid) round (the
#: global id's multiply and add, the key's multiply and add, lowbias32: 12)
#: and the type from the seven block bounds (7 compares, 7 selects).
AGENT_CALL = OpMix(int32=26)
#: One level at one step: the best-quote tests and book sums (4 FP32, 4
#: integer selects and max/min), the totals (2), one add for each of the two
#: scans (2), the match's min and the argmax compare (2) and select (1
#: integer), the allocation (two sides of subtract, subtract, max, min) and
#: the residual books (10). The shock (one step of a call) is left out.
LEVEL_STEP = OpMix(fp32=20, int32=5)
#: One market at one step: the mid (an int→float conversion, an add, a
#: multiply), the imbalance (a subtract, an add and an IEEE division: a
#: reciprocal at the conversion rate and about eight FP32 refinement and
#: fix-up steps) and the step's three selects.
MARKET_STEP = OpMix(fp32=11, int32=3, conversion=2)


def agent_mix(params: MarketParams, num_agents: int) -> Dict[int, int]:
    """Agents of each archetype summed over the markets of ``params``
    (host columns of ``[M, 1]``)."""
    counts = {t: int(np.asarray(getattr(params, f)).sum())
              for t, f in ((MAKER, "num_makers"), (MOMENTUM, "num_momentum"),
                           (FUNDAMENTALIST, "num_fundamentalists"),
                           (WHALE, "num_whales"), (HFT, "num_hft"),
                           (INFORMED, "num_informed"),
                           (ARBITRAGEUR, "num_arbitrageurs"))}
    M = int(np.asarray(params.num_makers).shape[0])
    counts[NOISE] = M * num_agents - sum(counts.values())
    return counts


def packed_mix(params: PackedParams, num_agents: int) -> Dict[int, int]:
    """:func:`agent_mix` of the rows of packed params, from their host copy
    (``params.host_ints``): no device read."""
    ints = params_mod.host_ints(params)
    return agent_mix(MarketParams(**{
        f: ints[:, INT_FIELDS.index(f)] if f in INT_FIELDS else None
        for f in MarketParams._fields}), num_agents)


def op_count(num_markets: int, num_agents: int, num_levels: int, steps: int,
             mix: Mapping[int, int]) -> int:
    """FP32-lane issue slots of one call that runs ``steps`` steps: the
    function's instructions by class (``AGENT_STEP`` and the ``CHANNEL``
    draws its archetype reads per agent-step, ``LEVEL_STEP`` and
    ``MARKET_STEP`` per step, ``AGENT_CALL`` once), each weighted by its
    rate (``PIPE_WEIGHTS``). ``mix`` (:func:`agent_mix`) gives the agents of
    each archetype over all markets."""
    if sum(mix.values()) != num_markets * num_agents:
        raise ValueError("mix must count num_markets * num_agents agents")
    agent_steps = sum(n * (AGENT_STEP.slots + CHANNELS_READ[t] * CHANNEL.slots)
                      for t, n in mix.items())
    per_step = (agent_steps + num_markets * (
        num_levels * LEVEL_STEP.slots + MARKET_STEP.slots))
    return steps * per_step + num_markets * num_agents * AGENT_CALL.slots


def byte_count(num_markets: int, num_levels: int, chunk: int, *,
               ext: bool, stats_only: bool) -> int:
    """Bytes a call must move: each input read once, each output written
    once (books, scalars, params, ids, peer column, paths or stats)."""
    M, L = num_markets, num_levels
    books = 2 * 2 * M * L * 4                    # bid/ask in and out
    scalars = 2 * 2 * M * 4 + 2 * M * 4          # last/pmid; ids, peer
    ext_b = 2 * M * L * 4 if ext else 0
    out = 2 * 6 * M * 4 if stats_only else 3 * M * chunk * 4
    params = M * NUM_PARAM_OPERANDS * 4
    return books + scalars + ext_b + params + out


def legacy_op_count(cfg: MarketConfig, num_markets: int) -> int:
    """:func:`op_count` of one legacy call: ``cfg.num_steps`` steps of
    ``num_markets`` markets of one scalar config."""
    return op_count(num_markets, cfg.num_agents, cfg.num_levels,
                    cfg.num_steps, agent_mix(params_mod.params_from_config(
                        cfg, num_markets), cfg.num_agents))


def legacy_byte_count(num_markets: int, num_levels: int, steps: int) -> int:
    """Bytes a legacy one-shot call must move: books and scalars in and
    out, the one params row, and the two ``[M, S]`` paths."""
    M, L = num_markets, num_levels
    return (2 * 2 * M * L * 4 + 2 * 2 * M * 4 + NUM_PARAM_OPERANDS * 4
            + 2 * M * steps * 4)
