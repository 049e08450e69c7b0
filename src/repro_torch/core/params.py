"""Per-market scenario parameters and the ensemble front door (PyTorch port).

  * :class:`MarketParams` — 22 per-market ``[M, 1]`` columns, one per
    scenario-varying :class:`~repro_torch.core.config.MarketConfig` field
    (11 float32, 11 int32). An :class:`EnsembleSpec` holds them as host numpy
    arrays; the plain step code reads them as torch columns.
  * :class:`PackedParams` — the device form a session keeps: one contiguous
    f32 ``[M, 11]`` and one int32 ``[M, 11]`` tensor, packed once per session
    in the column order :data:`FLOAT_FIELDS` / :data:`INT_FIELDS`, which the
    CUDA kernel shares (see ``kernels/csrc/kinetic_clearing.cu``).
  * :class:`EnsembleSpec` — the builder API: ``homogeneous(cfg)``,
    ``from_scenarios([...])``, ``product``, ``concatenate``,
    ``with_values``, and the serving gateway's row splices
    ``replace_markets`` and ``parked``. A spec holds its markets as
    :class:`SpecBlocks`, blocks of equal rows (one a config), and builds
    its per-market ``[M, 1]`` views on first read;
    :func:`block_table` packs the B rows for the open fill.

Markets are row-independent and the RNG is a pure function of (seed, global
market id, step, channel), so market ``m`` of a heterogeneous ensemble
equals market ``m`` of the homogeneous ensemble of its scenario.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import (Any, Callable, Dict, Iterable, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.core.config import (
    MarketConfig,
    assign_agent_types,
    scenario_config,
    seed_books,
)
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device
from repro_torch.core.result import to_host


class MarketParams(NamedTuple):
    """Scenario-varying parameters, one ``[M, 1]`` column per market."""

    shock_step: Any           # int32 flash-crash step (< 0 → disabled)
    shock_intensity: Any      # f32 P(agent panic-sells at the shock)
    shock_cancel: Any         # f32 fraction of resting bids withdrawn
    p_marketable: Any         # f32 P(order is marketable)
    q_max: Any                # f32 max order quantity (integer-valued)
    noise_delta: Any          # f32 noise-trader price offset half-width
    maker_half_spread: Any    # f32 maker quote half-spread
    fundamental: Any          # f32 resolved fundamentalist target
    fundamentalist_kappa: Any # f32 mean-reversion strength
    num_makers: Any           # int32 leading agents assigned MAKER
    num_momentum: Any         # int32 next block assigned MOMENTUM
    num_fundamentalists: Any  # int32 next block assigned FUNDAMENTALIST
    num_whales: Any           # int32 next block assigned WHALE
    num_hft: Any              # int32 next block assigned HFT
    num_informed: Any         # int32 next block assigned INFORMED
    num_arbitrageurs: Any     # int32 next block assigned ARBITRAGEUR
    whale_size: Any           # f32 lots per whale sweep (integer-valued)
    whale_period: Any         # int32 steps between whale sweeps (>= 1)
    hft_threshold: Any        # f32 |book imbalance| HFT trigger
    informed_horizon: Any     # int32 steps of early shock knowledge
    arb_kappa: Any            # f32 arbitrageur gap-chasing strength
    coupling_peer: Any        # int32 peer market feeding arbs (<0: self)

    @staticmethod
    def field_dtype(field: str):
        return np.int32 if field in INT_FIELDS else np.float32

    def to_numpy(self) -> "MarketParams":
        return MarketParams(*(to_host(x) for x in self))

    def asarray(self, device=DEFAULT_DEVICE) -> "MarketParams":
        """Dtype-preserving placement of every column on ``device``: the
        one copy of the per-field dtype coercion, which the packing, the
        scalar columns and the kernels' spec fallback share."""
        device = resolve_device(device)
        return MarketParams(*(
            torch.from_numpy(np.array(to_host(leaf),
                                      dtype=MarketParams.field_dtype(f)))
            .to(device) for f, leaf in zip(MarketParams._fields, self)))

    @classmethod
    def zeros(cls, num_markets: int, device=DEFAULT_DEVICE) -> "MarketParams":
        """Valid all-zero ``[M, 1]`` torch columns on ``device`` (timing
        and padding operands)."""
        device = resolve_device(device)
        return cls(*(torch.zeros((num_markets, 1), device=device,
                                 dtype=torch.int32 if f in INT_FIELDS
                                 else torch.float32)
                     for f in cls._fields))

    @property
    def num_markets(self) -> int:
        return int(np.shape(self.shock_step)[0])


#: Column order of the packed int32 ``[M, 11]`` operand (shared with the
#: CUDA source, which checks it at load time).
INT_FIELDS = ("shock_step", "num_makers", "num_momentum",
              "num_fundamentalists", "num_whales", "num_hft",
              "num_informed", "num_arbitrageurs", "whale_period",
              "informed_horizon", "coupling_peer")
#: Column order of the packed float32 ``[M, 11]`` operand.
FLOAT_FIELDS = tuple(f for f in MarketParams._fields if f not in INT_FIELDS)

#: The value each leaf takes when its archetype is absent (the fill for
#: payloads that predate a field). ``fundamental`` is shape-dependent.
INERT_PARAM_VALUES: Dict[str, float] = {
    "shock_step": -1, "shock_intensity": 0.0, "shock_cancel": 0.0,
    "p_marketable": 0.0, "q_max": 1.0, "noise_delta": 0.0,
    "maker_half_spread": 0.0, "fundamentalist_kappa": 0.0,
    "num_makers": 0, "num_momentum": 0, "num_fundamentalists": 0,
    "num_whales": 0, "num_hft": 0, "num_informed": 0,
    "num_arbitrageurs": 0, "whale_size": 1.0, "whale_period": 1,
    "hft_threshold": 0.0, "informed_horizon": 0, "arb_kappa": 0.0,
    "coupling_peer": -1,
}


class PackedParams(NamedTuple):
    """Device-resident params: f32 ``[M, 11]`` + int32 ``[M, 11]``."""

    floats: torch.Tensor  # columns in FLOAT_FIELDS order
    ints: torch.Tensor    # columns in INT_FIELDS order

    def columns(self) -> MarketParams:
        """``[M, 1]`` views of every column, as :class:`MarketParams`."""
        cols = {f: self.floats[:, k:k + 1] for k, f in enumerate(FLOAT_FIELDS)}
        cols.update({f: self.ints[:, k:k + 1] for k, f in enumerate(INT_FIELDS)})
        return MarketParams(**cols)

    def to_numpy(self) -> MarketParams:
        return self.columns().to_numpy()


def pack_params(params: MarketParams, device) -> PackedParams:
    """Pack host or device columns into the two contiguous device tensors
    (the int32 block keeps its host copy: :func:`host_ints`)."""
    host = params.asarray("cpu")

    def stack(fields):
        return torch.stack([getattr(host, f).reshape(-1) for f in fields],
                           dim=1).contiguous()

    ints = stack(INT_FIELDS)
    return with_host_ints(PackedParams(
        floats=stack(FLOAT_FIELDS).to(device),
        ints=ints.to(device)), ints.numpy().copy())


#: The host copy of each packed int32 block, by the tensor it was packed
#: into (weakly: an entry lives as long as its tensor, so a copy must not
#: share the tensor's memory, which would keep it alive).
_HOST_INTS = WeakIdKeyDictionary()


def with_host_ints(packed: PackedParams,
                   host: Union[np.ndarray, Callable[[], np.ndarray]],
                   ) -> PackedParams:
    """Record ``host`` (int32 ``[M, 11]``, or a function that builds it
    when :func:`host_ints` first reads it) as the host copy of
    ``packed.ints``; returns ``packed``."""
    _HOST_INTS[packed.ints] = host
    return packed


def carry_host_ints(src: torch.Tensor, dst: torch.Tensor) -> None:
    """Record the host copy of ``src`` (if it has one) as ``dst``'s: ``dst``
    is a copy of a packed int32 block, as a CUDA graph's static input and a
    replay's returned clone are."""
    host = _HOST_INTS.get(src)
    if host is not None:
        _HOST_INTS[dst] = host


def host_ints(packed: PackedParams) -> np.ndarray:
    """The host copy of ``packed.ints`` (int32 ``[M, 11]``, columns in
    :data:`INT_FIELDS` order), read without touching the device: the
    archetype counts of the rows a kernel call ran. Raises ``LookupError``
    for a block that :func:`pack_params` (or :func:`with_host_ints`) did
    not make."""
    try:
        host = _HOST_INTS[packed.ints]
    except KeyError:
        raise LookupError(
            "these packed params have no host copy: make them with "
            "pack_params (or record one with with_host_ints)") from None
    if callable(host):
        host = _HOST_INTS[packed.ints] = host()
    return host


def coupled_count(peer, first: int = 0) -> int:
    """Markets with a real peer: rows ``first, first + 1, ...`` whose
    ``coupling_peer`` (``peer``, host values) is neither ``< 0`` nor the
    row's own index."""
    peer = np.asarray(peer).reshape(-1)
    own = np.arange(first, first + peer.size)
    return int(np.count_nonzero((peer >= 0) & (peer != own)))


def replace_rows(params: MarketParams, slots, rows: MarketParams,
                 ) -> MarketParams:
    """Host row splice: ``params`` with markets ``slots`` replaced by the
    rows of ``rows`` (a ``len(slots)``-market params). Shapes and dtypes are
    unchanged, so every runner keyed on the shape is reused, and every other
    row is carried over untouched."""
    idx = np.asarray(slots, dtype=np.int64).reshape(-1)
    M = params.num_markets
    if idx.size != rows.num_markets:
        raise ValueError(
            f"replace_rows got {idx.size} slots but {rows.num_markets} "
            "replacement rows")
    if idx.size != np.unique(idx).size:
        raise ValueError(f"slots must be unique, got {idx.tolist()}")
    if ((idx < 0) | (idx >= M)).any():
        raise ValueError(f"slots {idx.tolist()} out of range [0, {M})")
    out = []
    for f, leaf, src in zip(MarketParams._fields, params, rows):
        leaf = np.array(to_host(leaf), dtype=MarketParams.field_dtype(f))
        leaf[idx] = np.asarray(to_host(src), dtype=leaf.dtype)
        out.append(leaf)
    return MarketParams(*out)


def params_from_dict(values: Dict[str, Any], num_markets: int,
                     num_levels: int) -> MarketParams:
    """Host params from a ``{field: array}`` mapping, inert-filling fields
    the payload lacks."""
    M = int(num_markets)
    leaves = []
    for f in MarketParams._fields:
        dt = MarketParams.field_dtype(f)
        if f in values:
            leaves.append(np.asarray(to_host(values[f]),
                                     dtype=dt).reshape(M, 1))
        else:
            fill = (float(num_levels // 2) if f == "fundamental"
                    else INERT_PARAM_VALUES[f])
            leaves.append(np.full((M, 1), fill, dt))
    return MarketParams(*leaves)


def _config_values(cfg: MarketConfig) -> Dict[str, float]:
    vals = {f: getattr(cfg, f) for f in MarketParams._fields
            if f not in ("coupling_peer",)}
    # A plain config always self-couples.
    vals["coupling_peer"] = -1
    return vals


def params_from_config(cfg: MarketConfig, num_markets: int = None,
                       ) -> MarketParams:
    """Homogeneous host params: broadcast one config over M rows."""
    M = cfg.num_markets if num_markets is None else int(num_markets)
    vals = _config_values(cfg)
    return MarketParams(**{
        f: np.full((M, 1), vals[f], dtype=MarketParams.field_dtype(f))
        for f in MarketParams._fields})


def scalar_params(cfg: MarketConfig, device=DEFAULT_DEVICE) -> MarketParams:
    """Broadcastable ``[1, 1]`` torch columns for scalar-config callers."""
    return params_from_config(cfg, num_markets=1).asarray(device)


def agent_types(params: MarketParams, num_agents: int,
                device=DEFAULT_DEVICE):
    """Per-market strategy-class lattice: int32 broadcastable to [M, A]."""
    return assign_agent_types(num_agents, params.num_makers,
                              params.num_momentum, params.num_fundamentalists,
                              params.num_whales, params.num_hft,
                              params.num_informed, params.num_arbitrageurs,
                              device=device)


#: Fields every block of a heterogeneous ensemble must agree on.
_STATIC_FIELDS = ("num_agents", "num_levels", "num_steps", "seed")

#: Columns of a spec's block table (:func:`block_table`, int32
#: ``[B, FILL_COLS]``): the float params' bits in :data:`FLOAT_FIELDS`
#: order, the int params in :data:`INT_FIELDS` order, then the opening
#: book's depth (its float32 bits) and spread, and the block's first
#: market. ``kernels/csrc/open_fill.cuh`` reads this layout.
FILL_QUOTE = len(FLOAT_FIELDS) + len(INT_FIELDS)
FILL_SPREAD = FILL_QUOTE + 1
FILL_START = FILL_QUOTE + 2
FILL_COLS = FILL_QUOTE + 3


def _runs(labels) -> Tuple[Tuple[str, int], ...]:
    """``labels`` as ``(label, count)`` runs."""
    return tuple((k, len(list(g))) for k, g in itertools.groupby(labels))


class SpecBlocks(NamedTuple):
    """An ensemble's markets as blocks of equal rows: block ``b`` holds
    markets ``starts[b]`` up to the next block's first market (the last one
    up to ``num_markets``), each market with row ``b`` of every leaf. A
    spec built from configs holds a block a config; a per-market value
    makes every market a block of its own, its leaves as given."""

    starts: np.ndarray                       # int64[B] first market
    params: MarketParams                     # host [B, 1] leaves
    initial_quote_qty: Any                   # f32[B] opening book depth
    initial_spread: Any                      # int32[B] opening spread
    scenarios: Tuple[Tuple[str, int], ...]   # (label, markets) runs
    num_markets: int                         # the markets covered

    @property
    def counts(self) -> np.ndarray:
        """Markets a block (int64[B])."""
        return np.diff(np.append(self.starts, self.num_markets))

    def expand(self, leaf):
        """A ``[B, ...]`` leaf as its ``[M, ...]`` market rows: the leaf
        itself where every block is one market."""
        if len(self.starts) == self.num_markets:
            return leaf
        return np.repeat(np.asarray(leaf), self.counts, axis=0)

    def markets(self, bad) -> list:
        """The first eight markets of the blocks ``bad`` (bool[B]) marks."""
        ends = np.append(self.starts[1:], self.num_markets)
        out: list = []
        for b in np.flatnonzero(bad):
            lo = int(self.starts[b])
            out.extend(range(lo, min(int(ends[b]), lo + 8 - len(out))))
            if len(out) == 8:
                break
        return out

    def market_view(self, name: str):
        """The per-market form of ``params``, ``initial_quote_qty``,
        ``initial_spread`` or ``scenarios`` (a tuple of labels)."""
        if name == "params":
            return MarketParams(*map(self.expand, self.params))
        if name == "scenarios":
            return tuple(itertools.chain.from_iterable(
                itertools.repeat(k, n) for k, n in self.scenarios))
        return self.expand(getattr(self, name))


def block_table(blocks: SpecBlocks) -> np.ndarray:
    """The B distinct rows of ``blocks`` as one int32 ``[B, FILL_COLS]``
    table (:data:`FILL_COLS`), each
    column coerced as :func:`pack_params` and
    :func:`~repro_torch.core.config.seed_books` coerce it: what a session
    opened on one device uploads for the open fill
    (:mod:`repro_torch.kernels.open_fill`) to write the M rows there."""
    B = len(blocks.starts)
    table = np.empty((B, FILL_COLS), np.int32)
    bits = table.view(np.float32)
    for k, f in enumerate(FLOAT_FIELDS):
        bits[:, k] = np.asarray(to_host(getattr(blocks.params, f)),
                                np.float32).reshape(B)
    for k, f in enumerate(INT_FIELDS, start=len(FLOAT_FIELDS)):
        table[:, k] = np.asarray(to_host(getattr(blocks.params, f)),
                                 np.int32).reshape(B)
    bits[:, FILL_QUOTE] = np.asarray(blocks.initial_quote_qty, np.float32)
    table[:, FILL_SPREAD] = np.asarray(blocks.initial_spread, np.int32)
    table[:, FILL_START] = blocks.starts
    return table


@dataclasses.dataclass(frozen=True, eq=False, init=False)
class EnsembleSpec:
    """A heterogeneous market ensemble: static shape + per-market params.

    The per-market values are held as :class:`SpecBlocks`, blocks of equal
    rows; ``params`` (host numpy ``[M, 1]`` leaves), ``initial_quote_qty``
    (f32[M]), ``initial_spread`` (int32[M]) and ``scenarios`` (per-market
    labels, metadata) are their per-market views, built on first read and
    kept. Per-market values given to the constructor make one block a
    market; ``dataclasses.replace`` with static fields alone keeps the
    blocks, and with a per-market value makes the rows per row, reading
    the values it is not given from the blocks.
    """

    num_markets: int
    num_agents: int
    num_levels: int
    num_steps: int
    seed: int
    blocks: SpecBlocks

    def __init__(self, num_markets: int, num_agents: int, num_levels: int,
                 num_steps: int, seed: int, params: MarketParams = None,
                 initial_quote_qty: np.ndarray = None,
                 initial_spread: np.ndarray = None,
                 scenarios: Tuple[str, ...] = None,
                 blocks: Optional[SpecBlocks] = None):
        rows = dict(params=params, initial_quote_qty=initial_quote_qty,
                    initial_spread=initial_spread)
        if blocks is None or scenarios is not None or any(
                v is not None for v in rows.values()):
            # Per-market values make one block a market; in a replace()
            # the values not given are read from the old blocks.
            if blocks is None:
                missing = [k for k, v in rows.items() if v is None]
                if missing:
                    raise TypeError(f"EnsembleSpec() missing required "
                                    f"arguments {missing} (or blocks=)")
                labels = _runs(scenarios or ())
            else:
                rows = {k: blocks.market_view(k) if v is None else v
                        for k, v in rows.items()}
                labels = blocks.scenarios if scenarios is None \
                    else _runs(scenarios)
            blocks = SpecBlocks(np.arange(num_markets, dtype=np.int64),
                                rows["params"], rows["initial_quote_qty"],
                                rows["initial_spread"], labels,
                                int(num_markets))
        for name, value in (("num_markets", num_markets),
                            ("num_agents", num_agents),
                            ("num_levels", num_levels),
                            ("num_steps", num_steps), ("seed", seed),
                            ("blocks", blocks), ("_views", {})):
            object.__setattr__(self, name, value)
        self.validate()

    def _view(self, name: str):
        views = self.__dict__["_views"]
        if name not in views:
            views[name] = self.blocks.market_view(name)
        return views[name]

    @property
    def params(self) -> MarketParams:
        """Host numpy ``[M, 1]`` leaves, a row a market."""
        return self._view("params")

    @property
    def initial_quote_qty(self) -> np.ndarray:
        """f32[M] opening book depth."""
        return self._view("initial_quote_qty")

    @property
    def initial_spread(self) -> np.ndarray:
        """int32[M] opening spread (ticks)."""
        return self._view("initial_spread")

    @property
    def scenarios(self) -> Tuple[str, ...]:
        """Per-market preset labels (metadata)."""
        return self._view("scenarios")

    @property
    def num_blocks(self) -> int:
        """B, the distinct rows the blocks hold."""
        return len(self.blocks.starts)

    @classmethod
    def homogeneous(cls, cfg: MarketConfig) -> "EnsembleSpec":
        M = cfg.num_markets
        B = min(M, 1)
        return cls(
            num_markets=M, num_agents=cfg.num_agents,
            num_levels=cfg.num_levels, num_steps=cfg.num_steps,
            seed=cfg.seed, blocks=SpecBlocks(
                starts=np.zeros(B, np.int64),
                params=params_from_config(cfg, B),
                initial_quote_qty=np.full(B, cfg.initial_quote_qty,
                                          np.float32),
                initial_spread=np.full(B, cfg.initial_spread, np.int32),
                scenarios=((cfg.scenario, M),) if M else (),
                num_markets=M))

    @classmethod
    def from_scenarios(cls, blocks: Sequence[Union[MarketConfig, str]],
                       **common: Any) -> "EnsembleSpec":
        """Concatenate scenario blocks (configs or preset names); ``common``
        overrides apply to every block."""
        cfgs = [scenario_config(b, **common) if isinstance(b, str)
                else (dataclasses.replace(b, **common) if common else b)
                for b in blocks]
        if not cfgs:
            raise ValueError("from_scenarios needs at least one block")
        return cls.concatenate([cls.homogeneous(c) for c in cfgs])

    @classmethod
    def product(cls, base: MarketConfig, sweep: Dict[str, Iterable[Any]],
                markets_per_config: int = None) -> "EnsembleSpec":
        """Cartesian parameter sweep as one ensemble.

        ``sweep`` maps :class:`MarketConfig` field names to value lists;
        every combination, in ``itertools.product`` order over the keys as
        given, contributes ``markets_per_config`` (default
        ``base.num_markets``) rows built with ``dataclasses.replace``.
        """
        if not sweep:
            raise ValueError("product() needs a non-empty sweep")
        M = base.num_markets if markets_per_config is None \
            else int(markets_per_config)
        names = list(sweep)
        return cls.from_scenarios([
            dataclasses.replace(base, num_markets=M,
                                **dict(zip(names, combo)))
            for combo in itertools.product(*(sweep[n] for n in names))])

    @classmethod
    def concatenate(cls, specs: Sequence["EnsembleSpec"]) -> "EnsembleSpec":
        """Stack already-built specs along the market axis (their blocks,
        one after another)."""
        if not specs:
            raise ValueError("concatenate needs at least one spec")
        first = specs[0]
        for i, s in enumerate(specs[1:], start=1):
            for f in _STATIC_FIELDS:
                if getattr(s, f) != getattr(first, f):
                    raise ValueError(
                        f"ensemble blocks must agree on static field {f!r}: "
                        f"block 0 has {getattr(first, f)}, block {i} has "
                        f"{getattr(s, f)}")
        parts = [s.blocks for s in specs]
        offsets = np.cumsum([0] + [s.num_markets for s in specs])
        return cls(
            num_markets=int(offsets[-1]),
            num_agents=first.num_agents, num_levels=first.num_levels,
            num_steps=first.num_steps, seed=first.seed, blocks=SpecBlocks(
                starts=np.concatenate([b.starts + off for b, off
                                       in zip(parts, offsets)]),
                params=MarketParams(*(
                    np.concatenate([np.asarray(getattr(b.params, f))
                                    for b in parts], axis=0)
                    for f in MarketParams._fields)),
                initial_quote_qty=np.concatenate(
                    [b.initial_quote_qty for b in parts]),
                initial_spread=np.concatenate(
                    [b.initial_spread for b in parts]),
                scenarios=tuple(itertools.chain.from_iterable(
                    b.scenarios for b in parts)),
                num_markets=int(offsets[-1])))

    @classmethod
    def coerce(cls, obj: Union["EnsembleSpec", MarketConfig]) -> "EnsembleSpec":
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, MarketConfig):
            return cls.homogeneous(obj)
        raise TypeError(
            f"expected MarketConfig or EnsembleSpec, got {type(obj).__name__}")

    @property
    def mid0(self) -> float:
        return float(self.num_levels // 2)

    def events(self) -> int:
        """Total agent events M·A·S (the paper's throughput denominator)."""
        return self.num_markets * self.num_agents * self.num_steps

    def coupled_markets(self) -> int:
        """Markets with a real peer (:func:`coupled_count` of the
        ``coupling_peer`` column), counted a block at a time."""
        b = self.blocks
        peer = np.asarray(to_host(b.params.coupling_peer)).reshape(-1)
        ends = np.append(b.starts[1:], b.num_markets)
        own = (peer >= b.starts) & (peer < ends)
        return int(np.sum(np.where(peer >= 0, ends - b.starts - own, 0)))

    def initial_books(self, device=DEFAULT_DEVICE
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(bid, ask) float32[M, L] per-market opening books on ``device``."""
        return seed_books(self.num_levels,
                          np.asarray(self.initial_quote_qty, np.float32),
                          np.asarray(self.initial_spread, np.int32),
                          device=device)

    def static_key(self) -> Tuple[Any, ...]:
        """Runner cache key: shapes and the RNG seed, never values."""
        return (self.num_markets, self.num_agents, self.num_levels, self.seed)

    def replace_markets(self, slots, sub: "EnsembleSpec") -> "EnsembleSpec":
        """New spec with markets ``slots`` replaced by the rows of ``sub``
        (params, opening-book fields and labels). ``sub`` must agree on every
        static field, so the result keeps this spec's :meth:`static_key`."""
        for f in _STATIC_FIELDS:
            if getattr(sub, f) != getattr(self, f):
                raise ValueError(
                    f"replace_markets rows must agree on static field {f!r}:"
                    f" this spec has {getattr(self, f)}, the replacement has"
                    f" {getattr(sub, f)}")
        idx = np.asarray(slots, dtype=np.int64).reshape(-1)
        scenarios = list(self.scenarios or ("?",) * self.num_markets)
        quote = np.array(self.initial_quote_qty, np.float32)
        spread = np.array(self.initial_spread, np.int32)
        params = replace_rows(self.params, idx, sub.params)  # validates idx
        quote[idx] = np.asarray(sub.initial_quote_qty, np.float32)
        spread[idx] = np.asarray(sub.initial_spread, np.int32)
        for k, slot in enumerate(idx):
            scenarios[slot] = (sub.scenarios[k] if k < len(sub.scenarios)
                               else "?")
        return dataclasses.replace(
            self, params=params, initial_quote_qty=quote,
            initial_spread=spread, scenarios=tuple(scenarios))

    @classmethod
    def parked(cls, like: "EnsembleSpec", num_markets: int = None,
               ) -> "EnsembleSpec":
        """Inert rows agreeing with ``like`` on every static field: the
        serving gateway's parked slots. A parked row keeps being simulated
        (the shape is fixed), with no events, passive unit orders at the mid
        and empty opening books."""
        M = like.num_markets if num_markets is None else int(num_markets)
        B = min(M, 1)
        values = dict(INERT_PARAM_VALUES,
                      fundamental=float(like.num_levels // 2))
        return cls(
            num_markets=M, num_agents=like.num_agents,
            num_levels=like.num_levels, num_steps=like.num_steps,
            seed=like.seed, blocks=SpecBlocks(
                starts=np.zeros(B, np.int64),
                params=MarketParams(**{
                    f: np.full((B, 1), values[f], MarketParams.field_dtype(f))
                    for f in MarketParams._fields}),
                initial_quote_qty=np.zeros(B, np.float32),
                initial_spread=np.zeros(B, np.int32),
                scenarios=(("parked", M),) if M else (), num_markets=M))

    def with_values(self, **fields: Any) -> "EnsembleSpec":
        """New spec with some :class:`MarketParams` leaves replaced (values
        broadcast over markets); labels gain a trailing ``*``. Single values
        keep the blocks; an array of values makes the rows per row."""
        unknown = set(fields) - set(MarketParams._fields)
        if unknown:
            raise KeyError(f"unknown MarketParams fields: {sorted(unknown)}")
        values = {f: np.asarray(v, MarketParams.field_dtype(f))
                  for f, v in fields.items()}
        b = self.blocks
        labels = tuple((n if n.endswith("*") else n + "*", k)
                       for n, k in b.scenarios)
        if all(v.size == 1 for v in values.values()):
            B = len(b.starts)
            leaves = {f: np.full((B, 1), values[f].reshape(()))
                      if f in values else np.asarray(getattr(b.params, f))
                      for f in MarketParams._fields}
            return dataclasses.replace(self, blocks=b._replace(
                params=MarketParams(**leaves), scenarios=labels))
        leaves = {}
        for f in MarketParams._fields:
            if f in values:
                v = values[f]
                if v.ndim:
                    v = v.reshape(-1, 1)
                leaves[f] = np.ascontiguousarray(
                    np.broadcast_to(v, (self.num_markets, 1)))
            else:
                leaves[f] = np.asarray(getattr(self.params, f))
        return dataclasses.replace(self, blocks=SpecBlocks(
            np.arange(self.num_markets, dtype=np.int64),
            MarketParams(**leaves), self.initial_quote_qty,
            self.initial_spread, labels, self.num_markets))

    def validate(self) -> None:
        """Check the shapes and values, a block row at a time; an error
        names the first eight markets that violate it."""
        M, A, L = self.num_markets, self.num_agents, self.num_levels
        if L < 4 or (L & (L - 1)) != 0:
            raise ValueError(f"num_levels must be a power of two >= 4, got {L}")
        if L > 1024:
            raise ValueError("num_levels > 1024 requires tiling (paper §V)")
        b = self.blocks
        B = len(b.starts)
        if b.num_markets != M:
            raise ValueError(f"params.{MarketParams._fields[0]} must have "
                             f"shape ({M}, 1), got ({b.num_markets}, 1)")
        if B and (b.starts[0] != 0 or (np.diff(b.starts) <= 0).any()
                  or b.starts[-1] >= M):
            raise ValueError(f"block starts must rise from 0 below {M}")
        p = b.params.to_numpy()
        for f in MarketParams._fields:
            arr = np.asarray(getattr(p, f))
            if arr.shape != (B, 1):
                raise ValueError(
                    f"params.{f} must have shape ({B}, 1), got {arr.shape}")
            bad = ~np.isfinite(arr.astype(np.float64))
            if bad.any():
                raise ValueError(
                    f"params.{f} contains non-finite values (nan/inf) in "
                    f"markets {b.markets(bad[:, 0])}; "
                    "parameter operands must be finite")
        for name in ("initial_quote_qty", "initial_spread"):
            arr = np.asarray(getattr(b, name))
            if arr.shape != (B,):
                raise ValueError(
                    f"{name} must have shape ({B},), got {arr.shape}")
        spread = np.asarray(b.initial_spread)
        half = spread // 2 + spread % 2
        off_grid = (spread < 0) | (half > L // 2 - 1)
        if off_grid.any():
            raise ValueError(
                f"initial_spread must place both opening quotes on the grid "
                f"(0 <= spread, ceil(spread/2) <= {L // 2 - 1} for "
                f"num_levels={L}); markets "
                f"{b.markets(off_grid)} violate it")
        if (np.asarray(b.initial_quote_qty) < 0).any():
            raise ValueError("initial_quote_qty must be >= 0")

        def check(bad, msg):
            if np.asarray(bad).any():
                rows = b.markets(np.asarray(bad).reshape(B, -1)[:, 0])
                raise ValueError(f"{msg}; markets {rows} violate it")

        for name in ("shock_intensity", "shock_cancel", "p_marketable"):
            arr = getattr(p, name)
            check((arr < 0.0) | (arr > 1.0), f"{name} must be in [0, 1]")
        check(p.q_max < 1.0, "q_max must be >= 1 (qty = 1 + floor(u * q_max) "
              "would go non-positive)")
        check(p.fundamental < 0.0,
              f"fundamental must be a resolved price >= 0 (the config's "
              f"negative-means-midpoint sentinel is applied at build time; "
              f"use num_levels // 2 = {L // 2} for the grid midpoint)")
        counts = (p.num_makers, p.num_momentum, p.num_fundamentalists,
                  p.num_whales, p.num_hft, p.num_informed,
                  p.num_arbitrageurs)
        check(sum(counts) > A,
              f"agent mixture assigns more than num_agents={A} agents")
        check(np.any([c < 0 for c in counts], axis=0),
              "archetype counts must be >= 0")
        check((p.whale_size < 1.0) | (p.whale_size != np.floor(p.whale_size)),
              "whale_size must be an integer-valued lot count >= 1")
        check(p.whale_period < 1, "whale_period must be >= 1")
        check((p.hft_threshold < 0.0) | (p.hft_threshold > 1.0),
              "hft_threshold must be in [0, 1]")
        check(p.informed_horizon < 0, "informed_horizon must be >= 0")
        check(p.arb_kappa < 0.0, "arb_kappa must be >= 0")
        check((p.coupling_peer < -1) | (p.coupling_peer >= M),
              f"coupling_peer must be -1 (self) or a market index in [0, {M})")
        check(p.shock_step >= self.num_steps,
              f"shock_step must be < num_steps={self.num_steps} (the session "
              "horizon)")

    def __repr__(self) -> str:
        kinds = [f"{name}×{sum(n for _, n in group)}" for name, group
                 in itertools.groupby(self.blocks.scenarios,
                                      key=lambda run: run[0])]
        return (f"EnsembleSpec(M={self.num_markets}, A={self.num_agents}, "
                f"L={self.num_levels}, S={self.num_steps}, seed={self.seed}, "
                f"scenarios=[{', '.join(kinds) or '?'}])")
