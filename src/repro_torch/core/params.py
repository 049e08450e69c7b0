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
    ``replace_markets`` and ``parked``.

Markets are row-independent and the RNG is a pure function of (seed, global
market id, step, channel), so market ``m`` of a heterogeneous ensemble
equals market ``m`` of the homogeneous ensemble of its scenario.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import (Any, Dict, Iterable, NamedTuple, Sequence, Tuple,
                    Union)

import numpy as np
import torch

from repro_torch.core.config import (
    MarketConfig,
    assign_agent_types,
    scenario_config,
    seed_books,
)
from repro_torch.core.device import DEFAULT_DEVICE, resolve_device


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
        return MarketParams(*(_host(x) for x in self))

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


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


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
    """Pack host or device columns into the two contiguous device tensors."""
    def stack(fields, dtype):
        cols = [torch.tensor(_host(getattr(params, f)).reshape(-1),
                             dtype=dtype) for f in fields]
        return torch.stack(cols, dim=1).contiguous().to(device)

    return PackedParams(floats=stack(FLOAT_FIELDS, torch.float32),
                        ints=stack(INT_FIELDS, torch.int32))


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
        leaf = np.array(_host(leaf), dtype=MarketParams.field_dtype(f))
        leaf[idx] = np.asarray(_host(src), dtype=leaf.dtype)
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
            leaves.append(np.asarray(_host(values[f]), dtype=dt).reshape(M, 1))
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
    device = resolve_device(device)
    host = params_from_config(cfg, num_markets=1)
    return MarketParams(*(torch.as_tensor(x).to(device) for x in host))


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


@dataclasses.dataclass(frozen=True, eq=False)
class EnsembleSpec:
    """A heterogeneous market ensemble: static shape + per-market params."""

    num_markets: int
    num_agents: int
    num_levels: int
    num_steps: int
    seed: int
    params: MarketParams               # host numpy [M, 1] leaves
    initial_quote_qty: np.ndarray      # f32[M] opening book depth
    initial_spread: np.ndarray         # int32[M] opening spread (ticks)
    scenarios: Tuple[str, ...] = ()    # per-market preset labels (metadata)

    @classmethod
    def homogeneous(cls, cfg: MarketConfig) -> "EnsembleSpec":
        M = cfg.num_markets
        return cls(
            num_markets=M, num_agents=cfg.num_agents,
            num_levels=cfg.num_levels, num_steps=cfg.num_steps,
            seed=cfg.seed, params=params_from_config(cfg),
            initial_quote_qty=np.full(M, cfg.initial_quote_qty, np.float32),
            initial_spread=np.full(M, cfg.initial_spread, np.int32),
            scenarios=(cfg.scenario,) * M)

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
        """Stack already-built specs along the market axis."""
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
        return cls(
            num_markets=sum(s.num_markets for s in specs),
            num_agents=first.num_agents, num_levels=first.num_levels,
            num_steps=first.num_steps, seed=first.seed,
            params=MarketParams(*(
                np.concatenate([np.asarray(getattr(s.params, f))
                                for s in specs], axis=0)
                for f in MarketParams._fields)),
            initial_quote_qty=np.concatenate(
                [s.initial_quote_qty for s in specs]),
            initial_spread=np.concatenate([s.initial_spread for s in specs]),
            scenarios=tuple(itertools.chain.from_iterable(
                s.scenarios for s in specs)))

    @classmethod
    def coerce(cls, obj: Union["EnsembleSpec", MarketConfig]) -> "EnsembleSpec":
        if isinstance(obj, cls):
            return obj
        if isinstance(obj, MarketConfig):
            return cls.homogeneous(obj)
        raise TypeError(
            f"expected MarketConfig or EnsembleSpec, got {type(obj).__name__}")

    def __post_init__(self):
        self.validate()

    @property
    def mid0(self) -> float:
        return float(self.num_levels // 2)

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
        values = dict(INERT_PARAM_VALUES,
                      fundamental=float(like.num_levels // 2))
        return cls(
            num_markets=M, num_agents=like.num_agents,
            num_levels=like.num_levels, num_steps=like.num_steps,
            seed=like.seed,
            params=MarketParams(**{
                f: np.full((M, 1), values[f], MarketParams.field_dtype(f))
                for f in MarketParams._fields}),
            initial_quote_qty=np.zeros(M, np.float32),
            initial_spread=np.zeros(M, np.int32),
            scenarios=("parked",) * M)

    def with_values(self, **fields: Any) -> "EnsembleSpec":
        """New spec with some :class:`MarketParams` leaves replaced (values
        broadcast over markets); labels gain a trailing ``*``."""
        unknown = set(fields) - set(MarketParams._fields)
        if unknown:
            raise KeyError(f"unknown MarketParams fields: {sorted(unknown)}")
        leaves = {}
        for f in MarketParams._fields:
            if f in fields:
                v = np.asarray(fields[f], MarketParams.field_dtype(f))
                if v.ndim:
                    v = v.reshape(-1, 1)
                leaves[f] = np.ascontiguousarray(
                    np.broadcast_to(v, (self.num_markets, 1)))
            else:
                leaves[f] = np.asarray(getattr(self.params, f))
        labels = tuple(n if n.endswith("*") else n + "*"
                       for n in self.scenarios)
        return dataclasses.replace(self, params=MarketParams(**leaves),
                                   scenarios=labels)

    def validate(self) -> None:
        M, A, L = self.num_markets, self.num_agents, self.num_levels
        if L < 4 or (L & (L - 1)) != 0:
            raise ValueError(f"num_levels must be a power of two >= 4, got {L}")
        if L > 1024:
            raise ValueError("num_levels > 1024 requires tiling (paper §V)")
        p = self.params.to_numpy()
        for f in MarketParams._fields:
            arr = np.asarray(getattr(p, f))
            if arr.shape != (M, 1):
                raise ValueError(
                    f"params.{f} must have shape ({M}, 1), got {arr.shape}")
            bad = ~np.isfinite(arr.astype(np.float64))
            if bad.any():
                raise ValueError(
                    f"params.{f} contains non-finite values (nan/inf) in "
                    f"markets {np.where(bad[:, 0])[0][:8].tolist()}")
        for name in ("initial_quote_qty", "initial_spread"):
            arr = np.asarray(getattr(self, name))
            if arr.shape != (M,):
                raise ValueError(
                    f"{name} must have shape ({M},), got {arr.shape}")
        spread = np.asarray(self.initial_spread)
        half = spread // 2 + spread % 2
        if ((spread < 0) | (half > L // 2 - 1)).any():
            raise ValueError(
                f"initial_spread must place both opening quotes on the grid "
                f"(0 <= spread, ceil(spread/2) <= {L // 2 - 1})")
        if (np.asarray(self.initial_quote_qty) < 0).any():
            raise ValueError("initial_quote_qty must be >= 0")

        def check(bad, msg):
            if np.asarray(bad).any():
                rows = np.where(np.asarray(bad).reshape(M, -1)[:, 0])[0]
                raise ValueError(f"{msg}; markets {rows[:8].tolist()} "
                                 "violate it")

        for name in ("shock_intensity", "shock_cancel", "p_marketable"):
            arr = getattr(p, name)
            check((arr < 0.0) | (arr > 1.0), f"{name} must be in [0, 1]")
        check(p.q_max < 1.0, "q_max must be >= 1")
        check(p.fundamental < 0.0,
              f"fundamental must be a resolved price >= 0 (use "
              f"num_levels // 2 = {L // 2} for the grid midpoint)")
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
        kinds = [f"{name}×{len(list(group))}"
                 for name, group in itertools.groupby(self.scenarios)]
        return (f"EnsembleSpec(M={self.num_markets}, A={self.num_agents}, "
                f"L={self.num_levels}, S={self.num_steps}, seed={self.seed}, "
                f"scenarios=[{', '.join(kinds) or '?'}])")
