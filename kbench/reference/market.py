"""Plain PyTorch reference of the market step (paper Alg. 1 lines 5-22).

A straightforward restatement of the simulator's semantics, independent
of the program under test: the counter hash ``kinetic_hash32`` and its
uniform draws, the eight archetypes and ``decide``, order binning, the
uniform-price call auction, the residual books and the ``stats_only``
accumulators. It imports ``torch`` alone and takes plain numbers: a
configuration's market fields, and each row's seed and market id, so rows
of several ensembles (each with its own seed) run in one batch.

``fdt`` is the float type of every float tensor. The configuration states
float32 with exact-integer books; the control runs the same code in
bfloat16, the nearest precision below, which has to fail the comparison.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

MASK = 0xFFFFFFFF
M1, M2 = 0x7FEB352D, 0x846CA68B
GOLDEN = 0x9E3779B9
K_GID, K_STEP, K_CHAN = 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F

NOISE, MOMENTUM, MAKER, FUNDAMENTALIST = 0, 1, 2, 3
WHALE, HFT, INFORMED, ARBITRAGEUR = 4, 5, 6, 7
CH_SIDE, CH_PRICE, CH_MKT, CH_QTY, CH_SHOCK = 0, 1, 2, 3, 4
PANIC = "panic"   # in present(): some row draws the shock channel

#: The agent blocks in index order (makers first, then momentum, ...), each
#: with the fraction field that sizes it; the remaining agents are noise.
BLOCKS = ((MAKER, "alpha_maker"), (MOMENTUM, "alpha_momentum"),
          (FUNDAMENTALIST, "alpha_fundamentalist"), (WHALE, "alpha_whale"),
          (HFT, "alpha_hft"), (INFORMED, "alpha_informed"),
          (ARBITRAGEUR, "alpha_arbitrageur"))
FLOAT_FIELDS = ("shock_intensity", "shock_cancel", "p_marketable", "q_max",
                "noise_delta", "maker_half_spread", "fundamental",
                "fundamentalist_kappa", "whale_size", "hft_threshold",
                "arb_kappa", "initial_quote_qty")
INT_FIELDS = ("shock_step", "whale_period", "informed_horizon",
              "initial_spread")


def agent_counts(market: Dict[str, float], num_agents: int) -> Dict[int, int]:
    """Agents of each non-noise archetype: ``round(A * alpha)``."""
    return {tid: int(round(num_agents * float(market.get(field, 0.0))))
            for tid, field in BLOCKS}


def columns(market: Dict[str, float], num_agents: int, num_levels: int,
            rows: int, device) -> Dict[str, torch.Tensor]:
    """Per-row ``[rows, 1]`` columns of one scalar market description
    (float32 and int64), the agent counts under their archetype ids."""
    vals = dict(market)
    fp = float(vals.get("fundamental_price", -1.0))
    vals["fundamental"] = float(num_levels // 2) if fp < 0 else fp
    out = {}
    for f in FLOAT_FIELDS:
        out[f] = torch.full((rows, 1), float(vals[f]), dtype=torch.float32,
                            device=device)
    for f in INT_FIELDS:
        out[f] = torch.full((rows, 1), int(vals[f]), dtype=torch.int64,
                            device=device)
    for tid, n in agent_counts(market, num_agents).items():
        out[tid] = torch.full((rows, 1), n, dtype=torch.int64, device=device)
    return out


def stack_columns(parts) -> Dict[str, torch.Tensor]:
    """Row-wise concatenation of several :func:`columns` results."""
    return {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}


# ---- the counter hash, uint32 values held in int64 ----
def _mul(x: torch.Tensor, const: int) -> torch.Tensor:
    """``x * const mod 2**32``, with no intermediate past 2**48."""
    lo, hi = const & 0xFFFF, const >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK


def mix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul(x, M1)
    x = x ^ (x >> 15)
    x = _mul(x, M2)
    return x ^ (x >> 16)


def absorb(x: torch.Tensor, value, const: int) -> torch.Tensor:
    """One round of ``kinetic_hash32``: ``mix32(x + value * const)``."""
    if isinstance(value, int):
        return mix32((x + ((value & MASK) * const & MASK)) & MASK)
    return mix32((x + _mul(value & MASK, const)) & MASK)


def uniform(h_step: torch.Tensor, channel: int, fdt) -> torch.Tensor:
    """The channel's uniform in [0, 1): the top 24 bits of the hash."""
    bits = absorb(h_step, channel, K_CHAN)
    return (bits >> 8).to(fdt) * (2.0 ** -24)


class Rows(NamedTuple):
    """Rows to simulate: each one market of some ensemble."""

    seed: torch.Tensor       # int64[N, 1] the ensemble's seed (mod 2**32)
    market_id: torch.Tensor  # int64[N, 1] the market's index in it
    cols: Dict              # columns() of each row


class Books(NamedTuple):
    bid: torch.Tensor
    ask: torch.Tensor
    last: torch.Tensor
    prev_mid: torch.Tensor


def opening_books(rows: Rows, num_levels: int, fdt) -> Books:
    """Quotes of ``initial_quote_qty`` straddling L/2 at ceil(spread/2)."""
    c = rows.cols
    L = num_levels
    dev = rows.seed.device
    spread = c["initial_spread"]
    half = spread // 2 + spread % 2
    levels = torch.arange(L, device=dev)[None, :]
    q = c["initial_quote_qty"].to(fdt)
    bid = (levels == L // 2 - half).to(fdt) * q
    ask = (levels == L // 2 + half).to(fdt) * q
    mid0 = torch.full_like(q, float(L // 2))
    return Books(bid, ask, mid0, mid0.clone())


def agent_types(rows: Rows, num_agents: int) -> torch.Tensor:
    """int64[N, A]: makers, momentum, fundamentalists, whales, HFTs,
    informed, arbitrageurs by agent index, the rest noise."""
    a = torch.arange(num_agents, device=rows.seed.device)[None, :]
    out = torch.full((rows.seed.shape[0], num_agents), NOISE,
                     dtype=torch.int64, device=a.device)
    upper = torch.zeros_like(rows.seed)
    lower = upper
    for tid, _ in BLOCKS:
        upper = lower + rows.cols[tid]
        out = torch.where((a >= lower) & (a < upper), tid, out)
        lower = upper
    return out


def present(rows: Rows) -> frozenset:
    """The archetypes some row has agents of, and ``PANIC`` where some
    row can panic (read once: it waits for the device)."""
    c = rows.cols
    out = {tid for tid, _ in BLOCKS if bool((c[tid] > 0).any())}
    if out & {ARBITRAGEUR}:
        raise ValueError("this reference runs uncoupled markets only: an "
                         "arbitrageur reads its peer's mid frozen at each "
                         "chunk entry, which it does not model")
    if bool((c["shock_intensity"] > 0).any()):
        out.add(PANIC)
    return frozenset(out)


def decide(rows: Rows, atype, h_agent, mid, prev_mid, imbalance, step: int,
           num_agents: int, num_levels: int, fdt, kinds: frozenset):
    """Every agent's order at ``step``: (side_buy, price int64, qty).
    ``kinds`` is :func:`present` of the rows: an absent archetype's select
    would change nothing."""
    c = rows.cols
    A, L = num_agents, num_levels
    h = absorb(h_agent, step, K_STEP)
    u_side = uniform(h, CH_SIDE, fdt)
    u_price = uniform(h, CH_PRICE, fdt)
    u_mkt = uniform(h, CH_MKT, fdt)
    u_qty = uniform(h, CH_QTY, fdt)
    f = lambda x: x.to(fdt)  # noqa: E731
    coin = u_side < 0.5
    one = torch.ones_like(u_side)

    # noise (the default), then each archetype where its agents are
    side = coin.clone()
    price = mid + (u_price * 2.0 - 1.0) * f(c["noise_delta"])
    jitter = u_price * 2.0 - 1.0
    shock_step = c["shock_step"]
    if MOMENTUM in kinds:
        ret = torch.sign(mid - prev_mid)
        s = torch.where(ret != 0.0, (ret > 0.0).expand_as(coin), coin)
        side = torch.where(atype == MOMENTUM, s, side)
        price = torch.where(atype == MOMENTUM,
                            mid + torch.where(s, one, -one), price)
    if MAKER in kinds:
        a = torch.arange(A, device=mid.device)[None, :]
        s = (((a + step) % 2) == 0).expand_as(coin)
        half = f(c["maker_half_spread"])
        side = torch.where(atype == MAKER, s, side)
        price = torch.where(atype == MAKER,
                            torch.where(s, mid - half, mid + half), price)
    if FUNDAMENTALIST in kinds:
        dev = f(c["fundamental"]) - mid
        s = torch.where(dev != 0.0, (dev > 0.0).expand_as(coin), coin)
        side = torch.where(atype == FUNDAMENTALIST, s, side)
        price = torch.where(atype == FUNDAMENTALIST,
                            mid + dev * f(c["fundamentalist_kappa"]) + jitter,
                            price)
    if WHALE in kinds:
        side = torch.where(atype == WHALE, coin, side)
        price = torch.where(atype == WHALE,
                            torch.where(coin, float(L - 1), 0.0).to(fdt),
                            price)
    if HFT in kinds:
        s = torch.where(imbalance.abs() > f(c["hft_threshold"]),
                        (imbalance > 0.0).expand_as(coin), coin)
        side = torch.where(atype == HFT, s, side)
        price = torch.where(atype == HFT, mid + torch.where(s, one, -one),
                            price)
    if INFORMED in kinds:
        window = ((shock_step >= 0)
                  & (step >= shock_step - c["informed_horizon"])
                  & (step < shock_step)).expand_as(coin)
        inf = atype == INFORMED
        side = torch.where(inf, torch.where(window, False, coin), side)
        price = torch.where(inf, torch.where(window, 0.0, mid + jitter)
                            .to(fdt), price)

    maker = atype == MAKER
    edge = torch.where(side, float(L - 1), 0.0).to(fdt)
    price = torch.where((u_mkt < f(c["p_marketable"])) & ~maker, edge, price)
    if PANIC in kinds:
        u_shock = uniform(h, CH_SHOCK, fdt)
        panic = ((u_shock < f(c["shock_intensity"])) & ~maker
                 & (step == shock_step))
        side = torch.where(panic, False, side)
        price = torch.where(panic, 0.0, price)
    # Rounded half to even and clipped to the grid; the second clip only
    # matters where L - 1 is not exact in ``fdt`` (the bfloat16 control).
    tick = torch.clamp(torch.clamp(torch.round(price), 0.0, float(L - 1))
                       .to(torch.int64), 0, L - 1)
    qty = 1.0 + torch.floor(u_qty * f(c["q_max"]))
    if WHALE in kinds:
        period = torch.clamp(c["whale_period"], min=1)
        wq = torch.where((step % period) == 0, f(c["whale_size"]), 0.0)
        qty = torch.where(atype == WHALE, wq.to(fdt).expand_as(qty), qty)
    return side, tick, qty


def best_quotes(bid, ask, last):
    """(best bid, best ask, mid): the mid is the last price on a side with
    no quotes."""
    L = bid.shape[-1]
    levels = torch.arange(L, device=bid.device)[None, :]
    bb = torch.where(bid > 0.0, levels, -1).amax(-1, keepdim=True)
    ba = torch.where(ask > 0.0, levels, L).amin(-1, keepdim=True)
    ok = (bb >= 0) & (ba < L)
    return torch.where(ok, (bb + ba).to(bid.dtype) * 0.5, last)


def clear(total_buy, total_ask):
    """Uniform-price call auction: the price of the largest executable
    volume (the lowest tick on a tie), then priority allocation."""
    d_cum = total_buy.flip(-1).cumsum(-1).flip(-1)
    s_cum = total_ask.cumsum(-1)
    match = torch.minimum(d_cum, s_cum)
    p_star = match.argmax(-1, keepdim=True)
    volume = match.gather(-1, p_star)
    zero = torch.zeros((), dtype=total_buy.dtype, device=total_buy.device)
    traded_buy = torch.minimum(
        total_buy, torch.maximum(zero, volume - (d_cum - total_buy)))
    traded_sell = torch.minimum(
        total_ask, torch.maximum(zero, volume - (s_cum - total_ask)))
    return p_star, volume, total_buy - traded_buy, total_ask - traded_sell


class Stats(NamedTuple):
    count: torch.Tensor
    sum_mid: torch.Tensor
    sumsq_mid: torch.Tensor
    min_mid: torch.Tensor
    max_mid: torch.Tensor
    sum_volume: torch.Tensor


def step(rows: Rows, books: Books, atype, h_agent, t: int, num_agents: int,
         num_levels: int, fdt, kinds: frozenset, ext_buy=None, ext_ask=None):
    """One step of every row: ``(books, price, volume, mid)``."""
    c = rows.cols
    cancelled = torch.floor(books.bid * c["shock_cancel"].to(fdt))
    bid = torch.where(c["shock_step"] == t, books.bid - cancelled, books.bid)
    mid = best_quotes(bid, books.ask, books.last)
    sum_bid = bid.sum(-1, keepdim=True)
    sum_ask = books.ask.sum(-1, keepdim=True)
    depth = sum_bid + sum_ask
    safe = torch.where(depth > 0.0, depth, torch.ones_like(depth))
    imbalance = torch.where(depth > 0.0, (sum_bid - sum_ask) / safe,
                            torch.zeros_like(depth))
    side, tick, qty = decide(rows, atype, h_agent, mid, books.prev_mid,
                             imbalance, t, num_agents, num_levels, fdt, kinds)
    sidef = side.to(fdt)
    buy = torch.zeros_like(bid).scatter_add_(1, tick, qty * sidef)
    sell = torch.zeros_like(bid).scatter_add_(1, tick, qty * (1.0 - sidef))
    total_buy, total_ask = bid + buy, books.ask + sell
    if ext_buy is not None:
        total_buy = total_buy + ext_buy
    if ext_ask is not None:
        total_ask = total_ask + ext_ask
    p_star, volume, new_bid, new_ask = clear(total_buy, total_ask)
    last = torch.where(volume > 0.0, p_star.to(fdt), books.last)
    return Books(new_bid, new_ask, last, mid), last, volume, mid


def agent_hash(rows: Rows, num_agents: int) -> torch.Tensor:
    """The step-invariant first two rounds of the hash: (seed, gid)."""
    a = torch.arange(num_agents, device=rows.seed.device)[None, :]
    gid = (rows.market_id * num_agents + a) & MASK
    return absorb((rows.seed & MASK) ^ GOLDEN, gid, K_GID)


def simulate(rows: Rows, num_agents: int, num_levels: int, num_steps: int,
             fdt=torch.float32, stats_only: bool = False,
             books: Optional[Books] = None):
    """``num_steps`` steps of every row from its opening books: the
    ``[N, S]`` price, volume and mid paths, or the six ``[N, 1]``
    accumulators with ``stats_only``."""
    books = opening_books(rows, num_levels, fdt) if books is None else books
    atype = agent_types(rows, num_agents)
    h_agent = agent_hash(rows, num_agents)
    kinds = present(rows)
    paths = []
    N = rows.seed.shape[0]
    zeros = torch.zeros((N, 1), dtype=fdt, device=rows.seed.device)
    stats = Stats(zeros, zeros, zeros, zeros + float("inf"),
                  zeros - float("inf"), zeros)
    for t in range(num_steps):
        books, price, volume, mid = step(rows, books, atype, h_agent, t,
                                         num_agents, num_levels, fdt, kinds)
        if stats_only:
            stats = Stats(stats.count + 1.0, stats.sum_mid + mid,
                          stats.sumsq_mid + mid * mid,
                          torch.minimum(stats.min_mid, mid),
                          torch.maximum(stats.max_mid, mid),
                          stats.sum_volume + volume)
        else:
            paths.append((price, volume, mid))
    if stats_only:
        return stats
    return tuple(torch.cat(p, dim=1) for p in zip(*paths))
