"""Plain PyTorch reference of coupled, heterogeneous markets.

The counterpart of ``kbench/reference/market.py`` for ensembles whose rows
differ in their parameters and whose arbitrageurs trade toward a peer
market's mid. It keeps that module's counter hash, per-row columns,
opening books, agent blocks, best quotes and call auction, and restates the
rest: the eight archetypes with the arbitrageur among them
(:func:`decide`), the step, and a step loop
that resolves each row's peer mid at every chunk entry from rows it
simulates itself (:func:`simulate`). It imports ``torch`` and that module
alone, and never reads a peer from the program under test.

The arbitrageur: its side is toward ``peer_mid - mid`` (its side coin where
the gap is zero), its price ``mid + (peer_mid - mid) * arb_kappa +
jitter``, and the marketable and panic overlays apply to it as to every
non-maker. ``peer_mid`` is the peer row's previous mid at the entry of the
chunk the step lies in, held for the whole chunk; at step 0 it is the
opening mid, L/2, for every row.

Where this departs from the published semantics, and why:

  * A row is simulated only as far as some output needs it. A market's
    outputs over S steps read its peer at the entries 0, chunk, ... below
    S, so its peer is needed to the last entry it reads, the peer's peer
    to the entry before, and so on (:func:`cone`): along a ring of offset
    1 at S = 500 and chunk 64, market m needs m+1 to step 448, m+2 to 384,
    ..., m+7 to 64, and m+8 not at all. Rows past their horizon stop; the
    outputs of the rows asked for are those of the whole ensemble.
  * A row whose peer is not among the rows simulated reads its own mid at
    each entry instead. :func:`cone` never hands such a row a horizon past
    the first chunk, where every peer reads L/2, so no output asked for
    depends on it.
  * ``refresh`` (default: the chunk) is how often the peer is read; the
    planted fault that reads it at every step passes 1.

``fdt`` is the float type of every float tensor, as in ``market.py``: the
configuration states float32 with exact-integer books, and the control
runs bfloat16, which has to fail the comparison.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Optional, Sequence

import torch

from kbench.reference.market import (ARBITRAGEUR, BLOCKS, CH_MKT, CH_PRICE,
                                     CH_QTY, CH_SHOCK, CH_SIDE,
                                     FUNDAMENTALIST, HFT, INFORMED, MAKER,
                                     MOMENTUM, WHALE, K_STEP, Books, Rows,
                                     Stats, absorb, agent_hash, agent_types,
                                     best_quotes, clear, opening_books,
                                     uniform)

PANIC = "panic"


def kinds_of(cols: Dict) -> frozenset:
    """The archetypes some row has agents of, and ``PANIC`` where some row
    can panic (read once: it waits for the device)."""
    out = {tid for tid, _ in BLOCKS if bool((cols[tid] > 0).any())}
    if bool((cols["shock_intensity"] > 0).any()):
        out.add(PANIC)
    return frozenset(out)


def decide(cols: Dict, atype, h_agent, mid, prev_mid, peer_mid, imbalance,
           t: int, num_agents: int, num_levels: int, fdt, kinds: frozenset):
    """Every agent's order at step ``t``: (side_buy, price int64, qty).
    ``kinds`` is :func:`kinds_of` of the rows: an absent archetype's
    select would change nothing."""
    c = cols
    A, L = num_agents, num_levels
    h = absorb(h_agent, t, K_STEP)
    u_side = uniform(h, CH_SIDE, fdt)
    u_price = uniform(h, CH_PRICE, fdt)
    u_mkt = uniform(h, CH_MKT, fdt)
    u_qty = uniform(h, CH_QTY, fdt)
    f = lambda x: x.to(fdt)  # noqa: E731
    coin = u_side < 0.5
    one = torch.ones_like(u_side)
    jitter = u_price * 2.0 - 1.0

    def toward(gap, kappa):
        s = torch.where(gap != 0.0, (gap > 0.0).expand_as(coin), coin)
        return s, mid + gap * f(kappa) + jitter

    side = coin.clone()
    price = mid + (u_price * 2.0 - 1.0) * f(c["noise_delta"])
    if MOMENTUM in kinds:
        ret = torch.sign(mid - prev_mid)
        s = torch.where(ret != 0.0, (ret > 0.0).expand_as(coin), coin)
        side = torch.where(atype == MOMENTUM, s, side)
        price = torch.where(atype == MOMENTUM,
                            mid + torch.where(s, one, -one), price)
    if MAKER in kinds:
        a = torch.arange(A, device=mid.device)[None, :]
        s = (((a + t) % 2) == 0).expand_as(coin)
        half = f(c["maker_half_spread"])
        side = torch.where(atype == MAKER, s, side)
        price = torch.where(atype == MAKER,
                            torch.where(s, mid - half, mid + half), price)
    if FUNDAMENTALIST in kinds:
        s, p = toward(f(c["fundamental"]) - mid, c["fundamentalist_kappa"])
        side = torch.where(atype == FUNDAMENTALIST, s, side)
        price = torch.where(atype == FUNDAMENTALIST, p, price)
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
        shock_step = c["shock_step"]
        window = ((shock_step >= 0)
                  & (t >= shock_step - c["informed_horizon"])
                  & (t < shock_step)).expand_as(coin)
        inf = atype == INFORMED
        side = torch.where(inf, torch.where(window, False, coin), side)
        price = torch.where(inf, torch.where(window, 0.0, mid + jitter)
                            .to(fdt), price)
    if ARBITRAGEUR in kinds:
        s, p = toward(peer_mid - mid, c["arb_kappa"])
        side = torch.where(atype == ARBITRAGEUR, s, side)
        price = torch.where(atype == ARBITRAGEUR, p, price)

    maker = atype == MAKER
    edge = torch.where(side, float(L - 1), 0.0).to(fdt)
    price = torch.where((u_mkt < f(c["p_marketable"])) & ~maker, edge, price)
    if PANIC in kinds:
        u_shock = uniform(h, CH_SHOCK, fdt)
        panic = ((u_shock < f(c["shock_intensity"])) & ~maker
                 & (t == c["shock_step"]))
        side = torch.where(panic, False, side)
        price = torch.where(panic, 0.0, price)
    # Rounded half to even and clipped to the grid; the second clip only
    # matters where L - 1 is not exact in ``fdt`` (the bfloat16 control).
    tick = torch.clamp(torch.clamp(torch.round(price), 0.0, float(L - 1))
                       .to(torch.int64), 0, L - 1)
    qty = 1.0 + torch.floor(u_qty * f(c["q_max"]))
    if WHALE in kinds:
        period = torch.clamp(c["whale_period"], min=1)
        wq = torch.where((t % period) == 0, f(c["whale_size"]), 0.0)
        qty = torch.where(atype == WHALE, wq.to(fdt).expand_as(qty), qty)
    return side, tick, qty


def step(cols: Dict, books: Books, atype, h_agent, peer_mid, t: int,
         num_agents: int, num_levels: int, fdt, kinds: frozenset):
    """One step of every row: ``(books, price, volume, mid)``."""
    cancelled = torch.floor(books.bid * cols["shock_cancel"].to(fdt))
    bid = torch.where(cols["shock_step"] == t, books.bid - cancelled,
                      books.bid)
    mid = best_quotes(bid, books.ask, books.last)
    sum_bid = bid.sum(-1, keepdim=True)
    sum_ask = books.ask.sum(-1, keepdim=True)
    depth = sum_bid + sum_ask
    safe = torch.where(depth > 0.0, depth, torch.ones_like(depth))
    imbalance = torch.where(depth > 0.0, (sum_bid - sum_ask) / safe,
                            torch.zeros_like(depth))
    side, tick, qty = decide(cols, atype, h_agent, mid, books.prev_mid,
                             peer_mid, imbalance, t, num_agents, num_levels,
                             fdt, kinds)
    sidef = side.to(fdt)
    buy = torch.zeros_like(bid).scatter_add_(1, tick, qty * sidef)
    sell = torch.zeros_like(bid).scatter_add_(1, tick, qty * (1.0 - sidef))
    p_star, volume, new_bid, new_ask = clear(bid + buy, books.ask + sell)
    last = torch.where(volume > 0.0, p_star.to(fdt), books.last)
    return Books(new_bid, new_ask, last, mid), last, volume, mid


def cone(kept: Sequence[int], peer_of: Callable[[int], int],
         num_steps: int, chunk: int) -> Dict[int, int]:
    """``{market: steps}``: the markets whose outputs over ``num_steps``
    steps ``kept`` depend on, each with the steps it has to be simulated
    (``num_steps`` for a kept market). A market simulated for ``n`` steps
    reads its peer at the chunk entries below ``n``, the last of them
    ``chunk * ((n - 1) // chunk)``, so its peer needs that many steps; a
    peer needed for 0 steps reads the opening mid and is left out.
    ``peer_of(m)`` is ``m``'s peer (``m`` itself where it has none)."""
    need: Dict[int, int] = {}
    for m in kept:
        n = num_steps
        while n > 0 and need.get(m, 0) < n:
            need[m] = n
            p = peer_of(m)
            if p == m:
                break
            m, n = p, chunk * ((n - 1) // chunk)
    return need


def rows_of(need: Dict[int, int], peer_of: Callable[[int], int]):
    """``(markets, peer, steps)`` of a :func:`cone`, as lists in one order:
    ``peer[k]`` is the position of market ``k``'s peer in the list, or
    ``k`` where its peer is not in it."""
    markets = sorted(need)
    pos = {m: k for k, m in enumerate(markets)}
    peer = [pos.get(peer_of(m), k) for k, m in enumerate(markets)]
    return markets, peer, [need[m] for m in markets]


def simulate(rows: Rows, peer: torch.Tensor, steps: torch.Tensor,
             num_agents: int, num_levels: int, num_steps: int, chunk: int,
             fdt=torch.float32, stats_only: bool = False,
             refresh: Optional[int] = None):
    """Simulate every row from its opening books for ``steps[n]`` steps
    (int64[N], at most ``num_steps``), each arbitrageur reading the mid of
    row ``peer[n]`` (int64[N], a position in ``rows``) frozen at every
    ``refresh`` steps (default ``chunk``). Returns the ``[N, S]`` price,
    volume and mid paths (NaN past a row's horizon), or with
    ``stats_only`` the six ``[N, 1]`` accumulators over each row's
    horizon."""
    refresh = int(chunk if refresh is None else refresh)
    dev = rows.seed.device
    N = rows.seed.shape[0]
    # Rows by horizon, longest first: the rows still running are a prefix.
    order = torch.argsort(steps.to(dev), descending=True, stable=True)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(N, device=dev)
    # Negated horizons, ascending: bisect counts the rows past step t.
    ends = [-h for h in steps.to(dev)[order].tolist()]
    peer_pos = inv[peer.to(dev)[order]][:, None]
    cols = {k: v[order] for k, v in rows.cols.items()}
    srows = Rows(rows.seed[order], rows.market_id[order], cols)
    books = opening_books(srows, num_levels, fdt)
    atype = agent_types(srows, num_agents)
    h_agent = agent_hash(srows, num_agents)
    kinds = kinds_of(cols)

    zeros = torch.zeros((N, 1), dtype=fdt, device=dev)
    acc = [zeros, zeros, zeros, zeros + float("inf"), zeros - float("inf"),
           zeros]
    paths: List[List[torch.Tensor]] = [[], [], []]
    entry_mid = books.prev_mid.clone()   # each row's mid at the last entry
    n = N
    for t in range(num_steps):
        alive = bisect.bisect_left(ends, -t)
        if alive == 0:
            break
        if alive < n:
            entry_mid[:n] = books.prev_mid
            n = alive
            books = Books(*(x[:n] for x in books))
            atype, h_agent = atype[:n], h_agent[:n]
            cols = {k: v[:n] for k, v in cols.items()}
        if t % refresh == 0:
            entry_mid[:n] = books.prev_mid
            peer_mid = entry_mid.gather(0, peer_pos[:n])
        books, price, volume, mid = step(cols, books, atype, h_agent,
                                         peer_mid, t, num_agents,
                                         num_levels, fdt, kinds)
        if stats_only:
            acc = [torch.cat([a[:n] + b, a[n:]]) for a, b in
                   zip(acc[:3], (1.0, mid, mid * mid))] + [
                torch.cat([torch.minimum(acc[3][:n], mid), acc[3][n:]]),
                torch.cat([torch.maximum(acc[4][:n], mid), acc[4][n:]]),
                torch.cat([acc[5][:n] + volume, acc[5][n:]])]
        else:
            for p, x in zip(paths, (price, volume, mid)):
                p.append(torch.cat([x, torch.full((N - n, 1), float("nan"),
                                                  dtype=fdt, device=dev)]))
    if stats_only:
        return Stats(*(a[inv] for a in acc))
    pad = num_steps - len(paths[0])
    return tuple(torch.cat(p + [torch.full((N, pad), float("nan"), dtype=fdt,
                                           device=dev)] * bool(pad),
                           dim=1)[inv] for p in paths)
