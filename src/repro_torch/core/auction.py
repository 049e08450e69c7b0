"""Uniform-price call-auction clearing (paper §II-A, §IV-C) on torch tensors.

The allocation rule is the closed form of the paper's priority-based
allocation: orders with limits strictly better than the clearing price fill
first; the marginal level p* is rationed. Books are exact-integer float32,
so every scan order gives the same bits.
"""
from __future__ import annotations

import torch


def prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over the last axis (cumulative supply)."""
    return torch.cumsum(x, dim=-1, dtype=x.dtype)


def suffix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive suffix sum over the last axis (cumulative demand)."""
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), dim=-1,
                                   dtype=x.dtype), (-1,))


def hillis_steele_prefix(x: torch.Tensor) -> torch.Tensor:
    """Θ(log L)-depth Hillis–Steele inclusive prefix scan (paper §III-D)."""
    L = x.shape[-1]
    off = 1
    while off < L:
        zeros = x.new_zeros(x.shape[:-1] + (off,))
        x = x + torch.cat([zeros, x[..., :-off]], dim=-1)
        off *= 2
    return x


def hillis_steele_suffix(x: torch.Tensor) -> torch.Tensor:
    """Θ(log L)-depth suffix scan (reads ``off`` lanes ahead)."""
    L = x.shape[-1]
    off = 1
    while off < L:
        zeros = x.new_zeros(x.shape[:-1] + (off,))
        x = x + torch.cat([x[..., off:], zeros], dim=-1)
        off *= 2
    return x


def best_quotes(bid: torch.Tensor, ask: torch.Tensor, last_price):
    """Best bid/ask and mid price (paper Eq. 3).

    Returns (bb int32[M,1], ba int32[M,1], mid float32[M,1]); bb = -1 when no
    bids, ba = L when no asks; mid falls back to ``last_price``.
    """
    L = bid.shape[-1]
    levels = torch.arange(L, dtype=torch.int32, device=bid.device)
    bb = torch.where(bid > 0.0, levels, -1).amax(dim=-1, keepdim=True)
    ba = torch.where(ask > 0.0, levels, L).amin(dim=-1, keepdim=True)
    ok = (bb >= 0) & (ba < L)
    mid = torch.where(ok, (bb + ba).to(torch.float32) * 0.5,
                      torch.as_tensor(last_price, dtype=torch.float32))
    return bb.to(torch.int32), ba.to(torch.int32), mid


def clear(total_buy: torch.Tensor, total_ask: torch.Tensor,
          scan: str = "cumsum"):
    """Clear one step of the uniform-price call auction.

    ``scan`` is ``'cumsum'`` or ``'hillis-steele'`` (bitwise-identical for
    exact-integer books). Returns a dict with p_star int32[...,1], volume
    float32[...,1], new_bid/new_ask and traded_buy/traded_sell float32[...,L].
    """
    if scan == "hillis-steele":
        d_cum = hillis_steele_suffix(total_buy)
        s_cum = hillis_steele_prefix(total_ask)
    elif scan == "cumsum":
        d_cum = suffix_sum(total_buy)
        s_cum = prefix_sum(total_ask)
    else:
        raise ValueError(f"unknown scan {scan!r}")

    match = torch.minimum(d_cum, s_cum)  # executable volume V(p)
    # torch.argmax returns the first (lowest-price) maximizer: the paper's
    # tournament tie-break toward lower ticks.
    p_star = torch.argmax(match, dim=-1, keepdim=True)
    volume = torch.gather(match, -1, p_star)

    demand_above = d_cum - total_buy
    traded_buy = torch.minimum(total_buy,
                               torch.clamp(volume - demand_above, min=0.0))
    supply_below = s_cum - total_ask
    traded_sell = torch.minimum(total_ask,
                                torch.clamp(volume - supply_below, min=0.0))
    return {
        "p_star": p_star.to(torch.int32),
        "volume": volume,
        "new_bid": total_buy - traded_buy,
        "new_ask": total_ask - traded_sell,
        "traded_buy": traded_buy,
        "traded_sell": traded_sell,
    }
