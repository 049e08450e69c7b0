"""Uniform-price call-auction clearing (paper §II-A, §IV-C) in NumPy.

Orders with limits strictly better than the clearing price fill first; the
marginal level p* is rationed (the closed form of the paper's
priority-based allocation).
"""
from __future__ import annotations

import numpy as np


def prefix_sum(x):
    """Inclusive prefix sum over the last axis (cumulative supply)."""
    return np.cumsum(x, axis=-1, dtype=x.dtype)


def suffix_sum(x):
    """Inclusive suffix sum over the last axis (cumulative demand)."""
    return np.flip(np.cumsum(np.flip(x, axis=-1), axis=-1, dtype=x.dtype),
                   axis=-1)


def hillis_steele_prefix(x):
    """Θ(log L)-depth Hillis–Steele inclusive prefix scan (paper §III-D):
    at each stride ``off`` every lane adds the value ``off`` lanes behind
    it. Exact-integer float adds make it equal to ``cumsum`` bit for bit."""
    L = x.shape[-1]
    off = 1
    while off < L:
        shifted = np.concatenate(
            [np.zeros(x.shape[:-1] + (off,), dtype=x.dtype), x[..., :-off]],
            axis=-1,
        )
        x = x + shifted
        off *= 2
    return x


def hillis_steele_suffix(x):
    """Θ(log L)-depth suffix scan (reads ``off`` lanes ahead)."""
    L = x.shape[-1]
    off = 1
    while off < L:
        shifted = np.concatenate(
            [x[..., off:], np.zeros(x.shape[:-1] + (off,), dtype=x.dtype)],
            axis=-1,
        )
        x = x + shifted
        off *= 2
    return x


def best_quotes(bid, ask, last_price):
    """Best bid/ask and mid price (paper Eq. 3).

    Returns (bb int32[M,1], ba int32[M,1], mid float32[M,1]); bb = -1 when no
    bids, ba = L when no asks; mid falls back to last_price.
    """
    L = bid.shape[-1]
    levels = np.arange(L, dtype=np.int32)
    has_bid = bid > np.float32(0.0)
    has_ask = ask > np.float32(0.0)
    bb = np.max(np.where(has_bid, levels, np.int32(-1)), axis=-1,
                keepdims=True)
    ba = np.min(np.where(has_ask, levels, np.int32(L)), axis=-1,
                keepdims=True)
    ok = (bb >= np.int32(0)) & (ba < np.int32(L))
    mid = np.where(
        ok,
        (bb + ba).astype(np.float32) * np.float32(0.5),
        np.asarray(last_price, dtype=np.float32),
    )
    return bb, ba, mid


def clear(total_buy, total_ask, scan="cumsum"):
    """Clear one step of the uniform-price call auction.

    ``total_buy``/``total_ask`` are the float32[..., L] aggregate books;
    ``scan`` is ``"cumsum"`` or ``"hillis-steele"`` (equal bit for bit on
    exact-integer books). Returns a dict with p_star int32[..., 1], volume
    float32[..., 1], new_bid/new_ask and traded_buy/traded_sell
    float32[..., L].
    """
    f32 = np.float32
    if scan == "hillis-steele":
        d_cum = hillis_steele_suffix(total_buy)
        s_cum = hillis_steele_prefix(total_ask)
    else:
        d_cum = suffix_sum(total_buy)
        s_cum = prefix_sum(total_ask)

    match = np.minimum(d_cum, s_cum)  # executable volume V(p)
    # argmax returns the first (lowest-price) maximizer: the paper's
    # tie-break toward lower ticks.
    p_star = np.argmax(match, axis=-1).astype(np.int32)[..., None]
    volume = np.take_along_axis(match, p_star, axis=-1)

    # Priority allocation: demand strictly above p is d_cum[p] - buy[p];
    # traded_buy[p] = min(buy[p], max(0, V - demand_above_p)).
    zero = f32(0.0)
    demand_above = d_cum - total_buy
    traded_buy = np.minimum(total_buy, np.maximum(zero, volume - demand_above))
    supply_below = s_cum - total_ask
    traded_sell = np.minimum(total_ask,
                             np.maximum(zero, volume - supply_below))

    new_bid = total_buy - traded_buy
    new_ask = total_ask - traded_sell
    return {
        "p_star": p_star,
        "volume": volume,
        "new_bid": new_bid,
        "new_ask": new_ask,
        "traded_buy": traded_buy,
        "traded_sell": traded_sell,
    }
