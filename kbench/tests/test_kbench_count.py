"""The kernel's yardstick: a pure function of the shapes and the mix."""
import pytest

from kbench import count
from kbench.reference import market as ref


def table4_mix(M=8192, A=256):
    counts = ref.agent_counts({"alpha_maker": 0.15, "alpha_momentum": 0.15},
                              A)
    return count.mix_of(counts, M, A)


def test_table4_counts():
    mix = table4_mix()
    assert mix[count.MAKER] == mix[count.MOMENTUM] == 38 * 8192
    assert mix[count.NOISE] == 180 * 8192
    ops = count.ensemble_ops(8192, 256, 128, 500, mix)
    # 180 noise, 38 momentum and 38 maker agents a market, 128 levels.
    per_market_step = (180 * count.agent_step_ops(count.NOISE)
                       + 38 * count.agent_step_ops(count.MOMENTUM)
                       + 38 * count.agent_step_ops(count.MAKER)
                       + 128 * count.LEVEL_STEP + count.MARKET_STEP)
    assert ops == 500 * 8192 * per_market_step + 8192 * 256 \
        * count.AGENT_ONCE
    assert 7e10 < ops < 1e11
    b = count.ensemble_bytes(8192, 128, 500, 64)
    assert b == 7 * count.call_bytes(8192, 128, 64, stats_only=False) \
        + count.call_bytes(8192, 128, 52, stats_only=False)
    # compute-bound at Table IV
    assert count.least_seconds(ops, b) == ops / count.PEAK_OPS_PER_S


def test_linear_in_steps_and_markets():
    mix = table4_mix(M=4, A=16)
    one = count.ensemble_ops(4, 16, 16, 1, mix)
    ten = count.ensemble_ops(4, 16, 16, 10, mix)
    once = 4 * 16 * count.AGENT_ONCE
    assert ten - once == 10 * (one - once)
    mix8 = table4_mix(M=8, A=16)
    assert count.ensemble_ops(8, 16, 16, 10, mix8) == 2 * ten
    assert count.ensemble_ops(4, 16, 16, 10, mix, stats_only=True) == \
        ten + 10 * 4 * count.STATS_STEP


def test_mix_must_cover_every_agent():
    with pytest.raises(ValueError):
        count.ensemble_ops(4, 16, 16, 10, {count.NOISE: 3})


def test_stats_only_moves_fewer_bytes():
    full = count.ensemble_bytes(8192, 1024, 500, 64)
    stats = count.ensemble_bytes(8192, 1024, 500, 64, stats_only=True)
    assert stats < full
    assert count.call_bytes(1, 4, 2, stats_only=False) == \
        (2 * 2 * 4 + 6 + 22 + 3 * 2) * 4
