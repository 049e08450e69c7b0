"""The plain references against the port on the CPU at a tiny size, and
their controls: the references in the precision below fail the check."""
import numpy as np
import pytest
import torch

from kbench.reference import market as rm
from kbench.reference import ppo as rp

from repro_torch.core.config import MarketConfig, scenario_config
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.session import Engine

MARKET = dict(q_max=8, p_marketable=0.1, noise_delta=8.0,
              maker_half_spread=2.0, alpha_maker=0.15, alpha_momentum=0.15,
              alpha_fundamentalist=0.0, fundamental_price=-1.0,
              fundamentalist_kappa=0.5, alpha_whale=0.0, alpha_hft=0.0,
              alpha_informed=0.0, alpha_arbitrageur=0.0, whale_size=32.0,
              whale_period=16, hft_threshold=0.2, informed_horizon=8,
              arb_kappa=0.5, shock_step=-1, shock_intensity=0.0,
              shock_cancel=0.0, initial_quote_qty=10.0, initial_spread=2)
M, A, L, S = 6, 40, 16, 30


def rows(seed, market=MARKET, n=M):
    return rm.Rows(torch.full((n, 1), seed), torch.arange(n)[:, None],
                   rm.columns(market, A, L, n, "cpu"))


@pytest.mark.parametrize("seed", [3, 2**32 - 5])
@pytest.mark.parametrize("stats_only", [False, True])
def test_market_reference_equals_the_port(seed, stats_only):
    cfg = MarketConfig(num_markets=M, num_agents=A, num_levels=L,
                       num_steps=S, seed=seed, **MARKET)
    eng = Engine("cuda-kinetic", device="cpu", stats_only=stats_only,
                 chunk_size=8)
    with eng.open(EnsembleSpec.homogeneous(cfg)) as sess:
        batch = sess.run(S)
        got = sess.stats if stats_only else batch.to_numpy()
    want = rm.simulate(rows(seed), A, L, S, stats_only=stats_only)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), w.numpy())


def test_every_scenario_archetype_but_coupling():
    presets = ["flash-crash", "high-vol", "whale", "hft", "informed",
               "wide-book", "thin-book"]
    fund = MarketConfig(alpha_fundamentalist=0.2, fundamental_price=70.0)
    spec = EnsembleSpec.from_scenarios(presets + [fund], num_markets=3,
                                       num_agents=A, num_levels=L,
                                       num_steps=S, seed=11)
    got = Engine("torch-scan", device="cpu").open(spec).run(S).to_numpy()
    cfgs = [scenario_config(n, num_steps=S) for n in presets] + [fund]
    parts = [rm.columns({k: getattr(c, k) for k in MARKET}, A, L, 3, "cpu")
             for c in cfgs]
    n = 3 * len(cfgs)
    r = rm.Rows(torch.full((n, 1), 11), torch.arange(n)[:, None],
                rm.stack_columns(parts))
    want = rm.simulate(r, A, L, S)
    assert all(np.array_equal(g, w.numpy()) for g, w in zip(got, want))
    control = rm.simulate(r, A, L, S, fdt=torch.bfloat16)
    assert sum(int((g != w.float().numpy()).sum())
               for g, w in zip(got, control)) > 0


def test_coupled_markets_are_refused():
    market = dict(MARKET, alpha_arbitrageur=0.1)
    with pytest.raises(ValueError):
        rm.simulate(rows(1, market), A, L, 4)


def test_bfloat16_control_keeps_ticks_on_a_wide_grid():
    r = rm.Rows(torch.full((4, 1), 9), torch.arange(4)[:, None],
                rm.columns(dict(MARKET, p_marketable=0.5), 8, 1024, 4,
                           "cpu"))
    out = rm.simulate(r, 8, 1024, 6, fdt=torch.bfloat16, stats_only=True)
    assert torch.isfinite(out.sum_volume).all()


def test_ppo_reference_equals_the_port_and_faults_read():
    from repro_torch.env import (InventoryPenalty, MarketFeatures,
                                 SpreadCapture, Sum)
    from repro_torch.train import PPOConfig
    from kbench.loops.ppo import clones

    seed, T = 123, 8
    spec = EnsembleSpec.from_scenarios(["flash-crash", "high-vol"],
                                       num_markets=4, num_agents=16,
                                       num_levels=16, num_steps=T, seed=seed)
    ppo = dict(rollout_len=T, num_envs=1, num_epochs=2, num_minibatches=2,
               hidden=(8, 8), lr=1e-3, seed=seed)
    tr = Engine("cuda-kinetic", device="cpu").trainer(
        spec, PPOConfig(**ppo),
        reward=Sum((SpreadCapture(), InventoryPenalty(0.001))),
        obs=MarketFeatures())
    ts = tr.init()
    p0 = clones(ts.params)
    ts, m = tr.train(ts, 3)
    prog = rp.Readings([float(x) for x in m["loss"]],
                       clones(ts.opt_state.mu), p0, clones(ts.params))
    parts = []
    for name in ("flash-crash", "high-vol"):
        c = scenario_config(name, num_steps=T)
        parts.append(rm.columns({k: getattr(c, k) for k in MARKET}, 16, 16,
                                4, "cpu"))
    r = rm.Rows(torch.full((8, 1), seed), torch.arange(8)[:, None],
                rm.stack_columns(parts))
    s = rp.Settings(num_agents=16, num_levels=16, horizon=T, rollout_len=T,
                    num_epochs=2, num_minibatches=2, gamma=0.99,
                    gae_lambda=0.95, clip_eps=0.2, vf_coef=0.5,
                    ent_coef=0.01, lr=1e-3, max_grad_norm=0.5, hidden=(8, 8),
                    k_max=3, qty=1.0, inventory_weight=0.001, seed=seed)
    clean = rp.train(r, s, 3)
    assert rp.compare(prog, clean) == {"loss_rel_gap": 0.0,
                                       "moment_gap": 0.0,
                                       "param_change_gap": 0.0}
    for mode in ("unchanged", "half_batch", "reward"):
        got = rp.compare(rp.train(r, s, 3, mode=mode), clean)
        assert max(got.values()) > 1e-2, (mode, got)
