"""The port's roofline (``repro_torch.launch.roofline``) against
``repro.launch.hlo_analysis`` and against closed forms.

Flops follow ``repro``'s rules and are held to ``repro``'s analyzer on the
same numpy-seeded inputs: a 16-step matmul loop (``repro`` reads its
``lax.scan`` with the trip count, the port counts each iteration as it
runs) and an MLP forward. Bytes are eager's: every op reads its operands
and writes its result, where XLA fuses, so they are held to closed forms,
not to ``repro``'s fused count. Kernel calls are held to the wrappers'
``op_count``/``byte_count`` and launch counts, transfers to the closed form
of the resident shards (the ring of mids and the joined paths), and every result under the recorder to the result
without it (and to ``repro``'s) with ``==``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import MarketConfig as JConfig
from repro.core.session import Engine as JEngine
from repro.launch import hlo_analysis
from repro_torch.core import params as params_mod
from repro_torch.core.config import MarketConfig
from repro_torch.core.params import EnsembleSpec, PackedParams
from repro_torch.core.session import Engine
from repro_torch.core.step import initial_state
from repro_torch.env import MarketFeatures, rollout
from repro_torch.kernels import kinetic_clearing as kc
from repro_torch.kernels import naive_clearing as nc
from repro_torch.launch import (HW, MarketsMesh, Roofline, analyze, bound,
                                set_host_device_count, summarize,
                                top_contributors)
from repro_torch.launch import roofline
from repro_torch.train import PPOConfig, make_market_maker

#: A small ensemble with arbitrageurs and whales (every call's mix counts).
CFG = dict(num_markets=10, num_agents=16, num_levels=16, num_steps=20,
           seed=3, alpha_arbitrageur=0.2, alpha_whale=0.1, whale_period=3)
CHUNK = 6
#: ``kinetic_clearing.NUM_PARAM_OPERANDS``: the packed params' columns.
PARAM_COLS = kc.NUM_PARAM_OPERANDS


def _spec(**kw):
    return EnsembleSpec.homogeneous(MarketConfig(**{**CFG, **kw}))


def _mix(spec, rows=slice(None)):
    return kc.agent_mix(params_mod.MarketParams(
        *(np.asarray(c)[rows] for c in spec.params)), spec.num_agents)


def _chunks(steps, chunk=CHUNK):
    return [min(chunk, steps - s) for s in range(0, steps, chunk)]


# ---------------------------------------------------------------------------
# Against repro.launch.hlo_analysis.
# ---------------------------------------------------------------------------

def test_matmul_loop_flops_match_repro():
    """16 steps of ``c @ w`` at [128, 128]: the port counts 16·2·128³
    exactly; ``repro`` reads the ``lax.scan`` with its trip count, within
    1% of it, and both compute the same product."""
    n, steps = 128, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, n), dtype=np.float32)
    w = (rng.standard_normal((n, n)) / np.sqrt(n)).astype(np.float32)

    def port(x, w):
        c = x
        for _ in range(steps):
            c = c @ w
        return c

    def jloop(x, w):
        out, _ = jax.lax.scan(lambda c, _: (c @ w, None), x, None,
                              length=steps)
        return out

    with Roofline() as rf:
        got = port(torch.from_numpy(x), torch.from_numpy(w))
    ours = rf.summarize()
    assert ours["flops"] == steps * 2 * n ** 3
    assert ours["hbm_bytes"] == steps * 3 * n * n * 4
    theirs = hlo_analysis.summarize(jax.jit(jloop).lower(x, w).compile()
                                    .as_text())
    assert abs(ours["flops"] / theirs["flops"] - 1) < 0.01
    want = np.asarray(jax.jit(jloop)(x, w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("bias", [False, True])
def test_mlp_forward_flops_equal_repro(bias):
    """B=4096, 24→32→32→9, tanh: the port's flops equal ``repro``'s with
    ``==`` (dots, plus one flop an element of every tanh and bias add,
    which ``repro`` counts inside the fusions)."""
    rng = np.random.default_rng(1)
    dims = (24, 32, 32, 9)
    x = rng.standard_normal((4096, dims[0]), dtype=np.float32)
    layers = [((rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
               rng.standard_normal(b, dtype=np.float32) if bias else None)
              for a, b in zip(dims, dims[1:])]

    def mlp(x, layers, tanh):
        for k, (w, b) in enumerate(layers):
            x = x @ w if b is None else x @ w + b
            if k < len(layers) - 1:
                x = tanh(x)
        return x

    with Roofline() as rf:
        got = mlp(torch.from_numpy(x),
                  [(torch.from_numpy(w), None if b is None else
                    torch.from_numpy(b)) for w, b in layers], torch.tanh)
    theirs = hlo_analysis.summarize(jax.jit(
        lambda x, ls: mlp(x, ls, jnp.tanh)).lower(x, layers).compile()
        .as_text())
    dots = 2 * 4096 * sum(a * b for a, b in zip(dims, dims[1:]))
    adds = 4096 * sum(dims[1:]) if bias else 0
    assert rf.summarize()["flops"] == theirs["flops"] == \
        dots + 4096 * (32 + 32) + adds
    if not bias:
        assert theirs["flops"] == 17_301_504
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(
        lambda x, ls: mlp(x, ls, jnp.tanh))(x, layers)), rtol=1e-5,
        atol=1e-5)


def test_repro_keys_and_the_port_s_own():
    a = torch.ones(4, 8)
    r = analyze(torch.add, a, a)
    for kind in hlo_analysis.COLLECTIVES + ("scatter", "gather"):
        assert r["coll_" + kind] == 0 and r["cnt_" + kind] == 0
    assert (r["flops"], r["bytes"], r["wire"]) == (32, 3 * 32 * 4, 0)
    s = summarize(torch.add, a, a)
    theirs = hlo_analysis.summarize("ENTRY %main () -> f32[] {\n}\n")
    assert set(theirs) <= set(s)
    assert set(s["collective_breakdown"]) == set(
        theirs["collective_breakdown"]) | {"scatter", "gather"}
    assert s["per_device"] == {0: dict(device="cpu", flops=32,
                                       operations=32, bytes=384, wire=0,
                                       wire_no_link=0)}
    assert s["kernels"] == {} and s["aten_calls"] == 1
    assert top_contributors(torch.add, a, a, key="flops") == [
        (32, 1, "aten.add.Tensor", "aten")]


# ---------------------------------------------------------------------------
# The counting rules, each on a small case.
# ---------------------------------------------------------------------------

def _record(fn):
    with Roofline() as rf:
        fn()
    return rf.summarize()


def test_views_and_unmoved_to_are_free():
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    s = _record(lambda: (x.view(6, 4), x.t(), x[None].expand(3, 4, 6),
                         x.detach(), x[1:3, ::2], x.reshape(24),
                         x.to(torch.float32), x.unsqueeze(0), x.T[2]))
    assert s["aten_calls"] == 0 and s["hbm_bytes"] == 0 and s["flops"] == 0


def test_elementwise_reads_operands_and_writes_the_result():
    a, row = torch.ones(8, 16), torch.ones(1, 16)
    s = _record(lambda: a * row)          # the row is read once
    assert (s["flops"], s["hbm_bytes"]) == (128, (128 + 16 + 128) * 4)
    s = _record(lambda: a.sum(dim=1))     # one flop an output element
    assert (s["flops"], s["hbm_bytes"]) == (8, (128 + 8) * 4)
    b = torch.zeros(8, 16)
    s = _record(lambda: b.copy_(a))       # the destination is not read
    assert (s["flops"], s["hbm_bytes"]) == (128, 2 * 128 * 4)


@pytest.mark.parametrize("case", ["index", "gather", "index_select",
                                  "slice_copy"])
def test_slicing_ops_charge_the_sliced_bytes(case):
    x = torch.arange(64 * 32, dtype=torch.float32).reshape(64, 32)
    idx = torch.tensor([3, 1, 7])
    fn = {"index": lambda: x[idx],
          "gather": lambda: torch.gather(x, 1, torch.zeros(64, 2,
                                                           dtype=torch.long)),
          "index_select": lambda: torch.index_select(x, 0, idx),
          "slice_copy": lambda: torch.slice_copy(x, 1, 4, 9)}[case]
    with Roofline() as rf:
        out = fn()
    recs = [r for r in rf.top_contributors() if r[3] == "aten"]
    mine = [r for r in recs if case in r[2] and "zeros" not in r[2]]
    assert len(mine) == 1 and mine[0][0] == out.numel() * 4
    assert rf.top_contributors("flops")[0][0] == 64 * 2 * ("gather" == case)


@pytest.mark.parametrize("case", ["index_put_", "scatter_add_",
                                  "scatter_value", "index_add_"])
def test_updates_charge_twice_the_update(case):
    x = torch.zeros(64, 32)
    idx = torch.tensor([3, 1, 7])
    src = torch.ones(3, 32)
    sidx = torch.zeros(2, 32, dtype=torch.long)
    fn, update = {
        "index_put_": (lambda: x.index_put_((idx,), src), src),
        "scatter_add_": (lambda: x.scatter_add_(0, sidx, src[:2]), src[:2]),
        "scatter_value": (lambda: x.scatter_(0, sidx, 2.0), sidx[:, :]),
        "index_add_": (lambda: x.index_add_(0, idx, src), src)}[case]
    s = _record(fn)
    assert s["flops"] == 0 and s["aten_calls"] == 1
    assert s["hbm_bytes"] == 2 * update.numel() * 4


def test_backward_dots_are_counted_and_marked():
    """``(a @ b).sum()``'s backward: two dots of the forward's size, marked
    ``(backward)``; the dispatch mode reaches autograd's engine."""
    M, K, N = 16, 8, 4
    a = torch.randn(M, K, requires_grad=True)
    b = torch.randn(K, N, requires_grad=True)
    with Roofline() as rf:
        (a @ b).sum().backward()
    dots = {r[2]: r for r in rf.top_contributors("flops")
            if "aten.mm" in r[2]}
    assert dots["aten.mm.default"][:2] == (2 * M * K * N, 1)
    assert dots["aten.mm.default (backward)"][:2] == (4 * M * K * N, 2)
    x = torch.randn(5, K)
    lin = torch.nn.Linear(K, N)
    s = _record(lambda: lin(x))                 # addmm: the bias is free
    assert s["flops"] == 2 * 5 * K * N
    assert s["operations"] == 5 * K * N         # one FMA a slot
    p, q = torch.ones(3, 5, K), torch.ones(3, K, N)
    s = _record(lambda: torch.bmm(p, q))
    assert s["flops"] == 2 * 3 * 5 * K * N


def test_bound_takes_the_largest_time():
    assert HW["peak_lane_ops"] == HW["peak_flops_fp32"] / 2 == 33.5e12
    b = bound(33.5e9, 3.35e9)                    # 1 ms each: operations
    assert b == dict(ops=33.5e9, bytes=3.35e9, wire=0, bound_ms=1.0,
                     bound_by="operations")
    assert bound(1, 6.7e9)["bound_by"] == "bytes"
    w = bound(1, 1, wire=900e6)
    assert (w["bound_by"], w["bound_ms"]) == ("wire", 2.0)
    # Table IV, one 64-step chunk: the kernel rows' bound, 0.7228 ms.
    spec = EnsembleSpec.homogeneous(MarketConfig(
        num_markets=8192, num_agents=256, num_levels=128, num_steps=500,
        seed=20260611))
    t4 = bound(kc.op_count(8192, 256, 128, 64, _mix(spec)),
               kc.byte_count(8192, 128, 64, ext=False, stats_only=False))
    assert t4["bound_by"] == "operations" and \
        round(t4["bound_ms"], 4) == 0.7228
    assert t4["bytes"] == 23_986_176


# ---------------------------------------------------------------------------
# Kernel calls.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,entry", [
    ("cuda-kinetic", "kinetic_clearing_chunk"),
    ("cuda-naive", "naive_clearing_chunk")])
@pytest.mark.parametrize("stats_only", [False, True])
def test_session_kernel_records(backend, entry, stats_only):
    """A CPU session's chunk calls, as the card records them: calls,
    launches, ``op_count`` and ``byte_count`` summed over the chunks."""
    spec = _spec()
    with Engine(backend, device="cpu", chunk_size=CHUNK,
                stats_only=stats_only).open(spec) as s:
        with Roofline() as rf:
            s.run(spec.num_steps)
    M, A, L = spec.num_markets, spec.num_agents, spec.num_levels
    count = kc.byte_count if entry == "kinetic_clearing_chunk" \
        else nc.byte_count
    steps = _chunks(spec.num_steps)
    got = rf.summarize()["kernels"]
    assert got == {entry: dict(
        calls=len(steps),
        launches=len(steps) if entry == "kinetic_clearing_chunk"
        else spec.num_steps,
        operations=sum(kc.op_count(M, A, L, n, _mix(spec)) for n in steps),
        bytes=sum(count(M, L, n, ext=False, stats_only=stats_only)
                  for n in steps))}


@pytest.mark.parametrize("entry", ["kinetic_clearing", "naive_clearing"])
def test_legacy_entry_records(entry):
    cfg = MarketConfig(**CFG)
    fn, count = {"kinetic_clearing": (kc.kinetic_clearing,
                                      kc.legacy_byte_count),
                 "naive_clearing": (nc.naive_clearing,
                                    nc.legacy_byte_count)}[entry]
    state = initial_state(cfg, "cpu")
    with Roofline() as rf:
        got = fn(*state, cfg=cfg)
    M, A, L, S = 10, 16, 16, 20
    mix = kc.agent_mix(params_mod.params_from_config(cfg, M), A)
    assert rf.summarize()["kernels"] == {entry: dict(
        calls=1, launches=1 if entry == "kinetic_clearing" else S,
        operations=kc.op_count(M, A, L, S, mix), bytes=count(M, L, S))}
    assert rf.summarize()["aten_calls"] == 0   # the plain version's ops
    want = fn(*state, cfg=cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_env_step_records_carry_the_external_orders():
    spec = _spec()
    env = Engine("cuda-kinetic", device="cpu").env(spec)
    with Roofline() as rf:
        rollout(env, make_market_maker(spec.num_levels), 5)
    M, A, L = spec.num_markets, spec.num_agents, spec.num_levels
    assert rf.summarize()["kernels"] == {"kinetic_clearing_chunk": dict(
        calls=5, launches=5, operations=5 * kc.op_count(M, A, L, 1,
                                                        _mix(spec)),
        bytes=5 * kc.byte_count(M, L, 1, ext=True, stats_only=False))}


def test_swapped_markets_are_charged_their_own_agents():
    """After ``swap_markets`` a call runs the new rows' archetypes, and its
    record counts them (from the params' host copy, no device read)."""
    spec = _spec()
    sub = EnsembleSpec.homogeneous(MarketConfig(**{
        **CFG, "num_markets": 3, "alpha_arbitrageur": 0.0,
        "alpha_whale": 0.0, "alpha_hft": 0.5}))
    with Engine("cuda-kinetic", device="cpu",
                chunk_size=CHUNK).open(spec) as s:
        s.swap_markets([1, 4, 8], sub)
        with Roofline() as rf:
            s.run(CHUNK)
        swapped = s.spec
    M, A, L = spec.num_markets, spec.num_agents, spec.num_levels
    assert _mix(swapped) != _mix(spec)
    assert rf.summarize()["kernels"]["kinetic_clearing_chunk"][
        "operations"] == kc.op_count(M, A, L, CHUNK, _mix(swapped))


def test_a_failing_hook_raises_and_an_idle_one_does_nothing():
    spec = _spec()
    state = initial_state(spec, "cpu")
    packed = params_mod.pack_params(spec.params, "cpu")
    bare = PackedParams(packed.floats.clone(), packed.ints.clone())
    kw = dict(cfg=spec, chunk=4, params=bare)
    out = kc.kinetic_clearing_chunk(*state, 0, 4, **kw)   # no recorder
    with Roofline() as rf:
        with pytest.raises(LookupError, match="host copy"):
            kc.kinetic_clearing_chunk(*state, 0, 4, **kw)
    assert rf.summarize()["kernels"] == {}
    assert len(out) == 7 and not roofline._ACTIVE


def test_recorders_nest():
    spec = _spec()
    state = initial_state(spec, "cpu")
    kw = dict(cfg=spec, chunk=4,
              params=params_mod.pack_params(spec.params, "cpu"))
    with Roofline() as outer:
        torch.ones(3) + 1
        with Roofline() as inner:
            kc.kinetic_clearing_chunk(*state, 0, 4, **kw)
    assert inner.summarize()["kernels"] == outer.summarize()["kernels"]
    assert inner.summarize()["aten_calls"] == 0
    assert outer.summarize()["aten_calls"] == 2


# ---------------------------------------------------------------------------
# Sharded runs: per device, and the bytes of the cut.
# ---------------------------------------------------------------------------

@pytest.fixture
def host_devices():
    prev = set_host_device_count(3)
    yield
    set_host_device_count(prev)


def _rows(M, shards):
    base, extra = divmod(M, shards)
    return [base + (k < extra) for k in range(shards)]


def _sharded(shards, stats_only=False):
    spec = _spec()
    mesh = MarketsMesh.of(["cpu"] * shards)
    with Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK, mesh=mesh,
                stats_only=stats_only).open(spec) as s:
        with Roofline() as rf:
            batch = s.run(spec.num_steps)
        out = list(s.state) + ([torch.from_numpy(x) for x in s.stats]
                               if stats_only else list(batch))
    return spec, rf.summarize(), out


@pytest.mark.parametrize("shards", [2, 3])
@pytest.mark.parametrize("stats_only", [False, True])
def test_sharded_totals_sum_to_unsharded(host_devices, shards, stats_only):
    """The rows stay on their shards: a chunk moves the entry mids round
    the ring, (n-1)·M·4 bytes, and a run joins only the paths it returns,
    rows of shards 1.. x steps x 12 bytes (none with ``stats_only``);
    nothing is placed."""
    spec, one, want = _sharded(1, stats_only)
    _, many, got = _sharded(shards, stats_only)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert sorted(many["per_device"]) == list(range(shards))
    for key, total in (("flops", "flops"), ("operations", "operations"),
                       ("bytes", "hbm_bytes")):
        assert sum(d[key] for d in many["per_device"].values()) == \
            one[total] == many[total]
    calls = len(_chunks(spec.num_steps))
    assert many["kernels"]["kinetic_clearing_chunk"] == dict(
        one["kernels"]["kinetic_clearing_chunk"],
        calls=shards * calls, launches=shards * calls)
    M, S = spec.num_markets, spec.num_steps
    rows = _rows(M, shards)
    ring = calls * (shards - 1) * M * 4
    back = 0 if stats_only else sum(rows[1:]) * S * 3 * 4
    moved = many["collective_breakdown"]
    assert moved["scatter"] == 0
    assert moved["collective-permute"] == ring
    assert many["collective_counts"]["collective-permute"] == \
        calls * (shards - 1) * shards
    # Each hop k -> k+1 carries every part but shard k+1's own.
    assert many["collective_routes"] == {
        (k, (k + 1) % shards): calls * (M - rows[(k + 1) % shards]) * 4
        for k in range(shards)}
    assert moved["gather"] == back
    assert many["collective_wire_bytes"] == ring + back
    assert many["wire_no_link"] == ring + back     # one host: no link
    assert sum(d["wire"] for d in many["per_device"].values()) == ring + back
    for kind in hlo_analysis.COLLECTIVES:
        if kind != "collective-permute":
            assert moved[kind] == 0
    assert one["collective_wire_bytes"] == 0       # 1 shard: nothing moves


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_env_step_moves_orders_mids_and_what_the_caller_reads(
        host_devices, shards):
    """The env's state stays on its shards: after ``reset`` a step places
    only the [M] order triple (the scripted maker's bool side, int32 tick
    and f32 lots: 9 bytes a market), sends the mids round the ring, and
    joins only what the caller reads from shards 1..: the [M, D]
    observation, the [M] reward and the five StepInfo columns, every step
    (no book, scalar or params byte), beside the opening observation a
    resumed rollout reads once. The per-device work sums to the total,
    which is no less than the unsharded env's: each shard repeats the
    small set-up ops of a call (the level grid of the orders, the peer
    resolution)."""
    spec = _spec()
    M, L = spec.num_markets, spec.num_levels
    D, steps = MarketFeatures().size(spec), 3
    runs = {}
    for n in (1, shards):
        env = Engine("cuda-kinetic", device="cpu",
                     mesh=MarketsMesh.of(["cpu"] * n)).env(spec)
        state, _ = env.reset()
        with Roofline() as rf:
            final, batch = rollout(env, make_market_maker(L), steps,
                                   state=state)
        runs[n] = (rf.summarize(), batch)
    (one, want), (many, got) = runs[1], runs[shards]
    for g, w in zip(got[:8], want[:8]):
        assert torch.equal(g, w)
    moved = many["collective_breakdown"]
    joined = sum(_rows(M, shards)[1:])
    assert moved["scatter"] == steps * M * 9
    assert moved["collective-permute"] == steps * (shards - 1) * M * 4
    assert moved["gather"] == joined * 4 * D \
        + steps * joined * (4 * D + 4 + 5 * 4)
    for kind in hlo_analysis.COLLECTIVES:
        if kind != "collective-permute":
            assert moved[kind] == 0
    assert one["collective_wire_bytes"] == 0
    assert many["kernels"]["kinetic_clearing_chunk"]["calls"] == \
        shards * steps
    for key in ("flops", "operations"):
        assert sum(d[key] for d in many["per_device"].values()) == \
            many[key] >= one[key]


# ---------------------------------------------------------------------------
# The recorder changes no result.
# ---------------------------------------------------------------------------

def test_results_under_the_recorder_equal_those_without():
    spec = _spec()
    jspec = JConfig(**CFG)
    eng = Engine("cuda-kinetic", device="cpu", chunk_size=CHUNK)
    runs = []
    for record in (False, True):
        with eng.open(spec) as s:
            if record:
                with Roofline():
                    batch = s.run(spec.num_steps)
            else:
                batch = s.run(spec.num_steps)
            runs.append([x.numpy() for x in list(batch) + list(s.state)])
    with JEngine("numpy", chunk_size=CHUNK).open(jspec) as s:
        jbatch = s.run(jspec.num_steps).to_numpy()
        repro = list(jbatch) + [np.asarray(s.snapshot()[f]) for f in
                                ("bid", "ask", "last_price", "prev_mid")]
    for got, plain, theirs in zip(runs[1], runs[0], repro):
        assert np.array_equal(got, plain)
        assert np.array_equal(got, theirs)


def test_trainer_update_under_the_recorder_equals_without():
    """One PPO update on ``cuda-kinetic`` (CPU): equal params, metrics and
    env state with and without the recorder; the rollout's kernel calls
    recorded, the update's backward dots counted."""
    spec = _spec()
    cfg = PPOConfig(rollout_len=4, num_envs=1, num_epochs=2,
                    num_minibatches=2, hidden=(8, 8))
    tr = Engine("cuda-kinetic", device="cpu").trainer(
        spec, cfg, obs=MarketFeatures())
    ts = tr.init()
    plain, metrics = tr.train(ts, 1)
    with Roofline() as rf:
        recorded, rmetrics = tr.train(ts, 1)
    for g, w in zip(torch.utils._pytree.tree_leaves(recorded.params),
                    torch.utils._pytree.tree_leaves(plain.params)):
        assert torch.equal(g, w)
    for k in metrics:
        assert torch.equal(rmetrics[k], metrics[k])
    for g, w in zip(recorded.env_state.market, plain.env_state.market):
        assert torch.equal(g, w)
    s = rf.summarize()
    assert s["kernels"]["kinetic_clearing_chunk"]["calls"] == 4
    backward = sum(r[0] for r in rf.top_contributors("flops", 1000)
                   if r[2].startswith("aten.mm") and "backward" in r[2])
    assert backward > 0


def test_a_capture_records_on_its_tape_and_each_replay_reports_it():
    """Under ``roofline.capturing()`` the recorders around see nothing;
    the tape records the block it is entered around, and each
    ``roofline.replay(tape)`` adds the tape's records once, kernel calls,
    aten ops and transfers alike, as a CUDA graph's replays run its
    capture's work."""
    from repro_torch.launch import roofline as rl

    def work():
        x = torch.arange(12, dtype=torch.float32).reshape(3, 4)
        with rl.kernel_call("k", "cpu", lambda: (7, 11, 2)):
            (x * 2).sum()
        rl.transfer("gather", 0, "cpu", [x])
        return (x + 1).sum()

    with Roofline() as alone:
        work()
    with Roofline() as outer:
        with rl.capturing() as tape:
            torch.ones(3) + 1            # outside the tape: nowhere
            with tape:
                work()
        assert outer.summarize()["aten_calls"] == 0
        assert outer.summarize()["kernels"] == {}
        for _ in range(2):
            rl.replay(tape)
    want, got = alone.summarize(), outer.summarize()
    assert tape.summarize() == want
    assert got["kernels"] == {"k": dict(calls=2, launches=4, operations=14,
                                        bytes=22)}
    for key in ("aten_calls", "flops", "operations", "hbm_bytes",
                "collective_wire_bytes"):
        assert got[key] == 2 * want[key], key
