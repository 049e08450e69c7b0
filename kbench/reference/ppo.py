"""Plain PyTorch reference of PPO over the market env.

The market-maker env (one external limit order a market each step,
lowered onto the book after the agents' flow; price-priority fills; the
spread-capture reward less an inventory penalty; the five market features
as the observation; an auto-reset at the horizon), an actor-critic MLP
over a quote grid whose actions are drawn by Gumbel-max over the counter
hash, GAE, the clipped PPO loss and a bias-corrected Adam with a global
norm clip. It restates the semantics from plain numbers (the market
columns, the seeds, the PPO settings) with ``torch`` and
:mod:`kbench.reference.market` alone.

``train(..., mode=...)`` runs it as stated (``"float32"``: float32 with
TF32 off), as the control (``"tf32"``: the matrix products in TF32, the
nearest precision below), or with one planted fault: ``"unchanged"`` (an
update that returns its state as it was), ``"half_batch"`` (each
minibatch's loss over its first half only) or ``"reward"`` (one market's
reward altered at every step).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch
from torch import nn

from kbench.reference import market as mk

MODES = ("float32", "tf32", "unchanged", "half_batch", "reward")
ACTIONS_SALT, MINIBATCH_SALT = 1, 2


def hash_int(seed: int, gid: int, step: int, channel: int) -> int:
    """``kinetic_hash32`` of four Python ints."""
    x = torch.tensor([(seed & mk.MASK) ^ mk.GOLDEN], dtype=torch.int64)
    for v, k in ((gid, mk.K_GID), (step, mk.K_STEP), (channel, mk.K_CHAN)):
        x = mk.absorb(x, v & mk.MASK, k)
    return int(x[0])


def key_word(seed: int, salt: int) -> int:
    """A draw stream's 32-bit seed from the key ``(0, seed)``."""
    return hash_int(0, seed & mk.MASK, salt, 0)


def init_params(seed: int, obs_dim: int, num_actions: int, hidden,
                device) -> Dict:
    """Orthogonal weights (gains sqrt(2), 0.01, 1) drawn on the CPU from a
    generator seeded with ``seed``, and zero biases."""
    gen = torch.Generator(device="cpu").manual_seed(int(seed))

    def dense(n_in, n_out, gain):
        w = torch.empty((n_in, n_out), dtype=torch.float32)
        nn.init.orthogonal_(w, gain=gain, generator=gen)
        return [w.to(device), torch.zeros(n_out, device=device)]

    torso, n_in = [], obs_dim
    for n_out in hidden:
        torso.append(dense(n_in, n_out, float(np.sqrt(2.0))))
        n_in = n_out
    return {"torso": torso, "pi": dense(n_in, num_actions, 0.01),
            "v": dense(n_in, 1, 1.0)}


def leaves(p: Dict) -> List[torch.Tensor]:
    """The leaves in the trainer's order: keys sorted (pi, torso, v),
    each layer's weight then bias."""
    out = list(p["pi"])
    for layer in p["torso"]:
        out += list(layer)
    return out + list(p["v"])


def rebuild(p: Dict, flat: List[torch.Tensor]) -> Dict:
    it = iter(flat)
    pi = [next(it), next(it)]
    torso = [[next(it), next(it)] for _ in p["torso"]]
    return {"pi": pi, "torso": torso, "v": [next(it), next(it)]}


def mlp(p: Dict, obs):
    x = obs
    for w, b in p["torso"]:
        x = torch.tanh(x @ w + b)
    return x @ p["pi"][0] + p["pi"][1], (x @ p["v"][0] + p["v"][1])[..., 0]


def log_prob(logits, action):
    logp = torch.log_softmax(logits, dim=-1)
    onehot = action[..., None].to(torch.int64) == torch.arange(
        logits.shape[-1], device=logits.device)
    return torch.where(onehot, logp, 0.0).sum(dim=-1)


def entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def features(books: mk.Books, mid, volume):
    """[mid, spread, imbalance, last price, volume] of the books after a
    step and the step's output."""
    L = books.bid.shape[-1]
    levels = torch.arange(L, device=mid.device)[None, :]
    bb = torch.where(books.bid > 0.0, levels, -1).amax(-1, keepdim=True)
    ba = torch.where(books.ask > 0.0, levels, L).amin(-1, keepdim=True)
    db = books.bid.sum(-1, keepdim=True)
    da = books.ask.sum(-1, keepdim=True)
    imb = (db - da) / torch.clamp_min(db + da, 1.0)
    return torch.cat([mid, (ba - bb).to(torch.float32), imb, books.last,
                      volume], dim=-1)


class Settings(NamedTuple):
    num_agents: int
    num_levels: int
    horizon: int
    rollout_len: int
    num_epochs: int
    num_minibatches: int
    gamma: float
    gae_lambda: float
    clip_eps: float
    vf_coef: float
    ent_coef: float
    lr: float
    max_grad_norm: float
    hidden: tuple
    k_max: int
    qty: float
    inventory_weight: float
    seed: int


class Readings(NamedTuple):
    """What the check compares: each update's loss, Adam's first moment
    after the last update, and the parameters before and after."""

    losses: List[float]
    mu: List[torch.Tensor]
    params0: List[torch.Tensor]
    params: List[torch.Tensor]


def gumbel(word: int, update: int, T: int, M: int, n_act: int, device):
    gid = torch.arange(M * n_act, dtype=torch.int64, device=device)[None, :]
    h = mk.absorb(torch.full_like(gid, (word & mk.MASK) ^ mk.GOLDEN), gid,
                  mk.K_GID)
    h = mk.absorb(h, update, mk.K_STEP)
    chan = torch.arange(T, dtype=torch.int64, device=device)[:, None]
    bits = mk.absorb(h, chan, mk.K_CHAN)
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    return (-torch.log(-torch.log(u))).reshape(T, M, n_act)


def permutation(word: int, n: int, nmb: int, update: int, epoch: int,
                device):
    rows = torch.arange(n, dtype=torch.int64, device=device)
    h = mk.absorb(torch.full_like(rows, (word & mk.MASK) ^ mk.GOLDEN), rows,
                  mk.K_GID)
    bits = mk.absorb(mk.absorb(h, update, mk.K_STEP), epoch, mk.K_CHAN)
    return torch.sort(bits, stable=True).indices.reshape(nmb, -1)


class Env:
    """The market-maker env over the reference market step."""

    def __init__(self, rows: mk.Rows, s: Settings):
        self.rows, self.s = rows, s
        self.atype = mk.agent_types(rows, s.num_agents)
        self.h_agent = mk.agent_hash(rows, s.num_agents)
        self.kinds = mk.present(rows)
        self.open = mk.opening_books(rows, s.num_levels, torch.float32)
        self.levels = torch.arange(s.num_levels, dtype=torch.float32,
                                   device=rows.seed.device)[None, :]

    def reset(self):
        b = self.open
        mid = mk.best_quotes(b.bid, b.ask, b.last)
        zeros = torch.zeros_like(mid)
        return dict(books=b, t=0, cash=zeros, inv=zeros,
                    obs=features(b, mid, zeros))

    def step(self, st, action):
        s, L = self.s, self.s.num_levels
        mid0 = st["obs"][:, 0]
        a = action.to(torch.int64)
        buy = (a >= 1) & (a <= s.k_max)
        off = torch.where(buy, -a, a - s.k_max).to(torch.float32)
        tick = torch.clamp(torch.round(mid0 + off).to(torch.int64), 0, L - 1)
        q = torch.where(a > 0, s.qty, 0.0).to(torch.float32)
        onehot = self.levels == tick[:, None]
        eb = torch.where(onehot & buy[:, None], q[:, None], 0.0)
        ea = torch.where(onehot & ~buy[:, None], q[:, None], 0.0)
        books, price, volume, mid = mk.step(
            self.rows, st["books"], self.atype, self.h_agent, st["t"],
            s.num_agents, L, torch.float32, self.kinds, eb, ea)
        executed = volume > 0.0
        fb = torch.where(executed, torch.where(self.levels >= price, eb, 0.0)
                         .sum(-1, keepdim=True), 0.0)
        fa = torch.where(executed, torch.where(self.levels <= price, ea, 0.0)
                         .sum(-1, keepdim=True), 0.0)
        cash = st["cash"] - fb * price + fa * price
        inv = st["inv"] + fb - fa
        edge = fb * (mid - price) + fa * (price - mid)
        reward = 1.0 * edge[:, 0] + 1.0 * (
            -float(s.inventory_weight) * (inv * inv)[:, 0])
        t = st["t"] + 1
        done = t >= s.horizon
        if done:
            new = self.reset()
        else:
            new = dict(books=books, t=t, cash=cash, inv=inv,
                       obs=features(books, mid, volume))
        return new, reward, done


def gae(rewards, values, dones, gamma, lam):
    acc = torch.zeros_like(values[0])
    next_value = acc
    adv = [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        nonterm = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterm - values[t]
        acc = delta + gamma * lam * nonterm * acc
        adv[t] = acc
        next_value = values[t]
    adv = torch.stack(adv)
    return adv, adv + values


def loss_fn(flat_params, template, mb, s: Settings, half: bool):
    if half:
        n = mb["obs"].shape[0] // 2
        mb = {k: v[:n] for k, v in mb.items()}
    logits, value = mlp(rebuild(template, flat_params), mb["obs"])
    logp = log_prob(logits, mb["action"])
    ratio = torch.exp(logp - mb["log_prob"])
    adv = (mb["adv"] - mb["adv"].mean()) / (mb["adv"].std(correction=0)
                                            + 1e-8)
    pg = -torch.minimum(ratio * adv, torch.clamp(
        ratio, 1.0 - s.clip_eps, 1.0 + s.clip_eps) * adv)
    v_clip = mb["value"] + torch.clamp(value - mb["value"], -s.clip_eps,
                                       s.clip_eps)
    v_loss = 0.5 * torch.maximum(torch.square(value - mb["ret"]),
                                 torch.square(v_clip - mb["ret"])).mean()
    ent = entropy(logits).mean()
    return pg.mean() + s.vf_coef * v_loss - s.ent_coef * ent


def adam(flat, grads, mu, nu, count: int, s: Settings):
    sq = sum(torch.sum(torch.square(g)) for g in grads)
    gnorm = torch.sqrt(sq)
    scale = torch.clamp(torch.full_like(gnorm, s.max_grad_norm)
                        / torch.clamp(gnorm, min=1e-12), max=1.0)
    grads = [g * scale for g in grads]
    mu = [0.9 * m + (1.0 - 0.9) * g for m, g in zip(mu, grads)]
    nu = [0.999 * v + (1.0 - 0.999) * g * g for v, g in zip(nu, grads)]
    c = torch.tensor(float(count), device=flat[0].device)
    bc1, bc2 = 1.0 - torch.pow(0.9, c), 1.0 - torch.pow(0.999, c)
    flat = [p - s.lr * (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
            for p, m, v in zip(flat, mu, nu)]
    return flat, mu, nu


def train(rows: mk.Rows, s: Settings, updates: int,
          mode: str = "float32") -> Readings:
    """``updates`` PPO updates from the seed; the readings the check
    compares (see :class:`Readings`)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    device = rows.seed.device
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return _train(rows, s, updates, mode, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = prev


def _train(rows, s: Settings, updates: int, mode: str, device) -> Readings:
    env = Env(rows, s)
    M, T = rows.seed.shape[0], s.rollout_len
    n_act = 2 * s.k_max + 1
    params = init_params(s.seed, 5, n_act, s.hidden, device)
    flat = leaves(params)
    params0 = [p.clone() for p in flat]
    mu = [torch.zeros_like(p) for p in flat]
    nu = [torch.zeros_like(p) for p in flat]
    count = 0
    w_act, w_mb = key_word(s.seed, ACTIONS_SALT), key_word(s.seed,
                                                           MINIBATCH_SALT)
    st = env.reset()
    losses = []
    for u in range(updates):
        with torch.no_grad():
            cur = rebuild(params, flat)
            noise = gumbel(w_act, u, T, M, n_act, device)
            obs_l, act_l, lp_l, val_l, rew_l, done_l = ([] for _ in range(6))
            for k in range(T):
                obs = st["obs"]
                logits, value = mlp(cur, obs)
                action = torch.argmax(logits + noise[k], dim=-1)
                obs_l.append(obs)
                act_l.append(action)
                lp_l.append(log_prob(logits, action))
                val_l.append(value)
                st, reward, done = env.step(st, action)
                if mode == "reward":
                    reward = reward.clone()
                    reward[0] += 1.0
                rew_l.append(reward)
                done_l.append(float(done))
            values = torch.stack(val_l)
            dones = torch.tensor(done_l, device=device)[:, None].expand(
                T, M)
            adv, ret = gae(torch.stack(rew_l), values, dones, s.gamma,
                           s.gae_lambda)
            data = {"obs": torch.stack(obs_l).reshape(-1, 5),
                    "action": torch.stack(act_l).reshape(-1),
                    "log_prob": torch.stack(lp_l).reshape(-1),
                    "value": values.reshape(-1), "adv": adv.reshape(-1),
                    "ret": ret.reshape(-1)}
        totals = []
        start = [p.clone() for p in flat]
        for epoch in range(s.num_epochs):
            idx = permutation(w_mb, T * M, s.num_minibatches, u, epoch,
                              device)
            for mb_idx in idx:
                mb = {k: v.index_select(0, mb_idx) for k, v in data.items()}
                req = [p.detach().requires_grad_(True) for p in flat]
                total = loss_fn(req, params, mb, s, mode == "half_batch")
                grads = torch.autograd.grad(total, req)
                count += 1
                with torch.no_grad():
                    flat, mu, nu = adam(flat, list(grads), mu, nu, count, s)
                totals.append(total.detach())
        if mode == "unchanged":
            flat = start
        losses.append(float(torch.stack(totals).mean()))
    return Readings(losses, [m.clone() for m in mu], params0,
                    [p.detach() for p in flat])


def leaf_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor],
              keep=None) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger
    of the reference leaf's norm and the median leaf's (leaves not in
    ``keep`` left out)."""
    p = [float(torch.linalg.vector_norm(x.double())) for x in prog]
    r = [float(torch.linalg.vector_norm(x.double())) for x in ref]
    idx = [i for i in range(len(r)) if keep is None or i in keep]
    med = float(np.median([r[i] for i in idx]))
    return max(abs(p[i] - r[i]) / max(r[i], med, 1e-30) for i in idx)


def compare(prog: Readings, ref: Readings) -> Dict[str, float]:
    """The three numbers the check holds: the worst update's relative
    loss gap (every update of both sides; a missing one reads infinite),
    the gap of Adam's first moment after the last update, and the
    parameters' change over the updates (leaves whose first moment in the
    reference is under a thousandth of the median leaf's left out: they
    move by round-off alone)."""
    if len(prog.losses) != len(ref.losses) or not ref.losses:
        loss = float("inf")
    else:
        loss = max(abs(a - b) / max(abs(b), 1e-12)
                   for a, b in zip(prog.losses, ref.losses))
    mu_norm = [float(torch.linalg.vector_norm(m.double())) for m in ref.mu]
    med = float(np.median(mu_norm))
    keep = {i for i, n in enumerate(mu_norm) if n >= 1e-3 * med}
    d_prog = [a - b for a, b in zip(prog.params, prog.params0)]
    d_ref = [a - b for a, b in zip(ref.params, ref.params0)]
    out = {"loss_rel_gap": loss,
           "moment_gap": leaf_gaps(prog.mu, ref.mu),
           "param_change_gap": leaf_gaps(d_prog, d_ref, keep)}
    return {k: (v if math.isfinite(v) else float("inf"))
            for k, v in out.items()}
