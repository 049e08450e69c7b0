"""Stylized-facts validation gate (paper §IV-J).

The paper's stylized-fact battery (fat tails, volatility clustering,
volume/volatility correlation) as a typed pass/fail gate over pinned
scenario mixtures: the realism regression test for the archetype engine.

Layers:

  * :func:`stylized_facts` — the per-configuration measurement:
    volatility, kurtosis, volume/volatility correlation, return ACFs.
  * :class:`FactCheck` / :class:`ValidationReport` — typed pass/fail
    results; a report serializes to plain dicts.
  * :func:`validate_spec` — run one config and check the battery: excess
    kurtosis above threshold (fat tails; Gaussian = 0), positive
    volume/volatility correlation, and a decaying ``|r|`` ACF
    (``lag-1 > lag-10``, the volatility-clustering signature).
  * :data:`PINNED_MIXTURES` / :func:`validate_pinned` — the mixtures the gate
    pins: the high-vol momentum preset plus the whale / HFT / informed
    archetype mixtures introduced with the scenario engine.

The ``stats_check`` option cross-validates the path-derived moments
against the in-kernel :mod:`repro_torch.core.stats` accumulators (a second
session run in ``stats_only`` mode): the mid-price mean/variance and the
total volume must agree to float32 accumulation tolerance, tying the
gate's inputs to the statistics path used at scale.

Every fact is computed on host copies with the JAX package's numpy
expressions, so equal paths give equal facts, bit for bit. The entry points
run ``cuda-kinetic`` (kernel 1) on ``device="cuda"`` unless asked otherwise;
on a machine without a card they raise unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core import engine
from repro_torch.core.config import MarketConfig, scenario_config
from repro_torch.core.params import EnsembleSpec
from repro_torch.core.engine import DEFAULT_BACKEND
from repro_torch.core.result import to_host

#: Number of ensemble markets in the pinned mixtures.
PINNED_MARKETS = 64
#: Steps in the pinned mixtures: shorter runs leave the volume/volatility
#: correlation inside seed noise.
PINNED_STEPS = 500


def _mean_corr(a: np.ndarray, b: np.ndarray) -> float:
    """Mean-over-markets Pearson correlation of two [M, S] series."""
    ac = a - a.mean(axis=1, keepdims=True)
    bc = b - b.mean(axis=1, keepdims=True)
    num = (ac * bc).sum(axis=1)
    den = np.sqrt((ac * ac).sum(axis=1) * (bc * bc).sum(axis=1))
    with np.errstate(invalid="ignore", divide="ignore"):
        return float(np.nanmean(num / den))


def _mean_acf(x: np.ndarray, lag: int) -> float:
    """Mean-over-markets lag-``lag`` autocorrelation of an [M, S] series."""
    xc = x - x.mean(axis=1, keepdims=True)
    den = (xc * xc).sum(axis=1)
    with np.errstate(invalid="ignore", divide="ignore"):
        return float(np.nanmean(
            (xc[:, lag:] * xc[:, :-lag]).sum(axis=1) / den))


def stylized_facts(cfg, backend: str = DEFAULT_BACKEND, lags: int = 20,
                   eng: Optional[engine.Engine] = None,
                   device="cuda") -> dict:
    """Run ``cfg`` once and measure the paper's stylized-fact battery.

    ``cfg`` is a :class:`MarketConfig` or :class:`EnsembleSpec`; ``eng``
    (an open engine) takes the place of ``backend`` and ``device``. Returns
    volatility, excess/raw kurtosis, the volume/volatility correlation
    (positive = volume stimulates with |returns|), mean volume per step,
    and lag-1/lag-10 ACFs of ``r_t`` and ``|r_t|``.

    Returns are measured on the **mid-price path**, not the per-step
    clearing price. The clearing price holds at the last trade whenever a
    step fails to cross and pins at deep-crossing levels when it does, so
    its return series carries a strong bid-ask-bounce artifact (negative
    lag-1 ``|r|`` ACF) and a mechanically negative volume/volatility
    correlation — the uniform-price auction's discretization, not the
    dynamics of interest. The mid is the continuous price proxy, and on it
    the three canonical facts (fat tails, volatility clustering, positive
    volume/volatility correlation) can hold jointly.
    """
    spec = EnsembleSpec.coerce(cfg)
    if eng is None:
        eng = engine.Engine(backend, device=device)
    with eng.open(spec) as sess:
        batch = sess.run(spec.num_steps)
        mid = np.asarray(to_host(batch.mid), np.float64)
        vol = np.asarray(to_host(batch.volume), np.float64)
    r = np.diff(mid, axis=1)
    absr = np.abs(r)
    rc = r - r.mean(axis=1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        kurt = float(np.nanmean(
            (rc ** 4).mean(axis=1) / (rc ** 2).mean(axis=1) ** 2))
    return {
        "volatility": float(np.nanmean(r.std(axis=1))),
        "excess_kurtosis": kurt - 3.0,
        "kurtosis": kurt,  # raw kurtosis; Gaussian = 3
        "volume_volatility_corr": _mean_corr(absr, vol[:, 1:]),
        "volume_per_step": float(vol.mean()),
        "acf_r_lag1": _mean_acf(r, 1),
        "acf_abs_lag1": _mean_acf(absr, 1),
        "acf_abs_lag10": _mean_acf(absr, min(10, max(lags, 2))),
    }


@dataclasses.dataclass(frozen=True)
class FactCheck:
    """One stylized-fact assertion: ``value <op> threshold``."""

    name: str
    value: float
    op: str           # ">" or "<"
    threshold: float
    passed: bool

    @classmethod
    def check(cls, name: str, value: float, op: str,
              threshold: float) -> "FactCheck":
        if op not in (">", "<"):
            raise ValueError(f"FactCheck op must be '>' or '<', got {op!r}")
        v = float(value)
        ok = math.isfinite(v) and (v > threshold if op == ">"
                                   else v < threshold)
        return cls(name=name, value=v, op=op, threshold=float(threshold),
                   passed=ok)

    def __str__(self) -> str:
        mark = "PASS" if self.passed else "FAIL"
        return (f"{mark} {self.name}: {self.value:.4f} {self.op} "
                f"{self.threshold:g}")


@dataclasses.dataclass(frozen=True)
class ValidationReport:
    """The gate's result for one configuration: every check + raw facts."""

    scenario: str
    backend: str
    checks: Tuple[FactCheck, ...]
    facts: Dict[str, float]

    @property
    def passed(self) -> bool:
        return all(c.passed for c in self.checks)

    @property
    def failures(self) -> Tuple[FactCheck, ...]:
        return tuple(c for c in self.checks if not c.passed)

    def summary(self) -> str:
        head = ("PASS" if self.passed else "FAIL")
        lines = [f"{head} {self.scenario} [{self.backend}]"]
        lines += [f"  {c}" for c in self.checks]
        return "\n".join(lines)

    def to_dict(self) -> dict:
        return {
            "scenario": self.scenario,
            "backend": self.backend,
            "passed": self.passed,
            "checks": [dataclasses.asdict(c) for c in self.checks],
            "facts": dict(self.facts),
        }


def _stats_crosscheck(cfg, backend: str, facts: dict,
                      checks: list, device="cuda") -> None:
    """Tie the path-derived facts to the in-kernel MarketStats path.

    Kurtosis/ACF need the full per-step paths, but the first two mid
    moments and the total volume are exactly what the ``stats_only``
    accumulators carry — re-run in that mode and require agreement to
    float32 accumulation tolerance.
    """
    spec = EnsembleSpec.coerce(cfg)
    with engine.Engine(backend, device=device,
                       stats_only=True).open(spec) as sess:
        sess.run(spec.num_steps)
        st = sess.stats
    with engine.Engine(backend, device=device).open(spec) as sess:
        batch = sess.run(spec.num_steps)
        mids = np.asarray(to_host(batch.mid), np.float64)
        vols = np.asarray(to_host(batch.volume), np.float64)
    stats_mean = float(np.asarray(st.mean_mid()).mean())
    stats_var = float(np.asarray(st.var_mid()).mean())
    stats_vol = float(np.asarray(st.sum_volume).sum())
    path_mean = float(mids.mean())
    path_var = float(mids.var(axis=1).mean())
    path_vol = float(vols.sum())
    checks.append(FactCheck.check(
        "stats_mean_mid_agrees",
        abs(stats_mean - path_mean) / max(abs(path_mean), 1.0), "<", 1e-3))
    checks.append(FactCheck.check(
        "stats_var_mid_agrees",
        abs(stats_var - path_var) / max(abs(path_var), 1e-6), "<", 1e-2))
    checks.append(FactCheck.check(
        "stats_volume_agrees",
        abs(stats_vol - path_vol) / max(path_vol, 1.0), "<", 1e-3))
    facts.update(stats_mean_mid=stats_mean, stats_var_mid=stats_var,
                 stats_sum_volume=stats_vol)


def validate_spec(cfg, backend: str = DEFAULT_BACKEND, *,
                  scenario: Optional[str] = None,
                  min_excess_kurtosis: float = 0.0,
                  min_vv_corr: float = 0.0,
                  require_acf_decay: bool = True,
                  stats_check: bool = False,
                  lags: int = 20,
                  eng: Optional[engine.Engine] = None,
                  device="cuda") -> ValidationReport:
    """Run the stylized-facts battery on ``cfg`` and gate it.

    Checks (each a :class:`FactCheck` in the report):

      * ``excess_kurtosis > min_excess_kurtosis`` — fat tails. The default
        threshold ``0`` asserts super-Gaussian tails (raw kurtosis > 3).
      * ``volume_volatility_corr > min_vv_corr`` — volume stimulates with
        volatility.
      * ``acf_abs_lag1 > acf_abs_lag10`` — the |return| ACF decays from a
        positive short-lag value: volatility clustering without long-memory
        artifacts (only when ``require_acf_decay``).

    ``stats_check=True`` adds the in-kernel statistics cross-validation
    (a ``stats_only`` run and a path run; see module doc). Pass ``eng`` to
    run every gated mixture over one warm engine.
    """
    name = scenario if scenario is not None else (
        getattr(cfg, "scenario", None) or "custom")
    facts = stylized_facts(cfg, backend=backend, lags=lags, eng=eng,
                           device=device)
    checks = [
        FactCheck.check("excess_kurtosis", facts["excess_kurtosis"], ">",
                        min_excess_kurtosis),
        FactCheck.check("volume_volatility_corr",
                        facts["volume_volatility_corr"], ">", min_vv_corr),
    ]
    if require_acf_decay:
        checks.append(FactCheck.check(
            "acf_abs_decay",
            facts["acf_abs_lag1"] - facts["acf_abs_lag10"], ">", 0.0))
        checks.append(FactCheck.check(
            "acf_abs_lag1", facts["acf_abs_lag1"], ">", 0.0))
    if stats_check:
        _stats_crosscheck(cfg, backend, facts, checks, device=device)
    return ValidationReport(scenario=str(name), backend=backend,
                            checks=tuple(checks), facts=facts)


# ---------------------------------------------------------------------------
# Pinned mixtures. Functions, not configs, so the step count stays
# overridable for fast local smokes; the gate runs the defaults.
# ---------------------------------------------------------------------------


def high_vol_momentum_config(num_steps: int = PINNED_STEPS) -> MarketConfig:
    """The historical smoke pin: high-vol preset, momentum-heavy mix."""
    return scenario_config("high-vol", num_markets=PINNED_MARKETS,
                           num_agents=256, num_steps=num_steps,
                           alpha_maker=0.15, alpha_momentum=0.5, seed=1)


def whale_mixture_config(num_steps: int = PINNED_STEPS) -> MarketConfig:
    """Whale preset over the momentum-rich base: infrequent large sweeps
    thicken the tails on top of the clustering regime."""
    return scenario_config("whale", num_markets=PINNED_MARKETS,
                           num_agents=256, num_steps=num_steps,
                           alpha_momentum=0.5, seed=1)


def hft_mixture_config(num_steps: int = PINNED_STEPS) -> MarketConfig:
    """HFT preset over the momentum-rich base: imbalance chasers amplify
    one-sided books."""
    return scenario_config("hft", num_markets=PINNED_MARKETS,
                           num_agents=256, num_steps=num_steps,
                           alpha_momentum=0.5, seed=1)


def informed_mixture_config(num_steps: int = PINNED_STEPS) -> MarketConfig:
    """Informed preset: front-running of a mid-run shock adds an event-time
    volatility burst to the clustering regime."""
    return scenario_config("informed", num_markets=PINNED_MARKETS,
                           num_agents=256, num_steps=num_steps,
                           alpha_momentum=0.5, seed=1)


PINNED_MIXTURES: Dict[str, Callable[[], MarketConfig]] = {
    "high-vol-momentum": high_vol_momentum_config,
    "whale": whale_mixture_config,
    "hft": hft_mixture_config,
    "informed": informed_mixture_config,
}


def validate_pinned(backend: str = DEFAULT_BACKEND, *,
                    num_steps: int = PINNED_STEPS,
                    stats_check: bool = False,
                    device="cuda") -> Dict[str, ValidationReport]:
    """Run the gate on every pinned mixture; the realism gate fails if any
    report fails."""
    return {
        name: validate_spec(build(num_steps), backend=backend,
                            scenario=name, stats_check=stats_check,
                            device=device)
        for name, build in PINNED_MIXTURES.items()
    }
