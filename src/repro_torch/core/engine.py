"""Public engine API: one-shot wrappers over a one-session run.

The stateful front door is :mod:`repro_torch.core.session`
(``Engine(backend, device=...).open(spec)``). ``simulate`` and
``simulate_scenario`` open a session, run ``num_steps`` steps and return the
terminal :class:`SimResult`. Backends in this package:

  * ``cuda-kinetic`` — the paper's engine: the persistent clearing kernel,
    one launch per chunk (plain PyTorch version on ``device="cpu"``).
  * ``cuda-naive`` — the ablation: the per-step kernel, one launch per
    step, the books through device memory between steps.
  * ``torch-scan`` — framework baseline: eager PyTorch, one runner call
    loops the chunk's steps.
  * ``torch-per-step`` — framework baseline: one eager step per dispatch,
    the step's outputs copied to the host every step.
  * ``numpy``, ``numpy-splitmix64``, ``numpy-pcg64`` — the CPU reference
    family (``device="cpu"`` only), with ``clearing="sequential"``.

:func:`open_scenario` opens a warm session on a scenario preset. The
one-shot wrappers share warm engines keyed by ``(backend, device, sorted
options)``, so repeated calls reuse their runners and loaded kernels;
:func:`clear_compat_cache` releases them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from repro_torch.core.config import (  # noqa: F401 (re-exported API)
    MarketConfig,
    scenario_config,
    scenario_names,
)
from repro_torch.core.params import (  # noqa: F401 (re-exported API)
    EnsembleSpec,
    MarketParams,
)
from repro_torch.core.result import SimResult
from repro_torch.core.session import (  # noqa: F401 (re-exported API)
    Engine,
    ExternalOrders,
    Session,
    StepBatch,
    backend_available,
    backends,
    register_backend,
)
from repro_torch.core.stats import MarketStats  # noqa: F401 (re-exported API)

DEFAULT_BACKEND = "cuda-kinetic"

# Warm engines shared by the wrappers, keyed by (backend, device, sorted
# backend options).
_COMPAT_ENGINES: Dict[Tuple[Any, ...], Engine] = {}


def clear_compat_cache() -> None:
    """Release the wrappers' warm engines and their runners (for
    long-lived processes sweeping many distinct configurations)."""
    _COMPAT_ENGINES.clear()


def _compat_engine(backend: str, device, opts: Dict[str, Any]) -> Engine:
    key = (backend, str(device)) + tuple(sorted(opts.items()))
    eng = _COMPAT_ENGINES.get(key)
    if eng is None:
        eng = _COMPAT_ENGINES[key] = Engine(backend, device=device, **opts)
    return eng


def simulate(cfg, backend: str = DEFAULT_BACKEND, device="cuda",
             **backend_opts: Any) -> SimResult:
    """Open a session on ``cfg`` (a ``MarketConfig`` or ``EnsembleSpec``),
    run its ``num_steps`` steps, and return the terminal result."""
    with _compat_engine(backend, device, backend_opts).open(cfg) as sess:
        return sess.run_to_result(cfg.num_steps)


def simulate_scenario(name: str, backend: str = DEFAULT_BACKEND,
                      device="cuda",
                      config_overrides: Optional[Dict[str, Any]] = None,
                      **backend_opts: Any) -> SimResult:
    """Build a scenario preset config and simulate it on ``backend``."""
    cfg = scenario_config(name, **(config_overrides or {}))
    return simulate(cfg, backend=backend, device=device, **backend_opts)


def scenarios() -> Tuple[str, ...]:
    """Registered scenario preset names."""
    return scenario_names()


def open_scenario(name: str, backend: str = DEFAULT_BACKEND, device="cuda",
                  config_overrides: Optional[Dict[str, Any]] = None,
                  **backend_opts: Any) -> Session:
    """Open a session on a scenario preset (the caller closes it)."""
    cfg = scenario_config(name, **(config_overrides or {}))
    return _compat_engine(backend, device, backend_opts).open(cfg)
