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
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from repro_torch.core.config import scenario_config
from repro_torch.core.result import SimResult
from repro_torch.core.session import (  # noqa: F401 (re-exported API)
    Engine,
    backend_available,
    backends,
)

DEFAULT_BACKEND = "cuda-kinetic"


def simulate(cfg, backend: str = DEFAULT_BACKEND, device="cuda",
             **backend_opts: Any) -> SimResult:
    """Open a session on ``cfg`` (a ``MarketConfig`` or ``EnsembleSpec``),
    run its ``num_steps`` steps, and return the terminal result."""
    with Engine(backend, device=device, **backend_opts).open(cfg) as sess:
        return sess.run_to_result(cfg.num_steps)


def simulate_scenario(name: str, backend: str = DEFAULT_BACKEND,
                      device="cuda",
                      config_overrides: Optional[Dict[str, Any]] = None,
                      **backend_opts: Any) -> SimResult:
    """Build a scenario preset config and simulate it on ``backend``."""
    cfg = scenario_config(name, **(config_overrides or {}))
    return simulate(cfg, backend=backend, device=device, **backend_opts)
