"""Operations subsystem: failure injection, warm start, observability.

Three parts, wired through :class:`repro_torch.core.session.Engine`:

  * :mod:`repro_torch.ops.chaos`   — deterministic fault injection at chunk
    boundaries on one card (device loss as a restart on the same card,
    checkpoint corruption, torn checkpoint writes) and the harnesses
    :func:`run_plan` and :func:`run_serve_plan`;
  * :mod:`repro_torch.ops.warmup`  — ``Engine.warm(specs)`` builds and
    launches the ``(M, A, L, seed) x chunk`` runners before traffic, and
    ``Engine.readiness()`` reports which are warm;
  * :mod:`repro_torch.ops.metrics` — a per-session :class:`MetricsRegistry`
    sampled on the host outside every launch.
"""
from repro_torch.ops.chaos import (  # noqa: F401 (re-exported API)
    ChaosReport,
    CheckpointCorruption,
    DeviceLoss,
    FaultEvent,
    FaultPlan,
    ServeChaosReport,
    SimulatedCrash,
    TornCheckpointWrite,
    corrupt_checkpoint,
    count_write_ops,
    crash_during_write,
    run_plan,
    run_serve_plan,
)
from repro_torch.ops.metrics import MetricsRegistry  # noqa: F401
from repro_torch.ops.warmup import Readiness, readiness, warm  # noqa: F401
