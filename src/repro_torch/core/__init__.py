"""Semantic core: config, params, RNG, auction, agents, step, stats, session."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
from repro_torch.core.session import (  # noqa: F401 (re-exported API)
    Engine,
    ExternalOrders,
    Session,
    StepBatch,
    backend_available,
)
