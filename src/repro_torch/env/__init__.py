"""repro_torch.env — the RL environment over the engine (the counterpart
of ``repro.env``).

    from repro_torch.env import MarketEnv, rollout
    from repro_torch.env.obs import MarketFeatures, BookWindow, StatsFeatures
    from repro_torch.env.rewards import PnLReward, SpreadCapture

See :mod:`repro_torch.env.core` for the design notes.
"""
from repro_torch.env.actions import lower_actions, validate_actions  # noqa: F401
from repro_torch.env.core import (  # noqa: F401
    EnvState,
    MarketEnv,
    Portfolio,
    RolloutBatch,
    StepInfo,
    rollout,
    state_from_tree,
    state_tree,
)
from repro_torch.env.obs import (  # noqa: F401
    BookWindow,
    Composite,
    MarketFeatures,
    ObservationSpec,
    PortfolioFeatures,
    StatsFeatures,
)
from repro_torch.env.rewards import (  # noqa: F401
    InventoryPenalty,
    PnLReward,
    RewardContext,
    RewardFn,
    SpreadCapture,
    Sum,
)
