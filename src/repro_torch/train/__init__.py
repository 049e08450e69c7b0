"""repro_torch.train — PPO over the market env (the counterpart of
``repro.train``).

Public surface:

    from repro_torch.train import PPOConfig, PPOTrainer, fit
    from repro_torch.train.policies import make_market_maker, make_random_policy

    trainer = Engine("cuda-kinetic").trainer(spec, PPOConfig(...))
    ts, metrics = trainer.train(trainer.init(), 8)

One update is a rollout through the env (one kernel launch per env step on
the kernel backends), GAE, and minibatched autograd steps with a
hand-written Adam (see :mod:`repro_torch.train.ppo` for the design notes);
:func:`fit` drives checkpointed spans of updates from the host.
"""
from repro_torch.train.buffers import ActorExtras, TrainBatch, gae  # noqa: F401
from repro_torch.train.loop import (  # noqa: F401
    fit,
    restore_train_checkpoint,
    save_train_checkpoint,
    train_state_from_tree,
    train_state_tree,
)
from repro_torch.train.policies import (  # noqa: F401
    ActorCritic,
    QuoteGrid,
    apply_actor_critic,
    init_actor_critic,
    make_market_maker,
    make_random_policy,
)
from repro_torch.train.ppo import (  # noqa: F401
    AdamState,
    PPOConfig,
    PPOTrainer,
    TrainState,
    adam_apply,
    adam_init,
    ppo_loss,
)
