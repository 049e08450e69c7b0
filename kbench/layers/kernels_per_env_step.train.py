"""CUDA kernels launched in the traced slice per env step of its rollouts
(the slice is whole ``train`` calls: updates × rollout length env steps,
each update's PPO work included). A count: it repeats exactly."""


def read(sl, ctx):
    if sl is None or not ctx.env_steps_in_slice:
        return None
    n = len(sl.kernels())
    return n / ctx.env_steps_in_slice if n else None
