"""Agent-events per second of kernel 1's own device time in the traced
slice: the agent-steps the program dispatched (the summed ``agent_steps``
of its ``dispatch`` spans, from ``repro_torch.ops.trace.spans()``: rows
dispatched × A × steps) over the summed device time of every
``kinetic_chunk_kernel`` launch in the slice. Its ratio to
``agent_events_per_s`` is kernel 1's share of the wall. Nothing is
returned where the program records no such attribute or the trace holds no
such kernel."""


def value(records, kernels):
    steps = [r.attrs.get("agent_steps") for r in records
             if r.name == "dispatch"]
    device_s = sum(k.end - k.start for k in kernels)
    if not steps or None in steps or device_s <= 0:
        return None
    return sum(steps) / device_s


def read(sl, ctx):
    try:
        from repro_torch.ops import trace
    except ImportError:
        return None
    if sl is None:
        return None
    return value(trace.spans(), sl.kernels(ctx.kernel))
