"""Kernel 1's device time a step on market clusters in the traced slice,
in microseconds: the summed device time of every ``kinetic_chunk_kernel``
launch in the slice over the summed ``steps`` of the program's
``dispatch`` spans (``repro_torch.ops.trace.spans()``), where every one of
those spans spread each market over a cluster of CTAs
(``ctas_per_market`` above 1). At few markets that per-step critical path,
not the card's throughput, sets an ensemble's time. Nothing is returned
where a dispatch ran one CTA a market or records no such attribute (so
the kernel's time would not be the clusters' alone), where no dispatch
ran, or where the trace holds no such kernel."""


def value(records, kernels):
    spans = [r for r in records if r.name == "dispatch"]
    if not spans or any((r.attrs.get("ctas_per_market") or 0) <= 1
                        for r in spans):
        return None
    steps = sum(r.attrs.get("steps", 0) for r in spans)
    device_s = sum(k.end - k.start for k in kernels)
    if steps <= 0 or device_s <= 0:
        return None
    return 1e6 * device_s / steps


def read(sl, ctx):
    try:
        from repro_torch.ops import trace
    except ImportError:
        return None
    if sl is None:
        return None
    return value(trace.spans(), sl.kernels(ctx.kernel))
