"""Milliseconds of the program's chunk-entry peer gathers per ensemble in
the traced slice: the summed durations of its ``dispatch.peer`` spans over
its ``open`` spans, from ``repro_torch.ops.trace.spans()`` (the spans the
program recorded while the slice's profiler ran). Nothing is returned where
the program records no such spans."""


def value(records):
    opens = sum(r.name == "open" for r in records)
    ns = [r.end_ns - r.start_ns for r in records if r.name == "dispatch.peer"]
    if not opens or not ns:
        return None
    return 1e-6 * sum(ns) / opens


def read(sl, ctx):
    try:
        from repro_torch.ops import trace
    except ImportError:
        return None
    return None if sl is None else value(trace.spans())
