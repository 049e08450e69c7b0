"""Milliseconds of the program's ``Engine.open`` per ensemble in the
traced slice: the mean of its ``open`` spans, from
``repro_torch.ops.trace.spans()`` (the spans the program recorded while
the slice's profiler ran). Nothing is returned where the program records
no such spans."""


def value(records):
    ns = [r.end_ns - r.start_ns for r in records if r.name == "open"]
    return 1e-6 * sum(ns) / len(ns) if ns else None


def read(sl, ctx):
    try:
        from repro_torch.ops import trace
    except ImportError:
        return None
    return None if sl is None else value(trace.spans())
