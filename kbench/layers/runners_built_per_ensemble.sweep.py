"""Runners the program built per ensemble in the traced slice: its
``open.runner.build`` spans over its ``open`` spans, from
``repro_torch.ops.trace.spans()`` (the spans the program recorded while
the slice's profiler ran). Nothing is returned where the program records
no such spans."""


def value(records):
    opens = sum(r.name == "open" for r in records)
    if not opens:
        return None
    return sum(r.name == "open.runner.build" for r in records) / opens


def read(sl, ctx):
    try:
        from repro_torch.ops import trace
    except ImportError:
        return None
    return None if sl is None else value(trace.spans())
