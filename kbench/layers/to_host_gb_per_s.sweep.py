"""The rate of the program's copies of its outputs to the host in the
traced slice, in GB/s: the host bytes its ``to_host.copy`` spans wrote
(their ``bytes``) over the spans' summed durations, from
``repro_torch.ops.trace.spans()`` (the spans the program recorded while
the slice's profiler ran). The wait for the card is a span of its own,
``to_host.wait``, outside these. Nothing is returned where the program
records no such spans."""


def value(records):
    copies = [r for r in records if r.name == "to_host.copy"]
    ns = sum(r.end_ns - r.start_ns for r in copies)
    if ns <= 0:
        return None
    return sum(r.attrs["bytes"] for r in copies) / ns


def read(sl, ctx):
    try:
        from repro_torch.ops import trace
    except ImportError:
        return None
    return None if sl is None else value(trace.spans())
