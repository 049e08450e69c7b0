"""Kernel 1's share of its roofline in the traced slice, in percent.

The least time of the slice's ensembles (``kbench/count.py``: the larger
of their operations over the peak rate and their bytes over the peak
bandwidth) over the device time of every ``kinetic_chunk_kernel`` launch
in the slice. Nothing is returned where the trace holds no such kernel.
"""
from kbench import count


def read(sl, ctx):
    if sl is None or not ctx.ensembles_in_slice:
        return None
    kernels = sl.kernels(ctx.kernel)
    device_s = sum(k.end - k.start for k in kernels)
    if device_s <= 0:
        return None
    n = ctx.ensembles_in_slice
    least = count.least_seconds(n * ctx.ops_per_ensemble,
                                n * ctx.bytes_per_ensemble)
    return 100.0 * least / device_s
