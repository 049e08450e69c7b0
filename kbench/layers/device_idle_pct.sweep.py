"""Share of the traced slice's wall with no kernel, copy or memset on the
card (the union of their intervals), in percent."""
from kbench import trace


def read(sl, ctx):
    return None if sl is None else trace.idle_pct(sl)
