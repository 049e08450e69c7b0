"""Host milliseconds an ensemble spends in ``Engine.open`` and in
``Session.run``'s dispatch (the work before the host waits for the card),
from the harness's own spans around those calls, averaged over the
ensembles of the untraced window."""


def read(sl, ctx):
    return 1e3 * ctx.host_s_per_ensemble
