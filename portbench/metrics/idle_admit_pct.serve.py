"""idle_admit_pct.serve: per cent of the traced engine steps' span in which
the device is idle while the engine's host is in a ``serve.admit`` span:
admitting a request, its prefill windows and its slot writes."""

from portbench import spans


def read(ctx):
    return spans.idle_pct_under(ctx["events"], ctx["span"], "serve.admit")
