"""idle_decode_pct.serve: per cent of the traced engine steps' span in which
the device is idle while the engine's host is in a ``serve.decode`` span:
dispatching the launches of a decode chunk."""

from portbench import spans


def read(ctx):
    return spans.idle_pct_under(ctx["events"], ctx["span"], "serve.decode")
