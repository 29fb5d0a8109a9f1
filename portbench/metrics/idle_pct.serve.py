"""idle_pct.serve: per cent of the traced engine steps' span in which no
operation ran on the device."""

from portbench import trace


def read(ctx):
    return trace.idle_pct(ctx["events"], ctx["span"])
