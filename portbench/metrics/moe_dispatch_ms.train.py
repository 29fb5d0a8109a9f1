"""moe_dispatch_ms.train: device ms a training step in the program's
``moe.route``, ``moe.dispatch`` and ``moe.combine`` spans (the router, the
sort of the assignments by expert, and the gather back to the tokens),
from the program's CUDA events, over the traced steps."""

from portbench import spans


def read(ctx):
    ms = [spans.device_ms_per_step(n, ctx["segment"]["steps"])
          for n in ("moe.route", "moe.dispatch", "moe.combine")]
    if all(m is None for m in ms):
        return None
    return sum(m for m in ms if m is not None)
