"""launches_per_token.serve: kernels launched in the traced engine steps
over their decode token steps (one token step decodes every slot)."""

from portbench import trace


def read(ctx):
    ev, span, seg = ctx["events"], ctx["span"], ctx["segment"]
    if span is None:
        return None
    n = len(trace.device_events(ev, span, ("kernel",)))
    if n == 0 or not seg.get("token_steps"):
        return None
    return n / seg["token_steps"]
