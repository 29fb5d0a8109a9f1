"""paged_roofline_pct.serve: the bytes the traced steps' paged-attention
calls need (every slot's cached keys and values up to its position, the
queries and outputs; ``portbench.flops.paged_call_bytes``) over the
bandwidth, as a share of the paged kernels' device time."""

from portbench import trace


def read(ctx):
    ev, span, seg = ctx["events"], ctx["span"], ctx["segment"]
    if span is None:
        return None
    us = trace.kernel_us(ev, span, trace.PAGED)
    if us <= 0:
        return None
    return 100.0 * seg["paged_least_s"] / (us / 1e6)
