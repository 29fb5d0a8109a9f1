"""flash_roofline_pct.train: the traced steps' attention least time (each
layer's forward and backward at the larger of its operations over the bf16
peak and its bytes over the bandwidth, ``portbench.flops``) over the flash
kernels' device time."""

from portbench import trace


def read(ctx):
    ev, span, seg = ctx["events"], ctx["span"], ctx["segment"]
    if span is None:
        return None
    us = trace.kernel_us(ev, span, trace.FLASH)
    if us <= 0:
        return None
    return 100.0 * seg["attn_least_s"] * seg["steps"] / (us / 1e6)
