"""elementwise_ms.train: device ms a training step in kernels that are
neither GEMMs nor the flash kernels (the eager element-wise ops, the loss's
and AdamW's), over the traced steps."""

from portbench import trace


def read(ctx):
    ev, span, seg = ctx["events"], ctx["span"], ctx["segment"]
    if span is None or not trace.device_events(ev, span, ("kernel",)):
        return None
    us = trace.kernel_us(ev, span, exclude=(trace.GEMM, trace.FLASH))
    return us / 1e3 / seg["steps"]
