"""backward_ms.train: device ms a training step in the program's
``train.backward`` span (the gradients of every leaf), from the program's
CUDA events, over the traced steps."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step("train.backward",
                                    ctx["segment"]["steps"])
