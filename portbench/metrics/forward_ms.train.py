"""forward_ms.train: device ms a training step in the program's
``train.forward`` span (the loss: embedding, layers, head and
cross-entropy), from the program's CUDA events, over the traced steps."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step("train.forward",
                                    ctx["segment"]["steps"])
