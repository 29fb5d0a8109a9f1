"""optimizer_ms.train: device ms a training step in the program's
``train.optimizer`` span (the schedule and AdamW over every leaf), from
the program's CUDA events, over the traced steps."""

from portbench import spans


def read(ctx):
    return spans.device_ms_per_step("train.optimizer",
                                    ctx["segment"]["steps"])
