"""head_ms.train: device ms a training step in the program's
``ce.forward`` and ``ce.backward`` spans (the chunked cross-entropy over
the vocabulary: the tied head's chunk products and the loss's element-wise
passes, forward and backward), from the program's CUDA events, over the
traced steps."""

from portbench import spans


def read(ctx):
    ms = [spans.device_ms_per_step(n, ctx["segment"]["steps"])
          for n in ("ce.forward", "ce.backward")]
    if all(m is None for m in ms):
        return None
    return sum(m for m in ms if m is not None)
