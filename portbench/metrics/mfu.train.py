"""mfu.train: the model FLOPs of the window's training steps over its
seconds, as a share of the card's bf16 peak (``portbench.flops``)."""

from portbench import flops


def read(ctx):
    w = ctx["window"]
    if not w.get("steps"):
        return None
    return 100.0 * w["model_flops"] / w["seconds"] / flops.PEAK_BF16_FLOPS
