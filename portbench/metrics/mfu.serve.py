"""mfu.serve: the window's least time on the card over its measured time.
The least time is, for each token step, the larger of the delivered
tokens' FLOPs over the bf16 peak and the bytes (the weights once, each
delivered token's cache) over the bandwidth, plus each step's prefill at
its own bound (``closed_loop.Run._least``)."""


def read(ctx):
    w = ctx["window"]
    if not w.get("steps"):
        return None
    return 100.0 * w["least_s"] / w["seconds"]
