"""ttft_p95_ms.window: the 95th percentile, over every request sent in the
measured window, of send to the end of the ``step()`` that delivered its
first tokens (``closed_loop.Run.measure``). Kept per layer, as
``serve_tok_s.window`` is: its runs spread too widely to be held end to
end."""


def read(ctx):
    return ctx["window"].get("metrics", {}).get("ttft_p95_ms")
