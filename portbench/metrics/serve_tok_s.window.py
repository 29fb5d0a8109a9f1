"""serve_tok_s.window: output tokens that reached the host in the measured
window over its seconds (``closed_loop.Run.measure``). The host paces
serving, so runs spread too widely for this rate to be held end to end;
``tpot_p95_ms`` is held instead, and this rate is kept per layer."""


def read(ctx):
    return ctx["window"].get("metrics", {}).get("serve_tok_s")
