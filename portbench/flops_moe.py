"""Operation and byte counts of the routed MoE cells (Mellum-style), worked
out from shapes as ``portbench.flops`` does for the dense ones, whose
peaks and rules they share.

A shape here is a configuration's ``port`` section: ``d_model``,
``n_heads``, ``n_kv_heads``, ``head_dim``, ``n_layers``, ``d_ff`` (an
expert's width), ``vocab_size``, ``window`` with ``full_every`` (layers
i % full_every == full_every - 1 attend over the full causal past),
``n_experts`` (the router's width), ``experts_held`` and
``router_top_k``.

Model FLOPs count, per token, the attention projections and the router of
every layer, and the held experts' three matrices for each row routed to
them: ``tokens * k * held / n_experts`` rows a layer, the expected share
(the program's own count of a traced step's rows is read by the roofline
of K13). The rest is ``flops``' rules: 6 N a token, the tied head once
each way, 12 H d per kept (query, key) pair and layer.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from portbench import flops


def layer_windows(shape: Dict) -> List[Optional[int]]:
    k = shape.get("full_every")
    return [None if k and i % k == k - 1 else shape.get("window")
            for i in range(shape["n_layers"])]


def attn_params(shape: Dict) -> int:
    """Wq, Wk, Wv, Wo of one layer, at head width ``head_dim``."""
    D, d = shape["d_model"], shape["head_dim"]
    return 2 * D * shape["n_heads"] * d + 2 * D * shape["n_kv_heads"] * d


def expert_params(shape: Dict) -> int:
    """W1, Wg, W2 of one expert (SwiGLU)."""
    return 3 * shape["d_model"] * shape["d_ff"]


def expected_rows(shape: Dict, tokens: int) -> float:
    """Rows a layer's held experts take from ``tokens`` tokens when the
    router spreads its ``router_top_k`` choices evenly."""
    return (tokens * shape["router_top_k"] * shape["experts_held"]
            / shape["n_experts"])


def train_step_flops(shape: Dict, batch: int, seq: int) -> Dict[str, float]:
    """Model FLOPs of one training step over ``batch`` rows of ``seq``."""
    tokens = batch * seq
    L, H, d = shape["n_layers"], shape["n_heads"], shape["head_dim"]
    dense = 6.0 * L * (attn_params(shape)
                       + shape["d_model"] * shape["n_experts"]) * tokens
    experts = (6.0 * L * expert_params(shape)
               * expected_rows(shape, tokens))
    head = 6.0 * shape["vocab_size"] * shape["d_model"] * tokens
    attn = sum(12.0 * H * d * flops.attn_pairs(seq, w) * batch
               for w in layer_windows(shape))
    return {"layers": dense + experts, "head": head, "attn": attn,
            "total": dense + experts + head + attn}


def attn_train_least_seconds(shape: Dict, batch: int, seq: int) -> float:
    """Least time of one step's attention: each layer's forward (reads q,
    k, v, writes o and the f32 row statistics) and backward (reads q, k,
    v, o, dO, the statistics, writes dq, dk, dv) at its own band, grouped
    K/V at their own head count, each call at its bound."""
    H, hk, d = shape["n_heads"], shape["n_kv_heads"], shape["head_dim"]
    B2 = flops.BF16_BYTES
    q = batch * H * seq * d * B2
    kv = batch * hk * seq * d * B2
    stats = batch * H * seq * flops.F32_BYTES
    total = 0.0
    for w in layer_windows(shape):
        pairs = flops.attn_pairs(seq, w)
        total += flops.least_seconds(4.0 * H * d * pairs * batch,
                                     2 * q + 2 * kv + stats)
        total += flops.least_seconds(8.0 * H * d * pairs * batch,
                                     4 * q + 4 * kv + stats)
    return total


def expert_gemm_calls(shape: Dict, rows: int):
    """(flops, bytes) of each K13 call of one layer's training step with
    ``rows`` routed rows: the forward [U | G] = x W1g and Y = H W2, the
    backward dH = dY W2^T, dW2 = H^T dY, dW1g = x^T [dU | dG] and
    dx = [dU | dG] W1g^T. Each input byte read once (the gathered rows of
    x once each), each output written once, bf16."""
    D, F, El = shape["d_model"], shape["d_ff"], shape["experts_held"]
    b = flops.BF16_BYTES
    w1g, w2 = El * D * 2 * F * b, El * F * D * b
    x, ug, h, y = rows * D * b, rows * 2 * F * b, rows * F * b, rows * D * b
    mm = 2.0 * rows * D * F
    return [(2 * mm, x + w1g + ug),      # [U | G] = x W1g
            (mm, h + w2 + y),            # Y = H W2
            (mm, y + w2 + h),            # dH = dY W2^T
            (mm, h + y + w2),            # dW2 = H^T dY
            (2 * mm, x + ug + w1g),      # dW1g = x^T [dU | dG]
            (2 * mm, ug + w1g + x)]      # dx = [dU | dG] W1g^T


def expert_gemm_least_seconds(shape: Dict, rows: int) -> float:
    """Least time of one layer's K13 calls in a training step."""
    return sum(flops.least_seconds(f, n)
               for f, n in expert_gemm_calls(shape, rows))
