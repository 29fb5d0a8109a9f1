"""Operation and byte counts of the benchmark's cells, and the peaks they
are held against.

Everything here is worked out from shapes, never measured, and never read
from the program under test. A model's shape is a dict with the keys of a
configuration file's ``port`` section: ``d_model``, ``n_heads``,
``n_kv_heads`` (absent or null: equal to ``n_heads``), ``d_ff``,
``n_layers``, ``vocab_size``, ``ffn`` and ``window`` (null: full causal).

Model FLOPs count each multiply-add as two operations, the matmul weights
only (biases, norms and element-wise work are left out), the tied head
once in each direction, and attention over the pairs (query, key) that
the causal or banded mask keeps, forward and backward with no recompute
(the backward is twice the forward). A roofline's least time is the larger
of its operations over the peak rate and its bytes over the bandwidth,
each input byte read once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12

BF16_BYTES = 2
F32_BYTES = 4


def kv_heads(shape: Dict) -> int:
    return shape.get("n_kv_heads") or shape["n_heads"]


def d_head(shape: Dict) -> int:
    return shape["d_model"] // shape["n_heads"]


def gated(shape: Dict) -> bool:
    return shape.get("ffn", "relu") in ("swiglu", "geglu")


def layer_matmul_params(shape: Dict) -> int:
    """Matmul weights of one block: Wq, Wk, Wv, Wo and the FFN's two (or,
    gated, three) matrices."""
    D, F = shape["d_model"], shape["d_ff"]
    KD = kv_heads(shape) * d_head(shape)
    return 2 * D * D + 2 * D * KD + (3 if gated(shape) else 2) * D * F


def head_params(shape: Dict) -> int:
    return shape["vocab_size"] * shape["d_model"]


def attn_pairs(T: int, window: Optional[int] = None) -> int:
    """(query, key) pairs a causal mask keeps over T positions, each query
    seeing at most ``window`` keys (itself included)."""
    if window is None or window >= T:
        return T * (T + 1) // 2
    return window * (window + 1) // 2 + (T - window) * window


def train_step_flops(shape: Dict, batch: int, seq: int) -> Dict[str, float]:
    """Model FLOPs of one training step (forward and backward) over
    ``batch`` rows of ``seq`` tokens: 6 N per token for the layers and the
    tied head, 12 H d per kept pair and layer for attention."""
    tokens = batch * seq
    L, H = shape["n_layers"], shape["n_heads"]
    layers = 6.0 * L * layer_matmul_params(shape) * tokens
    head = 6.0 * head_params(shape) * tokens
    pairs = attn_pairs(seq, shape.get("window"))
    attn = 12.0 * H * d_head(shape) * pairs * batch * L
    return {"layers": layers, "head": head, "attn": attn,
            "total": layers + head + attn}


def attn_train_calls(shape: Dict, batch: int, seq: int,
                     elem_bytes: int = BF16_BYTES):
    """(flops, bytes) of one layer's attention forward and of its backward,
    as two calls: the forward reads q, k, v and writes o and the f32 row
    statistics; the backward reads q, k, v, o, dO and the statistics and
    writes dq, dk, dv. Grouped K/V count at their own head count."""
    H, hk, d = shape["n_heads"], kv_heads(shape), d_head(shape)
    pairs = attn_pairs(seq, shape.get("window"))
    q = batch * H * seq * d * elem_bytes
    kv = batch * hk * seq * d * elem_bytes
    stats = batch * H * seq * F32_BYTES
    fwd = (4.0 * H * d * pairs * batch, q + 2 * kv + q + stats)
    bwd = (8.0 * H * d * pairs * batch,
           q + 2 * kv + 2 * q + stats + q + 2 * kv)
    return fwd, bwd


def least_seconds(flops: float, nbytes: float) -> float:
    """A bf16 call's least time on the card: the larger of its two
    bounds."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def attn_train_least_seconds(shape: Dict, batch: int, seq: int) -> float:
    """Least time of one training step's attention: every layer's forward
    and backward call at its own bound."""
    fwd, bwd = attn_train_calls(shape, batch, seq)
    return shape["n_layers"] * (least_seconds(*fwd) + least_seconds(*bwd))


def weight_bytes(shape: Dict, elem_bytes: int = BF16_BYTES) -> int:
    """Bytes of the matmul weights and the tied head, read once a forward."""
    return (shape["n_layers"] * layer_matmul_params(shape)
            + head_params(shape)) * elem_bytes


def kv_row_bytes(shape: Dict, elem_bytes: int = BF16_BYTES) -> int:
    """Bytes of one position's keys and values in one layer."""
    return 2 * kv_heads(shape) * d_head(shape) * elem_bytes


def decode_token_flops(shape: Dict, ctx: int) -> float:
    """FLOPs of one decoded token that attends over ``ctx`` positions: the
    layers, the head, and q.K plus p.V over the context in every layer."""
    L, H, d = shape["n_layers"], shape["n_heads"], d_head(shape)
    return (2.0 * (L * layer_matmul_params(shape) + head_params(shape))
            + 4.0 * L * H * d * ctx)


def prefill_flops(shape: Dict, plen: int) -> float:
    """FLOPs of prefilling a prompt of ``plen`` tokens: the layers over
    every token, causal attention, and the head at the last position."""
    L, H, d = shape["n_layers"], shape["n_heads"], d_head(shape)
    return (2.0 * L * layer_matmul_params(shape) * plen
            + 4.0 * L * H * d * attn_pairs(plen, shape.get("window"))
            + 2.0 * head_params(shape))


def paged_call_bytes(shape: Dict, rows: int, slots: int,
                     elem_bytes: int = BF16_BYTES) -> int:
    """Bytes one paged-attention call (one layer, one token step) needs:
    the ``rows`` cached positions summed over the slots, their keys and
    values, and every slot's query read and output written."""
    qo = 2 * slots * shape["n_heads"] * d_head(shape) * elem_bytes
    return rows * kv_row_bytes(shape, elem_bytes) + qo
