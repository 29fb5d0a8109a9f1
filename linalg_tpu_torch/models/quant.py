"""Int8 weight-only decode and the int8 KV cache — the counterpart of
``linalg_tpu/models/quant.py``.

Weights: symmetric per-output-channel int8 (max-abs over the reduction
axis / 127), with f32 channel scales. Two arithmetic modes over the same
storage:

- ``mode="deq"`` (the default, the engine's and ``sample``'s):
  ``_ddot``, the dot of the activations rounded to bfloat16 with the int8
  weights, accumulated in float32, the channel scale applied to the
  output row (per-channel scales commute with the contraction);
- ``mode="int8"``: ``_qdot``, int8 x int8 -> int32 with per-token dynamic
  activation scales.

Exact forms of the JAX package's dots, in PyTorch:

- ``_ddot``: JAX runs a bfloat16 dot with a float32 accumulator. Here the
  operands are upcast exactly (int8 and bfloat16 values are exact in
  float32, and so are their products) and multiplied in float32, so the
  sum is never rounded to bfloat16 before the scale. On the card this
  needs TF32 off, PyTorch's default for matmuls.
- ``_qdot``: ``torch.matmul`` has no integer GEMM on CUDA, and
  ``torch._int_mm`` wants more than 16 rows where decode has one a slot.
  The int8 operands are multiplied in float64 instead: every product is
  an integer of at most 127^2 and |acc| <= K * 127^2 is far below 2^53,
  so the float64 sum IS the int32 sum, in any order.

Both dequantize on each call: the float32 copy of a weight lives for one
matmul (the JAX package's XLA fuses the convert into the dot's operand
read). No dequantized copy is kept, which would undo the int8 storage; a
fused dequant-in-dot GEMV kernel is ROADMAP.md item 8 ``perf_opt`` work.

The int8 KV cache stores each written row int8 with its own f32 scale
(max-abs over d_head / 127), quantized once at write time; attention
dequantizes on the read. Both quantizers compute ``x / s`` (not ``x *
(1/s)``) in float32 and round half to even, as ``jnp.round`` does, so the
two packages give the same int8 values and scales bit for bit.

Scope: the decode path only. Prefill stays in the compute dtype.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..nn.cache import fkv_write
from ..nn.functional import (geglu, gelu, layer_norm, relu,
                             sinusoidal_encoding, swiglu)
from .gpt import GPTConfig, Params, _decode_chunk_core, _gqa_decode_attn

__all__ = ["quantize_weight", "quantize_gpt_params", "quantize_kv_cache",
           "gpt_decode_chunk_q"]


def _int8_round(x, s):
    """round(x / s) clipped to [-127, 127] as int8 (round half to even)."""
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)


def quantize_weight(w, axis: int = -2):
    """Symmetric per-output-channel int8 quantization.

    ``axis`` is the REDUCTION axis of the matmul the weight feeds. Returns
    ``(w_q int8, scale f32)`` with ``scale`` shaped like ``w`` minus
    ``axis``; dequantization is ``w_q * scale`` broadcast over ``axis``."""
    w = torch.as_tensor(w).float()
    s = torch.clamp_min(w.abs().amax(dim=axis, keepdim=True) / 127.0, 1e-12)
    return _int8_round(w, s), s.squeeze(axis)


def _act_quantize(x):
    """Per-row (per-token) dynamic int8 activation quantization: (int8
    rows, f32 scales (..., 1))."""
    x = x.float()
    sx = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    return _int8_round(x, sx), sx


def _int_dot(a_q, b_q):
    """The exact int32 sum of an int8 x int8 matmul, as float32: the
    float64 product of integers of at most 127^2 in magnitude is exact
    for any K up to 2^53 / 127^2, then rounds once to float32, as JAX's
    int32 -> float32 convert does."""
    return (a_q.double() @ b_q.double()).float()


def _qdot(x, w_q, w_s):
    """x (..., K) @ w_q (K, N) int8 with per-channel scales w_s (N,):
    int8 activations with per-token scales, int32 accumulation, rescaled
    to f32."""
    xq, sx = _act_quantize(x)
    return _int_dot(xq, w_q) * sx * w_s


def _ddot(x, w_q, w_s):
    """The dequant-in-dot twin of ``_qdot``: the bfloat16-rounded
    activations against the int8 weights, accumulated in float32, then the
    channel scales. f32 out."""
    acc = x.to(torch.bfloat16).float() @ w_q.float()
    return acc * w_s


def quantize_gpt_params(params: Params, cfg: GPTConfig) -> Dict[str, Any]:
    """Quantize every decode matmul weight to int8 (+ f32 channel scales).

    LayerNorm gains/biases, matmul biases and the learned position table
    stay f32. Q/K/V are concatenated BEFORE quantization (one fused
    (D, D + 2 KD) matvec, as ``_dt_decode_ops``), and a gated FFN's up
    and gate branches into one (D, 2F); scales are per column, so
    concatenation mixes no channels. ``tok_W`` (V, D) gets per-row scales:
    the embedding reads rows, the tied head reduces over D."""
    L = params["layers"]
    W3_q, W3_s = quantize_weight(torch.cat([L["Wq"], L["Wk"], L["Wv"]], -1))
    Wo_q, Wo_s = quantize_weight(L["Wo"])
    if "Wg" in L:
        W1_q, W1_s = quantize_weight(torch.cat([L["W1"], L["Wg"]], -1))
        b1 = torch.cat([L["b1"], L["bg"]], -1)
    else:
        W1_q, W1_s = quantize_weight(L["W1"])
        b1 = L["b1"]
    W2_q, W2_s = quantize_weight(L["W2"])
    tok_q, tok_s = quantize_weight(params["tok_W"], axis=-1)
    out = {
        "layers": {
            "ln1_g": L["ln1_g"], "ln1_b": L["ln1_b"],
            "ln2_g": L["ln2_g"], "ln2_b": L["ln2_b"],
            "b1": b1, "b2": L["b2"],
            "W3_q": W3_q, "W3_s": W3_s,
            "Wo_q": Wo_q, "Wo_s": Wo_s,
            "W1_q": W1_q, "W1_s": W1_s,
            "W2_q": W2_q, "W2_s": W2_s,
        },
        "tok_W_q": tok_q,
        "tok_W_s": tok_s,
        "head_b": params["head_b"],
    }
    if "pos_W" in params:
        out["pos_W"] = params["pos_W"]
    return out


_LAYER_DT = ("ln1_g", "ln1_b", "ln2_g", "ln2_b", "b1", "b2")


def _q_decode_ops(qparams: Dict[str, Any], cfg: GPTConfig,
                  mode: str = "deq") -> Dict[str, Any]:
    """Int8 decode ops with the keys of ``models.gpt._dt_decode_ops``
    (its weight-only-quantized twin). ``mode`` picks ``_ddot`` ("deq") or
    ``_qdot`` ("int8") over the same int8 storage."""
    if mode not in ("int8", "deq"):
        raise ValueError(f"unknown quant decode mode: {mode!r}")
    qdot = _qdot if mode == "int8" else _ddot
    dt = cfg.compute_dtype
    ql = qparams["layers"]
    n_layers = ql["W3_q"].shape[0]
    lws = [{k: (v[i].to(dt) if k in _LAYER_DT else v[i])
            for k, v in ql.items()} for i in range(n_layers)]
    tok_q, tok_s = qparams["tok_W_q"], qparams["tok_W_s"]
    head_b = qparams["head_b"].float()
    dev = tok_q.device
    pe = None
    if cfg.pos not in ("rope", "alibi"):
        pe = (qparams["pos_W"] if cfg.pos == "learned" else
              sinusoidal_encoding(cfg.ctx_len, cfg.d_model,
                                  device=dev)).to(dt)

    if cfg.gated_ffn:
        Fd = cfg.dff
        gate_fn = swiglu if cfg.ffn == "swiglu" else geglu

        def ffn(lw, x2):
            # W1_q holds the fused (D, 2F) up + gate matvec
            ug = qdot(x2, lw["W1_q"], lw["W1_s"]).to(dt) + lw["b1"]
            h = gate_fn(ug[..., :Fd], ug[..., Fd:])
            return qdot(h, lw["W2_q"], lw["W2_s"]).to(dt) + lw["b2"]
    else:
        act = gelu if cfg.ffn == "gelu" else relu

        def ffn(lw, x2):
            u = qdot(x2, lw["W1_q"], lw["W1_s"]).to(dt) + lw["b1"]
            return qdot(act(u), lw["W2_q"], lw["W2_s"]).to(dt) + lw["b2"]

    def embed(token):
        # one-row dequant: D int8 and one scale per token, f32
        return (tok_q[token].float() * tok_s[token][:, None])[:, None, :]

    def head(h):  # f32 logits
        if mode == "deq":
            acc = h.to(torch.bfloat16).float() @ tok_q.float().T
            return acc * tok_s + head_b
        xq, sx = _act_quantize(h)
        return _int_dot(xq, tok_q.T) * sx * tok_s + head_b

    return {
        "lws": lws,
        "device": dev,
        "embed": embed,
        "pe": (None if pe is None else lambda rel: pe[
            torch.clamp(rel, max=cfg.ctx_len - 1).long()][:, None]),
        "ln1": lambda lw, x: layer_norm(x, lw["ln1_g"], lw["ln1_b"]),
        "qkv": lambda lw, xn: qdot(xn, lw["W3_q"], lw["W3_s"]).to(dt),
        "out": lambda lw, y: qdot(y, lw["Wo_q"], lw["Wo_s"]).to(dt),
        "ln2": lambda lw, x: layer_norm(x, lw["ln2_g"], lw["ln2_b"]),
        "ffn": ffn,
        "head": head,
    }


def _layer_views(buf):
    """A cache buffer indexable by layer: plain (L, ...) tensors as they
    are; an int8 {q, s} pair as a list of per-layer {q, s} views (writes
    through a view land in the buffer)."""
    if not isinstance(buf, dict):
        return buf
    return [{"q": q, "s": s} for q, s in zip(buf["q"], buf["s"])]


@torch.no_grad()
def gpt_decode_chunk_q(qparams, cache, logits, generator, cfg: GPTConfig,
                       n_tokens: int, temperature=1.0, top_k: int = 0,
                       top_p=0.0, mode: str = "deq", kv8: bool = False):
    """Int8 weight-only twin of ``gpt_decode_chunk``: the same cache
    contract (the cache of the full-precision ``gpt_prefill``), the same
    sampling; only the per-token matvecs read int8 weights. ``kv8=True``
    also reads and writes the KV cache int8: pass the cache through
    ``quantize_kv_cache`` first. Updates the cache in place; returns
    (tokens (B, n), logits, cache)."""
    ops = _q_decode_ops(qparams, cfg, mode)
    write = fkv_write
    if kv8:
        ops = dict(ops, attn=_kv8_attn(cfg.compute_dtype))
        write = _kv8_write(fkv_write)
    pos0 = int(cache["length"])
    toks, logits, _, _, pos = _decode_chunk_core(
        cfg, ops, logits, _layer_views(cache["k"]), _layer_views(cache["v"]),
        pos0, cache.get("start", 0), generator, n_tokens, temperature,
        top_k, top_p, write)
    return toks, logits, dict(cache, length=torch.as_tensor(
        pos, dtype=torch.int32, device=logits.device))


# -- int8 KV cache ----------------------------------------------------------

def _kv_row_quantize(x):
    """(..., d) rows -> (int8 rows, per-row f32 scales (..., 1))."""
    x = x.float()
    s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    return _int8_round(x, s), s


def quantize_kv_cache(cache):
    """A full-precision decode cache {k, v: (L, B, h, ctx, d), ...} (from
    ``gpt_prefill``) in the int8 form {k, v: {q, s}, ...} that
    ``gpt_decode_chunk_q(..., kv8=True)`` reads. Rows past ``length`` hold
    garbage in both forms (masked, then overwritten by decode)."""
    kq, ks = _kv_row_quantize(cache["k"])
    vq, vs = _kv_row_quantize(cache["v"])
    return dict(cache, k={"q": kq, "s": ks}, v={"q": vq, "s": vs})


def _kv8_write(write_fn):
    """Lift a plain cache writer to the {q, s} form: quantize the new rows,
    write the int8 rows and their scales with ``write_fn``."""

    def write(kd, vd, pos, k, v):
        kq, ks = _kv_row_quantize(k)
        vq, vs = _kv_row_quantize(v)
        write_fn(kd["q"], vd["q"], pos, kq, vq)
        write_fn(kd["s"], vd["s"], pos, ks.to(kd["s"].dtype),
                 vs.to(vd["s"].dtype))
        return kd, vd

    return write


def _kv8_dequant(x, dt):
    """{q, s} rows -> (q * s) in ``dt``, formed in float32."""
    return (x["q"].float() * x["s"]).to(dt)


def _kv8_attn(dt):
    """Attention over {q, s} caches: dequantize, then the grouped decode
    attention (grouped caches stay at their grouped size)."""

    def attn(q, kd, vd, mask):
        return _gqa_decode_attn(q, _kv8_dequant(kd, dt),
                                _kv8_dequant(vd, dt), mask)

    return attn
