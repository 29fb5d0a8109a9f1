"""Decoder-only char-GPT in PyTorch — the counterpart of
``linalg_tpu/models/gpt.py`` for the serving, training and sampling
slices.

Same model: pre-LN decoder blocks (masked self-attention + ReLU/GELU or
gated SwiGLU/GeGLU FFN, residuals), sinusoidal or learned positions added
at the embedding or RoPE/ALiBi inside attention, a sliding-window band, a
weight-tied output head, grouped-query attention. Same parameters: a dict
with the keys and the stacked ``(L, ...)`` layer layout of
``linalg_tpu.models.gpt.init_gpt_params``, drawn in the same numpy order,
so both packages hold bit-identical weights for one seed.

PyTorch idiom: eager functions on tensors, a Python loop where JAX scans
(over layers and over decoded tokens), ``torch.Generator``s for sampling,
and KV buffers updated in place. Parameters stay float32 masters; every
forward runs in ``cfg.compute_dtype`` and returns float32 logits.
``gpt_apply`` and ``gpt_loss`` are differentiable (the training path:
attention picked by ``_pick_attn``, and the JAX package's two gated
kernels on the card: ``_pick_attn_btd``'s (B, T, H*d) attention and
``_pick_fused``'s LayerNorm+QKV / LayerNorm+FFN; both read the same
parameter keys, so ``params_from_numpy`` carries JAX weights across
unchanged); prefill and decode run without gradients and always use
``sdpa``, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention import SUPPORTED_D as FLASH_D
from ..nn.cache import fkv_init, fkv_write
from ..nn.flash import FLASH_MAX_T, flash_attention
from ..nn.flash_btd import attention_btd, btd_supported
from ..nn.flash_long import flash_attention_long
from ..nn.flash_stream import STREAM_BLOCK, flash_attention_stream
from ..nn.fused_layer import fused_supported, ln_ffn, ln_qkv
from ..nn.functional import (YaRN, causal_mask, geglu, gelu, layer_norm,
                             relu, rope_rotate, rope_tables, sdpa,
                             sinusoidal_encoding, swiglu, yarn_tables)
from ..nn.losses import chunked_softmax_ce
from ..nn.positional import alibi_slopes

__all__ = ["GPTConfig", "init_gpt_params", "params_from_numpy", "gpt_apply",
           "gpt_loss", "init_decode_cache", "gpt_prefill",
           "gpt_prefill_batched", "gpt_generate", "gpt_decode_step",
           "gpt_decode_chunk", "filter_logits", "sample_token",
           "CE_CHUNK_THRESHOLD"]

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Same fields and validation as ``linalg_tpu.models.gpt.GPTConfig``."""

    vocab_size: int
    d_model: int = 256
    n_heads: int = 4
    n_layers: int = 4
    d_ff: Optional[int] = None
    ctx_len: int = 256
    pos: str = "sinusoidal"  # "sinusoidal" | "rope" | "learned" | "alibi"
    dtype: str = "float32"  # compute dtype: "float32" or "bfloat16"
    n_kv_heads: Optional[int] = None  # GQA: K/V heads, divides n_heads
    window: Optional[int] = None  # sliding-window attention
    ffn: str = "relu"  # "relu" | "gelu" | "swiglu" | "geglu"
    # the port's own fields (the JAX package has none of them); each
    # default is the model above
    head_dim: Optional[int] = None  # None: d_model // n_heads
    rope_theta: float = 10000.0
    # with ``window``, layers i % full_every == full_every - 1 attend over
    # the full causal context (None: every layer takes ``window``)
    full_every: Optional[int] = None
    rope_scaling: Optional[YaRN] = None  # RoPE of the full layers

    def __post_init__(self):
        if self.pos not in ("sinusoidal", "rope", "learned", "alibi"):
            raise ValueError(f"Unknown positional encoding: {self.pos!r}")
        if self.pos == "rope" and self.d_head % 2 != 0:
            raise ValueError("RoPE requires an even head dimension")
        if self.dtype not in ("float32", "bfloat16"):
            raise ValueError(f"Unknown compute dtype: {self.dtype!r}")
        if self.n_kv_heads is not None and (
                self.n_kv_heads < 1
                or self.n_heads % self.n_kv_heads != 0):
            raise ValueError(
                "n_kv_heads must divide n_heads (each KV head serves an "
                "equal group of query heads)")
        if self.window is not None and self.window < 1:
            raise ValueError("window must be >= 1 (tokens always see "
                             "at least themselves)")
        if self.ffn not in ("relu", "gelu", "swiglu", "geglu"):
            raise ValueError(f"Unknown ffn: {self.ffn!r} (expected relu, "
                             "gelu, swiglu or geglu)")
        if self.head_dim is not None and self.head_dim < 1:
            raise ValueError("head_dim must be >= 1")
        if self.full_every is not None and (self.full_every < 1
                                            or self.window is None):
            raise ValueError("full_every needs a window and must be >= 1")
        if self.rope_scaling is not None and self.pos != "rope":
            raise ValueError("rope_scaling needs pos='rope'")

    @property
    def dff(self) -> int:
        return self.d_ff if self.d_ff is not None else 4 * self.d_model

    @property
    def d_head(self) -> int:
        return (self.head_dim if self.head_dim is not None
                else self.d_model // self.n_heads)

    @property
    def q_width(self) -> int:
        """Columns of Wq (rows of Wo): n_heads * d_head."""
        return self.n_heads * self.d_head

    @property
    def layer_windows(self) -> tuple:
        """Each layer's attention band: ``window``, or None (full causal)
        at every ``full_every``-th layer."""
        k = self.full_every
        return tuple(None if k and i % k == k - 1 else self.window
                     for i in range(self.n_layers))

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def gated_ffn(self) -> bool:
        """True for the two-branch FFNs (an extra Wg/bg per layer)."""
        return self.ffn in ("swiglu", "geglu")

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def init_gpt_params(cfg: GPTConfig, seed: int = 123,
                    device=None) -> Params:
    """He-init attention/FFN weights, N(0, 0.02) embeddings, zero biases —
    the JAX package's draws in the JAX package's order (float64 draws
    rounded to float32), so the two are bit-equal."""
    rng = np.random.default_rng(seed)
    D, Fd, L, V = cfg.d_model, cfg.dff, cfg.n_layers, cfg.vocab_size

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    def he(fan_in, shape):
        return t(rng.normal(0.0, math.sqrt(2.0 / fan_in), size=shape))

    KD, QD = cfg.kv_heads * cfg.d_head, cfg.q_width
    layers = {
        "ln1_g": t(np.ones((L, D))),
        "ln1_b": t(np.zeros((L, D))),
        "Wq": he(D, (L, D, QD)),
        "Wk": he(D, (L, D, KD)),
        "Wv": he(D, (L, D, KD)),
        "Wo": he(QD, (L, QD, D)),
        "ln2_g": t(np.ones((L, D))),
        "ln2_b": t(np.zeros((L, D))),
        "W1": he(D, (L, D, Fd)),
        "b1": t(np.zeros((L, Fd))),
        "W2": he(Fd, (L, Fd, D)),
        "b2": t(np.zeros((L, D))),
    }
    if cfg.gated_ffn:  # the gate branch, drawn before tok_W as in JAX
        layers["Wg"] = he(D, (L, D, Fd))
        layers["bg"] = t(np.zeros((L, Fd)))
    out = {
        "tok_W": t(rng.normal(0.0, 0.02, size=(V, D))),
        "head_b": t(np.zeros((V,))),
        "layers": layers,
    }
    if cfg.pos == "learned":
        out["pos_W"] = t(rng.normal(0.0, 0.02, size=(cfg.ctx_len, D)))
    return out


def params_from_numpy(np_params, device=None, dtype=None) -> Params:
    """The JAX package's parameter pytree, as numpy arrays
    (``jax.tree.map(np.asarray, p)``), as this package's dict of tensors on
    ``device`` (cast to ``dtype`` when given)."""
    if isinstance(np_params, dict):
        return {k: params_from_numpy(v, device, dtype)
                for k, v in np_params.items()}
    return torch.tensor(np.asarray(np_params), device=device, dtype=dtype)


def _heads(x, h: int):
    B, T, D = x.shape
    return x.reshape(B, T, h, D // h).transpose(1, 2)


def _unheads(x):
    B, h, T, d = x.shape
    return x.transpose(1, 2).reshape(B, T, h * d)


def _gqa_expand(kv, n_heads: int):
    """Tile grouped K/V heads (B, hk, T, d) up to (B, n_heads, T, d): query
    head h reads KV head h // (n_heads // hk)."""
    hk = kv.shape[1]
    if hk == n_heads:
        return kv
    return torch.repeat_interleave(kv, n_heads // hk, dim=1)


def _gqa_decode_attn(q, k, v, mask):
    """Single-position attention against a GROUPED KV cache.

    q (B, H, 1, d); k/v (B, hk, S, d) with hk | H; mask (B, 1|H, 1, S)
    additive. Equal head counts go through ``sdpa`` (compute dtype, 1e-12
    denominator); grouped heads do their softmax in float32, as the JAX
    package does."""
    if k.shape[1] == q.shape[1]:
        return sdpa(q, k, v, mask)
    return _grouped_decode_attn(q, k, v, mask)


def _grouped_decode_attn(q, k, v, mask):
    """``_gqa_decode_attn``'s grouped branch at any head counts (hk | H):
    float32 softmax. A tensor-parallel rank of a grouped model takes it
    even where its own head counts are equal, so its rows are the
    unsharded model's."""
    B, H, Tq, d = q.shape
    hk, S = k.shape[1], k.shape[2]
    g = H // hk
    qg = q.reshape(B, hk, g * Tq, d)
    sc = (qg @ k.transpose(-1, -2)) / math.sqrt(d)
    m = mask.expand(B, H, Tq, S).reshape(B, hk, g * Tq, S)
    p = torch.softmax((sc + m).float(), dim=-1).to(q.dtype)
    return (p @ v).reshape(B, H, Tq, d)


def _ffn_dense(lp, x, ffn: str = "relu"):
    """Position-wise FFN: the 2-matmul MLP with relu/gelu, or the gated
    ``f(x @ W1 + b1, x @ Wg + bg) @ W2 + b2`` with swiglu/geglu."""
    u = x @ lp["W1"] + lp["b1"]
    if ffn in ("swiglu", "geglu"):
        gate_fn = swiglu if ffn == "swiglu" else geglu
        h = gate_fn(u, x @ lp["Wg"] + lp["bg"])
    else:
        h = gelu(u) if ffn == "gelu" else relu(u)
    return h @ lp["W2"] + lp["b2"]


def _ln_qkv(h_in, lp):
    """K8 (``ln_qkv``) on the layer's LayerNorm and projections. K8 takes
    (D, D) projections; narrower ones (a tensor-parallel rank's D/tp
    columns) are zero-padded to D columns and the outputs cut back, which
    leaves every product and gradient of the real columns as it was."""
    D = h_in.shape[-1]
    ws = [lp["Wq"], lp["Wk"], lp["Wv"]]
    widths = [w.shape[-1] for w in ws]
    if all(wd == D for wd in widths):
        return ln_qkv(h_in, lp["ln1_g"], lp["ln1_b"], *ws)
    outs = ln_qkv(h_in, lp["ln1_g"], lp["ln1_b"],
                  *(F.pad(w, (0, D - wd)) for w, wd in zip(ws, widths)))
    return tuple(o[..., :wd] for o, wd in zip(outs, widths))


def _attn_half(h_in, lp, mask, n_heads: int, n_kv: int, attn_fn: Callable,
               rope=None, fused: bool = False):
    """The attention branch of a pre-LN block: (LN(h) -> QKV -> attention
    -> Wo output (B, T, D), (k, v) at the grouped head count). ``fused``
    takes K8 for LN + QKV. Under tensor parallelism a rank passes its own
    head counts and column blocks, and the output is its partial sum."""
    if fused:
        qf, kf, vf = _ln_qkv(h_in, lp)
        q, k, v = _heads(qf, n_heads), _heads(kf, n_kv), _heads(vf, n_kv)
    else:
        xn = layer_norm(h_in, lp["ln1_g"], lp["ln1_b"])
        q = _heads(xn @ lp["Wq"], n_heads)
        k = _heads(xn @ lp["Wk"], n_kv)
        v = _heads(xn @ lp["Wv"], n_kv)
    if rope is not None:
        q = rope_rotate(q, *rope)
        k = rope_rotate(k, *rope)
    if getattr(attn_fn, "gqa_native", False):
        # the stream kernels read each grouped K/V head for its query heads
        a = _unheads(attn_fn(q, k, v, mask)) @ lp["Wo"]
    else:
        a = _unheads(attn_fn(q, _gqa_expand(k, n_heads),
                             _gqa_expand(v, n_heads), mask)) @ lp["Wo"]
    return a, (k, v)


def _ffn_half(h1, lp, ffn: str = "relu", fused: bool = False):
    """The FFN branch of a pre-LN block: K9 (``ln_ffn``) when ``fused``,
    else LayerNorm then ``_ffn_dense``."""
    if fused:
        return ln_ffn(h1, lp["ln2_g"], lp["ln2_b"], lp["W1"], lp["b1"],
                      lp["W2"], lp["b2"])
    return _ffn_dense(lp, layer_norm(h1, lp["ln2_g"], lp["ln2_b"]), ffn)


def _layer(h_in, lp, mask, n_heads: int, n_kv: Optional[int] = None,
           ffn: str = "relu", attn_fn: Callable = sdpa, rope=None,
           fused: bool = False, attn_btd: Optional[Callable] = None):
    """One pre-LN decoder block. ``rope`` is an optional (cos, sin) pair of
    (T, d_head/2) tables rotating q and k. ``attn_fn(q, k, v, mask)`` sees
    equal head counts, or the grouped K/V when it carries ``gqa_native``.
    Returns (h_out, (k, v)) with k/v at their grouped (B, n_kv, T, d) size
    — the prefill cache.

    The JAX package's order: ``attn_btd(q, k, v)``, a (B, T, H*d)-layout
    attention (``nn.flash_btd``), takes the block first when there is no
    RoPE (then k/v are not returned); else ``fused`` routes LN+QKV and
    LN+FFN through ``nn.fused_layer`` (``_pick_fused`` gates it to equal
    K/V heads and the ReLU FFN)."""
    n_kv = n_heads if n_kv is None else n_kv
    if attn_btd is not None and rope is None:
        xn = layer_norm(h_in, lp["ln1_g"], lp["ln1_b"])
        a = attn_btd(xn @ lp["Wq"], xn @ lp["Wk"], xn @ lp["Wv"]) @ lp["Wo"]
        h1 = h_in + a
        f = _ffn_dense(lp, layer_norm(h1, lp["ln2_g"], lp["ln2_b"]), ffn)
        return h1 + f, (None, None)
    a, kv = _attn_half(h_in, lp, mask, n_heads, n_kv, attn_fn, rope, fused)
    h1 = h_in + a
    return h1 + _ffn_half(h1, lp, ffn, fused), kv


def _embed(params: Params, x_ids, cfg: GPTConfig, T: int, dt):
    """Token embedding plus positions, formed in float32 and cast to
    ``dt``: (h, rope tables or None). Sinusoidal and learned tables are
    added here; RoPE returns the (T, d_head/2) rotation tables for the
    layers; ALiBi enters only through the mask."""
    dev = params["tok_W"].device
    emb = params["tok_W"][x_ids]
    if cfg.pos == "rope":
        return emb.to(dt), _rope(cfg, T, dt, dev, full=cfg.window is None)
    if cfg.pos == "alibi":
        return emb.to(dt), None
    if cfg.pos == "learned":
        pe = params["pos_W"][:T]
    else:
        pe = sinusoidal_encoding(cfg.ctx_len, cfg.d_model, device=dev)[:T]
    return (emb + pe[None]).to(dt), None


def _rope(cfg: GPTConfig, T: int, dt, device=None, full: bool = False):
    """The (cos, sin) RoPE tables of positions 0..T-1 in ``dt``, or None
    when the config does not rotate; ``full`` layers take the config's
    YaRN tables where it has them. The base is passed only where it is not
    the default, so two-argument stand-ins of ``rope_tables`` still fit."""
    if cfg.pos != "rope":
        return None
    pos = torch.arange(T, device=device)
    if full and cfg.rope_scaling is not None:
        cos, sin = yarn_tables(cfg.d_head, pos, cfg.rope_theta,
                               cfg.rope_scaling)
    elif cfg.rope_theta != 10000.0:
        cos, sin = rope_tables(cfg.d_head, pos, cfg.rope_theta)
    else:
        cos, sin = rope_tables(cfg.d_head, pos)
    return cos.to(dt), sin.to(dt)


def _layer_kinds(cfg: GPTConfig, T: int, dt, device, rope,
                 attn_fn: Optional[Callable] = None):
    """Each layer's (attention, mask, RoPE tables), built once a forward
    for each distinct band of ``cfg.layer_windows``: a full layer of a
    windowed config takes the full causal mask, ``_pick_attn_cfg``'s pick
    for no window, and the YaRN tables where the config has them.
    ``rope`` is ``_embed``'s tables (the config's own window); an explicit
    ``attn_fn`` serves every layer."""
    kinds = {}
    for w in set(cfg.layer_windows):
        c = cfg if w == cfg.window else dataclasses.replace(
            cfg, window=w, full_every=None)
        kinds[w] = (attn_fn or _pick_attn_cfg(c, T, device.type),
                    _trunk_mask(c, T, dt, device),
                    rope if w == cfg.window else _rope(
                        cfg, T, dt, device, full=w is None))
    return [kinds[w] for w in cfg.layer_windows]


def _trunk_mask(cfg: GPTConfig, T: int, dt, device=None):
    """Additive mask for the parallel paths: causal (1, 1, T, T); the
    window band bans keys window or more behind the query; ALiBi adds the
    per-head bias ``slope_h * (j - i)`` (formed in float32), giving
    (1, H, T, T)."""
    m = causal_mask(T, dtype=dt, device=device)
    i = torch.arange(T, device=device)
    if cfg.window is not None:
        far = (i[:, None] - i[None, :]) >= cfg.window  # query i, key j
        # a fill, not a scalar tensor made on the device: that copy waits
        # on the host
        m = m.masked_fill(far[None, None], -1e9)
    if cfg.pos == "alibi":
        sl = alibi_slopes(cfg.n_heads, device=device)
        bias = sl[:, None, None] * (i[None, None, :] - i[None, :, None])
        m = m + bias.to(dt)[None]
    return m


def _unstack(stack, dt=None):
    """Per-layer dicts of a dict of stacked (L, ...) weights, each stack
    cast to ``dt`` (when given) once and split by one ``unbind``: its
    backward writes the L layers' gradients into the stack once, where
    indexing ``w[i]`` per layer would zero-fill a whole stack for each
    layer and add them up, O(L^2) bytes."""
    split = {k: (w if dt is None else w.to(dt)).unbind(0)
             for k, w in stack.items()}
    return [dict(zip(split, ws)) for ws in zip(*split.values())]


def _layer_params(params: Params, dt):
    """Per-layer dicts of the stacked weights, cast to ``dt``."""
    return _unstack(params["layers"], dt)


def _head(params: Params, h, dt):
    return (h @ params["tok_W"].to(dt).T
            + params["head_b"].to(dt)).float()


# ``sdpa`` whose probabilities are recomputed in the backward rather than
# saved across the layer stack (``jax.checkpoint`` in the JAX package)
_REMAT_SDPA = functools.partial(checkpoint, sdpa, use_reentrant=False)


def _flash_width(d_head: int) -> bool:
    """Whether the flash kernels take a head of ``d_head`` columns: 8 to
    256 (``nn.flash.kernel_width`` zero-pads the widths between theirs),
    the JAX rule's every d_head >= 8 up to the kernels' widest width."""
    return 8 <= d_head <= FLASH_D[-1]


def _pick_attn_cfg(cfg: GPTConfig, T: int, device_type: str):
    """Config-aware attention pick, the JAX package's rule: ALiBi takes
    the rematted sdpa (no kernel threads its per-head bias). A window
    takes the band through ``flash_attention_stream`` on CUDA at T >= 512
    (ragged T right-padded to a multiple of 256, exact under the causal
    band), reading grouped K/V in place; below that, off CUDA, or for a
    d_head outside [8, 256] (``_flash_width``), the rematted sdpa with the
    band in its mask. Everything else takes ``_pick_attn``."""
    if cfg.pos == "alibi":
        return _REMAT_SDPA
    if cfg.window is None:
        return _pick_attn(T, cfg.d_head, device_type)
    if device_type != "cuda" or T < 512 or not _flash_width(cfg.d_head):
        return _REMAT_SDPA
    Tp = -(-T // STREAM_BLOCK) * STREAM_BLOCK
    banded = _padded_attn(functools.partial(flash_attention_stream,
                                            window=cfg.window), T, Tp)
    banded.gqa_native = True
    return banded


def _pick_attn(T: int, d_head: int, device_type: str):
    """Attention for a training forward of length T on ``device_type``.

    Off CUDA: ``sdpa`` (the JAX package's rule off the TPU). On CUDA, the
    JAX package's thresholds, TPU measurements that stand until an H100
    measurement replaces them: the rematted sdpa below T = 512 and for
    d_head < 8, as in JAX; otherwise, with T right-padded to Tp, a
    multiple of 256, the flash kernels (``flash_attention`` for Tp <= 1024,
    ``flash_attention_long`` for Tp <= 4096, ``flash_attention_stream``
    beyond, which reads grouped K/V in place: ``gqa_native``), a d_head
    between the kernels' widths zero-padded to the next, up to 256, the
    kernels' widest."""
    if device_type != "cuda":
        return sdpa
    if T < 512 or not _flash_width(d_head):
        return _REMAT_SDPA
    Tp = -(-T // 256) * 256
    if Tp <= FLASH_MAX_T:
        fn = flash_attention
    elif Tp <= 4096:
        fn = flash_attention_long
    else:
        fn = flash_attention_stream
    wrapped = _padded_attn(fn, T, Tp)
    wrapped.gqa_native = fn is flash_attention_stream
    return wrapped


def _pick_fused(B: int, T: int, cfg: GPTConfig, device_type: str) -> bool:
    """Gate for the fused LN+QKV / LN+FFN kernels (K8/K9): the JAX
    package's rule, opt-in with ``LINALG_TPU_FUSED_LN=1``, with ``cuda`` in
    the place of the TPU backend. Equal K/V heads (the fused QKV assumes
    equal-width projections), no window (attention must see its band), the
    ReLU FFN (``ln_ffn`` has no gate branch), and ``fused_supported``
    shapes. The JAX package measured them slower than its unfused path on
    the TPU; the gate stays as it is until a benchmark cell on the card
    shows otherwise (PERF.md has the H100 A/B)."""
    if cfg.kv_heads != cfg.n_heads or cfg.window is not None:
        return False
    if cfg.ffn != "relu" or cfg.q_width != cfg.d_model:
        return False
    if os.environ.get("LINALG_TPU_FUSED_LN", "") != "1":
        return False
    return device_type == "cuda" and fused_supported(B * T, cfg.d_model,
                                                     cfg.dff)


# The JAX package's btd-vs-rematted-sdpa crossover, measured on its TPU:
# the (B, T, H*d) kernel pays off once the (B, H, T, T) score tensor it
# keeps out of device memory is this large (~B >= 128 at the published
# config). Kept as it is until an H100 benchmark cell can move it.
_BTD_MIN_SCORE_ELEMS = 32 * 1024 * 1024


def _pick_attn_btd(B: int, T: int, cfg: GPTConfig, device_type: str):
    """(B, T, H*d)-layout attention for the short-context training path
    (K7), or None: the JAX package's rule with ``cuda`` in the place of
    the TPU backend. On by itself when B*H*T^2 >= 32M score elements;
    ``LINALG_TPU_BTD_ATTN=0/1`` forces it off/on (the size test only).
    Never with RoPE; only for T < 512 and a multiple of 256, and
    ``btd_supported`` shapes. ``_gpt_trunk`` also keeps it from ALiBi,
    grouped K/V and a window."""
    force = os.environ.get("LINALG_TPU_BTD_ATTN", "")
    if force == "0":
        return None
    if force != "1" and B * cfg.n_heads * T * T < _BTD_MIN_SCORE_ELEMS:
        return None
    if device_type != "cuda" or cfg.pos == "rope":
        return None
    if not (T < 512 and T % 256 == 0):
        return None
    if not btd_supported(B, T, cfg.d_model, cfg.n_heads):
        return None
    return lambda q, k, v: attention_btd(q, k, v, cfg.n_heads, True)


def _padded_attn(fn, T: int, Tp: int):
    """Wrap a causal attention kernel ``fn(q, k, v, causal)`` to serve
    ragged T <= Tp: right-pad to Tp and slice back. Exact under the causal
    mask: real rows never see the padded keys, and the padded rows are
    thrown away."""

    def padded(q, k, v, mask):
        if Tp == T:
            return fn(q, k, v, True)
        pad = (0, 0, 0, Tp - T)
        out = fn(F.pad(q, pad), F.pad(k, pad), F.pad(v, pad), True)
        return out[..., :T, :]

    return padded


def _gpt_trunk(params: Params, x_ids, cfg: GPTConfig,
               attn_fn: Optional[Callable] = None):
    """Embedding + layer stack: token ids (B, T) -> final hidden (B, T, D)
    in the compute dtype. Differentiable with respect to ``params``."""
    B, T = x_ids.shape[0], x_ids.shape[-1]
    dev = x_ids.device.type
    gqa = cfg.kv_heads != cfg.n_heads
    attn_btd = None
    if (attn_fn is None and cfg.pos != "alibi" and not gqa
            and cfg.window is None and cfg.q_width == cfg.d_model):
        # the (B, T, H*d) kernel takes the raw QKV projections: no
        # grouped K/V, and a pure causal mask (no band, no bias)
        attn_btd = _pick_attn_btd(B, T, cfg, dev)
    fused = (not gqa) and _pick_fused(B, T, cfg, dev)
    dt = cfg.compute_dtype
    h, rope = _embed(params, x_ids, cfg, T, dt)
    kinds = _layer_kinds(cfg, T, dt, h.device, rope, attn_fn)
    for lp, (fn, mask, rp) in zip(_layer_params(params, dt), kinds):
        h, _ = _layer(h, lp, mask, cfg.n_heads, cfg.kv_heads, cfg.ffn,
                      fn, rp, fused, attn_btd)
    return h


def gpt_apply(params: Params, x_ids, cfg: GPTConfig,
              attn_fn: Optional[Callable] = None):
    """Forward pass: token ids (B, T) -> float32 logits (B, T, V).

    ``attn_fn`` defaults to ``_pick_attn``'s choice for the ids' device;
    pass ``sdpa`` to force the explicit-matmul path."""
    dt = cfg.compute_dtype
    return _head(params, _gpt_trunk(params, x_ids, cfg, attn_fn), dt)


# Vocabularies at least this wide take the chunked CE: the full (B*T, V)
# logits, which autograd would also save, stop fitting comfortably once
# BPE vocabularies reach the tens of thousands.
CE_CHUNK_THRESHOLD = 8192


def gpt_loss(params: Params, x_ids, y_ids, cfg: GPTConfig,
             attn_fn: Optional[Callable] = None):
    """Mean softmax cross-entropy over all positions: float32 logits and
    logsumexp, differentiated by autograd (JAX autodiff there too). Wide
    vocabularies (>= ``CE_CHUNK_THRESHOLD``) stream the tied head through
    ``nn.losses.chunked_softmax_ce`` (its hand-derived backward), so the
    (B*T, V) logits are never formed."""
    return _hidden_loss(params, _gpt_trunk(params, x_ids, cfg, attn_fn),
                        y_ids, cfg)


def _hidden_loss(params: Params, h, y_ids, cfg: GPTConfig, head=None):
    """``gpt_loss`` from the trunk's final hidden h (B, T, D): the mean CE
    of the tied head, chunked at wide vocabularies; narrower ones form the
    logits with ``head`` (default ``_head``)."""
    if cfg.vocab_size >= CE_CHUNK_THRESHOLD:
        return chunked_softmax_ce(h, params["tok_W"], params["head_b"],
                                  y_ids)
    logits = (head or _head)(params, h, cfg.compute_dtype)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y_ids[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _uniform(cfg: GPTConfig) -> None:
    """Serving runs one attention kind at the default RoPE base: raise for
    a config whose layers differ (``full_every``, ``rope_scaling``) or
    whose base is another, which only training takes."""
    if (cfg.full_every is not None or cfg.rope_scaling is not None
            or cfg.rope_theta != 10000.0):
        raise ValueError("prefill and decode take one attention kind at "
                         "the default RoPE base; full_every, rope_scaling "
                         "and rope_theta are trained only")


@torch.no_grad()
def gpt_prefill(params: Params, x_ids, cfg: GPTConfig, length=None):
    """Run the prompt; return (next-token logits (B, V), cache).

    ``x_ids`` (B, T), T <= ctx_len, may be right-padded to a fixed window
    with the true length in ``length``: causality keeps the pads inert and
    the logits are read at ``length - 1``. The cache holds k/v
    (L, B, kv_heads, ctx_len, d) padded to ctx_len, and ``length``."""
    _uniform(cfg)
    T = x_ids.shape[1]
    dt = cfg.compute_dtype
    h, rope = _embed(params, x_ids, cfg, T, dt)
    mask = _trunk_mask(cfg, T, dt, h.device)
    ks, vs = [], []
    for lp in _layer_params(params, dt):
        h, (k, v) = _layer(h, lp, mask, cfg.n_heads, cfg.kv_heads, cfg.ffn,
                           rope=rope)
        ks.append(k)
        vs.append(v)
    logits, n = _prefill_head(params, h, length, dt)
    pad = cfg.ctx_len - T
    K = F.pad(torch.stack(ks), (0, 0, 0, pad))
    V = F.pad(torch.stack(vs), (0, 0, 0, pad))
    return logits, {"k": K, "v": V, "length": n}


def _prefill_head(params: Params, h, length, dt):
    """The prefill's next-token logits (B, V) from the final hidden (B, T,
    D), read at ``length - 1`` (the last row when None), and the length
    as an int32 tensor."""
    B, T = h.shape[:2]
    if length is None:
        return (_head(params, h[:, -1], dt),
                torch.tensor(T, dtype=torch.int32, device=h.device))
    n = torch.as_tensor(length, dtype=torch.int32, device=h.device)
    return _head(params, h[torch.arange(B, device=h.device), n.long() - 1],
                 dt), n


def init_decode_cache(cfg: GPTConfig, batch: int = 1, device=None):
    """A zeroed decode cache: k/v (L, batch, kv_heads, ctx_len, d_head) in
    the compute dtype, and ``length``."""
    return fkv_init(cfg.n_layers, batch, cfg.kv_heads, cfg.ctx_len,
                    cfg.d_head, dtype=cfg.compute_dtype, device=device)


@torch.no_grad()
def gpt_prefill_batched(params: Params, x_ids, start, cfg: GPTConfig):
    """Batched prefill of LEFT-padded prompts with per-row starts.

    ``x_ids`` (B, W) holds each prompt right-aligned (content in
    [start[b], W)), so every row ends at column W and the batch shares one
    decode position. Row b's token at column t sits at logical position
    t - start[b] (clipped at 0 for the masked pad columns) for every
    positional encoding; attention is causal, limited to columns >=
    start[b] and to the window band (column-relative: the rows share the
    shift), and ALiBi's bias is relative, so the shift cancels. The cache
    carries ``start`` so decode keeps masking the pad slots."""
    _uniform(cfg)
    dev = params["tok_W"].device
    x_ids = torch.as_tensor(x_ids, device=dev).long()
    B, W = x_ids.shape
    dt = cfg.compute_dtype
    start = torch.as_tensor(start, dtype=torch.int32, device=dev).reshape(B)
    cols = torch.arange(W, device=dev)
    pos_idx = torch.clamp(cols[None, :] - start[:, None], min=0)  # (B, W)
    rope = None
    h = params["tok_W"][x_ids]
    if cfg.pos == "rope":
        c, s_ = rope_tables(cfg.d_head, pos_idx)  # (B, W, d/2)
        rope = (c[:, None].to(dt), s_[:, None].to(dt))
    elif cfg.pos != "alibi":
        pe = (params["pos_W"] if cfg.pos == "learned" else
              sinusoidal_encoding(cfg.ctx_len, cfg.d_model, device=dev))
        h = h + pe[pos_idx]
    h = h.to(dt)
    live = ((cols[None, :, None] >= cols[None, None, :])
            & (cols[None, None, :] >= start[:, None, None]))
    if cfg.window is not None:
        live &= (cols[None, :, None] - cols[None, None, :]) < cfg.window
    mask = torch.where(live, 0.0, -1e9).to(dt)[:, None]  # (B, 1, W, W)
    if cfg.pos == "alibi":
        sl = alibi_slopes(cfg.n_heads, device=dev)
        bias = sl[:, None, None] * (cols[None, None, :]
                                    - cols[None, :, None]).float()
        mask = mask + bias.to(dt)[None]  # (B, H, W, W)
    ks, vs = [], []
    for lp in _layer_params(params, dt):
        h, (k, v) = _layer(h, lp, mask, cfg.n_heads, cfg.kv_heads, cfg.ffn,
                           rope=rope)
        ks.append(k)
        vs.append(v)
    logits = _head(params, h[:, -1], dt)
    pad = cfg.ctx_len - W
    K = F.pad(torch.stack(ks), (0, 0, 0, pad))
    V = F.pad(torch.stack(vs), (0, 0, 0, pad))
    return logits, {"k": K, "v": V, "length": torch.tensor(
        W, dtype=torch.int32, device=dev), "start": start}


def gpt_generate(params: Params, cfg: GPTConfig, prompts, n_tokens: int,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0,
                 generator: Optional[torch.Generator] = None):
    """Batched generation: ragged prompts in, (B, n_tokens) sampled ids
    out (a tensor on the parameters' device), one batched decode step per
    token for the whole batch.

    Each prompt keeps its last ctx_len - n_tokens ids; they are left-padded
    to that one window (aligned ends) and decoded together; an MoE config
    prefills through ``moe_prefill_batched`` and decodes through
    ``moe_decode_chunk``. Sampling draws from ``generator``, by default a
    generator on the parameters' device seeded with ``seed``."""
    if n_tokens >= cfg.ctx_len:
        raise ValueError("n_tokens must be < ctx_len (cache capacity)")
    W = cfg.ctx_len - n_tokens
    prompts = [np.asarray(p, dtype=np.int64).ravel()[-W:] for p in prompts]
    B = len(prompts)
    buf = np.zeros((B, W), dtype=np.int64)
    start = np.empty((B,), dtype=np.int32)
    for b, p in enumerate(prompts):
        if len(p) == 0:
            raise ValueError(f"prompt {b} is empty")
        start[b] = W - len(p)
        buf[b, start[b]:] = p
    dev = params["tok_W"].device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    from .moe import MoEGPTConfig

    if isinstance(cfg, MoEGPTConfig):  # left pads stay out of routing
        from .moe import moe_decode_chunk as decode_chunk
        from .moe import moe_prefill_batched as prefill_batched
    else:
        decode_chunk, prefill_batched = gpt_decode_chunk, gpt_prefill_batched
    logits, cache = prefill_batched(params, torch.from_numpy(buf),
                                    torch.from_numpy(start), cfg)
    toks, _, _ = decode_chunk(params, cache, logits, generator, cfg,
                              n_tokens, temperature, top_k, top_p)
    return toks


@torch.no_grad()
def gpt_decode_step(params: Params, cache, token, cfg: GPTConfig):
    """One incremental decode step: token (B,) -> (float32 logits (B, V),
    cache'). The token sits at cache slot ``cache["length"]`` and attends
    to the live slots (>= ``cache["start"]`` of a left-padded batch, and
    within the window); the cache's k/v buffers are written in place."""
    dev = params["tok_W"].device
    ops = _dt_decode_ops(params, cfg)
    pos = int(cache["length"])
    step = _make_decode_step(cfg, ops, cache.get("start", 0), fkv_write)
    K, V, logits = step(cache["k"], cache["v"], pos,
                        torch.as_tensor(token, device=dev).long().reshape(-1))
    return logits, dict(cache, k=K, v=V, length=torch.tensor(
        pos + 1, dtype=torch.int32, device=dev))


def filter_logits(logits, temperature=1.0, top_k=0, top_p=0.0):
    """Temperature / top-k / top-p transform of float32 logits.

    ``top_k`` is a Python int (one k for every row) or a per-row integer
    tensor ((B,) or (B, 1)); k <= 0 disables it for that row. ``temperature``
    and ``top_p`` are scalars or per-row (B, 1) tensors; top_p outside
    (0, 1) disables nucleus filtering. Filtered entries become -1e9."""
    dev = logits.device
    if isinstance(temperature, torch.Tensor):
        z = logits / torch.clamp_min(temperature, 1e-6)
    else:
        z = logits / max(1e-6, float(temperature))
    V = z.shape[-1]
    if isinstance(top_k, (int, np.integer)):
        if top_k > 0:
            kth = torch.topk(z, int(top_k), dim=-1).values[..., -1:]
            z = torch.where(z < kth, -1e9, z)
    else:
        k = torch.as_tensor(top_k, dtype=torch.int64, device=dev)
        k = k.reshape(k.shape + (1,) * (z.ndim - k.ndim))
        zs = torch.sort(z, dim=-1, descending=True).values
        kth = torch.gather(zs, -1, torch.clamp(k, 1, V).expand(
            zs.shape[:-1] + (1,)) - 1)
        z = torch.where((k > 0) & (z < kth), -1e9, z)
    if isinstance(top_p, torch.Tensor):
        p_eff = torch.where((top_p > 0.0) & (top_p < 1.0), top_p, 1.0)
    else:
        p_eff = float(top_p) if 0.0 < top_p < 1.0 else 1.0
    probs = torch.softmax(z, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    csum = torch.cumsum(sp, dim=-1)
    keep = (csum - sp) < p_eff
    thr = torch.amin(torch.where(keep, sp, torch.inf), dim=-1, keepdim=True)
    return torch.where(probs >= thr, z, -1e9)


def _categorical(z, generator: Optional[torch.Generator]):
    """One draw per row from softmax(z), by the Gumbel-max trick (the
    algorithm ``jax.random.categorical`` uses)."""
    u = torch.rand(z.shape, generator=generator, device=z.device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return torch.argmax(z - torch.log(-torch.log(u.clamp_min(tiny))), dim=-1)


def sample_token(generator, logits, temperature=1.0, top_k=0, top_p=0.0):
    """Temperature / top-k / top-p sampling of one token per row."""
    return _categorical(filter_logits(logits, temperature, top_k, top_p),
                        generator)


def _dt_decode_ops(params: Params, cfg: GPTConfig) -> Dict[str, Any]:
    """Decode ops over weights cast ONCE to the compute dtype, with Q/K/V
    fused into one (D, D + 2*kv_heads*d_head) matrix per layer, and a
    gated FFN's up and gate branches into one (D, 2F) matrix. ``lws`` is
    the per-layer list the decode loops walk; ``device`` the weights'
    device (``models.quant._q_decode_ops`` returns the same keys)."""
    dt = cfg.compute_dtype
    lws = [{"lp": lp, "W3": torch.cat([lp["Wq"], lp["Wk"], lp["Wv"]], -1)}
           for lp in _layer_params(params, dt)]
    tokW = params["tok_W"].to(dt)
    head_b = params["head_b"].to(dt)
    pe = None
    if cfg.pos not in ("rope", "alibi"):
        pe = (params["pos_W"] if cfg.pos == "learned" else
              sinusoidal_encoding(cfg.ctx_len, cfg.d_model,
                                  device=tokW.device)).to(dt)
    if cfg.gated_ffn:
        for lw in lws:
            lw["W1g"] = torch.cat([lw["lp"]["W1"], lw["lp"]["Wg"]], -1)
            lw["b1g"] = torch.cat([lw["lp"]["b1"], lw["lp"]["bg"]], -1)
        gate_fn = swiglu if cfg.ffn == "swiglu" else geglu

        def ffn(lw, x2):
            Fd = lw["lp"]["W1"].shape[-1]  # a tensor-parallel rank's F/tp
            ug = x2 @ lw["W1g"] + lw["b1g"]  # (B, 1, 2F)
            return (gate_fn(ug[..., :Fd], ug[..., Fd:]) @ lw["lp"]["W2"]
                    + lw["lp"]["b2"])
    else:
        act = gelu if cfg.ffn == "gelu" else relu

        def ffn(lw, x2):
            return (act(x2 @ lw["lp"]["W1"] + lw["lp"]["b1"])
                    @ lw["lp"]["W2"] + lw["lp"]["b2"])
    return {
        "lws": lws,
        "device": tokW.device,
        "embed": lambda token: tokW[token][:, None, :],
        # clamp: an idle serving slot's position grows past the table
        "pe": (None if pe is None else lambda rel: pe[
            torch.clamp(rel, max=cfg.ctx_len - 1).long()][:, None]),
        "ln1": lambda lw, x: layer_norm(x, lw["lp"]["ln1_g"],
                                        lw["lp"]["ln1_b"]),
        "qkv": lambda lw, xn: xn @ lw["W3"],
        "out": lambda lw, y: y @ lw["lp"]["Wo"],
        "ln2": lambda lw, x: layer_norm(x, lw["lp"]["ln2_g"],
                                        lw["lp"]["ln2_b"]),
        "ffn": ffn,
        "head": lambda h: (h @ tokW.T + head_b).float(),
    }


def _positions(x, dev):
    """Positions as an int32 (B|1,) tensor on ``dev``. A Python position
    is filled in on the device: a copy from the host would wait for the
    device's queue to drain (a host sync every decoded token)."""
    if isinstance(x, (int, np.integer)):
        return torch.full((1,), int(x), dtype=torch.int32, device=dev)
    return torch.as_tensor(x, dtype=torch.int32, device=dev).reshape(-1)


def _attn_out(ops, lw, h, rope, mask, kb, vb, pos, write_fn, attn,
              heads):
    """One layer's attention branch against KV buffers: LN, the fused QKV
    projection, RoPE, ``write_fn(kb, vb, pos, k, v)`` (in place), ``attn(q,
    k_l, v_l, mask)`` and Wo; returns the Wo output (B, S, D). ``heads`` =
    (query heads, KV heads, d_head) of the weights in ``lw``: the model's,
    or a tensor-parallel rank's (its Wo output is then a partial sum)."""
    H, hk, dh = heads
    qkv = ops["qkv"](lw, ops["ln1"](lw, h))
    q = _heads(qkv[..., :H * dh], H)
    k = _heads(qkv[..., H * dh:(H + hk) * dh], hk)
    v = _heads(qkv[..., (H + hk) * dh:], hk)
    if rope is not None:  # cached keys are stored rotated
        q = rope_rotate(q, *rope)
        k = rope_rotate(k, *rope)
    k_l, v_l = write_fn(kb, vb, pos, k, v)
    return ops["out"](lw, _unheads(attn(q, k_l, v_l, mask)))


def _decode_inputs(cfg: GPTConfig, ops, start1, pos1, token, t_ids, slopes):
    """A decode step's (h (B|1, 1, D) in the compute dtype, RoPE tables or
    None, additive mask (B|1, 1|H, 1, ctx)) for ``token`` at the per-row
    positions ``pos1``, rows ``start1`` on; ``slopes`` the ALiBi slopes or
    None."""
    dt = cfg.compute_dtype
    rel = pos1 - start1
    rope = None
    if cfg.pos == "rope":  # tables at the relative position
        c, s_ = rope_tables(cfg.d_head, rel[:, None])  # (B|1, 1, d/2)
        rope = (c[:, None].to(dt), s_[:, None].to(dt))
        h = ops["embed"](token).to(dt)
    elif cfg.pos == "alibi":
        h = ops["embed"](token).to(dt)
    else:
        h = (ops["embed"](token) + ops["pe"](rel)).to(dt)
    live = ((t_ids[None, :] <= pos1[:, None])
            & (t_ids[None, :] >= start1[:, None]))
    if cfg.window is not None:
        live &= t_ids[None, :] > pos1[:, None] - cfg.window
    mask = torch.where(live, 0.0, -1e9).to(dt)[:, None, None, :]
    if slopes is not None:
        # key slot j vs the query at ``pos``: slope_h * (j - pos); j > pos
        # is inert under the -1e9 of the live mask
        bias = (slopes[None, :, None, None]
                * (t_ids[None, :] - pos1[:, None]).float()[:, None, None, :])
        mask = mask + bias.to(dt)
    return h, rope, mask


def _make_decode_step(cfg: GPTConfig, ops, start, write_fn):
    """One-token decode step factory.

    Returns ``decode_step(kbuf, vbuf, pos, token) -> (K, V, logits)``: embed
    ``token`` at position ``pos`` (scalar or per-row), run the layers
    against the KV buffers (L, ...), write each layer's new K/V with
    ``write_fn`` (in place) and return float32 next-token logits.
    ``ops["attn"]`` replaces the grouped decode attention; with a
    ``wants_pos`` attribute it also receives the per-row positions.
    ``ops["layers"](h, rope, mask, kbuf, vbuf, pos, write_fn)`` replaces
    the layer loop (tensor-parallel serving: per-rank buffers)."""
    heads = (cfg.n_heads, cfg.kv_heads, cfg.d_head)
    attn = ops.get("attn") or _gqa_decode_attn
    wants_pos = getattr(attn, "wants_pos", False)
    layers = ops.get("layers")
    dev = ops["device"]
    t_ids = torch.arange(cfg.ctx_len, device=dev)
    start1 = _positions(start, dev)
    slopes = (alibi_slopes(cfg.n_heads, device=dev) if cfg.pos == "alibi"
              else None)

    def decode_step(kbuf, vbuf, pos, token):
        pos1 = _positions(pos, dev)
        h, rope, mask = _decode_inputs(cfg, ops, start1, pos1, token, t_ids,
                                       slopes)
        if layers is not None:
            h = layers(h, rope, mask, kbuf, vbuf, pos, write_fn)
            return kbuf, vbuf, ops["head"](h[:, -1])
        at = ((lambda q, k, v, m: attn(q, k, v, m, pos1)) if wants_pos
              else attn)
        for i, lw in enumerate(ops["lws"]):
            h1 = h + _attn_out(ops, lw, h, rope, mask, kbuf[i], vbuf[i], pos,
                               write_fn, at, heads)
            h = h1 + ops["ffn"](lw, ops["ln2"](lw, h1))
        return kbuf, vbuf, ops["head"](h[:, -1])

    return decode_step


@torch.no_grad()
def _decode_chunk_core(cfg: GPTConfig, ops, logits, kbuf, vbuf, pos0, start,
                       generator, n_tokens: int, temperature, top_k, top_p,
                       write_fn):
    """Sample -> decode-step loop shared by every decode chunk.

    ``pos0``/``start`` are scalars (one shared position) or per-row vectors
    (per-slot positions); ``temperature``/``top_p`` scalars or (B, 1)
    tensors; ``top_k`` an int or per-row tensor. Returns (tokens (B, n),
    logits, K, V, pos)."""
    decode_step = _make_decode_step(cfg, ops, start, write_fn)
    pos, toks = pos0, []
    for _ in range(n_tokens):
        tok = _categorical(filter_logits(logits, temperature, top_k, top_p),
                           generator)
        kbuf, vbuf, logits = decode_step(kbuf, vbuf, pos, tok)
        pos = pos + 1
        toks.append(tok)
    return torch.stack(toks, dim=1), logits, kbuf, vbuf, pos


def gpt_decode_chunk(params, cache, logits, generator, cfg: GPTConfig,
                     n_tokens: int, temperature=1.0, top_k: int = 0,
                     top_p=0.0):
    """Sample ``n_tokens`` autoregressively from a prefilled cache (one
    shared position ``cache["length"]``; a left-padded batch's per-row
    ``cache["start"]``). The cache's k/v buffers are updated in place;
    returns (tokens (B, n), logits, cache). The loop reads nothing back
    to the host."""
    ops = _dt_decode_ops(params, cfg)
    pos0 = int(cache["length"])
    toks, logits, K, V, pos = _decode_chunk_core(
        cfg, ops, logits, cache["k"], cache["v"], pos0,
        cache.get("start", 0), generator, n_tokens, temperature, top_k,
        top_p, fkv_write)
    return toks, logits, dict(cache, k=K, v=V, length=torch.as_tensor(
        pos, dtype=torch.int32, device=logits.device))
