"""Mixture-of-Experts GPT — the counterpart of ``linalg_tpu/models/moe.py``.

Each layer carries E expert FFNs stacked on a leading expert axis and a
linear router; every token goes to its top-1 (Switch) or top-k (GShard,
k >= 2: the chosen probabilities renormalised to sum to one) experts
under a per-expert capacity, with the Switch load-balancing loss
``E * sum_e f_e * P_e``. Tokens over capacity get a zero FFN output (the
residual carries them). Routing groups are the rows of the batch.

The port adds a third dispatch, ``"grouped"`` (the JAX package has none
like it): dropless, every assignment computed, the routed rows sorted by
expert and run through K13, the grouped GEMM (``kernels.grouped_gemm``),
with the group offsets kept on the device. While a profiler records it
marks ``moe.route``, ``moe.dispatch``, ``moe.experts`` and ``moe.combine``
and counts each layer's routed rows (``utils.profiling.count``,
``moe.rows``: the rows its held experts took and the largest expert's).

Same parameters as the JAX package (``init_moe_params`` draws the same
numpy stream in the same order), same routing rule, same two dispatch
implementations (dense one-hot einsums, or slot -> token index gathers).
Plain differentiable tensor ops, as the JAX module is plain ``jnp`` under
``jax.grad``; the LayerNorm, attention and loss underneath keep the
port's hand-derived ``autograd.Function``s, and ``_pick_fused`` opens K8
(``ln_qkv``) for the attention half exactly as it does for the dense GPT.
Prefill and decode run ``sdpa`` without gradients, as the JAX package's
do.

Where PyTorch differs from XLA and the code takes care:

- ``lax.top_k`` breaks ties toward the lower expert; ``torch.topk``
  promises no order, so the pick is a stable descending sort.
- ``jax.nn.one_hot`` gives a zero row for an index >= C (how overflow
  tokens drop); the slot one-hot here is an equality against ``arange(C)``.
- The gather mode's slot table sends overflow and pad tokens to a sink
  slot C (several writers, any winner), outside the slice that is read.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels.grouped_gemm import GroupedFFN, RowSum
from ..nn.cache import fkv_write
from ..nn.functional import (geglu, geglu_backward, gelu, gelu_backward,
                             layer_norm, relu, relu_backward, rope_tables,
                             sdpa, sinusoidal_encoding, swiglu,
                             swiglu_backward)
from ..nn.positional import alibi_slopes
from ..utils.profiling import count, span
from .gpt import (GPTConfig, _attn_half, _decode_chunk_core, _embed, _head,
                  _hidden_loss, _layer_kinds, _layer_params,
                  _make_decode_step, _pick_fused, _trunk_mask, _uniform)

__all__ = ["MoEGPTConfig", "init_moe_params", "moe_ffn", "moe_gpt_apply",
           "moe_gpt_loss", "moe_prefill", "moe_prefill_batched",
           "moe_decode_step", "moe_decode_chunk"]

Params = Dict[str, Any]

# router math, slot counts and the aux loss, whatever the compute dtype:
# bf16 probabilities perturb routing, and bf16 counts saturate at 256
_ROUTER_DTYPE = torch.float32


@dataclasses.dataclass(frozen=True)
class MoEGPTConfig(GPTConfig):
    """Same fields and validation as ``linalg_tpu.models.moe.MoEGPTConfig``."""

    n_experts: int = 8
    capacity_factor: float = 1.25
    aux_weight: float = 0.01
    router_top_k: int = 1  # 1 = Switch, 2 = GShard top-2 (grouped: any k)
    dispatch: str = "einsum"  # "einsum" | "gather" | "grouped" (moe_ffn)

    def __post_init__(self):
        super().__post_init__()
        if self.dispatch != "grouped":  # the JAX package's rules, verbatim
            if self.router_top_k not in (1, 2):
                raise ValueError("router_top_k must be 1 or 2")
            if self.dispatch not in ("gather", "einsum"):
                raise ValueError("dispatch must be 'gather' or 'einsum'")
        elif self.router_top_k < 1:  # dropless: any k of the n_experts
            raise ValueError("router_top_k must be >= 1")
        if self.router_top_k > self.n_experts:
            raise ValueError("router_top_k cannot exceed n_experts")


def init_moe_params(cfg: MoEGPTConfig, seed: int = 123,
                    device=None) -> Params:
    """GPT params with a per-layer router ``Wr`` (L, D, E) and expert-stacked
    ``W1/b1/W2/b2`` (L, E, ...) (and ``Wg/bg`` for swiglu/geglu experts):
    the JAX package's draws in its order, float64 rounded to float32."""
    rng = np.random.default_rng(seed)
    D, Fd, L, V, E = (cfg.d_model, cfg.dff, cfg.n_layers, cfg.vocab_size,
                      cfg.n_experts)

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
        # small router init: early routing is near-uniform
        "Wr": t(rng.normal(0.0, 0.02, size=(L, D, E))),
        "W1": he(D, (L, E, D, Fd)),
        "b1": t(np.zeros((L, E, Fd))),
        "W2": he(Fd, (L, E, Fd, D)),
        "b2": t(np.zeros((L, E, D))),
    }
    if cfg.gated_ffn:
        layers["Wg"] = he(D, (L, E, D, Fd))
        layers["bg"] = t(np.zeros((L, E, Fd)))
    out = {
        "tok_W": t(rng.normal(0.0, 0.02, size=(V, D))),
        "head_b": t(np.zeros((V,))),
        "layers": layers,
    }
    if cfg.pos == "learned":
        out["pos_W"] = t(rng.normal(0.0, 0.02, size=(cfg.ctx_len, D)))
    return out


def _expert_mlp(xin, W1, b1, W2, b2, Wg, bg, ffn: str):
    """The per-expert MLP over dispatched slots ``xin`` (B, E, C, D):
    relu/gelu, or swiglu/geglu with the gate branch ``Wg``/``bg``."""
    u = torch.einsum("becd,edf->becf", xin, W1) + b1[None, :, None, :]
    if ffn in ("swiglu", "geglu"):
        gate_fn = swiglu if ffn == "swiglu" else geglu
        h = gate_fn(u, torch.einsum("becd,edf->becf", xin, Wg)
                    + bg[None, :, None, :])
    else:
        h = gelu(u) if ffn == "gelu" else relu(u)
    return torch.einsum("becf,efd->becd", h, W2) + b2[None, :, None, :]


def _route(x, Wr, top_k: int):
    """(router probs (B, T, E) in ``_ROUTER_DTYPE``, expert ids (B, T, K),
    gates (B, T, K) in x's dtype). A stable descending sort picks the top
    k, so a tie goes to the lower expert, as ``lax.top_k`` breaks it. At
    k >= 2 the gates are the chosen probabilities over their sum (Hugging
    Face's ``norm_topk_prob``)."""
    probs = torch.softmax((x @ Wr).to(_ROUTER_DTYPE), dim=-1)
    vals, idxs = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idxs = vals[..., :top_k], idxs[..., :top_k]
    if top_k == 1:
        gates = vals  # Switch: the raw top-1 probability
    else:
        # GShard: renormalized, a convex mix of the chosen experts
        gates = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    return probs, idxs, gates.to(x.dtype)


def moe_ffn(x, Wr, W1, b1, W2, b2, capacity: int, top_k: int = 1,
            mode: str = "einsum", valid=None, Wg=None, bg=None,
            ffn: str = "relu", expert_offset: int = 0,
            stats: bool = False) -> Tuple[torch.Tensor, Any]:
    """Top-k routed expert FFN, each row of x one routing group.

    x (B, T, D); Wr (D, E); W1 (E, D, F); b1 (E, F); W2 (E, F, D); b2
    (E, D). Returns (out (B, T, D), aux loss in ``_ROUTER_DTYPE``).
    ``capacity`` is the per-expert slot budget of a row. Capacity is
    granted level by level: every first choice queues ahead of any second
    choice, positional (cumsum) order within a level. ``valid`` (B, T)
    bool keeps tokens out of routing altogether (zero output, no capacity
    taken, not in the aux loss): the batched prefill's left pads.

    ``mode`` "einsum": dense 0/1 dispatch and combine tensors (B, T, E, C),
    slot bookkeeping in ``_ROUTER_DTYPE`` whatever the compute dtype (bf16
    counts saturate at 256). "gather": an int slot -> token table and row
    gathers. The two compute the same function.

    "grouped": dropless (``capacity`` is not read), every token's k
    assignments computed through K13 (``_grouped_ffn``).

    Expert parallelism (einsum and grouped modes): W1 ... hold the experts
    ``expert_offset`` to ``expert_offset + W1.shape[0]`` of the router's E;
    routing runs over all E, and ``out`` is those experts' share of the
    combine (the shares sum to the whole). ``stats=True`` returns the
    load-balance statistics (f, P) (E,) in place of the aux loss
    ``E * sum(f * P)``, for a caller that averages them over a split
    batch first."""
    B, T, D = x.shape
    E = Wr.shape[-1]
    El = E if W1 is None else W1.shape[0]
    if El != E and mode == "gather":
        raise ValueError("an expert slice needs the einsum or grouped "
                         "dispatch")
    C = capacity
    dev = x.device
    with span("moe.route", dev):
        probs, idxs, gates = _route(x, Wr, top_k)
    rdt = _ROUTER_DTYPE
    validf = None if valid is None else valid.to(rdt)
    if mode == "grouped":
        out = _grouped_ffn(x, idxs, gates, W1, b1, W2, b2, Wg, bg, ffn,
                           expert_offset, valid)
        onehot1 = F.one_hot(idxs[..., 0], E).to(rdt)
        if valid is not None:
            onehot1 = onehot1 * validf[..., None]
    elif mode == "gather":
        b_ix = torch.arange(B, device=dev)[:, None]  # (B, 1)
        t_ix = torch.arange(T, device=dev)[None, :].expand(B, T)
        # slot -> token table: slot C is the overflow sink, token T the
        # empty sentinel (both read as zero rows)
        tok_slot = torch.full((B, E, C + 1), T, dtype=torch.long, device=dev)
        offset = torch.zeros((B, E), dtype=torch.long, device=dev)
        lvl_slots = []
        for lvl in range(top_k):
            e_id = idxs[..., lvl]  # (B, T)
            oh = F.one_hot(e_id, E)  # exact integer counts
            if valid is not None:
                oh = oh * valid[..., None].long()
            pos = torch.cumsum(oh, dim=1) - oh
            pos_tok = torch.gather(pos, -1, e_id[..., None])[..., 0]
            pos_tok = pos_tok + torch.gather(offset, 1, e_id)
            slot = torch.clamp(pos_tok, max=C)  # overflow -> the sink
            if valid is not None:
                slot = torch.where(valid, slot, C)  # pads -> the sink
            tok_slot[b_ix, e_id, slot] = t_ix
            lvl_slots.append((e_id, slot))
            offset = offset + oh.sum(1)
        onehot1 = F.one_hot(idxs[..., 0], E).to(rdt)
        if valid is not None:
            onehot1 = onehot1 * validf[..., None]
        x_pad = torch.cat([x, x.new_zeros((B, 1, D))], dim=1)
        xin = x_pad[b_ix[..., None], tok_slot[:, :, :C]]  # (B, E, C, D)
        out_e = _expert_mlp(xin, W1, b1, W2, b2, Wg, bg, ffn)
        out_e_pad = torch.cat([out_e, out_e.new_zeros((B, E, 1, D))], dim=2)
        out = x.new_zeros((B, T, D))
        for lvl, (e_id, slot) in enumerate(lvl_slots):
            out = out + out_e_pad[b_ix, e_id, slot] * gates[..., lvl, None]
    else:
        dispatch = x.new_zeros((B, T, E, C))
        combine = x.new_zeros((B, T, E, C))
        offset = torch.zeros((B, E), dtype=rdt, device=dev)
        slots = torch.arange(C, dtype=rdt, device=dev)
        onehot1 = None
        for lvl in range(top_k):
            oh = F.one_hot(idxs[..., lvl], E).to(rdt)
            if valid is not None:
                oh = oh * validf[..., None]
            if lvl == 0:
                onehot1 = oh
            pos = torch.cumsum(oh, dim=1) - oh + offset[:, None, :]
            pos_tok = torch.sum(pos * oh, dim=-1)  # (B, T)
            keep = (pos_tok < C).to(rdt)
            # one_hot(pos_tok, C) with a zero row past C
            slot = (pos_tok[..., None] == slots).to(rdt)
            d = (oh[..., None] * slot[..., None, :]
                 * keep[..., None, None]).to(x.dtype)  # exact 0/1
            dispatch = dispatch + d
            combine = combine + d * gates[..., lvl, None, None]
            offset = offset + oh.sum(1)
        if El != E:  # this rank's experts
            sl = slice(expert_offset, expert_offset + El)
            dispatch, combine = dispatch[:, :, sl], combine[:, :, sl]
        xin = torch.einsum("btec,btd->becd", dispatch, x)  # (B, E, C, D)
        out_e = _expert_mlp(xin, W1, b1, W2, b2, Wg, bg, ffn)
        out = torch.einsum("btec,becd->btd", combine, out_e)
    # Switch load balance over the routed tokens: first-choice
    # fractions f against mean router probabilities P
    if valid is None:
        f = onehot1.mean(dim=(0, 1))
        P_mean = probs.mean(dim=(0, 1))
    else:
        n_valid = torch.clamp_min(validf.sum(), 1.0)
        f = onehot1.sum(dim=(0, 1)) / n_valid
        P_mean = (probs * validf[..., None]).sum(dim=(0, 1)) / n_valid
    if stats:
        return out, (f, P_mean)
    return out, E * torch.sum(f * P_mean)


# (forward, backward) of each FFN activation, for ``GroupedFFN``
_ACTS = {"swiglu": (swiglu, swiglu_backward), "geglu": (geglu, geglu_backward),
         "gelu": (gelu, gelu_backward), "relu": (relu, relu_backward)}


def _grouped_ffn(x, idxs, gates, W1, b1, W2, b2, Wg, bg, ffn: str,
                 expert_offset: int, valid=None):
    """The dropless routed FFN of the held experts ``expert_offset`` ..
    ``expert_offset + El``: every (token, choice) assignment to one of them
    is a row. Rows are sorted by expert (a stable sort: token order within
    an expert), group e's rows are ``offs[e]:offs[e + 1]`` with ``offs`` on
    the device, and the buffers are sized for the most rows any routing
    can give, N * min(k, El), plus one zero row; nothing is read back to
    the host. K13 computes the experts (``GroupedFFN``), each row scaled
    by its gate before W2; ``RowSum`` adds each token's rows back."""
    B, T, D = x.shape
    N, k = B * T, idxs.shape[-1]
    El = W1.shape[0]
    dev = x.device
    with span("moe.dispatch", dev):
        local = idxs.reshape(N, k) - expert_offset
        held = (local >= 0) & (local < El)
        if valid is not None:
            held &= valid.reshape(N, 1)
        key = torch.where(held, local, El).reshape(-1)  # El: not held here
        order = torch.sort(key, stable=True).indices
        # a scatter, not ``bincount``: that reads its input's max back to
        # the host to size its output
        counts = torch.zeros(El + 1, dtype=torch.long,
                             device=dev).scatter_add_(
            0, key, torch.ones_like(key))
        offs = torch.cat([counts.new_zeros(1),
                          torch.cumsum(counts[:El], 0)]).int()
        M = N * min(k, El) + 1
        rows = order[:M - 1]
        rkey = key[rows]
        live = rkey < El
        tok = F.pad((rows // k).int(), (0, 1))
        gate = F.pad(torch.where(live, gates.reshape(-1)[rows], 0), (0, 1))
        onehot = F.one_hot(F.pad(rkey, (0, 1), value=El),
                           El + 1)[:, :El].to(x.dtype)
        slot = torch.empty_like(order)
        slot[order] = torch.arange(N * k, device=dev)
        R = torch.where(held.reshape(-1), slot, M - 1).reshape(N, k)
        count("moe.rows", lambda: torch.stack([counts[:El].sum(),
                                               counts[:El].max()]))
    with span("moe.experts", dev):
        gated = Wg is not None
        W1g = torch.cat([W1, Wg], -1) if gated else W1.contiguous()
        b1g = torch.cat([b1, bg], -1) if gated else b1
        Y = GroupedFFN.apply(x.reshape(N, D), W1g, b1g, W2.contiguous(),
                             gate, tok, offs, onehot, R, _ACTS[ffn], gated)
    with span("moe.combine", dev):
        # the held experts' output biases, each at its token's gate
        gsum = x.new_zeros((N, El + 1)).scatter_add(
            1, key.reshape(N, k), gates.reshape(N, k))
        out = RowSum.apply(Y, R, tok) + gsum[:, :El] @ b2
    return out.reshape(B, T, D)


def _moe_layer(h_in, lp, mask, n_heads: int, attn_fn: Callable, rope,
               capacity: int, top_k: int = 1, fused: bool = False,
               mode: str = "gather", valid=None, n_kv: Optional[int] = None,
               ffn: str = "relu"):
    """Pre-LN decoder block with the routed FFN: (out, (k, v), aux), k/v at
    the grouped head count (the prefill cache). ``fused`` takes K8
    (``ln_qkv``) for LayerNorm + QKV; the FFN stays routed."""
    n_kv = n_heads if n_kv is None else n_kv
    a, kv = _attn_half(h_in, lp, mask, n_heads, n_kv, attn_fn, rope, fused)
    h1 = h_in + a
    x2 = layer_norm(h1, lp["ln2_g"], lp["ln2_b"])
    f, aux = moe_ffn(x2, lp["Wr"], lp["W1"], lp["b1"], lp["W2"], lp["b2"],
                     capacity, top_k, mode, valid, Wg=lp.get("Wg"),
                     bg=lp.get("bg"), ffn=ffn)
    return h1 + f, kv, aux


def _capacity(cfg: MoEGPTConfig, group_tokens: int) -> int:
    """Per-expert slot budget of a routing group of ``group_tokens``;
    scales with router_top_k (top-2 dispatches ~2x the assignments)."""
    return max(1, int(math.ceil(cfg.capacity_factor * cfg.router_top_k
                                * group_tokens / cfg.n_experts)))


def _moe_trunk(params: Params, x_ids, cfg: MoEGPTConfig,
               attn_fn: Optional[Callable] = None):
    """Embedding + the routed layer stack: ids (B, T) -> (final hidden
    (B, T, D) in the compute dtype, mean aux loss over the layers). Each
    layer takes its kind's attention, mask and RoPE tables
    (``_layer_kinds``: ``_pick_attn_cfg``'s pick, the flash kernels on the
    card from T 512); ``_pick_fused`` opens K8 for the attention half."""
    B, T = x_ids.shape
    fused = _pick_fused(B, T, cfg, x_ids.device.type)
    dt = cfg.compute_dtype
    h, rope = _embed(params, x_ids, cfg, T, dt)
    kinds = _layer_kinds(cfg, T, dt, h.device, rope, attn_fn)
    cap = _capacity(cfg, T)  # per-row routing groups
    auxes = []
    for lp, (fn, mask, rp) in zip(_layer_params(params, dt), kinds):
        h, _, aux = _moe_layer(h, lp, mask, cfg.n_heads, fn, rp, cap,
                               cfg.router_top_k, fused, cfg.dispatch,
                               n_kv=cfg.kv_heads, ffn=cfg.ffn)
        auxes.append(aux)
    return h, torch.stack(auxes).mean()


def moe_gpt_apply(params: Params, x_ids, cfg: MoEGPTConfig,
                  attn_fn: Optional[Callable] = None):
    """Forward: ids (B, T) -> (float32 logits (B, T, V), mean aux loss over
    the layers). Differentiable with respect to ``params``."""
    h, aux = _moe_trunk(params, x_ids, cfg, attn_fn)
    return _head(params, h, cfg.compute_dtype), aux


def moe_gpt_loss(params: Params, x_ids, y_ids, cfg: MoEGPTConfig,
                 attn_fn: Optional[Callable] = None):
    """Mean cross-entropy plus ``aux_weight`` times the load-balance loss;
    the cross-entropy is ``gpt_loss``'s (``_hidden_loss``: chunked at wide
    vocabularies, so the (B, T, V) logits are never formed)."""
    h, aux = _moe_trunk(params, x_ids, cfg, attn_fn)
    return (_hidden_loss(params, h, y_ids, cfg, _head)
            + cfg.aux_weight * aux)


def _pad_cache(ks, vs, cfg: MoEGPTConfig, T: int):
    pad = (0, 0, 0, cfg.ctx_len - T)
    return F.pad(torch.stack(ks), pad), F.pad(torch.stack(vs), pad)


@torch.no_grad()
def moe_prefill(params: Params, x_ids, cfg: MoEGPTConfig, length=None):
    """Run the prompt; return (next-token logits (B, V), cache).

    ``x_ids`` may be right-padded to a fixed window with the true length
    in ``length``. Pads never take a real token's routing priority (it is
    positional), but the capacity grows with the padded T, so padding can
    only keep a token the unpadded prompt would have dropped: the engine's
    equality is against the window-padded prefill for that reason."""
    _uniform(cfg)
    B, T = x_ids.shape
    dt = cfg.compute_dtype
    h, rope = _embed(params, x_ids, cfg, T, dt)
    mask = _trunk_mask(cfg, T, dt, h.device)
    cap = _capacity(cfg, T)
    ks, vs = [], []
    for lp in _layer_params(params, dt):
        h, (k, v), _ = _moe_layer(h, lp, mask, cfg.n_heads, sdpa, rope, cap,
                                  cfg.router_top_k, mode=cfg.dispatch,
                                  n_kv=cfg.kv_heads, ffn=cfg.ffn)
        ks.append(k)
        vs.append(v)
    if length is None:
        last = h[:, -1]
        n = torch.tensor(T, dtype=torch.int32, device=h.device)
    else:
        n = torch.as_tensor(length, dtype=torch.int32, device=h.device)
        last = h[torch.arange(B, device=h.device), n.long() - 1]
    K, V = _pad_cache(ks, vs, cfg, T)
    return _head(params, last, dt), {"k": K, "v": V, "length": n}


@torch.no_grad()
def moe_prefill_batched(params: Params, x_ids, start, cfg: MoEGPTConfig):
    """Batched prefill of LEFT-padded prompts (``gpt_prefill_batched``'s
    layout); the left pads are kept out of expert routing by ``valid``
    (they precede real tokens in the capacity cumsum and would take every
    early slot)."""
    _uniform(cfg)
    dev = params["tok_W"].device
    x_ids = torch.as_tensor(x_ids, device=dev).long()
    B, W = x_ids.shape
    dt = cfg.compute_dtype
    start = torch.as_tensor(start, dtype=torch.int32, device=dev).reshape(B)
    cols = torch.arange(W, device=dev)
    pos_idx = torch.clamp(cols[None, :] - start[:, None], min=0)
    valid = cols[None, :] >= start[:, None]  # (B, W)
    rope = None
    h = params["tok_W"][x_ids]
    if cfg.pos == "rope":
        c, s_ = rope_tables(cfg.d_head, pos_idx)
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
    mask = torch.where(live, 0.0, -1e9).to(dt)[:, None]
    if cfg.pos == "alibi":
        sl = alibi_slopes(cfg.n_heads, device=dev)
        bias = sl[:, None, None] * (cols[None, None, :]
                                    - cols[None, :, None]).float()
        mask = mask + bias.to(dt)[None]
    cap = _capacity(cfg, W)
    ks, vs = [], []
    for lp in _layer_params(params, dt):
        h, (k, v), _ = _moe_layer(h, lp, mask, cfg.n_heads, sdpa, rope, cap,
                                  cfg.router_top_k, mode=cfg.dispatch,
                                  valid=valid, n_kv=cfg.kv_heads,
                                  ffn=cfg.ffn)
        ks.append(k)
        vs.append(v)
    K, V = _pad_cache(ks, vs, cfg, W)
    return _head(params, h[:, -1], dt), {
        "k": K, "v": V, "start": start,
        "length": torch.tensor(W, dtype=torch.int32, device=dev)}


def _moe_decode_ops(params: Params, cfg: MoEGPTConfig) -> Dict[str, Any]:
    """The MoE decode ops for ``models.gpt._decode_chunk_core``: the dense
    attention half of ``_dt_decode_ops`` (weights cast once, Q/K/V
    concatenated) and the routed ``moe_ffn`` with one token a routing
    group, so every row (a serving slot) routes its live token alone."""
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
    cap = _capacity(cfg, 1)

    def ffn(lw, x2):
        lp = lw["lp"]
        return moe_ffn(x2, lp["Wr"], lp["W1"], lp["b1"], lp["W2"], lp["b2"],
                       cap, cfg.router_top_k, cfg.dispatch, Wg=lp.get("Wg"),
                       bg=lp.get("bg"), ffn=cfg.ffn)[0]

    return {
        "lws": lws,
        "device": tokW.device,
        "embed": lambda token: tokW[token][:, None, :],
        "pe": (None if pe is None else lambda rel: pe[
            torch.clamp(rel, max=cfg.ctx_len - 1).long()][:, None]),
        "ln1": lambda lw, x: layer_norm(x, lw["lp"]["ln1_g"],
                                        lw["lp"]["ln1_b"]),
        "qkv": lambda lw, xn: xn @ lw["W3"],
        "out": lambda lw, y: y @ lw["lp"]["Wo"],
        "ln2": lambda lw, x: layer_norm(x, lw["lp"]["ln2_g"],
                                        lw["lp"]["ln2_b"]),
        "ffn": ffn,
        # ``_head`` over the weights cast once (its casts are no-ops here)
        "head": lambda h: _head({"tok_W": tokW, "head_b": head_b}, h, dt),
    }


@torch.no_grad()
def moe_decode_step(params: Params, cache, token, cfg: MoEGPTConfig):
    """One incremental decode step, token (B,) -> (float32 logits (B, V),
    cache'), each row's live token routed alone; the cache's k/v buffers
    are written in place."""
    dev = params["tok_W"].device
    pos = int(cache["length"])
    step = _make_decode_step(cfg, _moe_decode_ops(params, cfg),
                             cache.get("start", 0), fkv_write)
    K, V, logits = step(cache["k"], cache["v"], pos,
                        torch.as_tensor(token, device=dev).long().reshape(-1))
    return logits, dict(cache, k=K, v=V, length=torch.tensor(
        pos + 1, dtype=torch.int32, device=dev))


def moe_decode_chunk(params, cache, logits, generator, cfg: MoEGPTConfig,
                     n_tokens: int, temperature=1.0, top_k: int = 0,
                     top_p=0.0):
    """Sample ``n_tokens`` from a prefilled cache through the MoE decode
    ops (``gpt_decode_chunk``'s contract); returns (tokens (B, n), logits,
    cache)."""
    toks, logits, K, V, pos = _decode_chunk_core(
        cfg, _moe_decode_ops(params, cfg), logits, cache["k"], cache["v"],
        int(cache["length"]), cache.get("start", 0), generator, n_tokens,
        temperature, top_k, top_p, fkv_write)
    return toks, logits, dict(cache, k=K, v=V, length=torch.as_tensor(
        pos, dtype=torch.int32, device=logits.device))
