"""The plain reference of the benchmark's GPTs: forward, loss, gradients by
autograd, and AdamW, in float32 with TF32 off.

It follows the published architecture as the configuration files state it,
with their departures: pre-LN blocks (LayerNorm, eps 1e-5), attention with
1/sqrt(d) scaling under a causal mask or a band of ``window`` keys (itself
included), grouped K/V (query head h reads K/V head h // (H / hk)), RoPE
on interleaved feature pairs (base 10000) or learned positions added to
the token embedding, a tanh-GELU or SwiGLU FFN with biases, no final norm,
and a head tied to the token embedding plus a bias. It imports only torch:
nothing of the program under test, which it checks.

Every product goes through ``mm``, so the control (``fp8_mm``) computes
the same model with its operands rounded to float8 e4m3.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

__all__ = ["full_precision", "fp8_mm", "hidden", "logits", "row_loss",
           "train_steps", "lr_at"]

_DECAY = {"Wq", "Wk", "Wv", "Wo", "W1", "W2", "Wg"}
_E4M3_MAX = 448.0


@contextlib.contextmanager
def full_precision():
    """TF32 off for matmuls and convolutions, restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def _e4m3(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the whole tensor (its
    largest magnitude maps to e4m3's largest), back in float32."""
    s = x.detach().abs().amax().float().clamp_min(1e-30) / _E4M3_MAX
    return (x.float() / s).to(torch.float8_e4m3fn).float() * s


class _FP8MM(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _e4m3(a), _e4m3(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _e4m3(g)
        ga = qg @ qb.transpose(-1, -2)
        gb = qa.transpose(-1, -2) @ qg
        # broadcast batch dimensions fold back onto the operand's shape
        while ga.dim() > qa.dim():
            ga = ga.sum(0)
        while gb.dim() > qb.dim():
            gb = gb.sum(0)
        return ga, gb


def fp8_mm(a, b):
    """``a @ b`` with both operands, and the backward's incoming gradient,
    rounded to float8 e4m3: the precision a step below bfloat16."""
    return _FP8MM.apply(a, b)


def _shape(cfg: Dict) -> Tuple[int, int, int, int]:
    H = cfg["n_heads"]
    hk = cfg.get("n_kv_heads") or H
    return cfg["d_model"], H, hk, cfg["d_model"] // H


def _rope(x, pos):
    """Rotate interleaved even/odd pairs of x (h, T, d) by position."""
    d = x.shape[-1]
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang), torch.sin(ang)
    xe, xo = x[..., 0::2], x[..., 1::2]
    return torch.stack([xe * cos - xo * sin, xe * sin + xo * cos],
                       -1).reshape(x.shape)


def _attn_block(q, k, v, q0, k0, window, mm):
    """Softmax attention of queries q0.. over keys k0.. (masked)."""
    Tq, Tk, d = q.shape[1], k.shape[1], q.shape[-1]
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(d)
    i = torch.arange(q0, q0 + Tq, device=q.device)[:, None]
    j = torch.arange(k0, k0 + Tk, device=q.device)[None, :]
    ban = j > i
    if window is not None:
        ban = ban | (i - j >= window)
    s = s.masked_fill(ban, float("-inf"))
    return mm(torch.softmax(s, -1), v)


def _attention(q, k, v, window, mm, block: int):
    """q (H, T, d), k/v (H, T, d) already expanded to the query heads.
    Query blocks of ``block`` rows see only the keys their mask keeps;
    with several blocks each is recomputed in the backward."""
    T = q.shape[1]
    if T <= block:
        return _attn_block(q, k, v, 0, 0, window, mm)
    outs = []
    for q0 in range(0, T, block):
        q1 = min(T, q0 + block)
        k0 = 0 if window is None else max(0, q0 - window + 1)
        args = (q[:, q0:q1], k[:, k0:q1], v[:, k0:q1], q0, k0, window, mm)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attn_block, *args, use_reentrant=False))
        else:
            outs.append(_attn_block(*args))
    return torch.cat(outs, 1)


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def _block(h, lay: Dict, i: int, cfg: Dict, pos, mm: Callable, block: int):
    """Layer ``i`` of the stacks ``lay`` on hidden states h (T, D)."""
    D, H, hk, d = _shape(cfg)
    T = h.shape[0]
    w = {k: t[i].float() for k, t in lay.items()}
    x = F.layer_norm(h, (D,), w["ln1_g"], w["ln1_b"], 1e-5)
    q = mm(x, w["Wq"]).reshape(T, H, d).transpose(0, 1)
    k = mm(x, w["Wk"]).reshape(T, hk, d).transpose(0, 1)
    v = mm(x, w["Wv"]).reshape(T, hk, d).transpose(0, 1)
    if cfg.get("pos") == "rope":
        q, k = _rope(q, pos), _rope(k, pos)
    k = k.repeat_interleave(H // hk, 0)
    v = v.repeat_interleave(H // hk, 0)
    a = _attention(q, k, v, cfg.get("window"), mm, block)
    h = h + mm(a.transpose(0, 1).reshape(T, D), w["Wo"])
    x = F.layer_norm(h, (D,), w["ln2_g"], w["ln2_b"], 1e-5)
    u = mm(x, w["W1"]) + w["b1"]
    if cfg.get("ffn") == "swiglu":
        g = mm(x, w["Wg"]) + w["bg"]
        f = u * torch.sigmoid(u) * g
    else:
        f = _gelu(u)
    return h + mm(f, w["W2"]) + w["b2"]


def hidden(p: Dict, ids: torch.Tensor, cfg: Dict, mm: Callable = torch.matmul,
           block: int = 1024) -> torch.Tensor:
    """Final hidden states (T, D) of one row of token ids (T,). Under
    autograd each layer keeps only its input and is recomputed in the
    backward, so that a float32 stage at long context fits the card."""
    T = ids.shape[0]
    pos = torch.arange(T, device=ids.device)
    h = p["tok_W"][ids].float()
    if cfg.get("pos") == "learned":
        h = h + p["pos_W"][:T].float()
    for i in range(cfg["n_layers"]):
        args = (h, p["layers"], i, cfg, pos, mm, block)
        if torch.is_grad_enabled():
            h = checkpoint(_block, *args, use_reentrant=False)
        else:
            h = _block(*args)
    return h


def logits(p: Dict, h: torch.Tensor, mm: Callable = torch.matmul):
    """Tied head: (T, V) float32 logits of hidden states (T, D)."""
    return mm(h, p["tok_W"].float().t()) + p["head_b"].float()


def row_loss(p: Dict, x: torch.Tensor, y: torch.Tensor, cfg: Dict,
             mm: Callable = torch.matmul, chunk: int = 4096):
    """Mean cross-entropy of one row (T,) of inputs and targets, the head
    taken ``chunk`` positions at a time (each recomputed in the
    backward)."""
    h = hidden(p, x, cfg, mm)

    def part(hc, yc):
        z = logits(p, hc, mm)
        return (torch.logsumexp(z, -1)
                - z.gather(-1, yc[:, None])[:, 0]).sum()

    T = x.shape[0]
    total = 0.0
    for t0 in range(0, T, chunk):
        sl = slice(t0, min(T, t0 + chunk))
        if torch.is_grad_enabled() and T > chunk:
            total = total + checkpoint(part, h[sl], y[sl],
                                       use_reentrant=False)
        else:
            total = total + part(h[sl], y[sl])
    return total / T


def lr_at(step: int, sched: Dict) -> float:
    """Linear warmup, then cosine decay to ``min_lr`` (float64 here)."""
    base, lo = sched["base_lr"], sched["min_lr"]
    warm, top = sched["warmup"], sched["max_steps"]
    if step < warm:
        return base * step / max(1, warm)
    t = (step - warm) / max(1, top - warm)
    return lo + 0.5 * (base - lo) * (1.0 + math.cos(math.pi * t))


def _named(tree: Dict, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _named(v, f"{prefix}{k}.")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _nest(flat: Dict[str, torch.Tensor]) -> Dict:
    out: Dict = {}
    for name, t in flat.items():
        *path, last = name.split(".")
        d = out
        for k in path:
            d = d.setdefault(k, {})
        d[last] = t
    return out


def train_steps(p0: Dict, batches: Sequence[Tuple[torch.Tensor,
                                                  torch.Tensor]],
                cfg: Dict, sched: Dict, mm: Callable = torch.matmul,
                rows: int = 0):
    """AdamW (betas 0.9, 0.95, eps 1e-8, decoupled decay on the matmul
    weights, lr scales on the embedding and the head bias) over
    ``batches`` of (B, T) rows, each step's loss the mean over its rows.
    ``p0`` is updated in place. ``rows`` > 0 keeps only that many rows of
    each batch, ``rows`` < 0 only that many positions of each row (a
    fault: part of the batch left out).

    Returns (losses, the first step's gradients, the parameters)."""
    leaves = _named(p0)
    m = [torch.zeros_like(t) for _, t in leaves]
    v = [torch.zeros_like(t) for _, t in leaves]
    b1, b2, eps = 0.9, 0.95, 1e-8
    losses, first = [], None
    for step, (x, y) in enumerate(batches, start=1):
        if rows > 0:
            x, y = x[:rows], y[:rows]
        elif rows < 0:
            x, y = x[:, :-rows], y[:, :-rows]
        for _, t in leaves:
            t.requires_grad_(True)
            t.grad = None
        loss = 0.0
        for r in range(x.shape[0]):
            lr_ = row_loss(p0, x[r], y[r], cfg, mm) / x.shape[0]
            lr_.backward()
            loss += float(lr_.detach())
        losses.append(loss)
        grads = [t.grad for _, t in leaves]
        if first is None:
            first = _nest({n: g.detach().clone()
                           for (n, _), g in zip(leaves, grads)})
        lr = lr_at(step, sched)
        c1, c2 = 1.0 - b1 ** step, 1.0 - b2 ** step
        with torch.no_grad():
            for (name, t), g, mi, vi in zip(leaves, grads, m, v):
                key = name.split(".")[-1]
                lr_l = lr * (sched.get("lr_embed_scale", 1.0)
                             if key == "tok_W" else
                             sched.get("lr_head_scale", 1.0)
                             if key == "head_b" else 1.0)
                mi.mul_(b1).add_(g, alpha=1.0 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1.0 - b2)
                if key in _DECAY and sched["weight_decay"]:
                    t.sub_(lr_l * sched["weight_decay"] * t)
                t.sub_(lr_l * (mi / c1) / (torch.sqrt(vi / c2) + eps))
        for _, t in leaves:
            t.grad = None
            t.requires_grad_(False)
    return losses, first, p0
