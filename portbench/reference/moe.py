"""The plain reference of the benchmark's routed MoE GPTs (Mellum-style):
forward, loss, gradients by autograd, and AdamW, in float32 with TF32 off.

It follows the configuration file's published keys with the departures
it lists, as the program runs them: pre-LN blocks (LayerNorm, eps 1e-5);
grouped-query attention of ``head_dim``-wide heads scaled by 1/sqrt(d),
each layer of ``layer_types`` either a band of ``sliding_window`` keys
(itself included) or the full causal past; RoPE on interleaved feature
pairs at ``rope_theta``, the full layers' tables YaRN-scaled as Hugging
Face's ``_compute_yarn_parameters`` forms them (per pair, the inverse
frequency blended with itself over ``factor`` by a linear ramp between the
floor and ceiling of the correction dims of ``beta_fast`` and
``beta_slow``; cos and sin times ``attention_factor``); a router softmax
in float32 over all the router's experts, the top ``num_experts_per_tok``
by a stable sort, divided by their sum (``norm_topk_prob``); every token's
assignment to each expert the layer holds (the router's first
``W1.shape[0]``) computed, none dropped, as a loop over the held experts
(SwiGLU with biases, each expert's output times its gate), the absent
experts' share left out as the program leaves it out; the Switch load-balance loss (first choices against mean
probabilities) over the batch; the head tied to the token embedding plus
a bias. It imports only torch and the dense reference's attention and
float8 helpers: nothing of the program under test, which it checks.

Every product goes through ``mm``, so the control (``gpt.fp8_mm``)
computes the same model with its operands rounded to float8 e4m3.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.gpt import (_attention, _named, _nest,
                                     full_precision, lr_at)

__all__ = ["full_precision", "rope_tables", "hidden", "logits",
           "row_loss", "batch_loss", "train_steps"]

_DECAY = {"Wq", "Wk", "Wv", "Wo", "W1", "W2", "Wg"}


def rope_tables(cfg: Dict, kind: str, T: int, d: int, device,
                dtype=torch.float32):
    """(cos, sin) (T, d/2) of a layer of ``kind`` ("sliding_attention" or
    "full_attention") from ``rope_parameters``."""
    rp = cfg["rope_parameters"][kind]
    base = float(rp["rope_theta"])
    i = torch.arange(d // 2, dtype=torch.float64, device=device)
    inv = base ** (-2.0 * i / d)
    scale = 1.0
    if rp.get("rope_type", "default") == "yarn":
        orig, factor = rp["original_max_position_embeddings"], rp["factor"]

        def corr(rot):
            return d * math.log(orig / (rot * 2 * math.pi)) / (
                2 * math.log(base))

        low = max(math.floor(corr(rp["beta_fast"])), 0)
        high = min(math.ceil(corr(rp["beta_slow"])), d - 1)
        if low == high:
            high += 0.001
        ramp = torch.clamp((i - low) / (high - low), 0.0, 1.0)
        inv = inv / factor * ramp + inv * (1.0 - ramp)
        af = rp.get("attention_factor")
        scale = af if af is not None else 0.1 * math.log(factor) + 1.0
    ang = torch.arange(T, dtype=torch.float64, device=device)[:, None] * inv
    return ((torch.cos(ang) * scale).to(dtype),
            (torch.sin(ang) * scale).to(dtype))


def _rotate(x, cos, sin):
    """Rotate interleaved even/odd pairs of x (h, T, d)."""
    xe, xo = x[..., 0::2], x[..., 1::2]
    return torch.stack([xe * cos - xo * sin, xe * sin + xo * cos],
                       -1).reshape(x.shape)


def _experts(x, w: Dict, cfg: Dict, mm: Callable):
    """The routed FFN of one row (T, D): (output (T, D), first-choice
    fractions f (E,), mean probabilities P (E,))."""
    T = x.shape[0]
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(x, w["Wr"]), -1)
    E = probs.shape[-1]
    vals, idxs = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idxs = vals[:, :k], idxs[:, :k]
    if cfg.get("norm_topk_prob", True):
        vals = vals / vals.sum(-1, keepdim=True).clamp_min(1e-9)
    out = torch.zeros_like(x)
    for el in range(w["W1"].shape[0]):
        pick = idxs == el  # (T, k): at most one choice a token
        rows = pick.any(-1).nonzero()[:, 0]
        if rows.numel() == 0:
            continue
        gate = (vals * pick).sum(-1)[rows]
        xr = x[rows]
        u = mm(xr, w["W1"][el]) + w["b1"][el]
        g = mm(xr, w["Wg"][el]) + w["bg"][el]
        y = mm(u * torch.sigmoid(u) * g, w["W2"][el]) + w["b2"][el]
        out = out.index_add(0, rows, gate[:, None] * y)
    f = F.one_hot(idxs[:, 0], E).to(x.dtype).mean(0)
    return out, f, probs.mean(0)


def _block(h, lay: Dict, i: int, cfg: Dict, mm: Callable, block: int):
    """Layer ``i`` on hidden states h (T, D): (h, f, P)."""
    p = cfg["port"]
    D, H, hk, d = p["d_model"], p["n_heads"], p["n_kv_heads"], p["head_dim"]
    T = h.shape[0]
    w = {k: t[i].to(h.dtype) for k, t in lay.items()}
    kind = cfg["layer_types"][i]
    window = cfg["sliding_window"] if kind == "sliding_attention" else None
    x = F.layer_norm(h, (D,), w["ln1_g"], w["ln1_b"], 1e-5)
    q = mm(x, w["Wq"]).reshape(T, H, d).transpose(0, 1)
    k = mm(x, w["Wk"]).reshape(T, hk, d).transpose(0, 1)
    v = mm(x, w["Wv"]).reshape(T, hk, d).transpose(0, 1)
    cos, sin = rope_tables(cfg, kind, T, d, h.device, h.dtype)
    q, k = _rotate(q, cos, sin), _rotate(k, cos, sin)
    k = k.repeat_interleave(H // hk, 0)
    v = v.repeat_interleave(H // hk, 0)
    a = _attention(q, k, v, window, mm, block)
    h = h + mm(a.transpose(0, 1).reshape(T, H * d), w["Wo"])
    x = F.layer_norm(h, (D,), w["ln2_g"], w["ln2_b"], 1e-5)
    f, fr, P = _experts(x, w, cfg, mm)
    return h + f, fr, P


def hidden(p: Dict, ids: torch.Tensor, cfg: Dict,
           mm: Callable = torch.matmul, block: int = 1024,
           dtype=torch.float32, stats: List = None) -> torch.Tensor:
    """Final hidden states (T, D) of one row of token ids (T,); each layer's
    (f, P) appended to ``stats`` when given. Under autograd each layer
    keeps only its input and is recomputed in the backward."""
    h = p["tok_W"][ids].to(dtype)
    for i in range(cfg["port"]["n_layers"]):
        args = (h, p["layers"], i, cfg, mm, block)
        if torch.is_grad_enabled():
            h, f, P = checkpoint(_block, *args, use_reentrant=False)
        else:
            h, f, P = _block(*args)
        if stats is not None:
            stats.append((f, P))
    return h


def logits(p: Dict, h: torch.Tensor, mm: Callable = torch.matmul):
    """Tied head: (T, V) logits of hidden states (T, D)."""
    return mm(h, p["tok_W"].to(h.dtype).t()) + p["head_b"].to(h.dtype)


def row_loss(p: Dict, x: torch.Tensor, y: torch.Tensor, cfg: Dict,
             mm: Callable = torch.matmul, chunk: int = 4096,
             dtype=torch.float32, stats: List = None):
    """Mean cross-entropy of one row (T,), the head ``chunk`` positions at
    a time (each recomputed in the backward); the layers' (f, P) go to
    ``stats``."""
    h = hidden(p, x, cfg, mm, dtype=dtype, stats=stats)

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


def batch_loss(p: Dict, x: torch.Tensor, y: torch.Tensor, cfg: Dict,
               mm: Callable = torch.matmul, dtype=torch.float32):
    """The program's loss of a (B, T) batch: the mean cross-entropy plus
    ``aux_weight`` times the layers' mean load-balance loss, each layer's
    E * sum(f * P) over the batch's tokens."""
    B = x.shape[0]
    rows_stats, ce = [], 0.0
    for r in range(B):
        st: List = []
        ce = ce + row_loss(p, x[r], y[r], cfg, mm, dtype=dtype,
                           stats=st) / B
        rows_stats.append(st)
    auxes = []
    for layer in zip(*rows_stats):
        f = torch.stack([s[0] for s in layer]).mean(0)
        P = torch.stack([s[1] for s in layer]).mean(0)
        auxes.append(f.shape[0] * (f * P).sum())
    return ce + cfg["port"]["aux_weight"] * torch.stack(auxes).mean()


def train_steps(p0: Dict, batches: Sequence[Tuple[torch.Tensor,
                                                  torch.Tensor]],
                cfg: Dict, sched: Dict, mm: Callable = torch.matmul,
                rows: int = 0):
    """AdamW (betas 0.9, 0.95, eps 1e-8, decoupled decay on the matmul
    weights, lr scales on the embedding and the head bias) over
    ``batches`` of (B, T) rows. ``p0`` is updated in place. ``rows`` > 0
    keeps only that many rows of each batch, ``rows`` < 0 only that many
    positions of each row (a fault: part of the batch left out).

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
        loss = batch_loss(p0, x, y, cfg, mm)
        loss.backward()
        losses.append(float(loss.detach()))
        del loss
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
