"""Stateful GPT building blocks with the reference's component contract —
the counterpart of ``linalg_tpu/models/gpt_modules.py``.

``DecoderOnlyLayer`` (pre-LN masked self-attention + ReLU FFN with
residuals), ``GPT`` (a stack of them, layer i seeded ``seed + 7i``) and a
param-group ``AdamW``, each with forward/backward/step. The functional
training path is ``models.gpt`` + ``train.optim``. ``AdamW`` takes the
reference's param-group dicts (``{"p", "g", "weight_decay"}``) and keys
its moments by group ORDER, as the JAX package does (its arrays have no
stable identity), and returns the updated parameters as new tensors.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..nn.attention import MultiHeadAttention as MHA
from ..nn.normalization import LayerNorm
from .transformer import FFN

__all__ = ["DecoderOnlyLayer", "GPT", "AdamW"]


class DecoderOnlyLayer(nn.Module):
    """Pre-LN masked self-attention + FFN block."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, seed: int = 0,
                 device=None):
        super().__init__()
        self.ln1 = LayerNorm(d_model, device=device)
        self.sa = MHA(d_model, n_heads, seed=seed, device=device)
        self.ln2 = LayerNorm(d_model, device=device)
        self.ffn = FFN(d_model, d_ff, activation="relu", seed=seed + 1,
                       device=device)

    def forward(self, X, tgt_mask=None):
        X = torch.as_tensor(X)
        Y1 = X + self.sa.forward(self.ln1.forward(X), mask=tgt_mask, KV=None)
        return Y1 + self.ffn.forward(self.ln2.forward(Y1))

    def backward(self, dY):
        dY1 = dY + self.ln2.backward(self.ffn.backward(dY))
        dXn, _ = self.sa.backward(dY1)
        return dY1 + self.ln1.backward(dXn)

    def step(self, lr: float = 3e-3, weight_decay: float = 0.0) -> None:
        self.sa.step(lr, weight_decay)
        self.ffn.step(lr, weight_decay)
        self.ln1.step(lr, 0.0)
        self.ln2.step(lr, 0.0)


class GPT(nn.Module):
    """Decoder-only stack."""

    def __init__(self, num_layers: int = 4, d_model: int = 256,
                 n_heads: int = 4, d_ff: Optional[int] = None,
                 seed: int = 123, device=None):
        super().__init__()
        if d_ff is None:
            d_ff = 4 * d_model
        self.layers = nn.ModuleList(
            DecoderOnlyLayer(d_model, n_heads, d_ff, seed=seed + i * 7,
                             device=device) for i in range(num_layers))

    def forward(self, X, tgt_mask=None):
        H = torch.as_tensor(X)
        for lyr in self.layers:
            H = lyr.forward(H, tgt_mask)
        return H

    def backward(self, dH):
        g = dH
        for lyr in reversed(self.layers):
            g = lyr.backward(g)
        return g

    def step(self, lr: float = 3e-3, weight_decay: float = 1e-4) -> None:
        for lyr in self.layers:
            lyr.step(lr, weight_decay)


class AdamW:
    """Decoupled-weight-decay Adam over param groups.

    ``step(param_groups)`` takes dicts ``{"p": tensor, "g": tensor,
    "weight_decay": float}`` and returns the list of updated parameters
    (new tensors; the inputs are not modified); the moments of group i
    are keyed by i."""

    def __init__(self, lr: float = 3e-4, betas=(0.9, 0.95), eps: float = 1e-8,
                 weight_decay: float = 0.01):
        self.lr = lr
        self.b1, self.b2 = betas
        self.eps = eps
        self.wd = weight_decay
        self.t = 0
        self.state: Dict[int, Dict[str, torch.Tensor]] = {}

    def _get_state(self, idx: int, p) -> Dict[str, torch.Tensor]:
        if idx not in self.state:
            self.state[idx] = {"m": torch.zeros_like(p),
                               "v": torch.zeros_like(p)}
        return self.state[idx]

    @torch.no_grad()
    def step(self, param_groups: List[dict]) -> List[torch.Tensor]:
        self.t += 1
        out = []
        for idx, pg in enumerate(param_groups):
            p = torch.as_tensor(pg["p"]).detach()
            g = torch.as_tensor(pg["g"])
            wd = pg.get("weight_decay", self.wd)
            st = self._get_state(idx, p)
            m = self.b1 * st["m"] + (1.0 - self.b1) * g
            v = self.b2 * st["v"] + (1.0 - self.b2) * (g * g)
            st["m"], st["v"] = m, v
            mhat = m / (1.0 - self.b1 ** self.t)
            vhat = v / (1.0 - self.b2 ** self.t)
            if wd != 0.0:
                p = p - self.lr * wd * p
            out.append(p - self.lr * (mhat / (torch.sqrt(vhat) + self.eps)))
        return out
