"""Encoder-decoder transformer stack with the reference's component
contract — the counterpart of ``linalg_tpu/models/transformer.py``.

``FFN``, ``EncoderLayer``, ``DecoderLayer`` (causal self-attention ->
cross-attention -> FFN, each pre-LN with residuals), ``Encoder`` and
``Decoder`` stacks (the decoder's backward SUMS dMemory over its
layers), ``Transformer`` (encode -> decode; the backward feeds the summed
dMemory into the encoder), ``TokenEmbedding`` (scatter-add backward) and
``OutputHead`` (fused softmax cross-entropy returning (loss, dZ), dZ =
(P - onehot) / N).

The leaf components (``nn.normalization``, ``nn.attention``, ``FFN``)
pull their gradients back through autograd (``nn.stateful``); the layers'
``backward`` wire the residuals by hand, as the reference does. Weights
are the JAX package's numpy draws for the same seeds. For the functional
training path of the same architecture see ``models.seq2seq``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..nn.attention import MultiHeadAttention as MHA
from ..nn.functional import he_init, relu, softmax_last
from ..nn.normalization import LayerNorm
from ..nn.stateful import Stateful

__all__ = ["softmax_rows", "sinusoidal_pos_encoding", "FFN", "EncoderLayer",
           "DecoderLayer", "Encoder", "Decoder", "Transformer",
           "TokenEmbedding", "OutputHead"]


def softmax_rows(Z):
    """Row-wise stabilized softmax (2-D convenience alias)."""
    return softmax_last(torch.as_tensor(Z))


def sinusoidal_pos_encoding(max_len: int, d_model: int):
    from ..nn.functional import sinusoidal_encoding

    return sinusoidal_encoding(max_len, d_model)


def _ffn_apply(params, X):
    return relu(X @ params["W1"] + params["b1"]) @ params["W2"] + params["b2"]


class FFN(Stateful):
    """Position-wise feed-forward: ReLU(X W1 + b1) W2 + b2; ``step``
    decays W1 and W2."""

    DECAY = ("W1", "W2")

    def __init__(self, d_model: int = 512, d_ff: int = 2048,
                 activation: str = "relu", seed: int = 0,
                 device=None) -> None:
        super().__init__()
        if activation != "relu":
            raise NotImplementedError("only relu, matching the reference")
        rng = np.random.default_rng(seed)
        self._param("W1", he_init(d_model, d_ff, rng, device))
        self._param("b1", torch.zeros(d_ff, device=device))
        self._param("W2", he_init(d_ff, d_model, rng, device))
        self._param("b2", torch.zeros(d_model, device=device))
        self.activation = activation

    def _params(self):
        return {"W1": self.W1, "b1": self.b1, "W2": self.W2, "b2": self.b2}

    def forward(self, X):
        return self._record(lambda x: _ffn_apply(self._params(), x), X)

    def backward(self, dY):
        return self._pull(dY)[0]


class EncoderLayer(nn.Module):
    """Pre-LN self-attention + FFN block with residuals."""

    def __init__(self, d_model=512, n_heads=8, d_ff=2048, seed=0,
                 device=None):
        super().__init__()
        self.ln1 = LayerNorm(d_model, device=device)
        self.mha = MHA(d_model, n_heads, seed=seed, device=device)
        self.ln2 = LayerNorm(d_model, device=device)
        self.ffn = FFN(d_model, d_ff, activation="relu", seed=seed + 1,
                       device=device)

    def forward(self, X, src_mask=None):
        X = torch.as_tensor(X)
        A = self.mha.forward(self.ln1.forward(X), mask=src_mask, KV=None)
        Y1 = X + A
        return Y1 + self.ffn.forward(self.ln2.forward(Y1))

    def backward(self, dY):
        dY1 = dY + self.ln2.backward(self.ffn.backward(dY))
        dXn, _ = self.mha.backward(dY1)
        return dY1 + self.ln1.backward(dXn)

    def step(self, lr=1e-3, weight_decay=0.0):
        self.mha.step(lr, weight_decay)
        self.ffn.step(lr, weight_decay)
        self.ln1.step(lr, 0.0)
        self.ln2.step(lr, 0.0)


class DecoderLayer(nn.Module):
    """Pre-LN causal self-attention -> cross-attention (K/V = memory) ->
    FFN block."""

    def __init__(self, d_model=512, n_heads=8, d_ff=2048, seed=0,
                 device=None):
        super().__init__()
        self.ln1 = LayerNorm(d_model, device=device)
        self.self_attn = MHA(d_model, n_heads, seed=seed, device=device)
        self.ln2 = LayerNorm(d_model, device=device)
        self.cross_attn = MHA(d_model, n_heads, seed=seed + 1, device=device)
        self.ln3 = LayerNorm(d_model, device=device)
        self.ffn = FFN(d_model, d_ff, activation="relu", seed=seed + 2,
                       device=device)

    def forward(self, X, memory, tgt_mask=None, mem_mask=None):
        X = torch.as_tensor(X)
        A = self.self_attn.forward(self.ln1.forward(X), mask=tgt_mask,
                                   KV=None)
        Y1 = X + A
        C = self.cross_attn.forward(self.ln2.forward(Y1), mask=mem_mask,
                                    KV=memory)
        Y2 = Y1 + C
        return Y2 + self.ffn.forward(self.ln3.forward(Y2))

    def backward(self, dY) -> Tuple[torch.Tensor, torch.Tensor]:
        """(dX, dMemory): the two-output gradient the encoder's
        accumulation depends on."""
        dY2 = dY + self.ln3.backward(self.ffn.backward(dY))
        dY1n, dMem = self.cross_attn.backward(dY2)
        dY1 = dY2 + self.ln2.backward(dY1n)
        dXn, _ = self.self_attn.backward(dY1)
        return dY1 + self.ln1.backward(dXn), dMem

    def step(self, lr=1e-3, weight_decay=0.0):
        self.self_attn.step(lr, weight_decay)
        self.cross_attn.step(lr, weight_decay)
        self.ffn.step(lr, weight_decay)
        self.ln1.step(lr, 0.0)
        self.ln2.step(lr, 0.0)
        self.ln3.step(lr, 0.0)


class Encoder(nn.Module):
    """Stack of encoder layers (layer i seeded ``seed + 3i``)."""

    def __init__(self, num_layers=6, d_model=512, n_heads=8, d_ff=2048,
                 seed=0, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, n_heads, d_ff, seed=seed + i * 3,
                         device=device) for i in range(num_layers))

    def forward(self, X, src_mask=None):
        H = X
        for layer in self.layers:
            H = layer.forward(H, src_mask=src_mask)
        return H

    def backward(self, dH):
        dX = dH
        for layer in reversed(self.layers):
            dX = layer.backward(dX)
        return dX

    def step(self, lr=1e-3, weight_decay=0.0):
        for layer in self.layers:
            layer.step(lr, weight_decay)


class Decoder(nn.Module):
    """Stack of decoder layers (layer i seeded ``seed + 4i``); the backward
    sums dMemory over the layers."""

    def __init__(self, num_layers=6, d_model=512, n_heads=8, d_ff=2048,
                 seed=1000, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, n_heads, d_ff, seed=seed + i * 4,
                         device=device) for i in range(num_layers))

    def forward(self, X, memory, tgt_mask=None, mem_mask=None):
        H = X
        for layer in self.layers:
            H = layer.forward(H, memory, tgt_mask=tgt_mask,
                              mem_mask=mem_mask)
        return H

    def backward(self, dH):
        dX, dMem_total = dH, 0
        for layer in reversed(self.layers):
            dX, dMem = layer.backward(dX)
            dMem_total = dMem_total + dMem
        return dX, dMem_total

    def step(self, lr=1e-3, weight_decay=0.0):
        for layer in self.layers:
            layer.step(lr, weight_decay)


class Transformer(nn.Module):
    """Encoder-decoder transformer with pre-LN blocks."""

    def __init__(self, num_enc_layers=6, num_dec_layers=6, d_model=512,
                 n_heads=8, d_ff=2048, seed=0, device=None):
        super().__init__()
        self.encoder = Encoder(num_enc_layers, d_model, n_heads, d_ff,
                               seed=seed, device=device)
        self.decoder = Decoder(num_dec_layers, d_model, n_heads, d_ff,
                               seed=seed + 999, device=device)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                mem_mask=None):
        memory = self.encoder.forward(src, src_mask=src_mask)
        out = self.decoder.forward(tgt, memory, tgt_mask=tgt_mask,
                                   mem_mask=mem_mask)
        return out, memory

    def backward(self, dout):
        ddec, dmem = self.decoder.backward(dout)
        return self.encoder.backward(dmem), ddec

    def step(self, lr=1e-3, weight_decay=0.0):
        self.encoder.step(lr, weight_decay)
        self.decoder.step(lr, weight_decay)


class TokenEmbedding(Stateful):
    """W[idx] lookup, N(0, 0.02) init; ``backward`` scatter-adds the
    per-token gradients into ``gradW``."""

    DECAY = ("W",)

    def __init__(self, vocab_size: int, d_model: int, seed: int = 0,
                 device=None):
        super().__init__()
        rng = np.random.default_rng(seed)
        self._param("W", torch.tensor(rng.normal(0.0, 0.02, size=(
            vocab_size, d_model)), dtype=torch.float32, device=device))
        self._idx = None

    def forward(self, idx):
        self._idx = torch.as_tensor(idx, device=self.W.device).long()
        return self.W.detach()[self._idx]

    @torch.no_grad()
    def backward(self, dX) -> None:
        flat_idx = self._idx.reshape(-1)
        flat_grad = torch.as_tensor(dX).to(self.W).reshape(
            flat_idx.shape[0], -1)
        self.gradW = torch.zeros_like(self.W).index_add_(0, flat_idx,
                                                          flat_grad)

    def step(self, lr=1e-2, weight_decay=0.0):
        super().step(lr, weight_decay)


class OutputHead(Stateful):
    """Linear head (Glorot-normal W, zero b) with the fused softmax
    cross-entropy loss."""

    DECAY = ("W",)

    def __init__(self, d_model: int, vocab_size: int, seed: int = 1,
                 device=None):
        super().__init__()
        rng = np.random.default_rng(seed)
        std = np.sqrt(2.0 / (d_model + vocab_size))
        self._param("W", torch.tensor(rng.normal(0.0, std, size=(
            d_model, vocab_size)), dtype=torch.float32, device=device))
        self._param("b", torch.zeros(vocab_size, device=device))
        self._Y = None

    def logits(self, Y):
        self._Y = torch.as_tensor(Y)
        return (self._Y @ self.W + self.b).detach()

    def loss_and_dlogits(self, Z, targets):
        """(float CE loss, dZ = (P - onehot) / N)."""
        Z = torch.as_tensor(Z)
        B, T, V = Z.shape
        Zf = Z.reshape(B * T, V)
        y = torch.as_tensor(targets, device=Z.device).reshape(B * T).long()
        P = softmax_last(Zf)
        rows = torch.arange(B * T, device=Z.device)
        loss = -torch.mean(torch.log(P[rows, y] + 1e-12))
        dZ = P.clone()
        dZ[rows, y] -= 1.0
        return float(loss), (dZ / (B * T)).reshape(B, T, V)

    @torch.no_grad()
    def backward(self, dZ):
        dZ = torch.as_tensor(dZ)
        B, T, V = dZ.shape
        D = self._Y.shape[-1]
        Yf = self._Y.reshape(B * T, D)
        dZf = dZ.reshape(B * T, V)
        self.gradW = Yf.T @ dZf
        self.gradb = dZf.sum(dim=0)
        return (dZf @ self.W.T).reshape(B, T, D)

    def step(self, lr=1e-2, weight_decay=0.0):
        super().step(lr, weight_decay)
