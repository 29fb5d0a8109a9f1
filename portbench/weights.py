"""Seeded weights, made on the device, in the parameter layout of the GPT
under test: ``tok_W`` (V, D), ``head_b`` (V,), ``pos_W`` (ctx, D) for
learned positions, and ``layers``, a dict of (L, ...) stacks.

Each leaf is one ``torch.randn`` call (or a constant) on the device from a
``torch.Generator`` seeded by the run's seed and the leaf's name, so the
same seed gives the same tensors, and one leaf can be made again alone
(the training check needs the starting weights once the program has
updated its own in place). Both the program and the plain reference get
these tensors. Plain torch: nothing of the program is imported.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, Iterator, Tuple

import torch

_MATMUL = ("Wq", "Wk", "Wv", "Wo", "W1", "Wg", "W2")
_OUT_PROJ = ("Wo", "W2")  # the residual branch's last projections


def leaf_shapes(shape: Dict) -> Iterator[Tuple[str, tuple]]:
    """(name, shape) of every leaf; a layer stack's name is
    ``layers.<key>``."""
    D, F, L, V = (shape["d_model"], shape["d_ff"], shape["n_layers"],
                  shape["vocab_size"])
    KD = (shape.get("n_kv_heads") or shape["n_heads"]) * (
        D // shape["n_heads"])
    yield "tok_W", (V, D)
    yield "head_b", (V,)
    if shape.get("pos") == "learned":
        yield "pos_W", (shape["ctx_len"], D)
    dims = {"Wq": (D, D), "Wk": (D, KD), "Wv": (D, KD), "Wo": (D, D),
            "W1": (D, F), "W2": (F, D), "b1": (F,), "b2": (D,),
            "ln1_g": (D,), "ln1_b": (D,), "ln2_g": (D,), "ln2_b": (D,)}
    if shape.get("ffn") in ("swiglu", "geglu"):
        dims.update(Wg=(D, F), bg=(F,))
    for key, dim in dims.items():
        yield f"layers.{key}", (L,) + dim


def _leaf_seed(seed: int, name: str) -> int:
    return (int(seed) * 0x9E3779B1 + zlib.crc32(name.encode())) % (1 << 63)


def make_leaf(shape: Dict, init: Dict, seed: int, name: str, dims: tuple,
              device, dtype) -> torch.Tensor:
    """One leaf: N(0, std) matmul weights and embeddings (the residual
    branch's output projections scaled by 1/sqrt(2 L) where ``init`` asks
    for it), unit LayerNorm gains, zero biases."""
    key = name.split(".")[-1]
    if key in ("ln1_g", "ln2_g"):
        return torch.ones(dims, device=device, dtype=dtype)
    if key not in _MATMUL and key not in ("tok_W", "pos_W"):
        return torch.zeros(dims, device=device, dtype=dtype)
    std = float(init["std"])
    if key in _OUT_PROJ and init.get("scaled_out_proj"):
        std /= math.sqrt(2.0 * shape["n_layers"])
    g = torch.Generator(device=device)
    g.manual_seed(_leaf_seed(seed, name))
    t = torch.randn(dims, generator=g, device=device, dtype=dtype)
    return t.mul_(std)


def make_params(shape: Dict, init: Dict, seed: int, device,
                dtype=torch.float32) -> Dict:
    """Every leaf of the model, in ``dtype`` on ``device``."""
    out: Dict = {"layers": {}}
    for name, dims in leaf_shapes(shape):
        t = make_leaf(shape, init, seed, name, dims, device, dtype)
        if name.startswith("layers."):
            out["layers"][name[len("layers."):]] = t
        else:
            out[name] = t
    return out


def get_leaf(params: Dict, name: str) -> torch.Tensor:
    if name.startswith("layers."):
        return params["layers"][name[len("layers."):]]
    return params[name]


@torch.no_grad()
def leaf_norms(params: Dict, shape: Dict, scale: float = 1.0
               ) -> Dict[str, float]:
    """L2 norm of every leaf in float32, times ``scale``; a layer stack
    counts as one leaf a layer (``layers.<key>.<i>``)."""
    out: Dict[str, float] = {}
    for name, _ in leaf_shapes(shape):
        t = get_leaf(params, name).float()
        if name.startswith("layers."):
            n = torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=1)
            for i, v in enumerate((n * scale).tolist()):
                out[f"{name}.{i}"] = v
        else:
            out[name] = float(torch.linalg.vector_norm(t)) * scale
    return out


@torch.no_grad()
def change_norms(params: Dict, shape: Dict, init: Dict, seed: int
                 ) -> Dict[str, float]:
    """L2 norm, leaf by leaf, of how far ``params`` moved from the seed's
    starting weights, each starting leaf made again on ``params``' device
    in ``params``' dtype."""
    out: Dict[str, float] = {}
    for name, dims in leaf_shapes(shape):
        cur = get_leaf(params, name)
        start = make_leaf(shape, init, seed, name, dims, cur.device,
                          cur.dtype)
        d = (cur.detach() - start).float()
        del start
        if name.startswith("layers."):
            n = torch.linalg.vector_norm(d.reshape(d.shape[0], -1), dim=1)
            for i, v in enumerate(n.tolist()):
                out[f"{name}.{i}"] = v
        else:
            out[name] = float(torch.linalg.vector_norm(d))
        del d
    return out
