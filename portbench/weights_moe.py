"""Seeded weights of the routed MoE GPTs, made on the device in the layout
of ``linalg_tpu_torch.models.moe``: ``tok_W`` (V, D), ``head_b`` (V,), and
``layers``, a dict of (L, ...) stacks, the experts' with the held experts
on their second axis (L, El, ...), the router ``Wr`` (L, D, E) over all
the router's experts.

Each leaf is made as ``portbench.weights.make_leaf`` makes it (one
``torch.randn`` from a generator seeded by the run's seed and the leaf's
name, N(0, std) matmul weights, unit LayerNorm gains, zero biases), the
router too at N(0, std). Plain torch: nothing of the program is imported.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from portbench import weights


def leaf_shapes(shape: Dict) -> Iterator[Tuple[str, tuple]]:
    D, F, L, V = (shape["d_model"], shape["d_ff"], shape["n_layers"],
                  shape["vocab_size"])
    QD = shape["n_heads"] * shape["head_dim"]
    KD = shape["n_kv_heads"] * shape["head_dim"]
    El, E = shape["experts_held"], shape["n_experts"]
    yield "tok_W", (V, D)
    yield "head_b", (V,)
    dims = {"Wq": (D, QD), "Wk": (D, KD), "Wv": (D, KD), "Wo": (QD, D),
            "ln1_g": (D,), "ln1_b": (D,), "ln2_g": (D,), "ln2_b": (D,),
            "Wr": (D, E), "W1": (El, D, F), "b1": (El, F),
            "Wg": (El, D, F), "bg": (El, F), "W2": (El, F, D),
            "b2": (El, D)}
    for key, dim in dims.items():
        yield f"layers.{key}", (L,) + dim


def make_leaf(shape: Dict, init: Dict, seed: int, name: str, dims: tuple,
              device, dtype) -> torch.Tensor:
    """``weights.make_leaf``'s leaf; the router ``Wr`` at N(0, std)."""
    if name.split(".")[-1] != "Wr":
        return weights.make_leaf(shape, init, seed, name, dims, device,
                                 dtype)
    g = torch.Generator(device=device)
    g.manual_seed(weights._leaf_seed(seed, name))
    t = torch.randn(dims, generator=g, device=device, dtype=dtype)
    return t.mul_(float(init["std"]))


def make_params(shape: Dict, init: Dict, seed: int, device,
                dtype=torch.float32) -> Dict:
    out: Dict = {"layers": {}}
    for name, dims in leaf_shapes(shape):
        t = make_leaf(shape, init, seed, name, dims, device, dtype)
        if name.startswith("layers."):
            out["layers"][name[len("layers."):]] = t
        else:
            out[name] = t
    return out


def _per_layer(name: str, t: torch.Tensor, scale: float, out: Dict):
    if name.startswith("layers."):
        n = torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=1)
        for i, v in enumerate((n * scale).tolist()):
            out[f"{name}.{i}"] = v
    else:
        out[name] = float(torch.linalg.vector_norm(t)) * scale


@torch.no_grad()
def leaf_norms(params: Dict, shape: Dict, scale: float = 1.0
               ) -> Dict[str, float]:
    """``weights.leaf_norms`` over these leaves: one norm a leaf, a layer
    stack one a layer (its held experts together)."""
    out: Dict[str, float] = {}
    for name, _ in leaf_shapes(shape):
        _per_layer(name, weights.get_leaf(params, name).float(), scale, out)
    return out


@torch.no_grad()
def change_norms(params: Dict, shape: Dict, init: Dict, seed: int
                 ) -> Dict[str, float]:
    """``weights.change_norms`` over these leaves."""
    out: Dict[str, float] = {}
    for name, dims in leaf_shapes(shape):
        cur = weights.get_leaf(params, name)
        start = make_leaf(shape, init, seed, name, dims, cur.device,
                          cur.dtype)
        d = (cur.detach() - start).float()
        del start
        _per_layer(name, d, 1.0, out)
        del d
    return out
