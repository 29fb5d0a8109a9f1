"""LoRA: low-rank adaptation for the GPT — the counterpart of
``linalg_tpu/models/lora.py``.

Every target weight W gets a frozen base plus a trainable low-rank delta,

    W_eff = W + (alpha / rank) * A @ B,       A: (d_in, r), B: (r, d_out)

with B zero-initialized, so finetuning starts exactly at the base model
(Hu et al. 2021). Adapters keep the stacked (L, ...) layer layout and
the JAX package's keys (``Wq_A``, ``Wq_B``, ...). ``init_lora_params``
draws A from the same NumPy generator in the same order, so both
packages start from bit-identical adapters, and ``save_lora`` /
``load_lora`` keep the JAX package's npz + JSON layout, so adapter
checkpoints load in either package.

- Finetuning differentiates the loss through ``lora_merge`` with respect
  to the adapters only (``train.trainer.make_device_train_step(lora=...)``);
  the model's own backwards stay its hand-derived ``autograd.Function``s.
- Inference merges once (``lora_merge``) and runs every path unchanged.
- Multi-LoRA serving keeps zeroed adapter STACKS (``init_lora_stacks``:
  row 0 is the base model) and runs each slot's token through its own
  adapter on a low-rank side-path (``lora_decode_ops``); admissions
  prefill through dense weights merged from a stack row for that one
  prefill (``lora_merge_stacks``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["LoRAConfig", "init_lora_params", "lora_merge", "save_lora",
           "load_lora", "TARGET_SETS", "init_lora_stacks", "stack_lora",
           "lora_decode_ops", "lora_merge_stacks", "lora_from_numpy"]

# which stacked layer weights get adapters: "attn" is the classic recipe,
# "all" adds the FFN matmuls (Wg only where the config has a gate)
TARGET_SETS: Dict[str, Tuple[str, ...]] = {
    "attn": ("Wq", "Wk", "Wv", "Wo"),
    "all": ("Wq", "Wk", "Wv", "Wo", "W1", "W2", "Wg"),
}


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 8
    alpha: float = 16.0  # delta scale = alpha / rank (PEFT convention)
    targets: str = "attn"  # key into TARGET_SETS

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError("LoRA rank must be >= 1")
        if self.targets not in TARGET_SETS:
            raise ValueError(
                f"targets must be one of {sorted(TARGET_SETS)}, "
                f"got {self.targets!r}")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def init_lora_params(params, lcfg: LoRAConfig, seed: int = 0, device=None):
    """Adapter dict for a GPT parameter dict: for each target ``W`` of
    stacked shape (L, d_in, d_out), ``W_A`` (L, d_in, r) ~ N(0, 1/r) and
    ``W_B`` (L, r, d_out) = 0. Float32, drawn as the JAX package draws
    them; on ``device``, by default the parameters'."""
    rng = np.random.default_rng(seed)
    r = lcfg.rank
    layers = params["layers"]
    dev = device if device is not None else layers["Wq"].device
    out = {}
    for name in TARGET_SETS[lcfg.targets]:
        if name not in layers:
            continue
        L, din, dout = layers[name].shape
        out[f"{name}_A"] = torch.tensor(
            rng.normal(0.0, 1.0 / math.sqrt(r), size=(L, din, r)),
            dtype=torch.float32, device=dev)
        out[f"{name}_B"] = torch.zeros((L, r, dout), dtype=torch.float32,
                                       device=dev)
    if not out:
        raise ValueError("no LoRA targets present in this param pytree")
    return {"layers": out}


def lora_from_numpy(np_lora, device=None):
    """The JAX package's adapter tree, as numpy arrays, as this package's
    (the adapters' counterpart of ``models.gpt.params_from_numpy``)."""
    return {"layers": {k: torch.tensor(np.asarray(v), device=device)
                       for k, v in np_lora["layers"].items()}}


def lora_merge(params, lora, lcfg: LoRAConfig):
    """Effective dense params: base + (alpha/rank) * A @ B per target.
    Differentiable with respect to the adapters (the finetune step) and
    used once at load time for inference."""
    scale = lcfg.scale
    layers = dict(params["layers"])
    for key, a in lora["layers"].items():
        if not key.endswith("_A"):
            continue
        name = key[:-2]
        delta = scale * (a @ lora["layers"][f"{name}_B"])
        layers[name] = layers[name] + delta.to(layers[name].dtype)
    return dict(params, layers=layers)


# -- multi-LoRA serving: stacked adapters + a per-slot decode side-path -------


def init_lora_stacks(params, max_loras: int, rank: int, dtype=None):
    """Zeroed adapter STACKS: per attention target, A (L, max_loras+1,
    d_in, rank) and B (L, max_loras+1, rank, d_out), plus a per-adapter
    ``scale`` vector. Row 0 is the base model (an all-zero adapter)."""
    layers = params["layers"]
    dt = dtype or layers["Wq"].dtype
    dev = layers["Wq"].device
    out = {"scale": torch.zeros((max_loras + 1,), dtype=torch.float32,
                                device=dev)}
    for name in TARGET_SETS["attn"]:
        L, din, dout = layers[name].shape
        out[f"{name}_A"] = torch.zeros((L, max_loras + 1, din, rank),
                                       dtype=dt, device=dev)
        out[f"{name}_B"] = torch.zeros((L, max_loras + 1, rank, dout),
                                       dtype=dt, device=dev)
    return out


def stack_lora(stacks, lora, lcfg: LoRAConfig, idx: int):
    """Write adapter ``lora`` into row ``idx`` of the stacks, IN PLACE,
    zero-padding a smaller rank up to the stack's (the padding is exact
    zeros). Targets must be "attn" (the decode side-path adapts the
    attention projections). Returns the stacks."""
    if lcfg.targets != "attn":
        raise ValueError("multi-LoRA serving supports targets='attn'")
    r_stack = stacks["Wq_A"].shape[-1]
    if lcfg.rank > r_stack:
        raise ValueError(
            f"adapter rank {lcfg.rank} exceeds the engine's lora_rank "
            f"{r_stack}")
    stacks["scale"][idx] = lcfg.scale
    pad = r_stack - lcfg.rank
    for name in TARGET_SETS["attn"]:
        a = lora["layers"][f"{name}_A"].to(stacks[f"{name}_A"].device)
        b = lora["layers"][f"{name}_B"].to(stacks[f"{name}_B"].device)
        if pad:
            a = F.pad(a, (0, pad))
            b = F.pad(b, (0, 0, 0, pad))
        stacks[f"{name}_A"][:, idx] = a.to(stacks[f"{name}_A"].dtype)
        stacks[f"{name}_B"][:, idx] = b.to(stacks[f"{name}_B"].dtype)
    return stacks


def lora_merge_stacks(params, stacks, idx: int):
    """Effective dense params for stack row ``idx`` (0 = the base row):
    base + scale[idx] * A[:, idx] @ B[:, idx] per attention target, formed
    in float32. The engine builds them for one admission's prefill and
    drops them after, so it holds base + stacks, never a merged copy per
    adapter."""
    sc = stacks["scale"][idx]
    layers = dict(params["layers"])
    for name in TARGET_SETS["attn"]:
        a = stacks[f"{name}_A"][:, idx].float()  # (L, d_in, r)
        b = stacks[f"{name}_B"][:, idx].float()  # (L, r, d_out)
        delta = sc * (a @ b)
        layers[name] = layers[name] + delta.to(layers[name].dtype)
    return dict(params, layers=layers)


def lora_decode_ops(ops, stacks, ids, cfg):
    """Wrap decode ``ops`` (``models.gpt._dt_decode_ops`` or the int8
    ``models.quant._q_decode_ops``) so each SLOT's token runs through its
    own adapter: per layer and target, y += scale[id_b] * (x @ A[id_b]) @
    B[id_b], the low-rank side-path (merged weights cannot batch slots
    that wear different adapters). ``ids`` is the (B,) per-slot adapter-id
    tensor, read at every call, so the engine updates it in place; id 0
    is the all-zero base row."""
    del cfg
    base_qkv, base_out = ops["qkv"], ops["out"]

    def delta(x, a_l, b_l):
        # x (B, t, d_in); a_l (n, d_in, r); b_l (n, r, d_out)
        lo = torch.einsum("btd,bdr->btr", x, a_l[ids].to(x.dtype))
        hi = torch.einsum("btr,bro->bto", lo, b_l[ids].to(x.dtype))
        return hi * stacks["scale"][ids][:, None, None].to(x.dtype)

    def qkv(lw, xn):
        return base_qkv(lw, xn) + torch.cat(
            [delta(xn, lw["Wq_A"], lw["Wq_B"]),
             delta(xn, lw["Wk_A"], lw["Wk_B"]),
             delta(xn, lw["Wv_A"], lw["Wv_B"])], dim=-1)

    def out(lw, y):
        return base_out(lw, y) + delta(y, lw["Wo_A"], lw["Wo_B"])

    lws = []
    for i, lw in enumerate(ops["lws"]):
        lw = dict(lw)
        for name in TARGET_SETS["attn"]:
            lw[f"{name}_A"] = stacks[f"{name}_A"][i]
            lw[f"{name}_B"] = stacks[f"{name}_B"][i]
        lws.append(lw)
    return dict(ops, lws=lws, qkv=qkv, out=out)


def save_lora(path, lora, lcfg: LoRAConfig):
    """Adapter-only checkpoint: a flat npz + JSON meta (rank, alpha,
    targets), the JAX package's layout."""
    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    flat = {k: v.detach().cpu().numpy() for k, v in lora["layers"].items()}
    np.savez_compressed(path / "lora_adapters.npz", **flat)
    (path / "lora_meta.json").write_text(json.dumps({
        "rank": lcfg.rank, "alpha": lcfg.alpha, "targets": lcfg.targets,
    }), encoding="utf-8")
    return path / "lora_adapters.npz"


def load_lora(path, device=None):
    """(adapter dict, LoRAConfig) from ``save_lora``'s layout (either
    package's). Raises on a missing or invalid directory."""
    path = pathlib.Path(path)
    meta = json.loads((path / "lora_meta.json").read_text(encoding="utf-8"))
    lcfg = LoRAConfig(rank=int(meta["rank"]), alpha=float(meta["alpha"]),
                      targets=str(meta["targets"]))
    with np.load(path / "lora_adapters.npz") as z:
        layers = {k: torch.tensor(z[k], device=device) for k in z.files}
    return {"layers": layers}, lcfg
