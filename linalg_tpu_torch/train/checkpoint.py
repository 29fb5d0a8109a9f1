"""npz + JSON-sidecar checkpoints — the counterpart of
``linalg_tpu/train/checkpoint.py``.

The archive keys are the reference's (``tok_W``, ``head_W``, ``head_b``,
``pos_W``, ``l{i}_<layer key>``) and the sidecar ``chars_gpt_meta.json``
carries the tokenizer and the architecture, in the JAX package's format:
each package loads the other's checkpoints unchanged. A char tokenizer
rides the sidecar as ``stoi``/``itos``; byte-level BPE as ``"tokenizer":
"bpe"`` and its ``merges`` (with empty ``stoi``/``itos``). An MoE
checkpoint adds ``l{i}_Wr`` and the expert-stacked ``l{i}_W1`` ... to the
archive and ``experts``, ``capacity_factor``, ``aux_weight`` and
``router_top_k`` to the sidecar (``dispatch`` is not saved: a loaded MoE
takes the default, as in the JAX package).

``save_ckpt_orbax`` / ``load_ckpt_orbax`` keep the JAX package's names for
its second backend, but the port's backend is
``torch.distributed.checkpoint`` (DCP), not orbax: the parameter tree in
DCP's format under ``<ckpt_dir>/dcp`` beside the same JSON sidecar. The
two formats do not read each other (an orbax directory is not a DCP one,
and neither package converts).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Tuple

import numpy as np

from ..models.gpt import GPTConfig, Params, params_from_numpy
from ..models.moe import MoEGPTConfig
from ..nn.functional import YaRN
from ..nn.tokenizers import BPETokenizer, CharTokenizer

__all__ = ["save_ckpt", "load_ckpt", "load_tokenizer", "save_ckpt_orbax",
           "load_ckpt_orbax", "CKPT_NAME", "META_NAME", "DCP_NAME"]

CKPT_NAME = "chars_gpt_best.npz"
META_NAME = "chars_gpt_meta.json"
DCP_NAME = "dcp"  # save_ckpt_orbax's subdirectory

_LAYER_KEYS = ("ln1_g", "ln1_b", "Wq", "Wk", "Wv", "Wo", "ln2_g", "ln2_b",
               "W1", "b1", "W2", "b2")
_GATE_KEYS = ("Wg", "bg")  # swiglu/geglu's gate branch
# the MoE layer in ``init_moe_params``'s order: the router, then experts
_MOE_LAYER_KEYS = _LAYER_KEYS[:8] + ("Wr",) + _LAYER_KEYS[8:]
# config fields the JAX package lacks, with their defaults (its model): a
# sidecar names them only where a config sets them otherwise
_PORT_ONLY = {"head_dim": None, "rope_theta": 10000.0, "full_every": None,
              "rope_scaling": None}


def save_ckpt(ckpt_dir, params: Params, cfg: GPTConfig,
              stoi: Dict[str, int], itos: Dict[int, str],
              tokenizer=None) -> pathlib.Path:
    """Write ``params`` (float32 on any device) and the meta sidecar to
    ``ckpt_dir``; returns the archive's path. Uncompressed npz, as the JAX
    package writes it. A ``BPETokenizer`` adds its merge table to the
    sidecar. In a process group only process 0 writes (every process
    holds the same whole tree); the others return the path."""
    from ..parallel.distributed import process_index

    ckpt_dir = pathlib.Path(ckpt_dir)
    if process_index() != 0:
        return ckpt_dir / CKPT_NAME
    ckpt_dir.mkdir(parents=True, exist_ok=True)

    def host(t):
        return t.detach().float().cpu().numpy()

    tok_W = host(params["tok_W"])
    arrays = {"tok_W": tok_W, "head_W": tok_W.T,  # tied head, stored too
              "head_b": host(params["head_b"])}
    if "pos_W" in params:
        arrays["pos_W"] = host(params["pos_W"])
    for key, w in params["layers"].items():
        w = host(w)
        for i in range(cfg.n_layers):
            arrays[f"l{i}_{key}"] = w[i]
    path = ckpt_dir / CKPT_NAME
    np.savez(path, **arrays)
    (ckpt_dir / META_NAME).write_text(json.dumps(
        _build_meta(cfg, stoi, itos, tokenizer)))
    return path


def _build_meta(cfg: GPTConfig, stoi, itos, tokenizer=None) -> dict:
    """The JSON meta sidecar shared by the npz and DCP backends (the JAX
    package's ``_build_meta``)."""
    meta = {
        "stoi": stoi,
        "itos": {str(k): v for k, v in itos.items()},
        "vocab_size": cfg.vocab_size,
        "d_model": cfg.d_model,
        "heads": cfg.n_heads,
        "layers": cfg.n_layers,
        "ctx_len": cfg.ctx_len,
        "pos": cfg.pos,
        "d_ff": cfg.d_ff,  # None = the 4*d_model default
        "dtype": cfg.dtype,
    }
    if cfg.n_kv_heads is not None:
        meta["kv_heads"] = cfg.n_kv_heads
    if cfg.window is not None:
        meta["window"] = cfg.window
    if cfg.ffn != "relu":
        meta["ffn"] = cfg.ffn
    # the port's own settings, where they are not the JAX model's
    for key, default in _PORT_ONLY.items():
        val = getattr(cfg, key, default)
        if val != default:
            meta[key] = (dataclasses.asdict(val)
                         if dataclasses.is_dataclass(val) else val)
    if isinstance(tokenizer, BPETokenizer):
        meta["tokenizer"] = "bpe"
        meta["merges"] = [list(m) for m in tokenizer.merges]
    if isinstance(cfg, MoEGPTConfig):
        meta["experts"] = cfg.n_experts
        meta["capacity_factor"] = cfg.capacity_factor
        meta["aux_weight"] = cfg.aux_weight
        meta["router_top_k"] = cfg.router_top_k
        if cfg.dispatch == "grouped":  # the port's own dispatch
            meta["dispatch"] = cfg.dispatch
    return meta


def load_ckpt(ckpt_dir, device=None) -> Tuple[Params, GPTConfig,
                                              Dict[str, int], Dict[int, str]]:
    """Rebuild (params, cfg, stoi, itos) from an archive + meta sidecar;
    parameters are float32 tensors on ``device``. Raises on a missing or
    corrupt file."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    meta = json.loads((ckpt_dir / META_NAME).read_text())
    cfg = _cfg_from_meta(meta)
    stoi = meta["stoi"]
    itos = {int(k): v for k, v in meta["itos"].items()}
    keys = (_MOE_LAYER_KEYS if isinstance(cfg, MoEGPTConfig)
            else _LAYER_KEYS) + (_GATE_KEYS if cfg.gated_ffn else ())
    with np.load(ckpt_dir / CKPT_NAME) as z:
        # float32: reference-produced archives are float64
        host = {
            "tok_W": np.asarray(z["tok_W"], np.float32),
            "head_b": np.asarray(z["head_b"], np.float32),
            "layers": {
                k: np.stack([z[f"l{i}_{k}"] for i in range(cfg.n_layers)]
                            ).astype(np.float32)
                for k in keys},
        }
        if cfg.pos == "learned":
            host["pos_W"] = np.asarray(z["pos_W"], np.float32)
    return params_from_numpy(host, device), cfg, stoi, itos


def _cfg_from_meta(meta: dict) -> GPTConfig:
    """The (dense or MoE) config of a meta sidecar, tolerating
    reference-format metas (no pos/d_ff/dtype/vocab_size keys)."""
    common = dict(
        vocab_size=meta.get("vocab_size") or len(meta["stoi"]),
        d_model=meta["d_model"],
        n_heads=meta["heads"],
        n_layers=meta["layers"],
        ctx_len=meta["ctx_len"],
        pos=meta.get("pos", "sinusoidal"),
        d_ff=meta.get("d_ff"),
        dtype=meta.get("dtype", "float32"),
        n_kv_heads=meta.get("kv_heads"),
        window=meta.get("window"),
        ffn=meta.get("ffn", "relu"),
    )
    for key in ("head_dim", "rope_theta", "full_every"):
        if key in meta:
            common[key] = meta[key]
    if "rope_scaling" in meta:
        common["rope_scaling"] = YaRN(**meta["rope_scaling"])
    if meta.get("experts", 0):
        return MoEGPTConfig(
            n_experts=meta["experts"],
            capacity_factor=meta.get("capacity_factor", 1.25),
            aux_weight=meta.get("aux_weight", 0.01),
            router_top_k=meta.get("router_top_k", 1),
            dispatch=meta.get("dispatch", "einsum"), **common)
    return GPTConfig(**common)


def load_tokenizer(ckpt_dir):
    """The tokenizer a checkpoint was trained with: BPE from the merge
    table of a ``"tokenizer": "bpe"`` sidecar, else the char tokenizer
    from stoi/itos (reference-produced archives included)."""
    meta = json.loads((pathlib.Path(ckpt_dir) / META_NAME).read_text())
    if meta.get("tokenizer") == "bpe":
        return BPETokenizer.load({"merges": meta["merges"]})
    itos = {int(k): v for k, v in meta["itos"].items()}
    return CharTokenizer.from_pretrained(meta["stoi"], itos)


# -- the DCP backend (the JAX package's orbax names) -------------------------


def _flat(tree, prefix=""):
    """{"layers.Wq": tensor, ...}: the tree's leaves under dotted keys."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def save_ckpt_orbax(ckpt_dir, params: Params, cfg: GPTConfig,
                    stoi: Dict[str, int], itos: Dict[int, str],
                    tokenizer=None) -> pathlib.Path:
    """Save through ``torch.distributed.checkpoint`` (DCP), not orbax:
    ``dcp.save`` writes the parameter tree, in its own dtypes and from any
    device, to ``<ckpt_dir>/dcp``, and the JSON sidecar is ``save_ckpt``'s
    (the JAX package's ``_build_meta``). With a process group started
    (``parallel.init_distributed``) the processes save collectively, each
    its share; without one the process saves alone. Returns the DCP
    directory."""
    import torch.distributed.checkpoint as dcp

    ckpt_dir = pathlib.Path(ckpt_dir).resolve()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / DCP_NAME
    dcp.save(_flat(params), checkpoint_id=str(path))
    (ckpt_dir / META_NAME).write_text(json.dumps(
        _build_meta(cfg, stoi, itos, tokenizer)))
    return path


def load_ckpt_orbax(ckpt_dir, device=None) -> Tuple[
        Params, GPTConfig, Dict[str, int], Dict[int, str]]:
    """Counterpart of ``save_ckpt_orbax``: (params, cfg, stoi, itos) with
    the parameters on ``device`` (the card unless the caller asks for the
    CPU; without a card and without that request this raises). DCP loads
    in place, so the tree is allocated first, with the shapes and dtypes
    of DCP's own metadata; with a process group the processes load
    collectively. An orbax directory is not a DCP one: the JAX package's
    orbax checkpoints do not load here."""
    import torch
    import torch.distributed.checkpoint as dcp

    from ..utils.device import resolve_device

    ckpt_dir = pathlib.Path(ckpt_dir).resolve()
    meta = json.loads((ckpt_dir / META_NAME).read_text())
    cfg = _cfg_from_meta(meta)
    dev = resolve_device(device)
    path = str(ckpt_dir / DCP_NAME)
    md = dcp.FileSystemReader(path).read_metadata()
    flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype,
                           device=dev)
            for k, m in md.state_dict_metadata.items()}
    dcp.load(flat, checkpoint_id=path)
    params: Params = {}
    for key, t in flat.items():
        *parents, leaf = key.split(".")
        node = params
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    stoi = meta["stoi"]
    itos = {int(k): v for k, v in meta["itos"].items()}
    return params, cfg, stoi, itos
