"""A copy of the benchmark with tiny cells added, as new files and new
entries alone, for the CPU tests: ``make_root(dir)`` copies
``BENCHMARK.json`` and ``portbench/`` into ``dir`` and adds

- configurations ``tiny`` (learned positions, GELU, V 9000: the chunked
  loss), ``tinys`` (``tiny`` at a wider init, for serving) and ``tinyw``
  (RoPE, GQA 4/2, SwiGLU, window 24), all bfloat16;
- mixes ``t-train`` and ``t-serve`` (the ``train`` and ``closed_loop``
  kinds at tiny sizes);
- cells ``tiny-train``, ``tinyw-train`` and ``tiny-serve``, each reporting
  the metrics its kind's real cells report.
"""

from __future__ import annotations

import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]

_TINY = {"d_model": 32, "n_heads": 2, "n_layers": 2, "d_ff": 128,
         "ctx_len": 64, "vocab_size": 9000, "pos": "learned",
         "ffn": "gelu", "dtype": "bfloat16"}

CONFIGS = {
    "tiny": {"port": _TINY, "init": {"std": 0.02, "scaled_out_proj": True}},
    # logits spread widely enough that float8's roundings flip tokens by
    # more than bfloat16's do: at 0.02 a tiny model's logits all but tie
    "tinys": {"port": _TINY, "init": {"std": 0.2, "scaled_out_proj": True}},
    "tinyw": {"port": {"d_model": 32, "n_heads": 4, "n_kv_heads": 2,
                       "n_layers": 2, "d_ff": 96, "ctx_len": 64,
                       "vocab_size": 300, "pos": "rope", "ffn": "swiglu",
                       "window": 24, "dtype": "bfloat16"},
              "init": {"std": 0.02}},
}

MIXES = {
    "t-train": {"kind": "train", "batch": 4, "seq": 64, "grad_accum": 2,
                "corpus_tokens": 5000,
                "schedule": {"base_lr": 3e-4, "min_lr": 3e-5,
                             "warmup": 200, "max_steps": 4000,
                             "weight_decay": 0.01}},
    "t-serve": {"kind": "closed_loop", "clients": 4,
                "engine": {"paged": True, "paged_attn": "kernel",
                           "page": 8, "n_slots": 4, "chunk": 4},
                "prompt": {"dist": "lognormal", "median": 12, "sigma": 0.5,
                           "min": 6, "max": 24},
                "output": {"dist": "uniform", "min": 6, "max": 16},
                "grid": 64},
}

# limits at these sizes, between what the program reads against the
# reference and what the float8 control reads: serving's ``flip_gap``
# reads 0 to 0.0147 for the program over six seeds, 0.029 to 0.21 for
# the control (0.17 on the tests' seed) and 3.4 to 5.1 for a token altered
TRAIN_LIMITS = {"loss_gap": 1e-4, "grad_gap": 0.008}
SERVE_LIMITS = {"flip_gap": 0.05}

CELLS = {
    "tiny-train": ("tiny", "t-train", TRAIN_LIMITS, "gpt2xl-train"),
    "tinyw-train": ("tinyw", "t-train", TRAIN_LIMITS, "gpt2xl-train"),
    "tiny-serve": ("tinys", "t-serve", SERVE_LIMITS, "gpt2xl-serve"),
}


def write_json(path: pathlib.Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1))


def make_root(dest: pathlib.Path, cells=CELLS) -> pathlib.Path:
    """A checkout-like tree at ``dest`` with the tiny cells added."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, c in CONFIGS.items():
        write_json(dest / "portbench" / "configs" / f"{name}.json",
                   dict(c, name=name))
        bench["configs"].append({
            "name": name, "source": "https://example.invalid/tiny",
            "file": f"portbench/configs/{name}.json", "reduced": [],
            "why": "tiny CPU test configuration"})
    for name, m in MIXES.items():
        write_json(dest / "portbench" / "traffic" / f"{name}.json", m)
    for name, (cfg, mix, limits, like) in cells.items():
        write_json(dest / "portbench" / "workloads" / f"{name}.json",
                   {"config": cfg, "traffic": mix, "why": "tiny",
                    "check": {"requests": 4},
                    "limits": limits})
        bench["workloads"].append({"name": name, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "tiny CPU test cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(name)
    write_json(dest / "BENCHMARK.json", bench)
    return dest
