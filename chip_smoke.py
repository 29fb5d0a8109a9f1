#!/usr/bin/env python3
"""Drive the PyTorch port's paged serving path on one CUDA card.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:

1. device  — require CUDA; print the card and its power limit.
2. build   — build the CUDA paged-attention kernel from
             ``linalg_tpu_torch/kernels/csrc`` and time the build.
3. kernel  — the kernel against its plain PyTorch version at the serving
             shape (B 8, H 4, kv heads 2, d 128, page 256, 16 pages per
             slot; ragged positions and an idle slot on the trash page) in
             float32 and bfloat16, plus d 64 with a per-head mask; max
             error and median CUDA-event times of both.
4. engine  — ServeEngine(paged, page 256, 8 slots, chunk 32, prefill
             window 2048) over GPTConfig(d512, 4 heads, 2 KV heads, 8
             layers, ctx 4096, bf16), random weights from seed 0, 16
             requests (prompts 512-2048 ids, budgets 64-256 from
             ``np.random.default_rng(0)``), with paged_attn="kernel" and
             "gather". Every request must finish with its full budget, and
             the kernel run must launch the kernel once per layer per step.
5. equality — the same engine in float32 (TF32 off), greedy, on 4 of the
             requests: the kernel engine's tokens must equal the gather
             engine's.

The line before the last is a JSON object describing the kernel; the last
line is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SERVE_CFG = dict(vocab_size=65, d_model=512, n_heads=4, n_kv_heads=2,
                 n_layers=8, ctx_len=4096)
ENGINE_KW = dict(paged=True, page=256, n_slots=8, chunk=32,
                 prefill_window=2048)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def kernel_case(B, H, hk, d, page, Pmax, dtype, seed, per_head_mask=False):
    """Random inputs on the card in the engine's layout: distinct pages per
    slot, ragged positions, the last slot idle (all-trash table row, a
    position past ctx)."""
    rng = np.random.default_rng(seed)
    ctx = page * Pmax
    n_pages = 1 + B * Pmax
    dev = "cuda"

    def t(a):
        return torch.tensor(a, dtype=dtype, device=dev)

    q = t(rng.normal(size=(B, H, 1, d)))
    pk = t(rng.normal(size=(n_pages, hk, page, d)))
    pv = t(rng.normal(size=(n_pages, hk, page, d)))
    table = rng.permutation(np.arange(1, n_pages)).reshape(B, Pmax)
    table[-1] = 0
    pos = rng.integers(0, ctx, size=B)
    pos[-1] = ctx + 37
    live = np.arange(ctx)[None, :] <= pos[:, None]
    mask = np.where(live, 0.0, -1e9)[:, None, None, :]
    if per_head_mask:  # an additive per-head bias on the live rows
        mask = mask + rng.normal(scale=0.1, size=(B, H, 1, ctx)) * live[
            :, None, None, :]
    return (q, pk, pv, t(mask),
            torch.tensor(table, dtype=torch.int32, device=dev),
            torch.tensor(pos, dtype=torch.int32, device=dev))


def median_ms(fn, args, trials=15, reps=10):
    """Median over ``trials`` of the CUDA-event time of ``reps`` calls."""
    for _ in range(3):
        fn(*args)
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn(*args)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def make_requests(Request, n, greedy=False):
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(16):
        plen = int(rng.integers(512, 2049))
        budget = int(rng.integers(64, 257))
        prompt = rng.integers(0, SERVE_CFG["vocab_size"], size=plen).tolist()
        reqs.append(Request(prompt, budget, top_k=1 if greedy else None))
    return reqs[:n]


def run_engine(ServeEngine, params, cfg, reqs, mode, seed=0):
    eng = ServeEngine(params, cfg, paged_attn=mode, seed=seed,
                      device="cuda", **ENGINE_KW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.submit(r) for r in reqs]
    done = {c.request_id: c for c in eng.run()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [done[i] for i in ids]
    for r, c in zip(reqs, outs):
        if c.finish_reason != "length" or len(c.tokens) != r.max_new_tokens:
            raise RuntimeError(f"{mode}: request {c.request_id} ended "
                               f"{c.finish_reason} with {len(c.tokens)} of "
                               f"{r.max_new_tokens} tokens")
        if not all(0 <= t < cfg.vocab_size for t in c.tokens):
            raise RuntimeError(f"{mode}: token out of the vocabulary")
    if eng._allocator.n_free != eng._allocator.n_pages - 1:
        raise RuntimeError(f"{mode}: pages not returned to the pool")
    n_tok = sum(len(c.tokens) for c in outs)
    return outs, wall, n_tok, eng.stats


def main() -> int:
    # -- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from linalg_tpu_torch.kernels import build as kbuild
    from linalg_tpu_torch.kernels.paged_attention import paged_attention_cuda
    from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from linalg_tpu_torch.serve import Request, ServeEngine
    from linalg_tpu_torch.serve.paged import paged_attention_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase("device", f"{kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; cards {torch.cuda.device_count()}")
    print(smi, flush=True)

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    lib = kbuild.build("paged_attention")
    build_s = time.perf_counter() - t0
    phase("build", f"{lib.name} in {build_s:.2f} s")
    for ln in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in ln or "spill" in ln or "bytes smem" in ln:
            phase("build", ln.strip())

    # -- 3. kernel vs plain version -------------------------------------
    cases = [  # name, shape args, dtype, tolerance (rtol, atol)
        ("serve f32", (8, 4, 2, 128, 256, 16), torch.float32, (2e-5, 2e-6),
         False),
        ("serve bf16", (8, 4, 2, 128, 256, 16), torch.bfloat16, (0, 2e-2),
         False),
        ("d64 f32", (8, 8, 1, 64, 256, 16), torch.float32, (2e-5, 2e-6),
         True),
        ("d64 bf16", (8, 8, 1, 64, 256, 16), torch.bfloat16, (0, 2e-2),
         True),
    ]
    record = None
    for i, (name, shp, dt, (rtol, atol), per_head) in enumerate(cases):
        args = kernel_case(*shp, dt, seed=i, per_head_mask=per_head)
        got = paged_attention_cuda(*args)
        want = paged_attention_ref(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        ms = median_ms(paged_attention_cuda, args)
        plain_ms = median_ms(paged_attention_ref, args)
        phase("kernel", f"{name} B,H,hk,d,page,Pmax={shp}: max_abs_err "
              f"{err:.3e} (rtol {rtol}, atol {atol}); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        if name == "serve bf16":  # the engine's shape and dtype
            record = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # -- 4. engine ------------------------------------------------------
    cfg = GPTConfig(dtype="bfloat16", **SERVE_CFG)
    params = init_gpt_params(cfg, seed=0, device="cuda")
    reqs = make_requests(Request, 16)
    warm = [Request(list(range(1, 60)) * 9, 32)]
    for mode in ("kernel", "gather"):  # first-use costs out of the timing
        run_engine(ServeEngine, params, cfg, warm, mode)
    paged_attention_cuda.launches = 0
    _, wall_k, n_tok, stats = run_engine(ServeEngine, params, cfg, reqs,
                                         "kernel")
    launches = paged_attention_cuda.launches
    expected = stats["chunks"] * ENGINE_KW["chunk"] * cfg.n_layers
    if launches == 0 or launches != expected:
        raise RuntimeError(f"kernel engine launched the kernel {launches} "
                           f"times; expected {expected}")
    _, wall_g, n_tok_g, _ = run_engine(ServeEngine, params, cfg, reqs,
                                       "gather")
    if paged_attention_cuda.launches != launches:
        raise RuntimeError("the gather engine launched the kernel")
    _, wall_g2, _, _ = run_engine(ServeEngine, params, cfg, reqs, "gather")
    _, wall_k2, _, _ = run_engine(ServeEngine, params, cfg, reqs, "kernel")
    phase("engine", f"16 requests, {n_tok} tokens, {stats['chunks']} chunks,"
          f" {launches} kernel launches")
    phase("engine", f"kernel: {wall_k:.3f} s, {n_tok / wall_k:.1f} tok/s; "
          f"again {wall_k2:.3f} s, {n_tok / wall_k2:.1f} tok/s")
    phase("engine", f"gather: {wall_g:.3f} s, {n_tok_g / wall_g:.1f} tok/s; "
          f"again {wall_g2:.3f} s, {n_tok_g / wall_g2:.1f} tok/s")

    # -- 5. f32 greedy equality -----------------------------------------
    cfg32 = GPTConfig(dtype="float32", **SERVE_CFG)
    reqs4 = make_requests(Request, 4, greedy=True)
    out_k = run_engine(ServeEngine, params, cfg32, reqs4, "kernel")[0]
    out_g = run_engine(ServeEngine, params, cfg32, reqs4, "gather")[0]
    same = [a.tokens == b.tokens for a, b in zip(out_k, out_g)]
    phase("equality", f"f32 greedy, 4 requests, "
          f"{sum(len(c.tokens) for c in out_k)} tokens: kernel == gather "
          f"per request {same}")
    if not all(same):
        raise RuntimeError("f32 greedy tokens differ between the kernel and "
                           "gather engines")

    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "linalg_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "linalg_tpu/serve/paged.py:433",
        "launches": launches, **record}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
