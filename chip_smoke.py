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
6. qr      — the Householder panel kernel (``csrc/qr_panel.cu``): its build
             time and ptxas lines; the kernel against its plain PyTorch
             version at (b, m, k) = (32, 4096, 0), (32, 4096, 2048),
             (64, 4096, 0), the panel width (128, 4096, 0) and a strip with
             a zero column (exact skip), max error, tolerance and median
             CUDA-event times of both; then ``householder_qr`` on a 4096^2
             float32 matrix from ``np.random.default_rng(0)``: 128 strip
             launches (n / 32), rel_resid ||A-QR||_F/||A||_F in float64
             <= 1e-6, ||Q^T Q - I||_F, median times of three runs through
             the kernel, through the same driver with the plain strip, and
             of ``torch.linalg.qr`` (GFLOP/s as 2 N^3 / t); and once more
             with the caller's TF32 switched on, still <= 1e-6.

Phase 2 builds every kernel, one ``nvcc`` per source, all started
together. The line before the last is a JSON object describing the
kernels; the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
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
KERNELS = ("paged_attention", "qr_panel")
QR_N = 4096          # the headline QR: 4096^2 float32
QR_INNER = 32        # strip width householder_qr_panel passes the kernel
QR_RESID_MAX = 1e-6  # ||A - QR||_F / ||A||_F, the headline accuracy gate
# kernel vs plain sweep: float32 sums over m lanes in another order; a
# float64 sweep at m 4096 differs from the float32 one by 2e-5 on St
# (magnitude 65), 1.4e-7 on Vt and 1e-7 on Tt
QR_RTOL_OF_MAX = 1e-5


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


def median_ms(fn, args, trials=15, reps=10, warm=3):
    """Median over ``trials`` of the CUDA-event time of ``reps`` calls."""
    for _ in range(warm):
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


def build_all(kbuild):
    """Build every kernel, one nvcc per source, all started together.
    Returns {name: (library path, seconds)}; a failed build raises."""
    def one(name):
        t0 = time.perf_counter()
        lib = kbuild.build(name)
        return lib, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        futures = {name: pool.submit(one, name) for name in KERNELS}
        return {name: f.result() for name, f in futures.items()}


def report_build(tag, built):
    lib, seconds = built
    phase(tag, f"{lib.name} in {seconds:.2f} s")
    for ln in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in ln or "spill" in ln or "bytes smem" in ln:
            phase(tag, ln.strip())


def qr_phase():
    """Phase 6: the panel kernel against its plain version, then the
    4096^2 Householder QR through it. Returns the kernel's JSON record."""
    from linalg_tpu_torch.kernels.qr_panel import factor_strip_cuda
    from linalg_tpu_torch.ops.qr import householder_qr
    from linalg_tpu_torch.ops.qr_panel import (
        factor_panel_ref,
        factor_strip_ref,
        householder_qr_panel,
    )

    record = None
    cases = [  # name, (b, m, k), zero column
        ("strip", (32, 4096, 0), None),
        ("strip k 2048", (32, 4096, 2048), None),
        ("strip b 64", (64, 4096, 0), None),
        ("panel b 128", (128, 4096, 0), None),
        ("zero column", (32, 4096, 0), 5),
    ]
    for i, (name, (b, m, k), zero) in enumerate(cases):
        St = np.random.default_rng(100 + i).standard_normal((b, m))
        if zero is not None:
            St[zero] = 0.0
        St = torch.tensor(St, dtype=torch.float32, device="cuda")
        ref = factor_strip_ref if b <= 64 else factor_panel_ref
        got = factor_strip_cuda(St, k)
        want = ref(St, k)
        torch.cuda.synchronize()
        errs, tols = [], []
        for g, w, what in zip(got, want, ("St", "Vt", "Tt")):
            err = float((g - w).abs().max())
            tol = QR_RTOL_OF_MAX * max(1.0, float(w.abs().max()))
            errs.append(err)
            tols.append(tol)
            if not err <= tol:
                raise RuntimeError(f"qr_panel {name}: {what} max_abs_err "
                                   f"{err:.3e} > tolerance {tol:.3e}")
        if zero is not None:
            vz = float(got[1][zero].abs().max())
            tz = float(got[2][zero, zero])
            if vz != 0.0 or tz != 0.0:
                raise RuntimeError(f"qr_panel zero column: Vt row {vz}, "
                                   f"Tt diagonal {tz}; both must be 0")
        slow = b > 32
        ms = median_ms(factor_strip_cuda, (St, k), trials=7 if slow else 15,
                       reps=3 if slow else 10)
        plain_ms = median_ms(ref, (St, k), trials=5, reps=2, warm=1)
        phase("qr", f"{name} b,m,k={b},{m},{k}: max_abs_err St/Vt/Tt "
              f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e} (tolerance "
              f"{QR_RTOL_OF_MAX} x max|want|: {tols[0]:.3e}/{tols[1]:.3e}/"
              f"{tols[2]:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if name == "strip":  # the main path's shape
            record = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms)

    N = QR_N
    A_host = np.random.default_rng(0).standard_normal((N, N)).astype(
        np.float32)
    A = torch.tensor(A_host, device="cuda")
    A64 = A.double()
    eye = torch.eye(N, dtype=torch.float64, device="cuda")

    def quality(Q, R):
        rel = float(torch.linalg.norm(Q.double() @ R.double() - A64)
                    / torch.linalg.norm(A64))
        orth = float(torch.linalg.norm(Q.double().T @ Q.double() - eye))
        return rel, orth

    def plain_driver(A):  # the same driver with the plain strip sweep
        return householder_qr_panel(A, block=128, inner=QR_INNER,
                                    strip=factor_strip_ref)

    runs = {"kernel": householder_qr, "plain strip": plain_driver,
            "torch.linalg.qr": torch.linalg.qr}
    for fn in runs.values():  # first-use costs out of the timing
        fn(A)
    torch.cuda.synchronize()

    factor_strip_cuda.launches = 0
    Q, R = householder_qr(A)
    torch.cuda.synchronize()
    launches = factor_strip_cuda.launches
    if launches != N // QR_INNER:
        raise RuntimeError(f"householder_qr launched the strip kernel "
                           f"{launches} times; expected {N // QR_INNER}")
    rel, orth = quality(Q, R)
    phase("qr", f"householder_qr {N}x{N} f32: {launches} strip launches, "
          f"rel_resid {rel:.3e} (gate {QR_RESID_MAX}), ||Q^T Q - I||_F "
          f"{orth:.3e}")
    if not rel <= QR_RESID_MAX:
        raise RuntimeError(f"householder_qr rel_resid {rel:.3e} > "
                           f"{QR_RESID_MAX}")

    times = {name: [] for name in runs}
    for _ in range(3):  # interleaved, so drift hits every candidate
        for name, fn in runs.items():
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn(A)
            b.record()
            torch.cuda.synchronize()
            times[name].append(a.elapsed_time(b))
    for name, fn in runs.items():
        t = float(np.median(times[name]))
        r_, o_ = quality(*fn(A))
        phase("qr", f"{name}: median {t:.3f} ms of {times[name]}, "
              f"{2.0 * N ** 3 / (t * 1e-3) / 1e9:.1f} GFLOP/s, rel_resid "
              f"{r_:.3e}, ||Q^T Q - I||_F {o_:.3e}")

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        Q, R = householder_qr(A)
        still_on = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    rel_tf32, orth_tf32 = quality(Q, R)
    phase("qr", f"householder_qr with the caller's TF32 on: rel_resid "
          f"{rel_tf32:.3e}, ||Q^T Q - I||_F {orth_tf32:.3e}; the caller's "
          f"setting afterwards: allow_tf32={still_on}")
    if not rel_tf32 <= QR_RESID_MAX or not still_on:
        raise RuntimeError("householder_qr under the caller's TF32 missed "
                           "the gate or did not restore the setting")
    return dict(launches=launches, **record)


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
    built = build_all(kbuild)
    report_build("build", built["paged_attention"])

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

    # -- 6. qr -----------------------------------------------------------
    report_build("qr", built["qr_panel"])
    qr_record = qr_phase()

    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "linalg_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "linalg_tpu/serve/paged.py:433",
        "launches": launches, **record}, {
        "name": "qr_panel", "route": "cuda",
        "source": "linalg_tpu_torch/kernels/csrc/qr_panel.cu",
        "replaces": "linalg_tpu/ops/pallas/qr_panel.py:143",
        **qr_record}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
