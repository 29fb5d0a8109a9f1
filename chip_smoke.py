#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card: paged serving (with
shared prefixes, chunked prefill, the page cache, speculative decoding,
int8 weights, int8 KV pages and LoRA adapters), the Householder QR,
char-GPT training, long-context training (with ring-mode sampling and
serving and a LoRA finetune), short-context training through the gated
kernels, sequence-parallel training through the ring kernels, sampling,
the routed mixture-of-experts GPT (trained through K8 and K2, sampled,
served), the L2 encoder-decoder stack, the sharded trainers (dp x tp,
FSDP, the 1F1B pipeline, expert parallelism; every rank on the card,
K2 and K8/K9 inside each), the small apps, tensor-parallel serving with
DCP checkpoints, the ring kernels over one tensor per rank, one mesh
over two processes on the card, the ring kernels across two processes
through CUDA IPC, and K13, the grouped GEMM, with the Mellum cell's
training step.

    python3 chip_smoke.py

Phases, each reported on its own line; any failure exits non-zero:

1. device  — require CUDA; print the card and its power limit.
2. build   — build the CUDA paged-attention kernels from
             ``linalg_tpu_torch/kernels/csrc`` and time the build; the
             registers, shared memory and spills of every instantiation
             (any stack frame or spill fails).
3. kernel  — the paged kernels (split-K partials, then the combine)
             against their plain PyTorch version at the serving shape (B
             8, H 4, kv heads 2, d 128, page 256, 16 pages per slot;
             ragged positions and an idle slot on the trash page) in
             float32 and bfloat16, d 64 with 8 query heads per KV head and
             a per-head mask, d 256, and one slot at the last position of
             its context, and the serving shape with the same 4 page ids
             at the head of every slot's table (a registered prefix's
             shared pages; ``PAGED_CASES``, each in both dtypes; bfloat16
             held to 2% of max|want|); the split count S, max error,
             median CUDA-event times of both called from Python and
             replayed from a CUDA graph over input copies larger than the
             L2 (the device time without the host's launch overhead), and
             the bound (a pool row that several slots see counts once).
4. engine  — ServeEngine(paged, page 256, 8 slots, chunk 32, prefill
             window 2048) over GPTConfig(d512, 4 heads, 2 KV heads, 8
             layers, ctx 4096, bf16), random weights from seed 0, 16
             requests (prompts 512-2048 ids, budgets 64-256 from
             ``np.random.default_rng(0)``), with paged_attn="kernel" and
             "gather". Every request must finish with its full budget, and
             the kernel run must launch the kernel once per layer per step;
             a ``torch.profiler`` breakdown of one more kernel-mode run
             over 4 of the requests (the very last step: device time,
             idle share, top kernels).
5. equality — the same engine in float32 (TF32 off), greedy, on 4 of the
             requests: the kernel engine's tokens must equal the gather
             engine's.
19. quant  — (runs after phase 17, on phase 4's model) int8 weights:
             16 requests through ``quant="int8"`` with the paged kernels
             (K5/K6 once a layer and decode step) and with the gather,
             and through kv8 pools (gather): wall, useful tok/s beside
             phase 4's engine, weight and pool bytes against bf16; in f32,
             greedy, on 4 requests, int8 kernel == int8 gather ==
             single-stream ``gpt_decode_chunk_q`` and kv8 == the dense
             int8-KV twin (a first difference only where the reference's
             top-2 gap is under 2^-7 of max|logit|: one bf16 operand or
             int8 KV step); ``sample`` with int8 and int8kv at phase 16's
             config.
20. lora   — (after phase 19, on phase 4's model) 3 adapters (ranks 8,
             8, 4 in rank-8 stacks) and 16 requests over lora_id 0-3 in
             one engine, with the paged kernels (once a layer and step)
             and with the gather; quant x LoRA (kernel) and speculative
             K 4 x LoRA (slot) once each; in f32, greedy, each adapter's
             request equals an engine serving its merged weights.
17. prefix — (runs after phase 5, on its model) the serving features in
             bf16, 16 requests each, every request finishing with its
             full budget and every kernel-mode run launching the paged
             kernels once per layer and step: (a) a registered
             1,024-token prefix (its 4 pages at the head of every slot's
             table) with suffixes of 64-512 tokens, kernel and gather;
             (b) the same full prompts under ``auto_prefix``; (c) chunked
             prefill, window 512, prompts of 1,024-3,072 tokens; (d) the
             page cache over two waves of 8 prompts sharing a 1,536-token
             head (the second wave must hit); (e) speculative decoding, K
             4, in slot mode and paged with the gather (tokens a slot and
             round). Each run's wall time, useful tok/s, prefills, chunks
             and launches beside phase 4's engine on the same full
             prompts. Then in float32, greedy, TF32 off, 4 requests each:
             the prefix engine equals the full-prompt engine, the kernel
             engine with shared pages the gather engine, warm page-cache
             admissions cold ones, chunked prefill one-shot prefill, and
             the speculative engines the plain ones; at a first
             difference the plain stream's top-2 logit gap there must be
             under 1e-5 of its largest |logit| (a tie f32 cannot order),
             and such flips are counted.
6. qr      — the Householder panel kernels (``csrc/qr_panel.cu``): build
             time and ptxas lines, the registers, shared memory and spills
             of the cluster kernel's three instantiations and the grid
             kernel's two (any stack frame or spill fails); each kernel
             against its plain PyTorch version at ``QR_CASES``: (b, m, k)
             = (32, 4096, 0), (32, 4096, 2048), (32, 4096, 3968), (64,
             4096, 0) and a strip with a zero column (exact skip) on the
             cluster kernel; the panel widths (128, 4096, 0) and (256,
             4096, 0), the tall strips (32, 16384, 0) and (32, 16384,
             4064), (64, 8192, 0) and a tall strip with a zero column on
             the grid kernel. Each case names
             the kernel the shape rule gives it (C, or G and lanes a CTA;
             the launch counters must agree), max error, tolerance, 200
             more launches bitwise equal to the first, median CUDA-event
             times called from Python and replayed from a CUDA graph over
             copies larger than the L2, the plain version's, the bound, and
             ``torch.geqrf`` of the same strip as a yardstick; then
             ``householder_qr`` on a 4096^2 float32 matrix from
             ``np.random.default_rng(0)``: 128 strip launches (n / 32), all
             through the cluster kernel, rel_resid ||A-QR||_F/||A||_F in
             float64 <= 1e-6, ||Q^T Q - I||_F, median times of three runs
             through the kernel, through the same blocked QR with the
             plain strip, and of ``torch.linalg.qr`` (GFLOP/s as 2 N^3 /
             t); once more with the caller's TF32 switched on, still <=
             1e-6; then the same (but the plain strip) at 16384 x 4096,
             all 128 strips through the grid kernel; and a
             ``torch.profiler`` breakdown of one QR of each shape (run
             last, with the other profiles: device time, idle share, the
             panel kernels' share, top kernels and ops).
7. flash   — the flash-attention kernels (``csrc/flash_attention.cu``;
             bf16 on wgmma fed by a TMA ring): build time and ptxas lines,
             the registers, shared memory and spills of every
             instantiation (any stack frame or spill fails); forward (O,
             L) and backward (dq, dk, dv from a random dO) against their
             plain PyTorch versions at (B 24, H 8, T 1024, d 128) in bf16
             and f32, (2, 8, 2048,
             128) bf16 through ``flash_attention_long``, (4, 8, 1024, 64)
             f32, the widest heads (2, 4, 1024, 256) in bf16 and f32, and a
             ragged T 1000 through the picker's padding; median
             CUDA-event times of kernel and plain version, forward and
             forward+backward (the T 2048 shape also straight through the
             kernels), each as a factor of SDPA's and a share of its bound.
8. train   — ``train.trainer.train`` at the train_big configuration
             (``bench.py::bench_train_big``: d1024, 8 heads, 8 layers, ctx
             1024, bf16, batch 24, AdamW lr 3e-4, warmup 200, wd 0.01) on
             the synthetic corpus, 40 steps, eval every 20: launch counts
             per layer, finite losses, steady-state ms/step, tok/s, TFLOP/s
             and mfu (of the H100's 989 TFLOP/s dense bf16), peak memory,
             the checkpoint reloaded equal; one step's loss and gradients
             through the kernels against the plain versions (bf16, and f32
             with TF32 off); a few steps at the published config (d512,
             4 layers, ctx 256, batch 64, f32), which runs no kernel; a
             ``torch.profiler`` breakdown of one train_big step (run last,
             after phase 10: the profiler stays attached to the card).
9. stream  — the flash kernels with K4's band and grouped K/V
             (``flash_attention_stream``): forward (O, L) and backward
             (dq, dk, dv from a random dO) against their plain versions at
             (B 8, H 4, hk 2, T 4096, d 128) bf16 window 512 (the
             long_window shape), the same in f32 at B 2, (1, 4, hk 4, 8192,
             128) bf16 with no window, and MQA (hk 1) with window 300 and
             causal=False at T 1024; median CUDA-event times of the kernels,
             the plain versions and ``F.scaled_dot_product_attention(...,
             enable_gqa=True)`` (is_causal, or a boolean band mask), forward
             and forward+backward, launch counts and the bound; the
             kernels' factor of SDPA's time and share of the bound.
10. long   — ``train.trainer.train`` at long_window (GPTConfig(vocab 65,
             d512, 4 heads, 2 KV heads, 8 layers, ctx 4096, bf16, rope,
             swiglu, window 512), batch 8, AdamW lr 3e-4, warmup 200, wd
             0.01), 40 steps, eval every 20: launch counts, grouped K/V
             (hk 2) at the kernels, finite losses, ms/step, tok/s, TFLOP/s
             and mfu by the count in ``long_step_flops``, peak memory, the
             checkpoint (window included) reloaded equal; one step through
             the kernels against the plain versions (bf16, and f32 with
             TF32 off); one step at ctx 8192 (d512, 4 heads, 2 layers,
             batch 1, bf16) through ``_pick_attn``'s stream; a
             ``torch.profiler`` breakdown of one long_window step.
18. window — (runs after phase 10, on its trained weights) ``sample``
             through the ring: 2,048 tokens after a 3,584-token prompt,
             past ctx 4096 with one prefill; a ring-mode ``ServeEngine`` (8
             slots, chunk 32) serving 16 requests, 4 of 3,584 + 1,024
             tokens, every budget met, slot KV bytes against ctx-4096
             slots; a LoRA finetune (rank 8, attn, 20 steps, B 8) through
             ``train``, K4's forward and backward launches counted, then
             the merged model through the ring; in f32, greedy, the ring
             engine == single-stream ``gpt_stream_chunk`` on 4 requests
             and the stream past ctx_len == a windowed full forward.
11. btd    — K7 (``nn.flash_btd.attention_btd``: the flash kernels on head
             views of (B, T, H*d) tensors): forward (O, L) and backward
             (dq, dk, dv from a random dO) against the plain versions at
             (B 128, T 256, H 4, d 128) in f32 and bf16 and (2, 64, 2,
             128) f32; median CUDA-event times of the kernels, the plain
             versions and ``F.scaled_dot_product_attention`` on the head
             views, and the bound; the kernels' factor of SDPA's time and
             share of the bound.
12. fused  — K8 ``ln_qkv`` and K9 ``ln_ffn`` (``csrc/fused_layer.cu``):
             build lines; the registers, shared memory and spills of every
             instantiation (any stack frame or spill fails); forward and
             every gradient against the plain versions at N 16384 (B 64 x
             T 256), D 512, F 2048 and at train_big's width N 24576 (B 24
             x T 1024), D 1024, F 4096, in f32 and bf16; median times of
             the kernels, the plain versions and the unfused PyTorch
             composition (``F.layer_norm`` and matmuls, the path the
             picker takes otherwise; no single library call computes
             either function), the bound and each kernel's share of it.
13. short  — ``train.trainer.train`` at the published config (d512, 4
             heads, 4 layers, ctx 256, vocab 65) in bf16 and f32, 40 steps
             each (eval every 20): (a) batch 128 with default switches
             (K7 by its size gate), (b) batch 64 with
             LINALG_TPU_FUSED_LN=1 (K8/K9), (c)
             both batches with the kernels off (LINALG_TPU_BTD_ATTN=0; the
             fused switch unset): launch counts per layer, finite losses,
             ms/step, tok/s, peak memory, the A/B of (a) and (b) against
             (c); one step through the kernels against the plain versions
             for (a) and (b); ``torch.profiler`` breakdowns of one bf16
             step of (a) and of (b), last.
14. ring   — the ring kernels K10 (forward) and K11 (backward) of
             ``csrc/ring_attention.cu``, the ring's 4 ranks sharing the card
             (``parallel.ring_pallas``: one call per direction, each block
             looping over the ring's steps and reading the K/V chunks in
             place): build lines, registers and spills of every kernel (any
             spill fails); o, L, dq, dk, dv against the plain versions (the
             TPU's protocol step by step: K/V slots rotated, the backward's
             f32 bundle lapping the ring) at long_window's shape (B 8, h 4,
             T 4096, d 128, window 512) in bf16 and f32, train_big's (24, 8,
             1024, 128, causal) bf16, ALiBi, no causal ban, n 2 and 8, and a
             ragged T 1000 (Tl 250); one launch per ring call and direction;
             median times of K10 and K11 at the first three beside the plain
             versions, ``F.scaled_dot_product_attention`` over the gathered
             sequence (forward, and its backward alone) and the attention's
             bound; last, a profiler trace of one forward and backward of
             the ring through autograd at long_window's shape must show the
             three kernel launches and no device copy.
15. sp     — ``train.trainer.train`` with ``--sp 4`` (the mesh's 4 ranks on
             the card, attention through K10/K11): long_window 40 steps and
             train_big's widths at 2 layers 20 steps: launch counts (K10
             one per layer per forward, K11 one per layer per backward; the
             plain ring never runs), finite losses, ms/step, tok/s, peak
             memory,
             the checkpoint reloaded equal, the step-1 loss against the
             single-card run from the same seed (same batch); one step
             through the kernels against the plain ring (``--ring xla``)
             at 2 layers in f32 and bf16; a profiled long_window sp step
             last.
16. sample — the sampling path at the published config
             (``bench.py::bench_sampler``: vocab 65, d512, 4 heads, 4
             layers, ctx 256, ``init_gpt_params(seed=0)``), f32 then bf16:
             ``train.trainer.sample`` of 2048 tokens from [1, 2, 3] with
             context rollover and ``gpt_generate`` of 8 ragged prompts
             (3-120 ids from ``np.random.default_rng(1)``) x 128 new
             tokens, each with its tok/s; in f32 and greedy, the first 300
             sampled tokens equal an independent ``gpt_decode_step`` loop
             that re-prefills by the same rule, each ``gpt_generate`` row
             equals its prompt alone, beam 1 equals greedy decoding and
             beam 4's best score (64 new tokens) equals its log-probability
             re-scored by one ``gpt_apply`` (1e-4 of it); the host C
             library builds, BPE trained through it on the corpus
             round-trips the text and its merges on the first 20,000
             characters equal the Python loop's; the CLI trains a BPE model
             (``--tokenizer bpe --vocab_size 512``, 20 steps) and its
             ``--repl --top_k 1`` prints text for two prompts; ``gpt_loss``
             and its backward at vocab 50,257, batch 64, f32 through the
             chunked CE against the full logits (|dloss| <= 1e-5 |loss|,
             ||dg||/||g|| <= 1e-4 per leaf), with each path's time and
             peak memory; ``gpt_generate_speculative`` (K 4, greedy) of
             128 tokens from [1, 2, 3] in f32 and bf16 with its rounds and
             tok/s, in f32 equal to ``sample``'s greedy first chunk (or a
             tie, as in phase 17). No kernel of its own: the JAX package's
             sampling path is XLA-level code.

21. moe    — (after phase 16) the routed MoE GPT at bench_moe's config
             (``bench.py:300-315``: d512, 4 heads, 4 layers, ctx 256,
             vocab 65, 8 experts, top-1, einsum dispatch, batch 64)
             through ``train --experts 8``: f32 and bf16, 40 steps each
             with LINALG_TPU_FUSED_LN=1 (K8 ``ln_qkv`` under the attention
             half; the routed FFN takes no K9), bf16 again with the gate
             off (A/B), 20 bf16 steps of top-2 and of ``--dispatch
             gather``: launch counts, finite and falling losses, ms/step
             over steps 21-40, tok/s, the checkpoint reloaded equal; 10
             bf16 steps at ctx 1024, batch 8, rope, through K2 (launches
             counted); ``sample`` of 512 tokens (f32) and ``gpt_generate``
             8 x 64 with tok/s; the slot ``ServeEngine`` (8 slots, chunk
             16) over 16 requests (prompts 32-192 ids, budgets 16-48 from
             ``np.random.default_rng(0)``) in bf16 and f32, every budget
             met; in f32, greedy, each request's tokens equal to its
             window-padded ``moe_prefill`` + ``moe_decode_chunk`` stream
             (or a tie, as in phase 17); ``--serve`` and ``--repl`` of the
             checkpoint with --paged --speculative 4 --quant int8 --beam 2
             --prefix_file print the JAX CLI's fallbacks and finish.
22. l2     — ``apps.reverse_demo.train_reverse_demo`` (the seq2seq
             reversal task) on the card in f32, 20 epochs: step 1's loss
             within 1e-5 (relative) of the same run on the CPU, the losses
             and the greedy token and sequence accuracy; a ``Transformer``
             (2 + 2 layers, d 64) forward and backward on the card
             against the CPU to 1e-5 of max|.|, parameter gradients
             included.
23. parallel — the sharded trainers through ``train`` with every rank
             on the card (``PAR_RUNS``): train_big's widths (d 1024, 8
             heads, 8 layers, ctx 1024, bf16, B 24) under --dp 2 --tp 4
             (8 ranks), --tp 4 with LINALG_TPU_FUSED_LN=1 (K8 and K9 per
             rank, 5 steps), --fsdp 4 and --pp 4 (1F1B, 8 microbatches),
             and the MoE's T 1024 run (d 512, 8 experts, top-1, rope, B
             8) under --experts 8 --tp 4 --dp 2 with the gate on (K8, K2);
             10 steps each, steps 3-10 timed, each beside a single-card run
             of its config and seed: K2 and K8/K9 launches as worked out
             from ranks, layers, steps and evals (``par_want``), the
             collectives counted by kind, the step-1 loss within 1e-2 of
             the single card's, finite losses, ms/step against the single
             card's; the dp x tp checkpoint (gathered) reloaded equal on
             one card; each FSDP rank's parameter and moment bytes 1/4 of
             the single card's but for the replicated small leaves;
             1F1B's peak memory beside GPipe's at M 8; --dp 2 --tp 4 in
             f32 with TF32 off at 2 layers, step 1 within 1e-5
             (relative).
24. apps   — ``apps.logic_gates`` trains XOR and OR on the card (its
             asserts pass), ``Vector``'s self-test, ``load_glove`` of a
             1,000 x 50 file written here, and ``top_k_neighbors`` over a
             seeded 400,000 x 300 float32 matrix (GloVe 6B 300d's size):
             its top-10 equal to numpy's float64 top-10, the GEMV's time
             beside its bound at 3.35 TB/s.
25. mesh   — tensor-parallel serving: phase 4's model (d512, 4 heads, 2
             KV heads, 8 layers, ctx 4096) on the slot cache, 8 slots,
             chunk 32, phase 4's 16 requests, unsharded and under tp 2
             and tp 4 (two ranks share each KV head), every rank on the
             card: bf16 wall and useful tok/s, all-reduces counted by
             ``parallel.mesh.collectives`` (two a layer and token, two a
             layer and prefill); f32 greedy tokens of 4 requests equal to
             the unsharded slot engine's (a first difference only on a
             top-2 tie under 1e-5 of max|logit|); ``apps/gpt.py --serve
             --tp 2`` from a checkpoint; a DCP round trip
             (``save_ckpt_orbax``/``load_ckpt_orbax``) of train_big's
             parameters, bit-equal on the card, with bytes and seconds;
             ``init_distributed()`` False and ``global_mesh_shape`` for
             the card count.
26. ring tables — the K10/K11 wrappers on each rank's rows as a
             tensor of its own (heads Tl rows apart in the per-rank
             pointer tables) against the same calls on views of the
             rank-stacked tensors (heads T rows apart, every one-card
             ring's layout) at phase 14's sp shapes (long_window bf16 and
             f32, train_big): bit-equal outputs and gradients, one launch
             per direction each way, CUDA-event times of both; with two
             cards or more, the ring over two cards against one card
             (else a line says it was not run).
27. processes — two interpreters (``chip_smoke.py --process-child``) on
             the one card join one Gloo group (named, through a
             ``file://`` rendezvous) and train one model over a mesh that
             spans them: train_big under --dp 2 --tp 4 (4 ranks a
             process, 5 steps, one eval, the gathered checkpoint written
             by process 0 and reloaded equal), its step-1 loss within 1e-2
             of phase 23's one-process dp 2 x tp 4, ms/step, the bytes
             staged through the host a step and K2's launches (both
             processes' sum, as worked out); then the published widths in
             f32 with LINALG_TPU_FUSED_LN=1 under --dp 2 --tp 2 (3 steps),
             every step's loss and the val loss within 1e-5 (relative) of
             the same run in one process, K8/K9 launches as worked out.
             NCCL (the default backend on cards) cannot join two
             processes on one card; this phase does not run it.
28. ipc ring — two interpreters (``chip_smoke.py --ipc-child``) on the
             one card join one Gloo group; the ring kernels across them,
             two ranks in each, every process reading the other's chunks
             through CUDA IPC (``kernels.ring_attention.RingArena``): (a)
             K10/K11 at phase 14's sp shapes (``RING_TABLE_CASES``), each
             process's o, L, dq, dk, dv bit-equal to the one-process call
             on the same per-rank tensors, one launch a process and
             direction, CUDA-event ms beside phase 26's one-process call
             and the host µs a call spends in the handshake; (b)
             ``--train`` at train_big's widths with 2 layers and --sp 4 (5
             steps, one eval): K10/K11 launches a process as worked out,
             no plain ring call, both processes' losses equal, the step-1
             loss within 1e-2 of phase 15's one-process run, ms/step
             beside it. Nothing falls back to the plain ring.
29. grouped — K13 (``kernels.grouped_gemm``, the dropless routed FFN's
             grouped GEMM): registers and spills (any stack frame or spill
             fails); the six calls of a routed layer's training step at
             ``mellum2-ep8-train``'s shapes (8 held experts, d 2304, width
             896, 65,537-row buffers: the forward [U|G] with the token
             gather and Y, dH and dx with W^T, dW2 and dW1g with the
             gather) against the plain version at a bf16-tight tolerance,
             on even, skewed (empty groups and one of 2 rows), full (a
             tail of one row) and empty routings; the tail's rows and
             empty groups' gradients exactly zero; CUDA-event ms beside
             the bound and cuBLAS ``bmm`` over equal groups; then the
             cell's own step (28 layers, B 1 x T 8192, through
             ``make_device_train_step``): K13's launches counted from 0 over
             two steps (4 rows + 2 dw a layer and step), finite losses,
             ms/step, peak bytes, the steps under CUDA's sync debug mode
             at "error" (any host round trip inside them fails).

Phase 2 builds every kernel, one ``nvcc`` per source, all started
together. The line before the last is a JSON object describing the
kernels (with each one's bound: the larger of its bytes over 3.35 TB/s
and its operations over the peak of their type, from the H100's data
sheet); the last line is ``{"ok": true, "device": {...}}``. Imports
nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import pathlib
import subprocess
import sys
import tempfile
import time
import types
import warnings
from unittest import mock

import numpy as np
import torch

SERVE_CFG = dict(vocab_size=65, d_model=512, n_heads=4, n_kv_heads=2,
                 n_layers=8, ctx_len=4096)
ENGINE_KW = dict(paged=True, page=256, n_slots=8, chunk=32,
                 prefill_window=2048)
KERNELS = ("paged_attention", "qr_panel", "flash_attention", "fused_layer",
           "ring_attention", "grouped_gemm")
QR_N = 4096          # the headline QR: 4096^2 float32
QR_INNER = 32        # strip width householder_qr_panel passes the kernel
QR_RESID_MAX = 1e-6  # ||A - QR||_F / ||A||_F, the headline accuracy gate
# kernel vs plain sweep: float32 sums over m lanes in another order; a
# float64 sweep at m 4096 differs from the float32 one by 2e-5 on St
# (magnitude 65), 1.4e-7 on Vt and 1e-7 on Tt
QR_RTOL_OF_MAX = 1e-5
QR_TALL = (16384, 4096)  # the tall QR: every strip on the grid kernel
# phase 6 (and tools/bench_qr.py): name, (b, m, k), zero column, the
# kernel the shape rule gives it; case i's St comes from seed 100 + i
QR_CASES = (
    ("strip", (32, 4096, 0), None, "cluster"),
    ("strip k 2048", (32, 4096, 2048), None, "cluster"),
    ("strip k 3968", (32, 4096, 3968), None, "cluster"),
    ("strip b 64", (64, 4096, 0), None, "cluster"),
    ("panel b 128", (128, 4096, 0), None, "grid"),
    ("zero column", (32, 4096, 0), 5, "cluster"),
    ("tall strip", (32, 16384, 0), None, "grid"),
    ("tall strip k 4064", (32, 16384, 4064), None, "grid"),
    ("strip b 64 m 8192", (64, 8192, 0), None, "grid"),
    ("panel b 256", (256, 4096, 0), None, "grid"),
    ("tall zero column", (32, 16384, 0), 5, "grid"),
)
# phase 6's repeat check: launches of each cluster strip into outputs of
# their own, every one bitwise equal to the first
QR_REPEATS = 200
# flash kernels vs their plain versions, as a share of max|want|: float32
# sums over T and d in another order; bf16 outputs and the rounded P and dS
# keep 8 bits of mantissa, and the kernel's online softmax rounds
# exp(s - m_running) where the plain version rounds the normalized p
FLASH_RTOL_OF_MAX = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# train_big (bench.py::bench_train_big) and the published config
TRAIN_BIG = ["--d_model", "1024", "--heads", "8", "--layers", "8",
             "--ctx_len", "1024", "--dtype", "bfloat16", "--batch_size",
             "24", "--steps", "40", "--eval_every", "20"]
PUBLISHED = ["--d_model", "512", "--heads", "4", "--layers", "4",
             "--ctx_len", "256", "--dtype", "float32", "--batch_size", "64",
             "--steps", "5", "--eval_every", "5"]
# phase 13: the published widths; dtype, batch and switches per run
SHORT = ["--d_model", "512", "--heads", "4", "--layers", "4", "--ctx_len",
         "256", "--steps", "40", "--eval_every", "20"]
SWITCHES = ("LINALG_TPU_BTD_ATTN", "LINALG_TPU_FUSED_LN")
# K8/K9 vs their plain versions, as a share of max|want|: float32 sums in
# another order; bf16 outputs keep 8 bits of mantissa, and an element on a
# rounding boundary of x^, relu(z) or dz may round the other way
FUSED_RTOL_OF_MAX = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# ln_ffn's gradients behind the ReLU mask, by ||got - want|| / ||want||
FUSED_RTOL_OF_NORM = {torch.float32: 1e-3, torch.bfloat16: 2e-2}
# long_window: the JAX package's ctx-4096 serving widths with K4's band
LONG_WINDOW = ["--d_model", "512", "--heads", "4", "--kv_heads", "2",
               "--layers", "8", "--ctx_len", "4096", "--pos", "rope",
               "--ffn", "swiglu", "--window", "512", "--dtype", "bfloat16",
               "--batch_size", "8", "--steps", "40", "--eval_every", "20"]
EVAL_BATCHES = 20   # trainer._eval_device batches per eval
SP_EVAL_BATCHES = 10  # the sp trainer's eval batches (JAX's make_sp_eval)
SP = 4  # phase 15's ring: 4 ranks sharing the card
# phase 16: the sampler's published config (bench.py::bench_sampler)
SAMPLE_CFG = dict(vocab_size=65, d_model=512, n_heads=4, n_layers=4,
                  ctx_len=256)
SAMPLE_TOKENS = 2048  # sampled from [1, 2, 3], as bench.py:341-345
GEN_NEW, GEN_REPS = 128, 8  # gpt_generate of 8 ragged prompts, bench.py:352
SPEC_NEW = 128  # gpt_generate_speculative: sample's first chunk, no rollover
BEAM, BEAM_NEW = 4, 64
SAMPLE_TRAIN = ["--d_model", "512", "--heads", "4", "--layers", "4",
                "--ctx_len", "256", "--steps", "20", "--eval_every", "20"]
WIDE_V, WIDE_B = 50257, 64  # GPT-2's vocabulary, not a multiple of 4096
# phase 3 (and tools/bench_paged.py): name, (B, H, hk, d, page, Pmax),
# dtype, mask per head, layout (``kernel_case``); case i's inputs come from
# seed i
PAGED_CASES = (
    ("serve f32", (8, 4, 2, 128, 256, 16), torch.float32, False, "ragged"),
    ("serve bf16", (8, 4, 2, 128, 256, 16), torch.bfloat16, False,
     "ragged"),
    ("d64 f32", (8, 8, 1, 64, 256, 16), torch.float32, True, "ragged"),
    ("d64 bf16", (8, 8, 1, 64, 256, 16), torch.bfloat16, True, "ragged"),
    ("d256 bf16", (8, 4, 2, 256, 256, 16), torch.bfloat16, False, "ragged"),
    ("B1 full ctx bf16", (1, 4, 2, 128, 256, 16), torch.bfloat16, False,
     "full"),
    ("d256 f32", (8, 4, 2, 256, 256, 16), torch.float32, False, "ragged"),
    ("B1 full ctx f32", (1, 4, 2, 128, 256, 16), torch.float32, False,
     "full"),
    ("shared prefix f32", (8, 4, 2, 128, 256, 16), torch.float32, False,
     "shared"),
    ("shared prefix bf16", (8, 4, 2, 128, 256, 16), torch.bfloat16, False,
     "shared"),
)
# the pages a registered 1,024-token prefix fills at page 256: "shared"
# cases put them at the head of every slot's table, as the prefix phase's
# engine does
SHARED_PAGES = 4
# paged kernels vs their plain version: float32 sums in another order; a
# bf16 output keeps 8 bits of mantissa (an ulp of max|want| is ~0.4% of
# it) and p is rounded before p*v, so bf16 is held to 2% of max|want|,
# never more than 2e-2
PAGED_F32_TOL = (2e-5, 2e-6)  # rtol, atol
PAGED_BF16_ATOL_OF_MAX = 2e-2
H100_BF16_TFLOPS = 989.0  # dense bf16, NVIDIA's H100 SXM data sheet
# the H100 SXM's data sheet: HBM rate, dense peaks by operand type (f32
# runs on the FMA units: the kernels never use TF32)
H100_BYTES_PER_S = 3.35e12
H100_PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def bound_ms(flops, nbytes, dtype):
    """(least time in ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over the peak of their type."""
    t_ops = flops / H100_PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def live_pool_rows(table, pos, page):
    """Distinct (pool page, row) pairs the slots' positions make live: slot
    b sees logical rows 0..min(pos_b, ctx - 1) through its table, and a
    pool row that several slots see (a shared prefix page, the idle slots'
    trash page) counts once."""
    table, pos = table.cpu().numpy(), pos.cpu().numpy()
    seen = np.zeros((int(table.max()) + 1, page), bool)
    ctx = page * table.shape[1]
    for row, p in zip(table, np.minimum(np.maximum(pos, 0), ctx - 1)):
        n_full = p // page
        seen[row[:n_full]] = True
        seen[row[n_full], :p % page + 1] = True
    return int(seen.sum())


def paged_bound(q, pk, pv, mask, table, pos):
    """Bound of one paged decode-attention call: each live K/V pool row
    read once (``live_pool_rows``: a page that several slots share is read
    once), q, the mask, the table and the positions once, and the output
    written; 4 d operations per head and live key of each slot (an idle
    slot's clamped position sees ctx keys)."""
    B, H, _, d = q.shape
    hk, page = pk.shape[1], pk.shape[2]
    ctx = page * table.shape[1]
    live = int(torch.clamp(pos.long() + 1, max=ctx).sum())
    rows = live_pool_rows(table, pos, page)
    nbytes = (q.element_size() * (2 * q.numel() + 2 * hk * d * rows
                                  + mask.numel())
              + 4 * (table.numel() + pos.numel()))
    return bound_ms(4 * H * d * live, nbytes, q.dtype)


def strip_bound(b, m):
    """Bound of one Householder strip sweep of a (b, m) float32 strip:
    reads St once, writes St, Vt and the (b, b) Tt once; ~3 m b^2
    operations (2 m b^2 applying the reflectors, m b^2 forming Tt)."""
    return bound_ms(3 * m * b * b, 4 * (3 * b * m + b * b), torch.float32)


def attn_live_pairs(T, causal, window):
    """Visible (query, key) pairs of one head: row i sees keys
    (i - window, i] when causal, (i - window, T) when not."""
    i = np.arange(T)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(T, int)
    hi = i + 1 if causal else np.full(T, T)
    return int((hi - lo).sum())


def attn_bound(B, H, hk, T, d, dtype, causal=True, window=None):
    """Bound of attention forward+backward: 2 d operations per visible
    pair for each of Q K^T and P V forward and dV, dP, dQ, dK backward (no
    recomputation); q, k, v, dO read once, o, dq, dk, dv written once."""
    flops = 12 * d * B * H * attn_live_pairs(T, causal, window)
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * 4 * T * d * (B * H + B * hk)
    return bound_ms(flops, nbytes, dtype)


_CLOCK = {"last": time.perf_counter(), "tags": {}}


def phase(name, msg):
    """Print a phase's line; the host seconds since the previous line are
    charged to the phase (``phase_seconds``)."""
    now = time.perf_counter()
    tags = _CLOCK["tags"]
    tags[name] = tags.get(name, 0.0) + now - _CLOCK["last"]
    _CLOCK["last"] = now
    print(f"[{name}] {msg}", flush=True)


def phase_seconds():
    """One line: each phase's host seconds, in the order they first
    printed, and their sum."""
    tags = _CLOCK["tags"]
    return ", ".join(f"{k} {v:.1f}" for k, v in tags.items()) + (
        f"; total {sum(tags.values()):.1f} s")


def kernel_case(B, H, hk, d, page, Pmax, dtype, seed, per_head_mask=False,
                layout="ragged"):
    """Random inputs on the card in the engine's layout. ``layout``
    "ragged": distinct pages per slot, ragged positions, the last slot
    idle (all-trash table row, a position past ctx); "full": every slot at
    the last position of its context; "shared": every slot's table starts
    with the same ``SHARED_PAGES`` page ids (a registered prefix), then
    private pages, ragged positions past the shared run."""
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
    pos = rng.integers(0, ctx, size=B)
    if layout == "full":
        pos[:] = ctx - 1
    elif layout == "shared":
        table[:, :SHARED_PAGES] = table[0, :SHARED_PAGES]
        pos = rng.integers(SHARED_PAGES * page, ctx, size=B)
    else:
        table[-1] = 0
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


def graph_ms(fn, arg_sets, rounds=5, trials=10):
    """Device time of one call of ``fn``: the median over ``trials`` of the
    CUDA-event time of one replay of a CUDA graph that calls ``fn`` once
    per argument set, ``rounds`` times over, divided by the calls. The
    graph takes the host's launch overhead out; argument sets of more
    bytes together than the 50 MB L2 holds keep each call's reads cold.
    Warm-up and capture share one side stream. Afterwards
    ``graph_ms.captured`` holds the calls recorded into the graph (made
    from Python, launched only by its replays) and ``graph_ms.replayed``
    the calls its replays launched."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for a in arg_sets:
            fn(*a)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(rounds):
            for a in arg_sets:
                fn(*a)
    calls = rounds * len(arg_sets)
    graph_ms.captured, graph_ms.replayed = calls, (1 + trials) * calls
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / calls)
    del graph
    return float(np.median(times))


def cold_copies(args, nbytes=200 << 20):
    """``args`` and copies of it in fresh memory, enough that the sets
    hold ``nbytes`` together (four times the L2) and at least two."""
    size = sum(a.numel() * a.element_size() for a in args)
    n = max(2, -(-nbytes // size))
    return [args] + [tuple(a.clone() for a in args) for _ in range(n - 1)]


def paged_builds(lib):
    """Phase 2's build check: registers, shared memory and spills of every
    paged_attention instantiation; any stack frame or spill fails."""
    import ctypes
    import re

    smem = ctypes.CDLL(str(lib)).paged_partials_smem
    smem.argtypes = [ctypes.c_int] * 4
    smem.restype = ctypes.c_longlong
    kernels = ptxas_kernels(lib)
    for name, (regs, *frame) in sorted(kernels.items()):
        m = re.search(r"paged_(partials|combine)I(f|13__nv_bfloat16)"
                      r"((?:Li\d+E)*)E", name)
        if not m:
            continue
        bf16 = m.group(2) != "f"
        args = [int(a) for a in re.findall(r"Li(\d+)E", m.group(3))]
        what = (f"{m.group(1)}_{'bf16' if bf16 else 'f32'}"
                f"{'<%d, %d>' % tuple(args) if args else ''}: {regs} "
                f"registers, ")
        if args:  # <DP, GB>: d DP, one mask row a slot or one a head
            dp, gb = args
            what += (f"dynamic shared memory {smem(int(bf16), dp, 1, gb)} B"
                     f" ({smem(int(bf16), dp, gb, gb)} B with a per-head "
                     f"mask) at d {dp}, ")
        else:
            what += "dynamic shared memory 4 B a split, "
        phase("build", f"{what}stack frame {frame[0]}, spill stores "
              f"{frame[1]}, loads {frame[2]}")
    spills = ptxas_spills(lib)
    if not any("paged_" in k for k in kernels) or spills:
        raise RuntimeError(f"paged kernels spill registers: {spills}"
                           if spills else "no ptxas lines in the build log")


def paged_phase():
    """Phase 3: the paged kernels against their plain version at every
    ``PAGED_CASES`` case; returns the records of the serving bf16 case and
    of its shared-prefix twin."""
    from linalg_tpu_torch.kernels.paged_attention import (
        paged_attention_cuda, paged_splits)
    from linalg_tpu_torch.serve.paged import paged_attention_ref

    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    records = {}
    for i, (name, shp, dt, per_head, layout) in enumerate(PAGED_CASES):
        args = kernel_case(*shp, dt, seed=i, per_head_mask=per_head,
                           layout=layout)
        B_, H_, hk_, _, page_, Pmax_ = shp
        splits = paged_splits(B_, H_, hk_, page_, Pmax_, n_sm)
        got = paged_attention_cuda(*args)
        want = paged_attention_ref(*args)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        rtol, atol = (PAGED_F32_TOL if dt == torch.float32 else (0, min(
            2e-2, PAGED_BF16_ATOL_OF_MAX * float(want.float().abs().max()))))
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        ms = median_ms(paged_attention_cuda, args)
        plain_ms = median_ms(paged_attention_ref, args)
        sets = cold_copies(args)
        dev_ms = graph_ms(paged_attention_cuda, sets)
        plain_dev_ms = graph_ms(paged_attention_ref, sets)
        del sets
        phase("kernel", f"{name} B,H,hk,d,page,Pmax={shp}, S {splits}: "
              f"max_abs_err {err:.3e} (rtol {rtol}, atol {atol:.3e}); "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; from a CUDA "
              f"graph, cold L2: kernel {dev_ms:.4f} ms, plain "
              f"{plain_dev_ms:.4f}")
        bms, by = paged_bound(*args)
        phase("kernel", f"  bound {bms:.4f} ms ({by}), {bms / ms:.1%} of "
              f"it, {bms / dev_ms:.1%} from the graph")
        records[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             device_ms=dev_ms, plain_device_ms=plain_dev_ms,
                             bound_ms=bms, bound_by=by, library_ms=None)
        del args, got, want
        torch.cuda.empty_cache()
    # the engine's shape and dtype, with private and with shared pages
    return records["serve bf16"], records["shared prefix bf16"]


def make_requests(n):
    """Phase 4's requests: (prompt, budget, False): prompts of 512-2048
    ids, budgets 64-256, from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    reqs = []
    for _ in range(16):
        plen = int(rng.integers(512, 2049))
        budget = int(rng.integers(64, 257))
        prompt = rng.integers(0, SERVE_CFG["vocab_size"], size=plen).tolist()
        reqs.append((prompt, budget, False))
    return reqs[:n]


# the prefix phase (phase 17): a registered 1,024-token prefix (4 pages),
# the page cache's 1,536-token shared head (6 pages), chunked prefill's
# window, speculative decoding's K
PREFIX_LEN, PC_HEAD, CHUNKED_WINDOW, SPEC_K = 1024, 1536, 512, 4
# f32 greedy equality: at a first difference, the plain engine's top-2
# logit gap must be under this share of its largest |logit|, a tie f32
# cannot order (the compared paths sum in other orders: GEMMs of other M)
TIE_OF_MAX = 1e-5


def prefix_requests(n, seed=1):
    """The prefix phase's requests: (prefix, [(suffix, budget)]): a
    1,024-token prefix, suffixes of 64-512 tokens, budgets 64-256, all
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    V = SERVE_CFG["vocab_size"]
    prefix = rng.integers(0, V, PREFIX_LEN).tolist()
    reqs = [(rng.integers(0, V, int(rng.integers(64, 513))).tolist(),
             int(rng.integers(64, 257))) for _ in range(16)]
    return prefix, reqs[:n]


def long_requests(n, seed=2):
    """Chunked prefill's requests: prompts of 1,024-3,072 tokens, budgets
    64-256."""
    rng = np.random.default_rng(seed)
    V = SERVE_CFG["vocab_size"]
    reqs = [(rng.integers(0, V, int(rng.integers(1024, 3073))).tolist(),
             int(rng.integers(64, 257))) for _ in range(16)]
    return reqs[:n]


def head_requests(n, seed=3):
    """Two waves of ``n`` requests (the page cache's): prompts of a shared
    1,536-token head and a tail of 64-512 tokens, budgets 64-256."""
    rng = np.random.default_rng(seed)
    V = SERVE_CFG["vocab_size"]
    head = rng.integers(0, V, PC_HEAD).tolist()
    return [[(head + rng.integers(0, V, int(rng.integers(64, 513))).tolist(),
              int(rng.integers(64, 257))) for _ in range(n)]
            for _ in range(2)]


def serve_waves(ServeEngine, params, cfg, waves, prefix=None, greedy=False,
                per_wave=None, adapters=(), **kw):
    """One engine (``ENGINE_KW`` updated by ``kw``) serving ``waves`` (lists
    of (prompt, budget, uses the prefix[, lora_id])) one after the other,
    ``adapters`` ((adapter dict, LoRAConfig) pairs) and then ``prefix``
    registered first. Every request must finish with its full budget and
    every page not pinned by the prefix or held by the page cache must be
    back in the pool. Returns ([tokens per request], wall seconds, tokens,
    the engine); wall covers the waves, not the registration. ``per_wave``
    (a list) gets each wave's (wall, tokens, stats)."""
    from linalg_tpu_torch.serve import Request

    eng = ServeEngine(params, cfg, device="cuda", **dict(ENGINE_KW, **kw))
    for ad in adapters:
        eng.register_lora(*ad)
    pid = eng.register_prefix(prefix) if prefix is not None else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for wave in waves:
        t1 = time.perf_counter()
        ids = [eng.submit(Request(r[0], r[1], top_k=1 if greedy else None,
                                  prefix_id=pid if r[2] else None,
                                  lora_id=r[3] if len(r) > 3 else 0))
               for r in wave]
        done = {c.request_id: c for c in eng.run()}
        if per_wave is not None:
            torch.cuda.synchronize()
            per_wave.append((time.perf_counter() - t1,
                             sum(len(c.tokens) for c in done.values()),
                             dict(eng.stats)))
        for i, (_, n, *_) in zip(ids, wave):
            c = done[i]
            if c.finish_reason != "length" or len(c.tokens) != n:
                raise RuntimeError(f"request {i} ended {c.finish_reason} "
                                   f"with {len(c.tokens)} of {n} tokens")
            if not all(0 <= t < cfg.vocab_size for t in c.tokens):
                raise RuntimeError("token out of the vocabulary")
            outs.append(c.tokens)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng._allocator is not None:
        held = eng._shared_held + len(eng._pcache)
        if eng._allocator.n_free != eng._allocator.n_pages - 1 - held:
            raise RuntimeError("pages not returned to the pool")
    return outs, wall, sum(len(t) for t in outs), eng


def serve_line(tag, wall, n_tok, eng, launches=None):
    """A run's report: wall, useful tok/s, prefills, chunks and launches
    (and a speculative engine's tokens a round)."""
    st = eng.stats
    extra = ""
    if eng._spec:
        extra = (f", {st['spec_rounds']} rounds, "
                 f"{st['emitted_tokens'] / st['spec_slot_rounds']:.3f} "
                 f"tokens a slot and round (ceiling {eng._spec + 1})")
    if eng._page_cache:
        extra += (f", page cache {st['page_cache_hits']} hits, "
                  f"{st['page_cache_evicted']} evicted")
    phase("prefix", f"{tag}: {wall:.3f} s, {n_tok} tokens, "
          f"{n_tok / wall:.1f} tok/s useful, {st['prefills']} prefills, "
          f"{st['chunks']} chunks"
          + ("" if launches is None else f", {launches} kernel launches")
          + extra)


def kernel_run(ServeEngine, params, cfg, waves, **kw):
    """``serve_waves`` in kernel mode, holding the engine to one paged
    kernel call a layer and decode step. Returns (outs, wall, tokens,
    engine, launches)."""
    from linalg_tpu_torch.kernels.paged_attention import paged_attention_cuda

    before = paged_attention_cuda.launches
    outs, wall, n_tok, eng = serve_waves(ServeEngine, params, cfg, waves,
                                         paged_attn="kernel", **kw)
    launches = paged_attention_cuda.launches - before
    expected = eng.stats["chunks"] * eng.chunk * cfg.n_layers
    if launches == 0 or launches != expected:
        raise RuntimeError(f"kernel engine launched the kernel {launches} "
                           f"times; expected {expected}")
    return outs, wall, n_tok, eng, launches


def greedy_equal(tag, params, cfg, prompts, got, want, where="prefix"):
    """Exact equality of greedy streams, or a tie: at a request's first
    difference, the plain stream's (``want``) top-2 logit gap there, from
    one prefill of the prompt and its tokens before that position, must
    be under ``TIE_OF_MAX`` of the largest |logit|. Returns the flips."""
    from linalg_tpu_torch.models.gpt import gpt_prefill

    flips = 0
    for r, (prompt, g, w) in enumerate(zip(prompts, got, want)):
        if g == w:
            continue
        i = next(j for j, (a, b) in enumerate(zip(g, w)) if a != b)
        logits, _ = gpt_prefill(params, torch.tensor(
            [list(prompt) + list(w[:i])], device="cuda"), cfg)
        top2 = logits[0].topk(2).values
        gap, big = float(top2[0] - top2[1]), float(logits.abs().max())
        phase(where, f"{tag}: request {r} first differs at token {i}: "
              f"the plain stream's top-2 gap {gap:.3e} is "
              f"{gap / big:.3e} of max|logit| {big:.3e} (a tie under "
              f"{TIE_OF_MAX})")
        if not gap < TIE_OF_MAX * big:
            raise RuntimeError(f"{tag}: tokens differ at a gap f32 orders")
        flips += 1
    phase(where, f"{tag}: {len(got)} requests, "
          f"{sum(len(t) for t in got)} tokens, equal but {flips} tie "
          f"flips")
    return flips


def prefix_equalities(ServeEngine, params, cfg32):
    """Phase 17's f32 greedy equalities, 4 requests each (TF32 off)."""
    prefix, preqs = prefix_requests(4)
    full = [(prefix + p, n, False) for p, n in preqs]
    with_pid = [(p, n, True) for p, n in preqs]
    fulls = [prefix + p for p, _ in preqs]
    plain = kernel_run(ServeEngine, params, cfg32, [full], greedy=True)[0]
    kern = kernel_run(ServeEngine, params, cfg32, [with_pid], prefix=prefix,
                      greedy=True)[0]
    gath = serve_waves(ServeEngine, params, cfg32, [with_pid], prefix=prefix,
                       greedy=True, paged_attn="gather")[0]
    flips = greedy_equal("f32 prefix engine == full-prompt engine", params,
                         cfg32, fulls, kern, plain)
    flips += greedy_equal("f32 kernel engine, shared pages == gather "
                          "engine", params, cfg32, fulls, kern, gath)
    wave = head_requests(4)[0]
    wave = [(p, n, False) for p, n in wave]
    outs, _, _, eng, _ = kernel_run(ServeEngine, params, cfg32, [wave, wave],
                                 greedy=True, page_cache=True)
    if eng.stats["page_cache_hits"] == 0:
        raise RuntimeError("warm admissions found no cached page")
    flips += greedy_equal(f"f32 page cache warm == cold "
                          f"({eng.stats['page_cache_hits']} hits)", params,
                          cfg32, [p for p, _, _ in wave], outs[4:], outs[:4])
    long = [(p, n, False) for p, n in long_requests(4)]
    chunked = kernel_run(ServeEngine, params, cfg32, [long], greedy=True,
                         prefill_window=CHUNKED_WINDOW)[0]
    one = kernel_run(ServeEngine, params, cfg32, [long], greedy=True,
                     prefill_window=3072)[0]
    flips += greedy_equal("f32 chunked prefill == one-shot prefill", params,
                          cfg32, [p for p, _, _ in long], chunked, one)
    reqs = make_requests(4)
    prompts = [p for p, _, _ in reqs]
    for mode, kw in (("slot", dict(paged=False)),
                     ("paged gather", dict(paged_attn="gather"))):
        spec = serve_waves(ServeEngine, params, cfg32, [reqs], greedy=True,
                           speculative=SPEC_K, **kw)[0]
        base = serve_waves(ServeEngine, params, cfg32, [reqs], greedy=True,
                           **dict(kw, paged_attn="gather"))[0]
        flips += greedy_equal(f"f32 speculative K {SPEC_K} == plain, "
                              f"{mode}", params, cfg32, prompts, spec, base)
    return flips


def prefix_phase(ServeEngine, params, cfg, cfg32, phase4):
    """Phase 17: chunked prefill, shared prefixes, the page cache and
    speculative decoding at the serving widths, bf16; then the f32
    equalities. ``phase4``: (wall, tokens) of phase 4's kernel engine on
    its 16 requests. Returns the kernel launches of the bf16 runs."""
    from linalg_tpu_torch.kernels.paged_attention import paged_attention_cuda

    prefix, preqs = prefix_requests(16)
    full = [[(prefix + p, n, False) for p, n in preqs]]
    with_pid = [[(p, n, True) for p, n in preqs]]
    longs = [[(p, n, False) for p, n in long_requests(16)]]
    heads = [[(p, n, False) for p, n in w] for w in head_requests(8)]
    reqs = [make_requests(16)]
    paged_attention_cuda.launches = 0
    # (a) the registered prefix: its 4 pages head every slot's table
    _, wall, n_tok, eng, launches = kernel_run(
        ServeEngine, params, cfg, with_pid, prefix=prefix)
    if eng._shared_held != PREFIX_LEN // ENGINE_KW["page"]:
        raise RuntimeError("the prefix's pages are not shared")
    serve_line("(a) registered prefix, kernel", wall, n_tok, eng, launches)
    _, wall, n_tok, eng = serve_waves(ServeEngine, params, cfg, with_pid,
                                      prefix=prefix, paged_attn="gather")
    serve_line("(a) registered prefix, gather", wall, n_tok, eng)
    _, wall, n_tok, eng, launches = kernel_run(ServeEngine, params, cfg,
                                               full)
    serve_line("    phase 4's engine, the same full prompts", wall, n_tok,
               eng, launches)
    # (b) auto_prefix: the full prompts, matched at submit
    auto = [[(prefix + p, n, False) for p, n in preqs]]
    _, wall, n_tok, eng, launches = kernel_run(
        ServeEngine, params, cfg, auto, prefix=prefix, auto_prefix=True)
    if [c.prompt_len for c in sorted(eng.completions, key=lambda c:
                                     c.request_id)] != [len(p) for p, _ in
                                                        preqs]:
        raise RuntimeError("auto_prefix did not match the prefix")
    serve_line("(b) auto_prefix, kernel", wall, n_tok, eng, launches)
    # (c) chunked prefill: a 512-token window over 1,024-3,072 prompts
    _, wall, n_tok, eng, launches = kernel_run(
        ServeEngine, params, cfg, longs, prefill_window=CHUNKED_WINDOW)
    serve_line(f"(c) chunked prefill, window {CHUNKED_WINDOW}, kernel",
               wall, n_tok, eng, launches)
    _, wall, n_tok, eng, launches = kernel_run(ServeEngine, params, cfg,
                                               longs)
    serve_line("    phase 4's engine (window 2048), the same prompts", wall,
               n_tok, eng, launches)
    # (d) the page cache: a second wave over the first's retired pages
    waves = []
    _, wall, n_tok, eng, launches = kernel_run(
        ServeEngine, params, cfg, heads, page_cache=True, per_wave=waves)
    hits = [w[2]["page_cache_hits"] for w in waves]
    if hits[1] - hits[0] <= 0:
        raise RuntimeError("page cache: the second wave hit no page")
    serve_line(f"(d) page cache, kernel: wave 1 {waves[0][0]:.3f} s, "
               f"{waves[0][1]} tokens, {hits[0]} hits; wave 2 "
               f"{waves[1][0]:.3f} s, {waves[1][1]} tokens, "
               f"{hits[1] - hits[0]} hits; both", wall, n_tok, eng,
               launches)
    waves = []
    _, wall, n_tok, eng, launches = kernel_run(ServeEngine, params, cfg,
                                               heads, per_wave=waves)
    serve_line(f"    phase 4's engine: wave 1 {waves[0][0]:.3f} s, wave 2 "
               f"{waves[1][0]:.3f} s; both", wall, n_tok, eng, launches)
    # (e) speculative decoding, K 4: slot mode and the paged gather
    for mode, kw in (("slot", dict(paged=False)),
                     ("paged gather", dict(paged_attn="gather"))):
        _, wall, n_tok, eng = serve_waves(ServeEngine, params, cfg, reqs,
                                          speculative=SPEC_K, **kw)
        serve_line(f"(e) speculative K {SPEC_K}, {mode}", wall, n_tok, eng)
    _, wall, n_tok, eng = serve_waves(ServeEngine, params, cfg, reqs,
                                      paged=False)
    serve_line("    plain slot engine, the same requests", wall, n_tok, eng)
    phase("prefix", f"    phase 4's engine (kernel), the same requests: "
          f"{phase4[0]:.3f} s, {phase4[1] / phase4[0]:.1f} tok/s useful")
    launches = paged_attention_cuda.launches
    phase("prefix", f"bf16 runs: {launches} paged kernel calls, one a "
          f"layer and decode step of every kernel-mode run")
    flips = prefix_equalities(ServeEngine, params, cfg32)
    phase("prefix", f"f32 equalities hold, {flips} tie flips in all")
    return launches


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


def qr_builds(lib):
    """Phase 6's build check: registers, shared memory and spills of the
    panel kernels; a stack frame or spill in either fails."""
    import re

    spills = {}
    log = lib.with_suffix(".log").read_text()
    for name, (regs, *frame) in sorted(ptxas_kernels(lib).items()):
        m = re.search(r"qr_(cluster|grid)_kernelI((?:Li\d+E|Lb\dE)+)E",
                      name)
        if not m:
            continue
        args = re.findall(r"L[ib](\d+)E", m.group(2))
        after = log[log.index(f"Function properties for {name}"):]
        used = next(ln for ln in after.splitlines() if "Used" in ln)
        smem = re.search(r"(\d+) bytes smem", used)
        phase("qr", f"qr_{m.group(1)}_kernel<{', '.join(args)}>: {regs} "
              f"registers, {smem.group(1) if smem else 0} bytes of static "
              f"shared memory, stack frame {frame[0]}, spill stores "
              f"{frame[1]}, loads {frame[2]}")
        if any(frame):
            spills[name] = frame
    if spills:
        raise RuntimeError(f"qr panel kernels spill registers: {spills}")


def geqrf_ms(St, k):
    """``torch.geqrf`` of the same (m - k, b) strip: a yardstick only (no
    T factor, LAPACK's scaling); the port never calls it."""
    A = St[:, k:].T.contiguous()
    return median_ms(torch.geqrf, (A,), trials=7, reps=5)


def qr_repeat_check(name, St, k, first):
    """QR_REPEATS launches of the strip kernel on St into outputs of their
    own, back to back: St_out, Vt and Tt of every one must equal ``first``
    bit for bit. The kernel's sums run in a fixed order, so any difference
    is a race between its threads or CTAs."""
    from linalg_tpu_torch.kernels.qr_panel import factor_strip_cuda

    outs = [factor_strip_cuda(St, k) for _ in range(QR_REPEATS)]
    torch.cuda.synchronize()
    bad = [i for i, out in enumerate(outs)
           if not all(torch.equal(g, f) for g, f in zip(out, first))]
    phase("qr", f"  {QR_REPEATS} more launches into outputs of their own: "
          f"{QR_REPEATS - len(bad)} bitwise equal to the first")
    if bad:
        raise RuntimeError(f"qr_panel {name}: launches {bad[:8]} differ "
                           "from the first (a race in the kernel)")


def qr_strip_cases():
    """Phase 6's strips: each kernel against its plain version at
    ``QR_CASES``, the kernel the shape rule names (the launch counters must
    agree), QR_REPEATS more launches bitwise equal to the first, device
    times beside the plain version, the bound and ``torch.geqrf``. Returns
    the JSON records of the two kernels (at "strip" and "tall strip") and
    the launches at K12's widths (b > 64): the wrapper's panel counter,
    less the calls recorded into CUDA graphs, plus the calls the graphs'
    replays launched."""
    from linalg_tpu_torch.kernels.qr_panel import (cluster_shape,
                                                   factor_strip_cuda,
                                                   grid_shape)
    from linalg_tpu_torch.ops.qr_panel import (factor_panel_ref,
                                               factor_strip_ref)

    records, k12 = {}, 0
    for i, (name, (b, m, k), zero, kernel) in enumerate(QR_CASES):
        St = np.random.default_rng(100 + i).standard_normal((b, m))
        if zero is not None:
            St[zero] = 0.0
        St = torch.tensor(St, dtype=torch.float32, device="cuda")
        ref = factor_strip_ref if b <= 64 else factor_panel_ref
        C, lpt = cluster_shape(b, m, k)
        G, L, on_chip = grid_shape(b, m, k)
        if (kernel == "cluster") != bool(C):
            raise RuntimeError(f"qr_panel {name}: the shape rule gives "
                               f"C {C}, not the {kernel} kernel")
        counts = (factor_strip_cuda.cluster_launches,
                  factor_strip_cuda.grid_launches,
                  factor_strip_cuda.panel_launches)
        got = factor_strip_cuda(St, k)
        want = ref(St, k)
        torch.cuda.synchronize()
        moved = (factor_strip_cuda.cluster_launches - counts[0],
                 factor_strip_cuda.grid_launches - counts[1])
        if moved != ((1, 0) if C else (0, 1)):
            raise RuntimeError(f"qr_panel {name}: the {kernel} kernel, but "
                               f"the cluster/grid counters moved by {moved}")
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
                raise RuntimeError(f"qr_panel {name}: Vt row {vz}, "
                                   f"Tt diagonal {tz}; both must be 0")
        which = (f"cluster kernel, C {C}, {lpt} lane(s) a thread" if C else
                 f"grid kernel, G {G}, {L} lanes a CTA, S and Vt "
                 f"{'on chip' if on_chip else 'in device memory'}")
        phase("qr", f"{name} b,m,k={b},{m},{k}: {which};"
              f" max_abs_err St/Vt/Tt {errs[0]:.3e}/{errs[1]:.3e}/"
              f"{errs[2]:.3e} (tolerance {QR_RTOL_OF_MAX} x max|want|: "
              f"{tols[0]:.3e}/{tols[1]:.3e}/{tols[2]:.3e})")
        qr_repeat_check(name, St, k, got)
        ms = median_ms(factor_strip_cuda, (St, k))
        # the device time without the host's launch cost: a CUDA graph over
        # copies of St larger than the L2
        dev_ms = graph_ms(factor_strip_cuda, [
            (c, k) for (c,) in cold_copies((St,), 64 << 20)])
        if b > 64:  # K12's widths: launched only by these checks
            k12 += (factor_strip_cuda.panel_launches - counts[2]
                    - graph_ms.captured + graph_ms.replayed)
        plain_ms = median_ms(ref, (St, k), trials=5, reps=2, warm=1)
        bms, by = strip_bound(b, m - k)
        phase("qr", f"  kernel {ms:.4f} ms from Python, {dev_ms:.4f} ms of "
              f"device time (CUDA graph, cold L2); plain {plain_ms:.4f} ms; "
              f"bound {bms:.5f} ms ({by}), {bms / dev_ms:.2%} of it; "
              f"torch.geqrf of the ({m - k}, {b}) strip {geqrf_ms(St, k):.4f}"
              f" ms (yardstick: no T, LAPACK's scaling)")
        if name in ("strip", "tall strip"):  # the QR paths' shapes
            records[kernel] = dict(
                max_abs_err=max(errs), ms=ms, device_ms=dev_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None, **({"cluster_size": C} if C else
                                    {"grid_ctas": G, "lanes_per_cta": L}))
        del St, got, want
        torch.cuda.empty_cache()
    return records, k12


def qr_matrix(M, N, kernel, plain):
    """``householder_qr`` of an (M, N) float32 matrix from
    ``np.random.default_rng(0)``: N / 32 strip launches, all through
    ``kernel`` ("cluster" or "grid"), rel_resid ||A-QR||_F/||A||_F in
    float64 <= QR_RESID_MAX, ||Q^T Q - I||_F, median times of three
    interleaved runs beside ``torch.linalg.qr`` (and, with ``plain``, the
    same blocked QR with the plain strip sweep), once more with the
    caller's TF32 on. Returns the QR's [cluster, grid] launches and its
    launches at K12's widths (b > 64), by the wrapper's counters."""
    from linalg_tpu_torch.kernels.qr_panel import factor_strip_cuda
    from linalg_tpu_torch.ops.qr import householder_qr
    from linalg_tpu_torch.ops.qr_panel import (factor_strip_ref,
                                               householder_qr_panel)

    A = torch.tensor(np.random.default_rng(0).standard_normal((M, N)).astype(
        np.float32), device="cuda")
    A64 = A.double()
    eye = torch.eye(N, dtype=torch.float64, device="cuda")
    tag = f"householder_qr {M}x{N} f32"

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
    if not plain:
        del runs["plain strip"]
    for fn in runs.values():  # first-use costs out of the timing
        fn(A)
    torch.cuda.synchronize()

    factor_strip_cuda.launches = 0
    factor_strip_cuda.cluster_launches = 0
    factor_strip_cuda.grid_launches = 0
    factor_strip_cuda.panel_launches = 0
    Q, R = householder_qr(A)
    torch.cuda.synchronize()
    launches = factor_strip_cuda.launches
    by_kernel = [factor_strip_cuda.cluster_launches,
                 factor_strip_cuda.grid_launches]
    panel = factor_strip_cuda.panel_launches
    want = [N // QR_INNER, 0] if kernel == "cluster" else [0, N // QR_INNER]
    if launches != N // QR_INNER or by_kernel != want:
        raise RuntimeError(f"{tag} launched the strip kernels {launches} "
                           f"times (cluster, grid: {by_kernel}); expected "
                           f"{N // QR_INNER}, all {kernel}")
    rel, orth = quality(Q, R)
    phase("qr", f"{tag}: {launches} strip launches, all through the "
          f"{kernel} kernel, rel_resid {rel:.3e} (gate {QR_RESID_MAX}), "
          f"||Q^T Q - I||_F {orth:.3e}")
    if not rel <= QR_RESID_MAX:
        raise RuntimeError(f"{tag} rel_resid {rel:.3e} > {QR_RESID_MAX}")

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
    flops = 2.0 * M * N * N - 2.0 * N ** 3 / 3  # R alone, as bench.py's 2 N^3
    for name, fn in runs.items():
        t = float(np.median(times[name]))
        r_, o_ = quality(*fn(A))
        phase("qr", f"{tag} {name}: median {t:.3f} ms of {times[name]}, "
              f"{(2.0 * N ** 3 if M == N else flops) / (t * 1e-3) / 1e9:.1f}"
              f" GFLOP/s, rel_resid {r_:.3e}, ||Q^T Q - I||_F {o_:.3e}")

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        Q, R = householder_qr(A)
        still_on = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    rel_tf32, orth_tf32 = quality(Q, R)
    phase("qr", f"{tag} with the caller's TF32 on: rel_resid "
          f"{rel_tf32:.3e}, ||Q^T Q - I||_F {orth_tf32:.3e}; the caller's "
          f"setting afterwards: allow_tf32={still_on}")
    if not rel_tf32 <= QR_RESID_MAX or not still_on:
        raise RuntimeError(f"{tag} under the caller's TF32 missed the gate "
                           "or did not restore the setting")
    del A, A64, Q, R
    torch.cuda.empty_cache()
    return by_kernel, panel


def qr_phase():
    """Phase 6: the panel kernels against their plain version, then the
    4096^2 Householder QR (every strip on the cluster kernel) and the
    16384 x 4096 one (every strip on the grid kernel). Returns the JSON
    records of the cluster and the grid kernel."""
    records, k12 = qr_strip_cases()
    by_path, panel = {}, 0
    for (M, N), kernel, plain in (((QR_N, QR_N), "cluster", True),
                                  (QR_TALL, "grid", False)):
        by_path[f"householder_qr {M}x{N}"], p = qr_matrix(M, N, kernel,
                                                          plain)
        panel += p
    cluster = dict(launches=sum(c for c, _ in by_path.values()),
                   launches_cluster_grid_by_path=by_path, **records["cluster"])
    grid = dict(launches=sum(g for _, g in by_path.values()),
                launches_cluster_grid_by_path=by_path,
                launches_k12={"qr_paths": panel, "phase6_checks": k12},
                **records["grid"])
    return cluster, grid


def profile_qr():
    """A ``torch.profiler`` breakdown of one ``householder_qr`` at 4096^2
    and at 16384 x 4096 (run with the other profiles, last): device time,
    idle share, the panel kernels' share, the top kernels and ops."""
    from linalg_tpu_torch.ops.qr import householder_qr

    for shape in ((QR_N, QR_N), QR_TALL):
        A = torch.tensor(np.random.default_rng(0).standard_normal(
            shape), dtype=torch.float32, device="cuda")
        householder_qr(A)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=PROFILED) as prof:
            t0 = time.perf_counter()
            householder_qr(A)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        report_profile("qr", f"householder_qr {shape[0]}x{shape[1]} f32",
                       prof, wall)
        panel = total = 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms_ = getattr(e, "self_device_time_total", 0) / 1e3
                total += ms_
                if "qr_cluster_kernel" in e.key or "qr_grid_kernel" in e.key:
                    panel += ms_
        phase("qr", f"panel kernels {panel:.3f} ms of {total:.3f} ms of "
              f"device time ({panel / max(total, 1e-9):.1%}); the rest is "
              f"the blocked QR's GEMMs, reductions, copies and element-wise "
              f"ops")
        del A
        torch.cuda.empty_cache()


def flash_case(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), dtype=dtype,
                         device="cuda") for _ in range(4)]


def flash_compare(name, pairs, dtype, tag="flash"):
    """Max abs errors of (what, got, want) pairs against the tolerance;
    raises on a miss."""
    rtol = FLASH_RTOL_OF_MAX[dtype]
    errs = {}
    for what, got, want in pairs:
        err = float((got.float() - want.float()).abs().max())
        tol = rtol * max(1.0, float(want.float().abs().max()))
        if not err <= tol:
            raise RuntimeError(f"{tag} {name}: {what} max_abs_err "
                               f"{err:.3e} > tolerance {tol:.3e}")
        errs[what] = err
    phase(tag, f"{name}: max_abs_err " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tolerance {rtol} x max|want|)")
    return max(errs.values())


def library_ms(q, k, v, do, causal, window):
    """Median ms of the one PyTorch call computing the same attention,
    ``F.scaled_dot_product_attention`` (grouped K/V through enable_gqa;
    a window as a boolean band mask): forward, and forward+backward."""
    import torch.nn.functional as F

    T = q.shape[2]
    mask = None
    if window is not None:
        i = torch.arange(T, device=q.device)
        mask = (i[:, None] - i[None, :]) < window
        if causal:
            mask &= i[None, :] <= i[:, None]
    kw = dict(attn_mask=mask, is_causal=causal and mask is None,
              enable_gqa=k.shape[1] != q.shape[1])
    x = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def fwd(q, k, v):
        with torch.no_grad():
            return F.scaled_dot_product_attention(q, k, v, **kw)

    def fb(q, k, v):
        o = F.scaled_dot_product_attention(q, k, v, **kw)
        return torch.autograd.grad(o, (q, k, v), do)

    return (median_ms(fwd, x, trials=5, reps=3),
            median_ms(fb, x, trials=5, reps=3))


def against_library(ms, lib, bms):
    """A kernel's time as a factor of the library call's and as the share
    of its bound that it reaches."""
    return f"{ms / lib:.2f}x SDPA's time, {bms / ms:.1%} of the bound"


def flash_phase():
    """Phase 7: the flash kernels against their plain versions. Returns
    the kernel's JSON record (errors and times at the training shape)."""
    from linalg_tpu_torch.kernels.flash_attention import (
        flash_delta_cuda, flash_dkdv_cuda, flash_dq_cuda, flash_fwd_cuda)
    from linalg_tpu_torch.models.gpt import _padded_attn
    from linalg_tpu_torch.nn.flash import (flash_attention,
                                           flash_attention_ref,
                                           flash_bwd_ref, flash_delta_ref,
                                           flash_fwd_ref)
    from linalg_tpu_torch.nn.flash_long import flash_attention_long

    def kernel_fb(q, k, v, do):
        o, L = flash_fwd_cuda(q, k, v)
        delta = flash_delta_cuda(o, do)
        return (flash_dq_cuda(q, k, v, do, L, delta),
                flash_dkdv_cuda(q, k, v, do, L, delta))

    def plain_fb(q, k, v, do):
        o, L = flash_fwd_ref(q, k, v)
        return flash_bwd_ref(q, k, v, o, L, do)

    record = None
    for i, (shape, dtype) in enumerate([
            ((24, 8, 1024, 128), torch.bfloat16),
            ((24, 8, 1024, 128), torch.float32),
            ((2, 8, 2048, 128), torch.bfloat16),  # flash_attention_long's
            ((4, 8, 1024, 64), torch.float32),
            ((2, 4, 1024, 256), torch.bfloat16),  # the widest heads
            ((2, 4, 1024, 256), torch.float32)]):
        q, k, v, do = flash_case(shape, dtype, seed=200 + i)
        o, L = flash_fwd_cuda(q, k, v)
        o_ref, L_ref = flash_fwd_ref(q, k, v)
        # the backward kernels from the plain forward's o and L, so each
        # kernel is held alone
        delta = flash_delta_cuda(o_ref, do)
        delta_ref = flash_delta_ref(o_ref, do)
        dq = flash_dq_cuda(q, k, v, do, L_ref, delta_ref)
        dk, dv = flash_dkdv_cuda(q, k, v, do, L_ref, delta_ref)
        torch.cuda.synchronize()
        want = flash_bwd_ref(q, k, v, o_ref, L_ref, do)
        dt = str(dtype).split(".")[1]
        err = flash_compare(f"B,H,T,d={shape} {dt}", [
            ("o", o, o_ref), ("L", L, L_ref), ("delta", delta, delta_ref),
            ("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])],
            dtype)
        del o, L, o_ref, L_ref, delta, delta_ref, dq, dk, dv, want
        args = (q, k, v)
        ms_f = median_ms(flash_fwd_cuda, args, trials=7, reps=3)
        plain_f = median_ms(flash_fwd_ref, args, trials=5, reps=2, warm=1)
        ms_fb = median_ms(kernel_fb, args + (do,), trials=7, reps=3)
        plain_fb_ms = median_ms(plain_fb, args + (do,), trials=5, reps=2,
                                warm=1)
        lib_f, lib_fb = library_ms(q, k, v, do, True, None)
        bms, by = attn_bound(shape[0], shape[1], shape[1], shape[2],
                             shape[3], dtype)
        phase("flash", f"  kernel fwd {ms_f:.4f} ms, fwd+bwd {ms_fb:.4f} ms; "
              f"plain fwd {plain_f:.4f} ms, fwd+bwd {plain_fb_ms:.4f} ms; "
              f"F.scaled_dot_product_attention fwd {lib_f:.4f} ms, fwd+bwd "
              f"{lib_fb:.4f} ms; bound fwd+bwd {bms:.4f} ms ({by}); "
              + against_library(ms_fb, lib_fb, bms))
        row = dict(max_abs_err=err, ms=ms_fb, plain_ms=plain_fb_ms,
                   bound_ms=bms, bound_by=by, library_ms=lib_fb, fwd_ms=ms_f,
                   plain_fwd_ms=plain_f, library_fwd_ms=lib_f)
        if i == 0:  # the training slice's shape and dtype
            record = row
        elif shape[-1] == 256:
            record[f"d256_{str(dtype).split('.')[1]}"] = row
        torch.cuda.empty_cache()

    for name, (B, H, T, d), dtype, fn, ref in [
            ("flash_attention_long T 2048", (2, 8, 2048, 128),
             torch.bfloat16, lambda q, k, v, m: flash_attention_long(q, k, v),
             lambda q, k, v, m: flash_attention_ref(q, k, v)),
            ("ragged T 1000 padded to 1024", (2, 8, 1000, 128),
             torch.float32, _padded_attn(flash_attention, 1000, 1024),
             _padded_attn(flash_attention_ref, 1000, 1024))]:
        # (B, T, H, d) transposed to heads, as the model hands them over
        x = flash_case((B, T, H, d), dtype, seed=T)
        outs = []
        for f in (fn, ref):
            q, k, v = (t.clone().requires_grad_(True) for t in x[:3])
            o = f(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  None)
            o.backward(x[3].transpose(1, 2))
            outs.append((o.detach(), q.grad, k.grad, v.grad))
        torch.cuda.synchronize()
        flash_compare(name, [(w, g, r) for w, g, r in zip(
            ("o", "dq", "dk", "dv"), *outs)], dtype)
    return record


def step_flops(d, L, T, V, batch):
    """Matmul FLOPs of one fwd+bwd train step by bench.py's count
    (``_gpt_step_flops``: 2 per multiply-add, backward twice the
    forward)."""
    per_tok_layer = 8 * d * d + 4 * d * 4 * d
    fwd = batch * T * (L * (per_tok_layer + 4 * T * d) + 2 * d * V)
    return 3 * fwd


def loss_and_grads(params, x, y, cfg, attn_fn=None):
    from linalg_tpu_torch.models.gpt import gpt_loss
    from linalg_tpu_torch.train.optim import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = gpt_loss(params, x, y, cfg, attn_fn=attn_fn)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return float(loss.detach()), grads


@contextlib.contextmanager
def patched(*pairs):
    """Set attributes for the block and restore them after:
    ``patched((obj, {name: value, ...}), ...)``."""
    with contextlib.ExitStack() as stack:
        for obj, attrs in pairs:
            for name, value in attrs.items():
                stack.enter_context(mock.patch.object(obj, name, value))
        yield


def one_step_check(tag, cfg, batch_size, plain, patch=(), counters=(),
                   kernel=None):
    """One step's loss and gradients through the kernels (the model's pick,
    or attention ``kernel``) against the same step with attention
    ``plain`` (the plain versions), at ``cfg``'s widths from seed-0 weights
    and ids; with ``patch`` (``patched`` pairs of ``models.gpt`` names and
    their plain stand-ins) the plain step takes the picker's path with
    those replaced. Each of ``counters`` must count
    launches in the kernel step and none in the plain one. f32 with TF32
    off: |dloss| and ||g_k - g_p|| / ||g_p|| <= 1e-4. bf16: |dloss| <= 1e-2,
    the kernels' gradients no farther from the f32 plain step's than the
    bf16 plain step's are (x 1.1), and ||g_k - g_p|| / ||g_p|| <= 2e-2,
    or, where bf16 alone moves the plain step's gradients farther than
    that off f32's, <= that distance."""
    from linalg_tpu_torch.models.gpt import init_gpt_params

    def rel(a, b):
        num = math.sqrt(sum(float(torch.sum((x - y).double() ** 2))
                            for x, y in zip(a, b)))
        return num / math.sqrt(sum(float(torch.sum(y.double() ** 2))
                                   for y in b))

    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (2, batch_size, cfg.ctx_len))
    x, y = (torch.tensor(a, device="cuda") for a in ids)
    truth = None
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, dtype=dtype)
        p = init_gpt_params(c, seed=0, device="cuda")
        for ctr in counters:
            ctr.launches = 0
        lk, gk = loss_and_grads(p, x, y, c, kernel)
        n_kernel = [ctr.launches for ctr in counters]
        with patched(*patch):
            lp, gp = loss_and_grads(p, x, y, c, plain)
        if counters and (min(n_kernel) == 0 or [
                ctr.launches for ctr in counters] != n_kernel):
            raise RuntimeError(f"one {dtype} step: the kernel step launched "
                               f"{n_kernel}; the plain step must launch none")
        dg = rel(gk, gp)
        if dtype == "float32":
            bounds = (1e-4, 1e-4)
            ok = abs(lk - lp) <= bounds[0] and dg <= bounds[1]
            extra = ""
            truth = [g.float() for g in gp]
        else:
            noise_p, noise_k = rel(gp, truth), rel(gk, truth)
            bounds = (1e-2, max(2e-2, noise_p))
            ok = (abs(lk - lp) <= bounds[0] and dg <= bounds[1]
                  and noise_k <= 1.1 * noise_p)
            extra = (f"; off the f32 step's gradients: kernels {noise_k:.3e}, "
                     f"plain {noise_p:.3e} (kernels <= 1.1 x plain)")
        phase(tag, f"one step {dtype}: loss kernels {lk:.6f}, plain "
              f"{lp:.6f}, |diff| {abs(lk - lp):.3e} (bound {bounds[0]}); "
              f"gradients ||g_k - g_p|| / ||g_p|| {dg:.3e} (bound "
              f"{bounds[1]:.3e}){extra}")
        if not ok:
            raise RuntimeError(f"one {dtype} step: kernels and plain "
                               "versions disagree")
        del p, gk, gp
        torch.cuda.empty_cache()


def checkpoint_reloads(ckpt_dir, rows, params, cfg, stoi, itos):
    """(steps whose eval saved the best checkpoint, its config, equal): the
    trainer keeps only the best checkpoint, so it is held against the
    trained params when the last eval saved it; when an earlier eval's val
    loss stayed the best, the trained params go through ``save_ckpt`` and
    ``load_ckpt`` beside it and are held against themselves (the best
    checkpoint must still load with the run's config)."""
    from linalg_tpu_torch.train.checkpoint import load_ckpt, save_ckpt
    from linalg_tpu_torch.train.optim import tree_leaves

    saved = [r["step"] for r in rows if r["event"] == "eval" and r["ckpt"]]
    evals = [r["step"] for r in rows if r["event"] == "eval"]
    back, cfg2, _, _ = load_ckpt(ckpt_dir, device="cuda")
    if not saved or saved[-1] != evals[-1]:
        save_ckpt(f"{ckpt_dir}_last", params, cfg, stoi, itos)
        back, cfg3, _, _ = load_ckpt(f"{ckpt_dir}_last", device="cuda")
        cfg2 = cfg2 if cfg3 == cfg2 else cfg3
    same = cfg2 == cfg and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(back),
                                          tree_leaves(params)))
    return saved, cfg2, same


def train_phase(smi):
    """Phase 8: the training path on the card. Returns the flash launch
    counts of the train_big run, its config and its batch size."""
    from linalg_tpu_torch.apps.gpt import build_parser
    from linalg_tpu_torch.kernels.flash_attention import (
        flash_delta_cuda, flash_dkdv_cuda, flash_dq_cuda, flash_fwd_cuda)
    from linalg_tpu_torch.nn.flash import flash_attention_ref
    from linalg_tpu_torch.train.trainer import train

    counters = (flash_fwd_cuda, flash_dq_cuda, flash_dkdv_cuda,
                flash_delta_cuda)
    with tempfile.TemporaryDirectory() as tmp:
        log = f"{tmp}/metrics.jsonl"
        args = build_parser().parse_args(
            ["--train", *TRAIN_BIG, "--ckpt_dir", f"{tmp}/ck", "--log_file",
             log, "--device", "cuda"])
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        params, cfg, stoi, itos = train(args)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = [json.loads(ln) for ln in open(log, encoding="utf-8")]
        n_eval = sum(r["event"] == "eval" for r in rows)
        want = [cfg.n_layers * (args.steps + n_eval * EVAL_BATCHES)] + [
            cfg.n_layers * args.steps] * 3
        phase("train", f"train_big: flash launches fwd/dq/dkdv/delta "
              f"{launches}, "
              f"expected {want} ({cfg.n_layers} layers x ({args.steps} "
              f"steps + {n_eval} evals x {EVAL_BATCHES} batches) forward, "
              f"{cfg.n_layers} x {args.steps} backward)")
        if launches != want:
            raise RuntimeError("train_big launch counts differ from the run")
        losses = [r.get("loss", r.get("val_loss")) for r in rows
                  if r["event"] in ("train", "eval")]
        phase("train", f"losses (train at steps 1, 20, 40; val at 20, 40): "
              f"{losses}")
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError("a train_big loss is not finite")
        t = {(r["event"], r["step"]): r["elapsed_s"] for r in rows
             if "step" in r}
        # steps 21..40: from the end of the step-20 eval to the step-40 sync
        ms = (t[("train", 40)] - t[("eval", 20)]) / 20 * 1e3
        tok_s = args.batch_size * cfg.ctx_len / (ms * 1e-3)
        tflops = step_flops(cfg.d_model, cfg.n_layers, cfg.ctx_len,
                            cfg.vocab_size, args.batch_size) / (
            ms * 1e-3) / 1e12
        phase("train", f"train_big steady state (steps 21-40): {ms:.2f} "
              f"ms/step, {tok_s:.0f} tok/s, {tflops:.1f} TFLOP/s, mfu "
              f"{tflops / H100_BF16_TFLOPS:.4f} of {H100_BF16_TFLOPS:.0f} "
              f"TFLOP/s; peak memory {peak_gb:.2f} GB; {smi}")
        saved, _, same = checkpoint_reloads(f"{tmp}/ck", rows, params, cfg,
                                            stoi, itos)
        phase("train", f"checkpoint saved at steps {saved}, reloaded equal "
              f"to the trained params: {same}")
        if not same:
            raise RuntimeError("the checkpoint does not reload equal to the "
                               "trained params")
    del params

    # one step's loss and gradients: kernels vs plain versions
    plain = lambda q, k, v, mask: flash_attention_ref(q, k, v, True)
    one_step_check("train", cfg, args.batch_size, plain)

    # the published config at batch 64 with default switches: T 256 takes
    # the rematted sdpa (K7's size gate is batch 128), and K8/K9 are
    # opt-in: no kernel
    from linalg_tpu_torch.kernels import fused_layer as kf

    counters += (kf.ln_qkv_fwd_cuda, kf.ln_qkv_bwd_cuda, kf.ln_ffn_fwd_cuda,
                 kf.ln_ffn_bwd_cuda)
    with tempfile.TemporaryDirectory() as tmp, switches():
        for ctr in counters:
            ctr.launches = 0
        log = f"{tmp}/metrics.jsonl"
        args2 = build_parser().parse_args(
            ["--train", *PUBLISHED, "--ckpt_dir", f"{tmp}/ck", "--log_file",
             log, "--device", "cuda"])
        train(args2)
        rows = [json.loads(ln) for ln in open(log, encoding="utf-8")]
        losses = [r.get("loss", r.get("val_loss")) for r in rows
                  if r["event"] in ("train", "eval")]
        n = [ctr.launches for ctr in counters]
        phase("train", f"published config (d512, 4 layers, ctx 256, B 64, "
              f"f32), {args2.steps} steps: losses {losses}, launches of "
              f"flash fwd/dq/dkdv/delta and ln_qkv fwd/bwd, ln_ffn fwd/bwd "
              f"{n}")
        if any(n) or not all(math.isfinite(v) for v in losses):
            raise RuntimeError("published config: a kernel launch or a "
                               "non-finite loss")

    return launches, cfg, args.batch_size


PROFILED = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]


def profile_step(tag, cfg, batch_size, attn_fn=None):
    """A ``torch.profiler`` breakdown of one train step (attention
    ``attn_fn``, default the model's pick) after three warm ones. Run after
    every timing: the profiler stays attached to the card and slows what
    runs after it."""
    from linalg_tpu_torch.models.gpt import init_gpt_params
    from linalg_tpu_torch.train.optim import adamw_init
    from linalg_tpu_torch.train.trainer import make_device_train_step

    rng = np.random.default_rng(0)
    p = init_gpt_params(cfg, seed=0, device="cuda")
    state = adamw_init(p)
    step = make_device_train_step(cfg, batch_size, base_lr=3e-4,
                                  min_lr=3e-5, warmup=200, max_steps=10000,
                                  weight_decay=0.01, attn_fn=attn_fn)
    data = torch.tensor(rng.integers(0, cfg.vocab_size, 400_000),
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(3):
        p, state, gen, loss = step(p, state, data, gen)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=PROFILED) as prof:
        t0 = time.perf_counter()
        p, state, gen, loss = step(p, state, data, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    report_profile(tag, "step", prof, wall)


def report_profile(tag, run, prof, wall):
    """Print a profiled run's wall time (ms), device time, idle share,
    kernel launches, and the top kernels and ops by device time."""
    avgs = prof.key_averages()

    def by_device_time(device_type):
        return sorted(((getattr(e, "self_device_time_total", 0) / 1e3,
                        e.count, e.key) for e in avgs
                       if e.device_type == device_type), reverse=True)

    kernels = by_device_time(torch.autograd.DeviceType.CUDA)
    total = sum(ms_ for ms_, _, _ in kernels)
    phase(tag, f"profiled {run}: wall {wall:.2f} ms, device time "
          f"{total:.2f} ms (idle {max(0.0, 1 - total / wall):.1%}), "
          f"{sum(n_ for _, n_, _ in kernels)} kernel launches")
    for what, rows in (("kernels", kernels),
                       ("ops", by_device_time(
                           torch.autograd.DeviceType.CPU))):
        phase(tag, f"top {what} by device time:")
        for ms_, n_, key in rows[:12]:
            phase(tag, f"  {ms_:9.3f} ms "
                  f"{100 * ms_ / max(total, 1e-9):5.1f}%  x{n_:<5d} "
                  f"{key[:80]}")


def profile_parallel():
    """``torch.profiler`` breakdowns of one dp 2 x tp 4 step at train_big's
    widths and one dp 2 x ep 4 step of the MoE's T 1024 run (K8 on), 8
    ranks on the card, after three warm steps (run last, as
    ``profile_step``)."""
    from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from linalg_tpu_torch.models.moe import MoEGPTConfig, init_moe_params
    from linalg_tpu_torch.parallel import (gpt_param_specs,
                                           make_ep_device_train_step,
                                           make_mesh,
                                           make_sharded_device_train_step,
                                           moe_param_specs, shard_tree)
    from linalg_tpu_torch.train.optim import adamw_init

    kw = dict(base_lr=3e-4, min_lr=3e-5, warmup=200, max_steps=10000,
              weight_decay=0.01)
    data = torch.tensor(np.random.default_rng(0).integers(0, 65, 400_000),
                        device="cuda")
    big = GPTConfig(vocab_size=65, d_model=1024, n_heads=8, n_layers=8,
                    ctx_len=1024, dtype="bfloat16")
    moe = MoEGPTConfig(vocab_size=65, d_model=512, n_heads=4, n_layers=4,
                       ctx_len=1024, pos="rope", dtype="bfloat16",
                       n_experts=8)
    for tag, cfg, B, names, make, specs, init, env in (
            ("parallel a", big, 24, ("dp", "tp"),
             make_sharded_device_train_step, gpt_param_specs(None, big),
             init_gpt_params, {}),
            ("parallel e", moe, 8, ("dp", "ep"), make_ep_device_train_step,
             moe_param_specs(moe), init_moe_params,
             {"LINALG_TPU_FUSED_LN": "1"})):
        mesh = make_mesh((2, 4), names, ["cuda"] * 8)
        with switches(**env):
            rp = shard_tree(init(cfg, seed=0, device="cuda"), specs, mesh)
            ro = [adamw_init(p) for p in rp]
            step = make(cfg, mesh, B, **kw)
            gen = torch.Generator(device="cuda").manual_seed(0)
            for _ in range(3):
                rp, ro, gen, _ = step(rp, ro, data, gen)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=PROFILED) as prof:
                t0 = time.perf_counter()
                rp, ro, gen, _ = step(rp, ro, data, gen)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        report_profile(tag, "step (8 ranks on the card)", prof, wall)
        del rp, ro
        torch.cuda.empty_cache()


def profile_engine(ServeEngine, params, cfg, reqs):
    """A ``torch.profiler`` breakdown of one kernel-mode engine run over
    ``reqs`` (run last, as ``profile_step``)."""
    with torch.profiler.profile(activities=PROFILED) as prof:
        _, wall, n_tok, _ = serve_waves(ServeEngine, params, cfg, [reqs],
                                        paged_attn="kernel")
    report_profile("engine", f"kernel-mode run ({len(reqs)} requests, "
                   f"{n_tok} tokens)", prof, wall * 1e3)


def stream_phase():
    """Phase 9: the flash kernels with K4's band and grouped K/V against
    their plain versions. Returns the record of the long_window shape."""
    from linalg_tpu_torch.kernels.flash_attention import (
        flash_delta_cuda, flash_dkdv_cuda, flash_dq_cuda, flash_fwd_cuda)
    from linalg_tpu_torch.nn.flash_stream import (stream_bwd_ref,
                                                  stream_fwd_ref)

    counters = (flash_fwd_cuda, flash_dq_cuda, flash_dkdv_cuda)
    record = None
    for i, (B, H, hk, T, d, dtype, window, causal) in enumerate([
            (8, 4, 2, 4096, 128, torch.bfloat16, 512, True),  # long_window
            (2, 4, 2, 4096, 128, torch.float32, 512, True),
            (1, 4, 4, 8192, 128, torch.bfloat16, None, True),
            (2, 4, 1, 1024, 128, torch.bfloat16, 300, False)]):
        rng = np.random.default_rng(300 + i)
        q, k, v, do = (torch.tensor(rng.standard_normal(shape), dtype=dtype,
                                    device="cuda")
                       for shape in ((B, H, T, d), (B, hk, T, d),
                                     (B, hk, T, d), (B, H, T, d)))
        g = H // hk

        def kernel_fwd(q, k, v):
            return flash_fwd_cuda(q, k, v, causal, window, g)

        def kernel_fb(q, k, v, do):
            o, L = flash_fwd_cuda(q, k, v, causal, window, g)
            delta = flash_delta_cuda(o, do)
            return (flash_dq_cuda(q, k, v, do, L, delta, causal, window, g),
                    flash_dkdv_cuda(q, k, v, do, L, delta, causal, window,
                                    g))

        def plain_fwd(q, k, v):
            return stream_fwd_ref(q, k, v, causal, window)

        def plain_fb(q, k, v, do):
            o, L = stream_fwd_ref(q, k, v, causal, window)
            return stream_bwd_ref(q, k, v, o, L, do, causal, window)

        for c in counters:
            c.launches = 0
        o, L = kernel_fwd(q, k, v)
        o_ref, L_ref = plain_fwd(q, k, v)
        delta = torch.sum(do.float() * o_ref.float(), dim=-1)
        dq = flash_dq_cuda(q, k, v, do, L_ref, delta, causal, window, g)
        dk, dv = flash_dkdv_cuda(q, k, v, do, L_ref, delta, causal, window,
                                 g)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        if launches != [1, 1, 1] or dk.shape != k.shape:
            raise RuntimeError(f"stream: launches {launches}, dk "
                               f"{tuple(dk.shape)} for k {tuple(k.shape)}")
        want = stream_bwd_ref(q, k, v, o_ref, L_ref, do, causal, window)
        dt = str(dtype).split(".")[1]
        name = (f"B,H,hk,T,d={B},{H},{hk},{T},{d} {dt} window {window} "
                f"{'causal' if causal else 'no causal ban'}")
        err = flash_compare(name, [
            ("o", o, o_ref), ("L", L, L_ref), ("dq", dq, want[0]),
            ("dk", dk, want[1]), ("dv", dv, want[2])], dtype, "stream")
        del o, L, o_ref, L_ref, delta, dq, dk, dv, want
        torch.cuda.empty_cache()
        ms_f = median_ms(kernel_fwd, (q, k, v), trials=7, reps=3)
        ms_fb = median_ms(kernel_fb, (q, k, v, do), trials=7, reps=3)
        plain_f = median_ms(plain_fwd, (q, k, v), trials=3, reps=2, warm=1)
        plain_fb_ms = median_ms(plain_fb, (q, k, v, do), trials=3, reps=2,
                                warm=1)
        lib_f, lib_fb = library_ms(q, k, v, do, causal, window)
        bms, by = attn_bound(B, H, hk, T, d, dtype, causal, window)
        phase("stream", f"  launches fwd/dq/dkdv {launches}; kernel fwd "
              f"{ms_f:.4f} ms, fwd+bwd {ms_fb:.4f} ms; plain fwd "
              f"{plain_f:.4f} ms, fwd+bwd {plain_fb_ms:.4f} ms; "
              f"F.scaled_dot_product_attention fwd {lib_f:.4f} ms, "
              f"fwd+bwd {lib_fb:.4f} ms; bound fwd+bwd {bms:.4f} ms ({by}); "
              + against_library(ms_fb, lib_fb, bms))
        if i == 0:
            record = dict(shape=[B, H, hk, T, d], window=window,
                          max_abs_err=err, ms=ms_fb, plain_ms=plain_fb_ms,
                          library_ms=lib_fb, bound_ms=bms, bound_by=by,
                          fwd_ms=ms_f, plain_fwd_ms=plain_f,
                          library_fwd_ms=lib_f)
        del q, k, v, do
        torch.cuda.empty_cache()
    return record


def long_step_flops(cfg, batch):
    """Operations of one fwd+bwd long_window step, counted out: per token
    and layer the Q and O projections (2 D^2 each), the narrower K/V
    projections (2 D KD each, KD = kv_heads d_head), the up, gate and
    down FFN products (2 D F each; the gate only for a gated FFN) and
    attention at the band's mean visible keys per query (4 D of them: Q K^T
    and P V); the tied head 2 D V; backward twice the forward."""
    D, T, F = cfg.d_model, cfg.ctx_len, cfg.dff
    KD = cfg.kv_heads * cfg.d_head
    keys = attn_live_pairs(T, True, cfg.window) / T
    per_layer = (4 * D * D + 4 * D * KD + (3 if cfg.gated_ffn else 2)
                 * 2 * D * F + 4 * D * keys)
    fwd = batch * T * (cfg.n_layers * per_layer + 2 * D * cfg.vocab_size)
    return 3 * fwd


def long_phase(smi):
    """Phase 10: long-context training through the stream kernels. Returns
    the flash launch counts of the long_window run, its config and batch
    size, and its trained (params, stoi, itos)."""
    from linalg_tpu_torch.apps.gpt import build_parser
    from linalg_tpu_torch.kernels import flash_attention as kfa
    from linalg_tpu_torch.models.gpt import (GPTConfig, _pick_attn_cfg,
                                             init_gpt_params)
    from linalg_tpu_torch.nn import flash as nn_flash
    from linalg_tpu_torch.nn.flash import flash_attention_ref
    from linalg_tpu_torch.train.optim import adamw_init
    from linalg_tpu_torch.train.trainer import make_device_train_step, train

    counters = (kfa.flash_fwd_cuda, kfa.flash_dq_cuda, kfa.flash_dkdv_cuda,
                kfa.flash_delta_cuda)
    dispatch = nn_flash.flash_fwd
    seen = set()

    def spy(q, k, v, causal=True, window=None, scale=None):
        """Records the head counts and window the attention Function hands
        the forward dispatcher, which passes them on to the kernel."""
        seen.add((q.shape[1], k.shape[1], window, q.is_cuda))
        return dispatch(q, k, v, causal, window, scale)

    with tempfile.TemporaryDirectory() as tmp:
        log = f"{tmp}/metrics.jsonl"
        args = build_parser().parse_args(
            ["--train", *LONG_WINDOW, "--ckpt_dir", f"{tmp}/ck",
             "--log_file", log, "--device", "cuda"])
        torch.cuda.reset_peak_memory_stats()
        nn_flash.flash_fwd = spy
        try:
            for c in counters:
                c.launches = 0
            params, cfg, stoi, itos = train(args)
            torch.cuda.synchronize()
            launches = [c.launches for c in counters]
        finally:
            nn_flash.flash_fwd = dispatch
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = [json.loads(ln) for ln in open(log, encoding="utf-8")]
        n_eval = sum(r["event"] == "eval" for r in rows)
        want = [cfg.n_layers * (args.steps + n_eval * EVAL_BATCHES)] + [
            cfg.n_layers * args.steps] * 3
        phase("long", f"long_window: flash launches fwd/dq/dkdv/delta "
              f"{launches}, "
              f"expected {want} ({cfg.n_layers} layers x ({args.steps} "
              f"steps + {n_eval} evals x {EVAL_BATCHES} batches) forward, "
              f"{cfg.n_layers} x {args.steps} backward); (H, hk, window, "
              f"on the card) at the kernel: {sorted(seen)}")
        if launches != want:
            raise RuntimeError("long_window launch counts differ from the "
                               "run")
        if seen != {(cfg.n_heads, cfg.kv_heads, cfg.window, True)} or (
                cfg.kv_heads != 2):
            raise RuntimeError("long_window: the kernel did not get the "
                               "grouped (hk 2) K/V and the window")
        losses = [r.get("loss", r.get("val_loss")) for r in rows
                  if r["event"] in ("train", "eval")]
        phase("long", f"losses (train at steps 1, 20, 40; val at 20, 40): "
              f"{losses}")
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError("a long_window loss is not finite")
        t = {(r["event"], r["step"]): r["elapsed_s"] for r in rows
             if "step" in r}
        ms = (t[("train", 40)] - t[("eval", 20)]) / 20 * 1e3
        tok_s = args.batch_size * cfg.ctx_len / (ms * 1e-3)
        tflops = long_step_flops(cfg, args.batch_size) / (ms * 1e-3) / 1e12
        phase("long", f"long_window steady state (steps 21-40): {ms:.2f} "
              f"ms/step, {tok_s:.0f} tok/s, {tflops:.1f} TFLOP/s, mfu "
              f"{tflops / H100_BF16_TFLOPS:.4f} of {H100_BF16_TFLOPS:.0f} "
              f"TFLOP/s (long_step_flops: "
              f"{long_step_flops(cfg, args.batch_size) / 1e12:.3f} TFLOP a "
              f"step); peak memory {peak_gb:.2f} GB; {smi}")
        saved, cfg2, same = checkpoint_reloads(f"{tmp}/ck", rows, params,
                                               cfg, stoi, itos)
        same = same and cfg2.window == 512
        phase("long", f"checkpoint saved at steps {saved}, reloaded equal to "
              f"the trained params, window {cfg2.window}: {same}")
        if not same:
            raise RuntimeError("the long_window checkpoint does not reload "
                               "equal")
    trained = (params, stoi, itos)  # phase 18 samples and serves it
    del params
    torch.cuda.empty_cache()

    def plain(q, k, v, mask):  # the same band through the plain versions
        return flash_attention_ref(q, k, v, True, cfg.window)

    plain.gqa_native = True
    one_step_check("long", cfg, args.batch_size, plain)

    # T 8192 with no window: _pick_attn streams (K4) past 4096
    c8 = GPTConfig(vocab_size=cfg.vocab_size, d_model=512, n_heads=4,
                   n_layers=2, ctx_len=8192, dtype="bfloat16")
    pick = _pick_attn_cfg(c8, c8.ctx_len, "cuda")
    p = init_gpt_params(c8, seed=0, device="cuda")
    step = make_device_train_step(c8, 1, base_lr=3e-4, min_lr=3e-5,
                                  warmup=200, max_steps=10000,
                                  weight_decay=0.01)
    data = torch.tensor(np.random.default_rng(1).integers(
        0, c8.vocab_size, 100_000), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    p, _, _, loss = step(p, adamw_init(p), data, gen)
    loss = float(loss)
    first_ms = (time.perf_counter() - t0) * 1e3
    n8 = [c.launches for c in counters]
    phase("long", f"ctx 8192 (d512, 4 heads, 2 layers, batch 1, bf16): pick "
          f"gqa_native={getattr(pick, 'gqa_native', False)}, launches "
          f"fwd/dq/dkdv/delta {n8}, loss {loss:.4f}, first step "
          f"{first_ms:.1f} ms")
    if n8 != [2, 2, 2, 2] or not getattr(pick, "gqa_native", False) or (
            not math.isfinite(loss)):
        raise RuntimeError("the ctx-8192 step did not stream through the "
                           "kernels")
    launches = [a + b for a, b in zip(launches, n8)]
    del p
    torch.cuda.empty_cache()
    return launches, cfg, args.batch_size, trained


def btd_phase():
    """Phase 11: K7, the flash kernels on head views of (B, T, H*d)
    tensors, against the plain versions. Returns the record of the
    published shape in bf16 (phase 13's batch 128)."""
    from linalg_tpu_torch.kernels.flash_attention import (
        flash_delta_cuda, flash_dkdv_cuda, flash_dq_cuda, flash_fwd_cuda)
    from linalg_tpu_torch.nn import flash_btd as fb

    def kernel_fb(q, k, v, do, H):
        o, L = fb._btd_fwd(q, k, v, H, True)
        return fb._btd_bwd(q, k, v, o, L, do, H, True)

    def plain_fb(q, k, v, do, H):
        o, L = fb.btd_fwd_ref(q, k, v, H)
        return fb.btd_bwd_ref(q, k, v, o, L, do, H)

    counters = (flash_fwd_cuda, flash_dq_cuda, flash_dkdv_cuda,
                flash_delta_cuda)
    record = None
    for i, ((B, T, H, d), dtype) in enumerate([
            ((128, 256, 4, 128), torch.bfloat16),
            ((128, 256, 4, 128), torch.float32),
            ((2, 64, 2, 128), torch.float32)]):
        q, k, v, do = flash_case((B, T, H * d), dtype, seed=400 + i)
        for c in counters:
            c.launches = 0
        o, L = fb._btd_fwd(q, k, v, H, True)
        o_ref, L_ref = fb.btd_fwd_ref(q, k, v, H)
        # the backward kernels from the plain forward's o and L
        dq, dk, dv = fb._btd_bwd(q, k, v, o_ref, L_ref, do, H, True)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        if launches != [1, 1, 1, 1] or o.shape != q.shape or not (
                o.is_contiguous() and dq.is_contiguous()):
            raise RuntimeError(f"btd: launches {launches}, o "
                               f"{tuple(o.shape)}; outputs must come back "
                               "in (B, T, H*d)")
        want = fb.btd_bwd_ref(q, k, v, o_ref, L_ref, do, H)
        dt = str(dtype).split(".")[1]
        err = flash_compare(f"B,T,H,d={B},{T},{H},{d} {dt}", [
            ("o", o, o_ref), ("L", L, L_ref), ("dq", dq, want[0]),
            ("dk", dk, want[1]), ("dv", dv, want[2])], dtype, "btd")
        del o, L, o_ref, L_ref, dq, dk, dv, want
        ms_f = median_ms(fb._btd_fwd, (q, k, v, H, True), trials=7, reps=5)
        ms_fb = median_ms(kernel_fb, (q, k, v, do, H), trials=7, reps=5)
        plain_fb_ms = median_ms(plain_fb, (q, k, v, do, H), trials=5,
                                reps=2, warm=1)
        heads = [fb._heads(t, H) for t in (q, k, v, do)]
        lib_f, lib_fb = library_ms(*heads, True, None)
        bms, by = attn_bound(B, H, H, T, d, dtype)
        phase("btd", f"  kernel fwd {ms_f:.4f} ms, fwd+bwd {ms_fb:.4f} ms; "
              f"plain fwd+bwd {plain_fb_ms:.4f} ms; "
              f"F.scaled_dot_product_attention on the head views fwd "
              f"{lib_f:.4f} ms, fwd+bwd {lib_fb:.4f} ms; bound fwd+bwd "
              f"{bms:.4f} ms ({by}); " + against_library(ms_fb, lib_fb, bms))
        if i == 0:
            record = dict(shape=[B, T, H, d], max_abs_err=err, ms=ms_fb,
                          plain_ms=plain_fb_ms, library_ms=lib_fb,
                          bound_ms=bms, bound_by=by, fwd_ms=ms_f,
                          library_fwd_ms=lib_f)
        del q, k, v, do, heads
        torch.cuda.empty_cache()
    return record


def fused_bound(N, D, F, dtype):
    """Bounds of K8 and K9, forward+backward each: ((ms, by) of ln_qkv,
    (ms, by) of ln_ffn, (flops, bytes) of both). Operations: 2 per
    multiply-add of each product without recomputation (ln_qkv 3 forward,
    3 dxn and 3 dW products of N D^2; ln_ffn 2 forward and dW2, da, dW1,
    dxn of N D F). Bytes: every input read once and every output written
    once in the io dtype (ln_qkv x, g, b, Wq, Wk, Wv, dq, dk, dv in; q, k,
    v, dx, dg, db, dWq, dWk, dWv out; ln_ffn x, g, b, W1, b1, W2, b2, df
    in; f, dx, dg, db, dW1, db1, dW2, db2 out)."""
    es = torch.tensor([], dtype=dtype).element_size()
    qkv = (18 * N * D * D, es * (8 * N * D + 6 * D * D + 4 * D))
    ffn = (12 * N * D * F, es * (4 * N * D + 4 * D * F + 2 * F + 6 * D))
    both = (qkv[0] + ffn[0], qkv[1] + ffn[1])
    return bound_ms(*qkv, dtype), bound_ms(*ffn, dtype), both


def fused_error(got, want, dtype, what):
    """(error, tolerance, kind) of one output: max abs against a share of
    max|want|; the outputs of K9's backward behind the ReLU mask by the
    relative norm instead (a z within the sums' rounding of 0 may take the
    other side of the ReLU in the two versions, moving that dz entry by
    all of da)."""
    g, w = got.float(), want.float()
    if what in ("ffn dx", "ffn dg", "ffn db", "dW1", "db1"):
        return (float(torch.linalg.norm(g - w) / torch.linalg.norm(w)),
                FUSED_RTOL_OF_NORM[dtype], "rel norm")
    return (float((g - w).abs().max()),
            FUSED_RTOL_OF_MAX[dtype] * max(1.0, float(w.abs().max())),
            "max abs")


def fused_builds(lib):
    """Phase 12's build check: registers, shared memory and spills of every
    fused_layer instantiation; any stack frame or spill fails."""
    import ctypes
    import re

    smem = ctypes.CDLL(str(lib)).fused_smem_bytes
    smem.argtypes = [ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    dyn = {"qkv_fwd_bf16": 0, "ffn_fwd_bf16": 1, "gemm_bf16": 2,
           "ffn_fwd_f32": 3}
    kernels = ptxas_kernels(lib)
    for name, (regs, *frame) in sorted(kernels.items()):
        short = next((k for k in (*dyn, "gemm_f32", "ln_stats", "ln_bwd_dx",
                                  "ln_bwd_dgb") if k in name), name)
        m = re.match(r"I((?:Li\d+E)+)E", name.split(short, 1)[-1])
        args = re.findall(r"Li(\d+)E", m.group(1)) if m else []
        if not args and short.startswith("ln_"):  # ln_*<T>
            args = ["bf16" if "bfloat16" in name else "f32"]
        inst = f"<{', '.join(args)}>" if args else ""
        where = (f", dynamic shared memory {smem(dyn[short], 512)} B at D "
                 f"512, {smem(dyn[short], 1024)} B at D 1024, "
                 f"{smem(dyn[short], 2048)} B at D 2048"
                 if short in dyn else "")
        phase("fused", f"{short}{inst}: {regs} registers{where}, stack frame "
              f"{frame[0]}, spill stores {frame[1]}, loads {frame[2]}")
    spills = ptxas_spills(lib)
    if not kernels or spills:
        raise RuntimeError(f"fused kernels spill registers: {spills}"
                           if spills else "no ptxas lines in the build log")


def fused_phase():
    """Phase 12: K8 and K9 against their plain versions at the published
    width and at train_big's (D 1024, F 4096), bf16 and f32, beside the
    unfused composition and the bound. Returns the kernel's JSON record
    (bf16 at the published width, train_big's width under "d1024")."""
    import torch.nn.functional as F_

    from linalg_tpu_torch.kernels import fused_layer as kf
    from linalg_tpu_torch.nn import fused_layer as fl

    names = ["q", "k", "v", "dx", "dg", "db", "dWq", "dWk", "dWv", "f",
             "ffn dx", "ffn dg", "ffn db", "dW1", "db1", "dW2", "db2"]
    counters = (kf.ln_qkv_fwd_cuda, kf.ln_qkv_bwd_cuda, kf.ln_ffn_fwd_cuda,
                kf.ln_ffn_bwd_cuda)
    records = {}
    for N, D, F in ((64 * 256, 512, 2048), (24 * 1024, 1024, 4096)):
        for dtype in (torch.bfloat16, torch.float32):
            rec = fused_case(N, D, F, dtype, names, counters, kf, fl, F_)
            if dtype == torch.bfloat16:
                records[D] = rec
    return {**records[512], "d1024": records[1024]}


def fused_case(N, D, F, dtype, names, counters, kf, fl, F_):
    """One shape and dtype of phase 12: every output against the plain
    versions, then the times. Returns the JSON record of the shape."""
    rng = np.random.default_rng(500)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.tensor(rng.standard_normal(shape) * scale + shift,
                            dtype=dtype, device="cuda")

    x = t(N, D)
    g, b = t(D, scale=0.1, shift=1.0), t(D, scale=0.1)
    qkv = (x, g, b, *(t(D, D, scale=D ** -0.5) for _ in range(3)))
    ffn = (x, g, b, t(D, F, scale=D ** -0.5), t(F, scale=0.1),
           t(F, D, scale=F ** -0.5), t(D, scale=0.1))
    dys = [t(N, D) for _ in range(3)]
    for c in counters:
        c.launches = 0
    got = [*kf.ln_qkv_fwd_cuda(*qkv), *kf.ln_qkv_bwd_cuda(*qkv, *dys),
           kf.ln_ffn_fwd_cuda(*ffn),
           *kf.ln_ffn_bwd_cuda(*ffn[:6], dys[0])]
    torch.cuda.synchronize()
    if [c.launches for c in counters] != [1, 1, 1, 1]:
        raise RuntimeError("fused: a wrapper did not launch once")
    want = [*fl.ln_qkv_ref(*qkv), *fl.ln_qkv_bwd_ref(*qkv, *dys),
            fl.ln_ffn_ref(*ffn), *fl.ln_ffn_bwd_ref(*ffn[:6], dys[0])]
    errs = {}
    for gt, w, what in zip(got, want, names):
        err, tol, kind = fused_error(gt, w, dtype, what)
        if not (gt.shape == w.shape and err <= tol):
            raise RuntimeError(f"fused {what} at N,D,F={N},{D},{F}: {kind} "
                               f"error {err:.3e} > tolerance {tol:.3e}")
        errs[what] = (err, kind)
    dt = str(dtype).split(".")[1]
    phase("fused", f"N,D,F={N},{D},{F} {dt}: " + ", ".join(
        f"{k} {e:.3e}" for k, (e, _) in errs.items())
        + f" (max abs within {FUSED_RTOL_OF_MAX[dtype]} x max|want|; "
        f"dx, dg, db, dW1, db1 of ln_ffn by relative norm within "
        f"{FUSED_RTOL_OF_NORM[dtype]})")
    del got, want

    def k_qkv(*a):
        return kf.ln_qkv_bwd_cuda(*a[:6], *kf.ln_qkv_fwd_cuda(*a[:6]))

    def p_qkv(*a):
        return fl.ln_qkv_bwd_ref(*a[:6], *fl.ln_qkv_ref(*a[:6]))

    def k_ffn(*a):
        return kf.ln_ffn_bwd_cuda(*a[:6], kf.ln_ffn_fwd_cuda(*a))

    def p_ffn(*a):
        return fl.ln_ffn_bwd_ref(*a[:6], fl.ln_ffn_ref(*a))

    ps = [t_.detach().clone().requires_grad_(True)
          for t_ in qkv + ffn[3:]]

    def u_qkv(x, g, b, wq, wk, wv, *_):
        y = F_.layer_norm(x, (D,), g, b, 1e-5)
        outs = (y @ wq, y @ wk, y @ wv)
        return torch.autograd.grad(outs, (x, g, b, wq, wk, wv), dys)

    def u_ffn(x, g, b, wq, wk, wv, w1, b1, w2, b2):
        y = F_.layer_norm(x, (D,), g, b, 1e-5)
        f = torch.relu(y @ w1 + b1) @ w2 + b2
        return torch.autograd.grad(f, (x, g, b, w1, b1, w2, b2), dys[0])

    times = {}
    for name, fn, args in (
            ("ln_qkv fwd", kf.ln_qkv_fwd_cuda, qkv),
            ("ln_qkv fwd+bwd", k_qkv, qkv),
            ("ln_qkv plain fwd+bwd", p_qkv, qkv),
            ("ln_qkv unfused fwd+bwd", u_qkv, ps),
            ("ln_ffn fwd", kf.ln_ffn_fwd_cuda, ffn),
            ("ln_ffn fwd+bwd", k_ffn, ffn),
            ("ln_ffn plain fwd+bwd", p_ffn, ffn),
            ("ln_ffn unfused fwd+bwd", u_ffn, ps)):
        slow = "plain" in name
        times[name] = median_ms(fn, args, trials=5 if slow else 7,
                                reps=2 if slow else 5,
                                warm=1 if slow else 3)
    bq, bf, both = fused_bound(N, D, F, dtype)
    phase("fused", "  " + "; ".join(f"{k} {v:.4f} ms"
                                     for k, v in times.items()))
    phase("fused", f"  bound fwd+bwd ln_qkv {bq[0]:.4f} ms ({bq[1]}), "
          f"{bq[0] / times['ln_qkv fwd+bwd']:.1%} of it; ln_ffn "
          f"{bf[0]:.4f} ms ({bf[1]}), "
          f"{bf[0] / times['ln_ffn fwd+bwd']:.1%} of it; no single "
          "library call computes either function")
    bms, by = bound_ms(*both, dtype)
    record = dict(
        shape=[N, D, F], max_abs_err=max(
            e for e, kind in errs.values() if kind == "max abs"),
        max_rel_norm_err=max(
            e for e, kind in errs.values() if kind == "rel norm"),
        ms=times["ln_qkv fwd+bwd"] + times["ln_ffn fwd+bwd"],
        plain_ms=(times["ln_qkv plain fwd+bwd"]
                  + times["ln_ffn plain fwd+bwd"]),
        bound_ms=bms, bound_by=by, library_ms=None,
        unfused_ms=(times["ln_qkv unfused fwd+bwd"]
                    + times["ln_ffn unfused fwd+bwd"]),
        ms_by_kernel={k: v for k, v in times.items()})
    del qkv, ffn, dys, ps, x
    torch.cuda.empty_cache()
    return record


@contextlib.contextmanager
def switches(**values):
    """Set the gate switches (``SWITCHES``) to ``values`` for the block,
    unset the others, and restore them all after."""
    with mock.patch.dict(os.environ):
        for name in SWITCHES:
            os.environ.pop(name, None)
        os.environ.update(values)
        yield


def short_phase(smi):
    """Phase 13: the published config through K7 (batch 128) and K8/K9
    (batch 64, LINALG_TPU_FUSED_LN=1), against the same batches with the
    kernels off. Returns the launches of the kernel runs ({"btd": [fwd, dq,
    dkdv, delta], "fused": [qkv fwd, qkv bwd, ffn fwd, ffn bwd]}) and the
    config and batch of the profiled steps."""
    from linalg_tpu_torch.apps.gpt import build_parser
    from linalg_tpu_torch.kernels import fused_layer as kf
    from linalg_tpu_torch.kernels.flash_attention import (
        flash_delta_cuda, flash_dkdv_cuda, flash_dq_cuda, flash_fwd_cuda)
    from linalg_tpu_torch.train.trainer import train

    flash = (flash_fwd_cuda, flash_dq_cuda, flash_dkdv_cuda,
             flash_delta_cuda)
    fused = (kf.ln_qkv_fwd_cuda, kf.ln_qkv_bwd_cuda, kf.ln_ffn_fwd_cuda,
             kf.ln_ffn_bwd_cuda)
    runs = [("btd", 128, {}), ("fused", 64, {"LINALG_TPU_FUSED_LN": "1"}),
            ("btd off", 128, {"LINALG_TPU_BTD_ATTN": "0"}),
            ("fused off", 64, {})]
    totals = {"btd": [0, 0, 0, 0], "fused": [0, 0, 0, 0]}
    ms = {}
    cfgs = {}
    for dtype in ("bfloat16", "float32"):
        for name, batch, env in runs:
            with tempfile.TemporaryDirectory() as tmp, switches(**env):
                log = f"{tmp}/metrics.jsonl"
                args = build_parser().parse_args(
                    ["--train", *SHORT, "--dtype", dtype, "--batch_size",
                     str(batch), "--ckpt_dir", f"{tmp}/ck", "--log_file",
                     log, "--device", "cuda"])
                torch.cuda.reset_peak_memory_stats()
                for c in flash + fused:
                    c.launches = 0
                _, cfg, _, _ = train(args)
                torch.cuda.synchronize()
                n_flash = [c.launches for c in flash]
                n_fused = [c.launches for c in fused]
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                rows = [json.loads(ln) for ln in open(log, encoding="utf-8")]
            n_eval = sum(r["event"] == "eval" for r in rows)
            L, steps = cfg.n_layers, args.steps
            fwd = L * (steps + n_eval * EVAL_BATCHES)
            want_flash, want_fused = [0, 0, 0, 0], [0, 0, 0, 0]
            if name == "btd":
                want_flash = [fwd, L * steps, L * steps, L * steps]
            elif name == "fused":
                want_fused = [fwd, L * steps, fwd, L * steps]
            losses = [r.get("loss", r.get("val_loss")) for r in rows
                      if r["event"] in ("train", "eval")]
            t = {(r["event"], r["step"]): r["elapsed_s"] for r in rows
                 if "step" in r}
            # steps 21..40: from the end of the step-20 eval to the step-40
            # sync
            ms[dtype, name] = (t[("train", 40)] - t[("eval", 20)]) / 20 * 1e3
            tok_s = batch * cfg.ctx_len / (ms[dtype, name] * 1e-3)
            phase("short", f"{dtype} B {batch} {name}: launches flash "
                  f"fwd/dq/dkdv/delta {n_flash} (expected {want_flash}), "
                  f"fused "
                  f"qkv fwd/bwd, ffn fwd/bwd {n_fused} (expected "
                  f"{want_fused}; {L} layers x ({steps} steps + {n_eval} "
                  f"evals x {EVAL_BATCHES} batches) forward, {L} x {steps} "
                  f"backward); losses {losses}; {ms[dtype, name]:.2f} "
                  f"ms/step, {tok_s:.0f} tok/s, peak {peak_gb:.2f} GB")
            if n_flash != want_flash or n_fused != want_fused:
                raise RuntimeError(f"short {name}: launch counts differ")
            if not all(math.isfinite(v) for v in losses):
                raise RuntimeError(f"short {name}: a loss is not finite")
            if name in totals:
                got = n_flash if name == "btd" else n_fused
                totals[name] = [a + b for a, b in zip(totals[name], got)]
                cfgs[name] = (cfg, batch)
        for name in ("btd", "fused"):
            on, off = ms[dtype, name], ms[dtype, name + " off"]
            phase("short", f"{dtype} A/B {name}: kernels {on:.2f} vs off "
                  f"{off:.2f} ms/step ({off / on:.3f}x); {smi}")

    # one step through the kernels against the plain versions
    from linalg_tpu_torch.models import gpt as tgpt
    from linalg_tpu_torch.nn import fused_layer as fl
    from linalg_tpu_torch.nn.flash_btd import attention_btd_ref

    def plain_btd(B, T, c, device_type):
        return lambda q, k, v: attention_btd_ref(q, k, v, c.n_heads, True)

    with switches():
        one_step_check("short", cfgs["btd"][0], 128, None,
                       [(tgpt, {"_pick_attn_btd": plain_btd})], flash)
    with switches(LINALG_TPU_FUSED_LN="1"):
        one_step_check(
            "short", cfgs["fused"][0], 64, None,
            [(tgpt, {"ln_qkv": lambda *a: fl.ln_qkv(*a, plain=True),
                     "ln_ffn": lambda *a: fl.ln_ffn(*a, plain=True)})],
            fused)
    return totals, cfgs


def ring_run(x, n, plain=False, devices=None, **kw):
    """(o, L, dq, dk, dv) of the ring over n ranks sharing the card (or on
    ``devices``): ``ring_attention_pallas_local`` and its backward, through
    K10/K11 or (``plain``) their plain versions; the backward from the
    forward's own o and L and the cotangent x[3]."""
    from linalg_tpu_torch.parallel import make_mesh
    from linalg_tpu_torch.parallel.ring_pallas import (
        ring_attention_pallas_bwd_local, ring_attention_pallas_local)

    q, k, v, do = x
    mesh = make_mesh((n,), ("sp",), devices or ["cuda"] * n)
    o, L = ring_attention_pallas_local(q, k, v, mesh=mesh, with_lse=True,
                                       plain=plain, **kw)
    delta = torch.sum(do.float() * o.float(), dim=-1)
    return (o, L) + ring_attention_pallas_bwd_local(
        q, k, v, do, L, delta, mesh=mesh, plain=plain, **kw)


def ring_bound(B, h, T, d, dtype, causal, window, what):
    """Bound of the attention the ring computes, as ``attn_bound`` counts
    it: forward (``what`` "fwd": 4 d operations per visible pair; q, k, v
    read, o and L written) or backward ("bwd": 8 d per pair; q, k, v, dO,
    L, delta read, dq, dk, dv written). With the ranks on one card no chunk
    has to move, and the kernels move none."""
    pairs = B * h * attn_live_pairs(T, causal, window)
    es = torch.tensor([], dtype=dtype).element_size()
    x = B * h * T * d
    if what == "fwd":
        return bound_ms(4 * d * pairs, es * 4 * x + 4 * B * h * T, dtype)
    return bound_ms(8 * d * pairs, es * 7 * x + 8 * B * h * T, dtype)


def ptxas_kernels(lib):
    """{kernel: (registers, stack frame, spill store, spill load bytes)} of
    every kernel of a built library, from its ``-Xptxas -v`` log."""
    out, name, frame = {}, None, None
    for ln in lib.with_suffix(".log").read_text().splitlines():
        if "Function properties for" in ln:
            name = ln.split("Function properties for")[1].strip()
        elif "bytes stack frame" in ln and name:
            frame = tuple(int(w) for w in ln.replace(",", " ").split()
                          if w.isdigit())[:3]
        elif "Used" in ln and "registers" in ln and name and frame:
            out[name] = (int(ln.split("Used")[1].split()[0]),) + frame
            name = frame = None
    return out


def ptxas_spills(lib):
    """{kernel: (stack frame, spill store, spill load bytes)} of every
    kernel of a built library with any of the three above 0."""
    return {k: v[1:] for k, v in ptxas_kernels(lib).items() if any(v[1:])}


def flash_builds(lib):
    """Phase 7's build check: registers, dynamic shared memory and spills
    of every flash_attention instantiation, and ptxas's notes on wgmma and
    setmaxnreg; any stack frame or spill fails."""
    import re

    from linalg_tpu_torch.kernels.flash_attention import smem_bytes

    for ln in lib.with_suffix(".log").read_text().splitlines():
        if "wgmma" in ln or "setmaxnreg" in ln:
            phase("flash", f"ptxas: {ln.strip()}")
    kernels = ptxas_kernels(lib)
    for name, (regs, *frame) in sorted(kernels.items()):
        m = re.search(r"(fwd|dq|dkdv)_(bf16|f32)I((?:Li\d+E)+)E", name)
        if not m:
            continue
        args = re.findall(r"Li(\d+)E", m.group(3))
        which = ("fwd", "dq", "dkdv").index(m.group(1))
        smem = smem_bytes(int(m.group(2) == "bf16"), int(args[0]), which)
        phase("flash", f"{m.group(1)}_{m.group(2)}<{', '.join(args)}>: "
              f"{regs} registers, {smem} bytes of shared memory, stack "
              f"frame {frame[0]}, spill stores {frame[1]}, loads {frame[2]}")
    spills = ptxas_spills(lib)
    if not kernels or spills:
        raise RuntimeError(f"flash kernels spill registers: {spills}"
                           if spills else "no ptxas lines in the build log")


def ring_phase(built):
    """Phase 14: K10 and K11 against their plain versions at the sp runs'
    shapes and beside them. Returns the records of K10 and K11 at
    long_window's shape (bf16, with train_big's times beside)."""
    from linalg_tpu_torch.kernels import ring_attention as kr
    from linalg_tpu_torch.nn.positional import alibi_slopes
    from linalg_tpu_torch.parallel import make_mesh
    from linalg_tpu_torch.parallel.ring_pallas import (
        ring_attention_pallas_bwd_local, ring_attention_pallas_local)

    spills = ptxas_spills(built[0])
    phase("ring", f"ptxas: {len(spills)} kernels with a stack frame or "
          f"spills{f' {spills}' if spills else ''}")
    if spills:
        raise RuntimeError("ring kernels spill registers")
    records = None
    for i, (name, B, h, T, d, n, dtype, causal, window, alibi) in enumerate([
            ("long_window", 8, 4, 4096, 128, SP, torch.bfloat16, True, 512,
             False),
            ("long_window f32", 8, 4, 4096, 128, SP, torch.float32, True,
             512, False),
            ("train_big", 24, 8, 1024, 128, SP, torch.bfloat16, True, None,
             False),
            ("alibi", 4, 8, 2048, 64, SP, torch.bfloat16, True, None, True),
            ("no causal ban", 2, 4, 2048, 128, SP, torch.float32, False, None,
             False),
            ("n 2", 4, 4, 2048, 128, 2, torch.bfloat16, True, None, False),
            ("n 8", 4, 4, 4096, 128, 8, torch.bfloat16, True, 512, False),
            ("ragged T 1000", 2, 4, 1000, 128, SP, torch.float32, True, None,
             False)]):
        rng = np.random.default_rng(1400 + i)
        x = [torch.tensor(rng.standard_normal((B, h, T, d)), dtype=dtype,
                          device="cuda") for _ in range(4)]
        kw = dict(causal=causal, window=window,
                  slopes=tuple(alibi_slopes(h).tolist()) if alibi else None)
        kr.ring_fwd_cuda.launches = kr.ring_bwd_cuda.launches = 0
        got = ring_run(x, n, **kw)
        torch.cuda.synchronize()
        launches = [kr.ring_fwd_cuda.launches, kr.ring_bwd_cuda.launches]
        if launches != [1, 1]:
            raise RuntimeError(f"ring {name}: launches {launches}, expected "
                               "one call per direction [1, 1]")
        want = ring_run(x, n, plain=True, **kw)
        dt = str(dtype).split(".")[1]
        label = (f"{name} B,h,T,d,n={B},{h},{T},{d},{n} {dt}"
                 f"{f' window {window}' if window else ''}"
                 f"{' alibi' if alibi else ''}")
        errs = [flash_compare(label, [(w, g, r) for w, g, r in zip(
            ("o", "L"), got[:2], want[:2])], dtype, "ring"),
                flash_compare(label, [(w, g, r) for w, g, r in zip(
                    ("dq", "dk", "dv"), got[2:], want[2:])], dtype, "ring")]
        del got, want
        torch.cuda.empty_cache()
        if i < 3:  # the sp runs' shapes and dtypes: times
            mesh = make_mesh((n,), ("sp",), ["cuda"] * n)
            fwd, plain_fwd = (functools.partial(
                ring_attention_pallas_local, mesh=mesh, with_lse=True,
                plain=plain, **kw) for plain in (False, True))
            o, L = fwd(*x[:3])
            delta = torch.sum(x[3].float() * o.float(), dim=-1)

            def bwd(plain):
                return lambda q, k, v, do: ring_attention_pallas_bwd_local(
                    q, k, v, do, L, delta, mesh=mesh, plain=plain, **kw)

            ms_f = median_ms(fwd, x[:3], trials=7, reps=3)
            ms_b = median_ms(bwd(False), x, trials=7, reps=3)
            pl_f = median_ms(plain_fwd, x[:3], trials=3, reps=1, warm=1)
            pl_b = median_ms(bwd(True), x, trials=3, reps=1, warm=1)
            del o, L, delta
            # the gathered sequence's SDPA; its backward alone is the
            # difference of forward+backward and forward
            lib_f, lib_fb = library_ms(*x, causal, window)
            lib_b = lib_fb - lib_f
            bf, byf = ring_bound(B, h, T, d, dtype, causal, window, "fwd")
            bb, byb = ring_bound(B, h, T, d, dtype, causal, window, "bwd")
            phase("ring", f"  K10 fwd {ms_f:.4f} ms, K11 bwd {ms_b:.4f} ms "
                  f"(fwd+bwd {ms_f + ms_b:.4f}); plain fwd {pl_f:.4f}, bwd "
                  f"{pl_b:.4f}; F.scaled_dot_product_attention over the "
                  f"gathered T fwd {lib_f:.4f}, bwd {lib_b:.4f} (fwd+bwd "
                  f"{lib_fb:.4f}); bound fwd {bf:.4f} ({byf}), bwd "
                  f"{bb:.4f} ({byb}): {bf / ms_f:.1%} and {bb / ms_b:.1%} "
                  f"of it")
            rec = [dict(shape=[B, h, T, d, n], window=window,
                        max_abs_err=errs[0], ms=ms_f, plain_ms=pl_f,
                        bound_ms=bf, bound_by=byf, library_ms=lib_f),
                   dict(shape=[B, h, T, d, n], window=window,
                        max_abs_err=errs[1], ms=ms_b, plain_ms=pl_b,
                        bound_ms=bb, bound_by=byb, library_ms=lib_b)]
            if i == 0:
                records = rec
            elif name == "train_big":
                for r_, x_ in zip(records, rec):
                    r_["train_big"] = x_
        del x
        torch.cuda.empty_cache()
    return records


def ring_copies(sessions=3):
    """A ``torch.profiler`` trace of one forward and backward of the ring
    (``ring_run``: the kernel ring's forward, delta, its backward) at
    long_window's shape, bf16: it must hold one K10 launch, K11's dq and
    dk/dv launches, and no device copy (no ``gpu_memcpy`` event): the
    kernels read the chunks in place. The device trace drops a record now
    and then on the chip machine (runs have held the ring's dq and dk/dv
    but not its forward, which the backward reads, or no ring kernel at
    all), so a trace with fewer ring kernels is taken again, up to
    ``sessions`` times; a copy or a fourth ring kernel in any trace fails
    at once, and so does no complete trace."""
    rng = np.random.default_rng(1500)
    x = [torch.tensor(rng.standard_normal((8, 4, 4096, 128)),
                      dtype=torch.bfloat16, device="cuda") for _ in range(4)]
    for _ in range(2):
        ring_run(x, SP, window=512)
    torch.cuda.synchronize()
    for session in range(1, sessions + 1):
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            # a kernel of its own first: the trace can miss a session's
            # first kernel
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            ring_run(x, SP, window=512)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            prof.export_chrome_trace(f"{tmp}/trace.json")
            events = json.load(open(f"{tmp}/trace.json"))["traceEvents"]
        timed = [e for e in events if "dur" in e]
        copies = [e for e in timed if e.get("cat") == "gpu_memcpy"]
        ring = [e["name"] for e in timed if e.get("cat") == "kernel"
                and any(f in e["name"] for f in ("fwd_bf16", "dq_bf16",
                                                   "dkdv_bf16"))]
        phase("ring", f"profiled ring forward+backward (long_window, n "
              f"{SP}, bf16; trace {session} of at most {sessions}): "
              f"{len(ring)} ring kernel launches, {len(copies)} device "
              f"copies ({sum(e['dur'] for e in copies) / 1e3:.4f} ms)")
        if copies or len(ring) > 3:
            raise RuntimeError("the ring's forward+backward must be 3 "
                               f"kernel launches and no copy; got {ring}, "
                               f"{[e['name'] for e in copies]}")
        if len(ring) == 3:
            return
    raise RuntimeError(f"no trace of {sessions} held the ring's 3 kernel "
                       "launches")


RING_TABLE_CASES = (  # phase 14's sp shapes: name, B, h, T, d, n, dtype,
    # window
    ("long_window", 8, 4, 4096, 128, SP, torch.bfloat16, 512),
    ("long_window f32", 8, 4, 4096, 128, SP, torch.float32, 512),
    ("train_big", 24, 8, 1024, 128, SP, torch.bfloat16, None))


def ring_tables_phase():
    """Phase 26: K10/K11 through their per-rank chunk tables. The kernel
    wrappers called on each rank's rows as a tensor of its own (separate
    allocations on the card, heads Tl rows apart) against the same calls
    on the ranks' views of the rank-stacked tensors (heads T rows apart,
    the layout of every one-card ring), at phase 14's sp shapes: outputs
    and gradients bit-equal, one launch per direction each way, CUDA-event
    times of both. With two cards or more, the ring with its ranks over
    two cards against the one-card result."""
    from linalg_tpu_torch.kernels import ring_attention as kr
    from linalg_tpu_torch.parallel.ring_pallas import _heads, _ranks

    counters = (kr.ring_fwd_cuda, kr.ring_bwd_cuda)
    records = {}
    for i, (name, B, h, T, d, n, dtype, window) in enumerate(
            RING_TABLE_CASES):
        rng = np.random.default_rng(2600 + i)
        x = [torch.tensor(rng.standard_normal((B, h, T, d)), dtype=dtype,
                          device="cuda") for _ in range(4)]
        kw = dict(H=h, causal=True, window=window, slopes=None,
                  scale=1.0 / math.sqrt(d))
        qf, kf, vf, dof = (_heads(t, d) for t in x)
        # the forward's L and delta = rowsum(dO * O)
        o_ref, L_ref = ring_run(x, n, window=window)[:2]
        L = L_ref.reshape(B * h, T).contiguous()
        dl = torch.sum(dof.float() * _heads(o_ref, d).float(),
                       dim=-1).contiguous()
        del o_ref, L_ref
        devs = [torch.device("cuda")] * n
        outs = {}
        for layout, cut in (("stacked", lambda t: _ranks(t, n)),
                            ("tables", lambda t: _ranks(t, n, devs))):
            ins = [cut(t) for t in (qf, kf, vf, dof, L, dl)]
            fo = [cut(torch.empty_like(qf)), cut(torch.empty_like(L))]
            bo = [cut(torch.empty_like(qf)) for _ in range(3)]
            for c in counters:
                c.launches = 0
            kr.ring_fwd_cuda(*ins[:3], *fo, **kw)
            kr.ring_bwd_cuda(*ins, *bo, **kw)
            torch.cuda.synchronize()
            launches = [c.launches for c in counters]
            if launches != [1, 1]:
                raise RuntimeError(f"ring tables {name} {layout}: launches "
                                   f"{launches}, expected [1, 1]")
            ms = (median_ms(lambda: kr.ring_fwd_cuda(*ins[:3], *fo, **kw),
                            (), trials=7, reps=3),
                  median_ms(lambda: kr.ring_bwd_cuda(*ins, *bo, **kw), (),
                            trials=7, reps=3))
            outs[layout] = ([torch.cat(t, dim=1) for t in fo + bo], ms)
            del ins, fo, bo
        same = [torch.equal(a, b) for a, b in zip(outs["stacked"][0],
                                                  outs["tables"][0])]
        ms = {k: v[1] for k, v in outs.items()}
        dt = str(dtype).split(".")[1]
        phase("ring tables", f"{name} B,h,T,d,n={B},{h},{T},{d},{n} {dt}"
              f"{f' window {window}' if window else ''}: one tensor per "
              f"rank == views of the stacked tensors bit for bit (o, L, dq, "
              f"dk, dv) {same}; launches [1, 1] each way; K10 stacked "
              f"{ms['stacked'][0]:.4f} ms, tables {ms['tables'][0]:.4f} ms; "
              f"K11 stacked {ms['stacked'][1]:.4f} ms, tables "
              f"{ms['tables'][1]:.4f} ms")
        if not all(same):
            raise RuntimeError(f"ring tables {name}: the per-rank tensors "
                               "differ from the stacked views")
        records[name] = dict(stacked_ms=list(ms["stacked"]),
                             tables_ms=list(ms["tables"]))
        if i == 0 and torch.cuda.device_count() >= 2:
            one = ring_run(x, n, window=window)
            two_cards = ["cuda:0"] * (n // 2) + ["cuda:1"] * (n - n // 2)
            for c in counters:
                c.launches = 0
            two = ring_run(x, n, window=window, devices=two_cards)
            torch.cuda.synchronize()
            launches = [c.launches for c in counters]
            same2 = [torch.equal(a, b) for a, b in zip(one, two)]
            phase("ring tables", f"{name} over cuda:0 and cuda:1 ({n // 2} "
                  f"ranks each): launches {launches} (one a card and "
                  f"direction), == one card bit for bit {same2}")
            if launches != [2, 2] or not all(same2):
                raise RuntimeError("ring tables: the two-card ring differs")
            del one, two
        elif i == 0:
            phase("ring tables", f"{torch.cuda.device_count()} card: the "
                  "ring across cards (peer reads of another card's chunks) "
                  "was not run")
        del x, outs
        torch.cuda.empty_cache()
    return records


def sp_phase(smi):
    """Phase 15: sequence-parallel training through train.trainer.train
    with --sp 4: long_window 40 steps and train_big's widths at 2 layers
    20 steps. Returns {"fwd": K10 launches, "bwd": K11 launches, and per
    run {"loss1": step-1 loss, "ms": ms/step}}."""
    from linalg_tpu_torch.apps.gpt import build_parser
    from linalg_tpu_torch.kernels import ring_attention as kr
    from linalg_tpu_torch.parallel import make_mesh, ring as plain_ring
    from linalg_tpu_torch.parallel.sharding import _sp_ring
    from linalg_tpu_torch.train.checkpoint import load_ckpt
    from linalg_tpu_torch.train.optim import tree_leaves
    from linalg_tpu_torch.train.trainer import train

    counters = (kr.ring_fwd_cuda, kr.ring_bwd_cuda)
    plain_calls = []
    local = plain_ring.ring_attention_local
    totals = {"fwd": 0, "bwd": 0}
    big2 = list(TRAIN_BIG)
    big2[big2.index("--layers") + 1] = "2"
    big2[big2.index("--steps") + 1] = "20"
    for name, argv, flops in (
            ("long_window", LONG_WINDOW, long_step_flops),
            ("train_big 2 layers", big2, None)):
        with tempfile.TemporaryDirectory() as tmp:
            log = f"{tmp}/metrics.jsonl"
            args = build_parser().parse_args(
                ["--train", *argv, "--sp", str(SP), "--ckpt_dir", f"{tmp}/ck",
                 "--log_file", log, "--device", "cuda"])
            torch.cuda.reset_peak_memory_stats()
            for c in counters:
                c.launches = 0
            with patched((plain_ring, {
                    "ring_attention_local": lambda *a, **k: plain_calls.append(
                        1) or local(*a, **k)})):
                params, cfg, _, _ = train(args)
            torch.cuda.synchronize()
            launches = [c.launches for c in counters]
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            rows = [json.loads(ln) for ln in open(log, encoding="utf-8")]
            n_eval = sum(r["event"] == "eval" for r in rows)
            want = [cfg.n_layers * (args.steps + n_eval * SP_EVAL_BATCHES),
                    cfg.n_layers * args.steps]
            phase("sp", f"{name} --sp {SP}: K10/K11 launches {launches}, "
                  f"expected {want} (one ring call per layer: "
                  f"{cfg.n_layers} layers x ({args.steps} steps + {n_eval} "
                  f"evals x {SP_EVAL_BATCHES} batches) forward, x "
                  f"{args.steps} backward); plain ring calls "
                  f"{len(plain_calls)}")
            if launches != want or plain_calls:
                raise RuntimeError(f"sp {name}: launch counts differ, or the "
                                   "plain ring ran")
            totals["fwd"] += launches[0]
            totals["bwd"] += launches[1]
            losses = [r.get("loss", r.get("val_loss")) for r in rows
                      if r["event"] in ("train", "eval")]
            if not all(math.isfinite(v) for v in losses):
                raise RuntimeError(f"sp {name}: a loss is not finite")
            t = {(r["event"], r["step"]): r["elapsed_s"] for r in rows
                 if "step" in r}
            last = args.steps
            ms = (t[("train", last)] - t[("eval", 20)]) / (last - 20) * 1e3 \
                if last > 20 else (t[("train", last)] - t[("train", 1)]) / (
                    last - 1) * 1e3
            tok_s = args.batch_size * cfg.ctx_len / (ms * 1e-3)
            rate = ""
            if flops is not None:
                tf = flops(cfg, args.batch_size) / (ms * 1e-3) / 1e12
                rate = (f", {tf:.1f} TFLOP/s, mfu "
                        f"{tf / H100_BF16_TFLOPS:.4f} of "
                        f"{H100_BF16_TFLOPS:.0f} TFLOP/s")
            window = ("steps 21-40" if last > 20
                      else f"steps 2-{last}, after the first")
            phase("sp", f"{name}: losses (train at steps 1, 20, 40; val at "
                  f"20, 40) {losses}; ({window}) {ms:.2f} ms/step, "
                  f"{tok_s:.0f} tok/s{rate}; peak memory {peak_gb:.2f} GB; "
                  f"{smi}")
            back, cfg2, _, _ = load_ckpt(f"{tmp}/ck", device="cuda")
            same = cfg2 == cfg and all(torch.equal(a, b) for a, b in zip(
                tree_leaves(back), tree_leaves(params)))
            del params, back
            # the single-card run from the same seed draws the same batch
            one = list(argv)
            one[one.index("--steps") + 1] = "1"
            log1 = f"{tmp}/one.jsonl"
            train(build_parser().parse_args(
                ["--train", *one, "--ckpt_dir", f"{tmp}/ck1", "--log_file",
                 log1, "--device", "cuda"]))
            single = json.loads(open(log1, encoding="utf-8").readline())
            d1 = abs(single["loss"] - losses[0])
            phase("sp", f"{name}: checkpoint reloaded equal: {same}; step-1 "
                  f"loss sp {losses[0]:.6f}, single card {single['loss']:.6f}"
                  f" (|diff| {d1:.3e}, bound 1e-2 in bf16)")
            totals[name] = dict(loss1=losses[0], ms=ms)  # phase 28's yardstick
            if not same or not d1 <= 1e-2:
                raise RuntimeError(f"sp {name}: checkpoint or step-1 loss")
        torch.cuda.empty_cache()

        # one step through the ring kernels against the plain ring, at 2
        # layers (the plain ring keeps every (T/n)^2 score block of every
        # step for autograd)
        c2 = dataclasses.replace(cfg, n_layers=2)
        mesh = make_mesh((1, SP), ("dp", "sp"), ["cuda"] * SP)
        kern = _sp_ring(mesh, True, c2)
        plain = _sp_ring(mesh, False, c2)
        one_step_check("sp", c2, args.batch_size, plain, counters=counters,
                       kernel=kern)
        torch.cuda.empty_cache()
    return totals


def timed(fn):
    """(result, seconds) of ``fn()`` on the host's clock, the card drained
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def greedy_by_steps(params, cfg, ctx, steps, chunk=256):
    """An independent greedy stream through ``gpt_decode_step``: the
    argmax of each step's logits, one token at a time, prefilling the last
    ``keep`` ids unpadded whenever fewer than n cache rows are left at the
    start of an n-token stretch (``sample``'s rule)."""
    from linalg_tpu_torch.models.gpt import gpt_decode_step, gpt_prefill

    n = max(1, min(chunk, cfg.ctx_len // 2))
    keep = cfg.ctx_len - n
    ids, out = list(ctx), []
    logits = cache = None
    while len(out) < steps:
        if cache is None or cfg.ctx_len - int(cache["length"]) < n:
            logits, cache = gpt_prefill(params, torch.tensor(
                [ids[-keep:]], device="cuda"), cfg)
        for _ in range(n):
            tok = logits.argmax(-1)
            ids.append(int(tok[0]))
            out.append(ids[-1])
            logits, cache = gpt_decode_step(params, cache, tok, cfg)
    return out[:steps]


def rescored_logprob(params, cfg, prompt, toks):
    """The log-probability of ``toks`` after ``prompt`` from one
    teacher-forced ``gpt_apply`` (float64 sums of its log-softmax)."""
    from linalg_tpu_torch.models.gpt import gpt_apply

    full = torch.tensor([list(prompt) + list(toks)], device="cuda")
    with torch.no_grad():
        logp = torch.log_softmax(gpt_apply(params, full, cfg), -1)[0]
    rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(toks),
                        device="cuda")
    return float(logp[rows, torch.tensor(list(toks), device="cuda")]
                 .double().sum())


def no_sync_chunk(params, cfg, prompt):
    """One 128-token decode chunk (the sampler's loop: filter, draw, step)
    under ``torch.cuda.set_sync_debug_mode("error")``: any host round trip
    inside it, an ``.item()`` or a blocking copy, raises."""
    from linalg_tpu_torch.models.gpt import (_decode_chunk_core,
                                             _dt_decode_ops, gpt_prefill)
    from linalg_tpu_torch.nn.cache import fkv_write

    logits, cache = gpt_prefill(params, torch.tensor([prompt],
                                                     device="cuda"), cfg)
    ops = _dt_decode_ops(params, cfg)
    generator = torch.Generator(device="cuda").manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks = _decode_chunk_core(cfg, ops, logits, cache["k"], cache["v"],
                                  len(prompt), 0, generator, 128, 1.0, 0,
                                  0.0, fkv_write)[0]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    phase("sample", f"a 128-token decode chunk ran with the sync debug mode "
          f"at 'error': no host round trip inside it ({tuple(toks.shape)} "
          f"tokens)")


def sample_phase(smi):
    """Phase 16: the sampling path at the published config
    (``bench.py:329``): ``sample`` and ``gpt_generate`` in f32 and bf16,
    greedy checks in f32, beam search, BPE through the C loops and the
    CLI, and the wide-vocabulary loss. Runs no kernel of its own."""
    from linalg_tpu_torch.models import gpt as tgpt
    from linalg_tpu_torch.models.beam import gpt_generate_beam
    from linalg_tpu_torch.models.gpt import (GPTConfig, gpt_decode_chunk,
                                             gpt_generate, gpt_prefill,
                                             init_gpt_params)
    from linalg_tpu_torch.models.speculative import gpt_generate_speculative
    from linalg_tpu_torch.native import native_available, native_error
    from linalg_tpu_torch.nn.tokenizers import BPETokenizer
    from linalg_tpu_torch.train.data import load_text
    from linalg_tpu_torch.train.trainer import sample

    ident = {i: i for i in range(SAMPLE_CFG["vocab_size"])}  # ids out
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 65, size=(int(L),))
               for L in rng.integers(3, 120, size=(8,))]
    for dtype in ("float32", "bfloat16"):
        cfg = GPTConfig(dtype=dtype, **SAMPLE_CFG)
        params = init_gpt_params(cfg, seed=0, device="cuda")
        list(sample(params, cfg, [1, 2, 3], ident, steps=256, seed=0))
        out, dt = timed(lambda: list(sample(params, cfg, [1, 2, 3], ident,
                                            steps=SAMPLE_TOKENS, seed=1)))
        if len(out) != SAMPLE_TOKENS:
            raise RuntimeError(f"sample gave {len(out)} tokens")
        phase("sample", f"{dtype} sample: {SAMPLE_TOKENS} tokens from "
              f"[1, 2, 3] (rollover every 128) in {dt:.3f} s, "
              f"{SAMPLE_TOKENS / dt:.1f} tok/s; {smi}")
        gpt_generate(params, cfg, prompts, GEN_NEW, seed=0)
        walls = [timed(lambda i=i: gpt_generate(
            params, cfg, prompts, GEN_NEW, seed=i).cpu())[1]
            for i in range(GEN_REPS)]
        wall = float(np.median(walls))
        phase("sample", f"{dtype} gpt_generate: B {len(prompts)} ragged "
              f"prompts of {sorted(len(p) for p in prompts)} ids, {GEN_NEW} "
              f"new each: median {wall:.3f} s of {GEN_REPS}, "
              f"{len(prompts) * GEN_NEW / wall:.1f} tok/s; {smi}")
        gpt_generate_speculative(params, cfg, [1, 2, 3], 16,
                                 n_draft=SPEC_K, top_k=1)
        (spec, rounds), dt = timed(lambda: gpt_generate_speculative(
            params, cfg, [1, 2, 3], SPEC_NEW, n_draft=SPEC_K, top_k=1))
        phase("sample", f"{dtype} gpt_generate_speculative, K {SPEC_K}, "
              f"greedy: {SPEC_NEW} tokens from [1, 2, 3] in {rounds} "
              f"rounds ({SPEC_NEW / rounds:.2f} a round), {dt:.3f} s, "
              f"{SPEC_NEW / dt:.1f} tok/s; {smi}")
        if dtype != "float32":
            continue
        greedy = list(sample(params, cfg, [1, 2, 3], ident, steps=300,
                             top_k=1, seed=2))
        # sample's first chunk (128 tokens) decodes without a rollover
        greedy_equal(f"f32 gpt_generate_speculative == sample's greedy, "
                     f"{SPEC_NEW} tokens", params, cfg, [[1, 2, 3]],
                     [spec.tolist()], [greedy[:SPEC_NEW]], where="sample")
        steps = greedy_by_steps(params, cfg, [1, 2, 3], 300)
        same = greedy == steps
        first = next((i for i, (a, b) in enumerate(zip(greedy, steps))
                      if a != b), None)
        phase("sample", f"f32 greedy sample, 300 tokens (rollovers after "
              f"128 and 256): equal to a gpt_decode_step loop: {same} "
              f"(first difference at {first})")
        if not same:
            raise RuntimeError("greedy sample differs from the step loop")
        batch = gpt_generate(params, cfg, prompts, GEN_NEW, top_k=1).cpu()
        alone = [bool(torch.equal(gpt_generate(
            params, cfg, [p], GEN_NEW, top_k=1).cpu()[0], batch[b]))
            for b, p in enumerate(prompts)]
        phase("sample", f"f32 greedy gpt_generate: each row equal to its "
              f"prompt alone (B 1): {alone}")
        if not all(alone):
            raise RuntimeError("a gpt_generate row differs from its prompt "
                               "alone")
        prompt = [int(t) for t in prompts[0]]
        logits, cache = gpt_prefill(params, torch.tensor(
            [prompt], device="cuda"), cfg)
        g = gpt_decode_chunk(params, cache, logits, torch.Generator(
            device="cuda").manual_seed(0), cfg, BEAM_NEW, 1.0, 1)[0]
        b1, _ = gpt_generate_beam(params, cfg, prompt, BEAM_NEW, beam=1)
        same1 = b1.tolist() == g[0].tolist()
        (toks, score), dt = timed(lambda: gpt_generate_beam(
            params, cfg, prompt, BEAM_NEW, beam=BEAM))
        want = rescored_logprob(params, cfg, prompt, toks)
        rel = abs(score - want) / max(1.0, abs(want))
        phase("sample", f"f32 beam: beam 1 equal to greedy decoding: "
              f"{same1}; beam {BEAM}, {BEAM_NEW} new after {len(prompt)} "
              f"ids in {dt:.3f} s: score {score:.6f}, re-scored by one "
              f"gpt_apply {want:.6f} (|diff| / max(1, |score|) {rel:.3e}, "
              f"bound 1e-4)")
        if not same1 or not rel <= 1e-4:
            raise RuntimeError("beam search: beam 1 or the best score")
        no_sync_chunk(params, cfg, prompt)
        del params
        torch.cuda.empty_cache()

    # -- BPE through the C loops, and through the CLI ----------------------
    if not native_available():
        raise RuntimeError(f"the C library did not build: {native_error()}")
    text = load_text(None)
    tok, dt = timed(lambda: BPETokenizer.train(text, 512))
    head = text[:20000]
    c_merges = BPETokenizer.train(head, 512).merges
    py_merges = BPETokenizer._train_py(head.encode("utf-8"), 512)
    ids, dt_enc = timed(lambda: tok.encode(text))
    back = tok.decode(ids) == text
    phase("sample", f"BPE: C library built; 512-token vocabulary from "
          f"{len(text)} chars in {dt:.3f} s, encoded to {len(ids)} ids in "
          f"{dt_enc:.3f} s, decoded back equal: {back}; C merges == Python "
          f"merges on the first 20,000 chars: {c_merges == py_merges}")
    if not back or c_merges != py_merges:
        raise RuntimeError("BPE: round trip or C vs Python merges")
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        # one process trains, saves, then reloads the checkpoint for the
        # REPL (the CLI runs --train before --repl)
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "linalg_tpu_torch.apps.gpt", "--train",
             "--tokenizer", "bpe", "--vocab_size", "512", *SAMPLE_TRAIN,
             "--repl", "--top_k", "1", "--gen_tokens", "64", "--ckpt_dir",
             f"{tmp}/ck", "--device", "cuda"],
            input="First Citizen:\nBefore we proceed any further\n",
            cwd=root, check=True, capture_output=True, text=True,
            timeout=600)
        wall = time.perf_counter() - t0
    repl_out = res.stdout.partition("REPL — ")[2]
    texts = [p.rstrip("\n") for p in repl_out.split("> ")[1:3]]
    phase("sample", f"CLI: --train --tokenizer bpe --vocab_size 512 (20 "
          f"steps, checkpoint saved) then --repl --top_k 1 --gen_tokens 64 "
          f"on two prompts, one process, {wall:.1f} s: {texts!r}")
    if len(texts) != 2 or not all(t.strip() for t in texts):
        raise RuntimeError(f"the REPL printed no text: {res.stdout!r}")

    # -- the wide-vocabulary loss: chunked against the full logits ---------
    cfg = GPTConfig(**dict(SAMPLE_CFG, vocab_size=WIDE_V))
    params = init_gpt_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(2)
    x, y = (torch.tensor(rng.integers(0, WIDE_V, (WIDE_B, cfg.ctx_len)),
                         device="cuda") for _ in range(2))
    runs = {}
    # "full": gpt_loss's small-vocabulary path, logsumexp over the whole
    # (B*T, V) logits
    for name, threshold in (("chunked", tgpt.CE_CHUNK_THRESHOLD),
                            ("full", WIDE_V + 1)):
        with patched((tgpt, {"CE_CHUNK_THRESHOLD": threshold})):
            loss_and_grads(params, x, y, cfg)
            torch.cuda.reset_peak_memory_stats()
            resident = torch.cuda.memory_allocated()
            (loss, grads), _ = timed(lambda: loss_and_grads(params, x, y,
                                                            cfg))
            # the step's own: what earlier phases left resident is not its
            peak = (torch.cuda.max_memory_allocated() - resident) / 1e9
            ms = float(np.median([timed(lambda: loss_and_grads(
                params, x, y, cfg))[1] for _ in range(3)])) * 1e3
        runs[name] = (loss, grads)
        phase("sample", f"wide vocabulary {name}: V {WIDE_V}, B {WIDE_B} x "
              f"T {cfg.ctx_len}, f32: loss {loss:.6f}, forward + backward "
              f"median {ms:.2f} ms of 3, peak memory {peak:.2f} GB above "
              f"the {resident / 1e9:.2f} GB resident before it; {smi}")
        del grads
    (lc, gc), (lf, gf) = runs["chunked"], runs["full"]
    dl = abs(lc - lf) / abs(lf)
    names = ["/".join(k) for k in leaf_names(params)]
    dg = {n: float((a - b).norm() / b.norm()) for n, a, b in
          zip(names, gc, gf)}
    worst = max(dg, key=dg.get)
    phase("sample", f"wide vocabulary chunked vs full: |dloss|/|loss| "
          f"{dl:.3e} (bound 1e-5), max ||dg||/||g|| {dg[worst]:.3e} at "
          f"{worst} (bound 1e-4) over {len(dg)} leaves")
    if not dl <= 1e-5 or not dg[worst] <= 1e-4:
        raise RuntimeError("wide vocabulary: chunked and full losses differ")
    del runs, params
    torch.cuda.empty_cache()


# phase 18: the ring stream and engine on long_window's trained weights
RING_PROMPT, RING_SAMPLE, RING_LONG_BUDGET = 3584, 2048, 1024
LORA_RANK, LORA_STEPS, LORA_BATCH = 8, 20, 8
# phase 20: three adapters of rank 8, 8 and 4 (rank-padded in the stacks)
LORA_RANKS = (8, 8, 4)
# phase 19's f32 equalities: the int8 decode rounds every matvec operand to
# bf16 (a step of 2^-8) and kv8 rounds every K/V row to int8 (a step of
# 1/127 of its max), so f32 sums that differ in their last bit (GEMMs of
# another M, a padded prefill) can round one operand the other way: at a
# first difference the reference's top-2 gap must be under 2^-7 of its
# largest |logit|, the size of one such step
QUANT_TIE_OF_MAX = 2.0 ** -7
QUANT_SAMPLE = 1024  # sample's tokens with int8 and int8kv (phase 19)


def ring_requests(V, seed=4):
    """Phase 18's 16 requests over a vocabulary of ``V``: 4 of 3,584-id
    prompts and budgets of 1,024 (past ctx 4096), then 12 of 512-3,584 ids
    and budgets of 64-256, from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    reqs = [(rng.integers(0, V, RING_PROMPT).tolist(), RING_LONG_BUDGET,
             False) for _ in range(4)]
    reqs += [(rng.integers(0, V, int(rng.integers(512, RING_PROMPT + 1)))
              .tolist(), int(rng.integers(64, 257)), False)
             for _ in range(12)]
    return reqs


def windowed_logits(params, cfg, ids):
    """Float32 logits of every row of ``ids`` from one windowed full
    forward through the plain attention (no kernel launch)."""
    from linalg_tpu_torch.models.gpt import gpt_apply
    from linalg_tpu_torch.nn.flash import flash_attention_ref

    def plain(q, k, v, mask):
        return flash_attention_ref(q, k, v, True, cfg.window)

    plain.gqa_native = True
    with torch.no_grad():
        return gpt_apply(params, torch.tensor([list(ids)], device="cuda"),
                         cfg, attn_fn=plain)[0]


def tie_or_equal(tag, where, got, want, gaps, tie=TIE_OF_MAX):
    """``got`` equals the greedy stream ``want``, or first differs where
    ``want``'s top-2 logit gap (``gaps[i]``: (gap, max|logit|)) is under
    ``tie`` of its largest |logit|. Returns 1 on a tie flip."""
    if got == want:
        return 0
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    gap, big = gaps[i] if i < len(gaps) else (math.inf, 1.0)
    phase(where, f"{tag}: first differs at token {i}: the reference's "
          f"top-2 gap {gap:.3e} is {gap / big:.3e} of max|logit| (a tie "
          f"under {tie:.3e})")
    if len(got) != len(want) or not gap < tie * big:
        raise RuntimeError(f"{tag}: tokens differ at a gap f32 orders")
    return 1


def top2_gap(logits):
    top2 = logits.float().topk(2, dim=-1).values
    return float(top2[0, 0] - top2[0, 1]), float(logits.abs().max())


def ring_stream_greedy(params, cfg, prompt, n):
    """Single-stream greedy ring decode of ``n`` tokens after ``prompt``
    (``gpt_stream_prefill``, then ``gpt_stream_chunk`` a token at a time,
    each step's top-2 gap kept). Returns (tokens, gaps, final logits)."""
    from linalg_tpu_torch.models.stream import (gpt_stream_chunk,
                                                gpt_stream_prefill)

    logits, ring = gpt_stream_prefill(params, torch.tensor(
        [prompt], device="cuda"), cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks, gaps = [], []
    for _ in range(n):
        gaps.append(top2_gap(logits))
        t, logits, ring = gpt_stream_chunk(params, ring, logits, gen, cfg, 1,
                                           1.0, 1, 0.0)
        toks.append(int(t[0, 0]))
    return toks, gaps, logits


def window_phase(smi, cfg, params, stoi, itos):
    """Phase 18: long_window's trained weights through the ring: ``sample``
    past ctx_len, the ring engine, a LoRA finetune through K4, and the f32
    equalities. Returns the flash launches of the finetune
    ([fwd, dq, dkdv, delta])."""
    from linalg_tpu_torch.apps.gpt import build_parser
    from linalg_tpu_torch.kernels import flash_attention as kfa
    from linalg_tpu_torch.serve import ServeEngine
    from linalg_tpu_torch.train import trainer as ttrainer
    from linalg_tpu_torch.train.checkpoint import save_ckpt

    ident = {i: i for i in range(cfg.vocab_size)}  # ids out
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, RING_PROMPT).tolist()
    prefills = []
    real_prefill = ttrainer.gpt_prefill

    def counted(*a, **k):
        prefills.append(1)
        return real_prefill(*a, **k)

    def ring_sample(p, steps):
        prefills.clear()
        with patched((ttrainer, {"gpt_prefill": counted})):
            out, sec = timed(lambda: list(ttrainer.sample(
                p, cfg, prompt, ident, steps=steps, seed=0)))
        if len(out) != steps or len(prefills) != 1 or not all(
                0 <= t < cfg.vocab_size for t in out):
            raise RuntimeError(f"ring sample: {len(out)} tokens, "
                               f"{len(prefills)} prefills")
        return sec

    ring_sample(params, 64)  # first-use costs out of the timing
    sec = ring_sample(params, RING_SAMPLE)
    phase("window", f"sample through the ring, bf16: {RING_SAMPLE} tokens "
          f"after a {RING_PROMPT}-token prompt (positions to "
          f"{RING_PROMPT + RING_SAMPLE} past ctx {cfg.ctx_len}), one "
          f"prefill, no rollover: {sec:.3f} s, {RING_SAMPLE / sec:.1f} "
          f"tok/s; {smi}")

    # the ring engine: 8 slots, chunk 32, 16 requests, 4 running past ctx
    reqs = ring_requests(cfg.vocab_size)
    ring_kw = dict(paged=False)
    serve_waves(ServeEngine, params, cfg, [reqs[4:5]], **ring_kw)  # warm
    outs, wall, n_tok, eng = serve_waves(ServeEngine, params, cfg, [reqs],
                                         **ring_kw)
    if not eng._ring:
        raise RuntimeError("the windowed RoPE engine did not take ring mode")
    ring_bytes = sum(eng._cache[k].numel() * eng._cache[k].element_size()
                     for k in ("k", "v"))
    slot_bytes = ring_bytes // cfg.window * cfg.ctx_len
    past = sum(len(p) + n > cfg.ctx_len for p, n, _ in reqs)
    phase("window", f"ring engine, bf16, 8 slots, chunk 32: 16 requests "
          f"({past} past ctx {cfg.ctx_len}, budgets to {RING_LONG_BUDGET}), "
          f"{n_tok} tokens, every budget met, {eng.stats['prefills']} "
          f"prefills, {eng.stats['chunks']} chunks: {wall:.3f} s, "
          f"{n_tok / wall:.1f} tok/s useful; slot KV {ring_bytes / 2**20:.1f}"
          f" MiB against {slot_bytes / 2**20:.1f} MiB for ctx-"
          f"{cfg.ctx_len} slots ({slot_bytes / ring_bytes:.1f}x fewer)")
    del eng, outs
    torch.cuda.empty_cache()

    # a LoRA finetune of the same model: K4 forward and backward
    counters = (kfa.flash_fwd_cuda, kfa.flash_dq_cuda, kfa.flash_dkdv_cuda,
                kfa.flash_delta_cuda)
    with tempfile.TemporaryDirectory() as tmp:
        save_ckpt(f"{tmp}/ck", params, cfg, stoi, itos)
        log = f"{tmp}/metrics.jsonl"
        args = build_parser().parse_args(
            ["--train", "--lora_rank", str(LORA_RANK), "--lora_targets",
             "attn", "--steps", str(LORA_STEPS), "--eval_every",
             str(LORA_STEPS), "--batch_size", str(LORA_BATCH), "--ckpt_dir",
             f"{tmp}/ck", "--log_file", log, "--device", "cuda"])
        for c in counters:
            c.launches = 0
        merged, _, _, _ = ttrainer.train(args)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        rows = [json.loads(ln) for ln in open(log, encoding="utf-8")]
        saved = os.path.exists(f"{tmp}/ck/lora/lora_adapters.npz")
    want = [cfg.n_layers * (LORA_STEPS + EVAL_BATCHES)] + [
        cfg.n_layers * LORA_STEPS] * 3
    losses = [r.get("loss", r.get("val_loss")) for r in rows
              if r["event"] in ("train", "eval")]
    t = {r["step"]: r["elapsed_s"] for r in rows if r["event"] == "train"}
    ms = (t[LORA_STEPS] - t[1]) / (LORA_STEPS - 1) * 1e3
    phase("window", f"LoRA finetune (rank {LORA_RANK}, attn, {LORA_STEPS} "
          f"steps, B {LORA_BATCH}, T {cfg.ctx_len}, window {cfg.window}): "
          f"K4 launches fwd/dq/dkdv/delta {launches}, expected {want}; "
          f"losses {losses}; {ms:.2f} ms/step (steps 2-{LORA_STEPS}); "
          f"adapters saved: {saved}")
    if launches != want or not all(math.isfinite(x) for x in losses) or (
            not saved):
        raise RuntimeError("the LoRA finetune did not run through K4")
    sec = ring_sample(merged, 512)
    phase("window", f"the merged model through the ring: 512 tokens after "
          f"{RING_PROMPT}, one prefill: {sec:.3f} s")
    del merged
    torch.cuda.empty_cache()

    # f32 greedy: the ring engine against single streams; the stream past
    # ctx_len against a windowed full forward
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    r4 = [(reqs[0][0], 520, False), (reqs[1][0], 520, False),
          (reqs[4][0], 100, False), (reqs[5][0], 100, False)]
    got = serve_waves(ServeEngine, params, cfg32, [r4], greedy=True,
                      **ring_kw)[0]
    flips = 0
    for i, (p, n, _) in enumerate(r4):
        toks, gaps, last = ring_stream_greedy(params, cfg32, p, n)
        flips += tie_or_equal(f"f32 ring engine == single stream, request "
                              f"{i}", "window", got[i], toks, gaps)
        if len(p) + n > cfg.ctx_len:
            full = windowed_logits(params, cfg32, p + toks)
            rows_ = full[len(p) - 1:]
            am = rows_.argmax(-1).tolist()
            top2 = rows_.topk(2, dim=-1).values
            for j, (a, b) in enumerate(zip(am, toks)):
                gap = float(top2[j, 0] - top2[j, 1])
                if a != b and not gap < TIE_OF_MAX * float(
                        rows_[j].abs().max()):
                    raise RuntimeError("the stream's token differs from the "
                                       "windowed forward's argmax")
            err = float((last[0] - full[-1]).abs().max())
            big = float(full[-1].abs().max())
            phase("window", f"f32 stream past ctx: request {i} to position "
                  f"{len(p) + n}: every token the windowed full forward's "
                  f"argmax (or a tie); last logits max|diff| {err:.3e} "
                  f"({err / big:.3e} of max|logit|, limit 1e-4)")
            if not err <= 1e-4 * big:
                raise RuntimeError("the stream's logits past ctx_len differ "
                                   "from the windowed forward's")
    phase("window", f"f32 equalities hold, {flips} tie flips")
    return launches


def weight_bytes(tree):
    return sum(x.numel() * x.element_size() for x in tree_tensors(tree))


def tree_tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_tensors(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def greedy_steps(step_fn, logits, n):
    """``n`` greedy tokens from ``step_fn(logits) -> logits'`` (one
    decode step of the greedy token), each step's top-2 gap kept."""
    toks, gaps = [], []
    for _ in range(n):
        gaps.append(top2_gap(logits))
        tok = logits.argmax(-1)
        toks.append(int(tok[0]))
        logits = step_fn(logits)
    return toks, gaps


def quant_references(params, cfg32, reqs):
    """Single-stream f32 greedy references of ``reqs``: the int8 decode
    (``gpt_decode_chunk_q``, mode "deq") and the dense int8-KV twin (the
    full-precision ops reading a ``quantize_kv_cache`` cache through
    ``_kv8_attn``/``_kv8_write``). Returns ([(toks, gaps)] int8, kv8)."""
    from linalg_tpu_torch.models.gpt import (_decode_chunk_core,
                                             _dt_decode_ops, gpt_prefill)
    from linalg_tpu_torch.models.quant import (_kv8_attn, _kv8_write,
                                               _layer_views,
                                               gpt_decode_chunk_q,
                                               quantize_gpt_params,
                                               quantize_kv_cache)
    from linalg_tpu_torch.nn.cache import fkv_write

    qp = quantize_gpt_params(params, cfg32)
    ops8 = dict(_dt_decode_ops(params, cfg32), attn=_kv8_attn(torch.float32))
    gen = torch.Generator(device="cuda").manual_seed(0)
    int8, kv8 = [], []
    for p, n, _ in reqs:
        ids = torch.tensor([p], device="cuda")
        logits, cache = gpt_prefill(params, ids, cfg32)
        box = [cache]

        def q_step(lg):
            _, lg, box[0] = gpt_decode_chunk_q(qp, box[0], lg, gen, cfg32, 1,
                                               1.0, 1, 0.0)
            return lg

        int8.append(greedy_steps(q_step, logits, n))
        logits, cache = gpt_prefill(params, ids, cfg32)
        qc = quantize_kv_cache(cache)
        kv = [_layer_views(qc["k"]), _layer_views(qc["v"]), len(p)]

        def kv8_step(lg):
            _, lg, _, _, kv[2] = _decode_chunk_core(
                cfg32, ops8, lg, kv[0], kv[1], kv[2], 0, gen, 1, 1.0, 1,
                0.0, _kv8_write(fkv_write))
            return lg

        kv8.append(greedy_steps(kv8_step, logits, n))
    return int8, kv8


def quant_phase(ServeEngine, params, cfg, cfg32, phase4, smi):
    """Phase 19: int8 weights under K5/K6 and through the gather, int8 KV
    pages, f32 equalities, and ``sample`` with int8 / int8kv. Returns the
    paged kernel calls of the bf16 int8 kernel run."""
    from linalg_tpu_torch.kernels.paged_attention import paged_attention_cuda
    from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from linalg_tpu_torch.train.trainer import sample

    reqs = make_requests(16)
    serve_waves(ServeEngine, params, cfg, [reqs[:1]], quant="int8",
                paged_attn="kernel")  # first-use costs out of the timing
    paged_attention_cuda.launches = 0
    _, wall_k, n_tok, eng_k, launches = kernel_run(
        ServeEngine, params, cfg, [reqs], quant="int8")
    _, wall_g, _, eng_g = serve_waves(ServeEngine, params, cfg, [reqs],
                                      quant="int8", paged_attn="gather")
    _, wall_8, _, eng_8 = serve_waves(ServeEngine, params, cfg, [reqs],
                                      kv8=True, paged_attn="gather")
    if paged_attention_cuda.launches != launches:
        raise RuntimeError("a gather engine launched the paged kernel")
    q = eng_k._decode_params
    qbytes = weight_bytes({k: v for k, v in q.items() if k != "head_b"}
                          ) - sum(weight_bytes(q["layers"][k]) for k in (
                              "ln1_g", "ln1_b", "ln2_g", "ln2_b", "b1", "b2"))
    dense = sum(x.numel() for x in (q["layers"]["W3_q"], q["layers"]["Wo_q"],
                                    q["layers"]["W1_q"], q["layers"]["W2_q"],
                                    q["tok_W_q"])) * 2
    pool8 = weight_bytes({k: eng_8._cache[k] for k in ("pool_k", "pool_v")})
    pool16 = weight_bytes({k: eng_k._cache[k] for k in ("pool_k", "pool_v")})
    phase("quant", f"int8 weights: {qbytes / 2**20:.2f} MiB (int8 + f32 "
          f"scales) against {dense / 2**20:.2f} MiB in bf16 "
          f"({dense / qbytes:.2f}x); kv8 pool {pool8 / 2**20:.1f} MiB against "
          f"{pool16 / 2**20:.1f} MiB bf16 ({pool16 / pool8:.2f}x)")
    phase("quant", f"16 requests, {n_tok} tokens: int8 kernel {wall_k:.3f} "
          f"s ({n_tok / wall_k:.1f} tok/s, {launches} paged calls, one a "
          f"layer and step), int8 gather {wall_g:.3f} s "
          f"({n_tok / wall_g:.1f}), kv8 gather {wall_8:.3f} s "
          f"({n_tok / wall_8:.1f}); phase 4's engine {phase4[0]:.3f} s "
          f"({phase4[1] / phase4[0]:.1f}); {smi}")
    del eng_k, eng_g, eng_8
    torch.cuda.empty_cache()

    r4 = make_requests(4)
    k_out = kernel_run(ServeEngine, params, cfg32, [r4], greedy=True,
                       quant="int8")[0]
    g_out = serve_waves(ServeEngine, params, cfg32, [r4], greedy=True,
                        quant="int8", paged_attn="gather")[0]
    e8_out = serve_waves(ServeEngine, params, cfg32, [r4], greedy=True,
                         kv8=True, paged_attn="gather")[0]
    ref8, refkv = quant_references(params, cfg32, r4)
    flips = 0
    for i in range(len(r4)):
        toks, gaps = ref8[i]
        flips += tie_or_equal(f"f32 int8 kernel == gather, request {i}",
                              "quant", k_out[i], g_out[i], gaps,
                              QUANT_TIE_OF_MAX)
        flips += tie_or_equal(f"f32 int8 kernel == gpt_decode_chunk_q, "
                              f"request {i}", "quant", k_out[i], toks, gaps,
                              QUANT_TIE_OF_MAX)
        flips += tie_or_equal(f"f32 kv8 engine == dense int8-KV twin, "
                              f"request {i}", "quant", e8_out[i], *refkv[i],
                              QUANT_TIE_OF_MAX)
    phase("quant", f"f32 greedy, 4 requests, "
          f"{sum(len(t) for t in k_out)} tokens: int8 kernel == int8 "
          f"gather == single-stream gpt_decode_chunk_q, kv8 == the dense "
          f"int8-KV twin; {flips} tie flips")

    # sample with int8 and int8kv at phase 16's config
    scfg = GPTConfig(**SAMPLE_CFG)
    sp = init_gpt_params(scfg, seed=0, device="cuda")
    ident = {i: i for i in range(scfg.vocab_size)}
    for quant in ("int8", "int8kv"):
        list(sample(sp, scfg, [1, 2, 3], ident, steps=64, quant=quant))
        out, sec = timed(lambda: list(sample(
            sp, scfg, [1, 2, 3], ident, steps=QUANT_SAMPLE, quant=quant)))
        if len(out) != QUANT_SAMPLE or not all(
                0 <= t < scfg.vocab_size for t in out):
            raise RuntimeError(f"sample quant={quant} returned bad tokens")
        phase("quant", f"sample quant={quant} (f32, phase 16's config): "
              f"{QUANT_SAMPLE} tokens in {sec:.3f} s, "
              f"{QUANT_SAMPLE / sec:.1f} tok/s (phase 16's plain sampler: "
              f"its f32 line)")
    return launches


def make_adapters(params, seed=6):
    """Phase 20's adapters: ``LORA_RANKS``, A as ``init_lora_params``
    draws it, B ~ N(0, 0.02) from ``np.random.default_rng(seed)`` (a
    trained adapter's nonzero delta)."""
    from linalg_tpu_torch.models.lora import LoRAConfig, init_lora_params

    rng = np.random.default_rng(seed)
    out = []
    for i, r in enumerate(LORA_RANKS):
        lcfg = LoRAConfig(rank=r)
        ad = init_lora_params(params, lcfg, seed=i)
        for k, v in ad["layers"].items():
            if k.endswith("_B"):
                ad["layers"][k] = torch.tensor(
                    rng.normal(0, 0.02, tuple(v.shape)), dtype=torch.float32,
                    device=v.device)
        out.append((ad, lcfg))
    return out


def lora_phase(ServeEngine, params, cfg, cfg32, phase4, smi):
    """Phase 20: 16 requests over adapters 0-3 batched in one engine under
    K5/K6 and through the gather; f32 equality with engines serving each
    adapter's merged weights; quant x LoRA and speculative x LoRA. Returns
    the paged kernel calls of the bf16 kernel runs."""
    from linalg_tpu_torch.kernels.paged_attention import paged_attention_cuda
    from linalg_tpu_torch.models.lora import lora_merge

    ads = make_adapters(params)
    lkw = dict(adapters=ads, max_loras=len(ads), lora_rank=max(LORA_RANKS))
    reqs = [(p, n, False, i % 4) for i, (p, n, _) in
            enumerate(make_requests(16))]
    serve_waves(ServeEngine, params, cfg, [reqs[:1]], paged_attn="kernel",
                **lkw)
    paged_attention_cuda.launches = 0
    _, wall_k, n_tok, eng, launches = kernel_run(ServeEngine, params, cfg,
                                                 [reqs], **lkw)
    _, wall_g, _, _ = serve_waves(ServeEngine, params, cfg, [reqs],
                                  paged_attn="gather", **lkw)
    _, wall_q, _, _, launches_q = kernel_run(ServeEngine, params, cfg,
                                             [reqs], quant="int8", **lkw)
    _, wall_s, _, eng_s = serve_waves(ServeEngine, params, cfg, [reqs],
                                      paged=False, speculative=SPEC_K, **lkw)
    stacks = weight_bytes(eng._lora_stacks)
    phase("lora", f"16 requests over lora_id 0-3 (ranks {LORA_RANKS} in "
          f"rank-{max(LORA_RANKS)} stacks, {stacks / 2**20:.2f} MiB), "
          f"{n_tok} tokens: kernel {wall_k:.3f} s ({n_tok / wall_k:.1f} "
          f"tok/s, {launches} paged calls, one a layer and step), gather "
          f"{wall_g:.3f} s ({n_tok / wall_g:.1f}); quant x LoRA, kernel "
          f"{wall_q:.3f} s ({launches_q} calls); speculative K {SPEC_K} x "
          f"LoRA, slot {wall_s:.3f} s "
          f"({eng_s.stats['emitted_tokens'] / eng_s.stats['spec_slot_rounds']:.3f}"
          f" tokens a slot and round); phase 4's engine {phase4[0]:.3f} s; "
          f"{smi}")
    launches += launches_q
    if paged_attention_cuda.launches != launches:
        raise RuntimeError("a gather or slot engine launched the kernel")
    del eng, eng_s
    torch.cuda.empty_cache()

    r4 = [(p, n, False, i) for i, (p, n, _) in enumerate(make_requests(4))]
    mixed = kernel_run(ServeEngine, params, cfg32, [r4], greedy=True,
                       **lkw)[0]
    flips = 0
    for i, (p, n, _, lid) in enumerate(r4):
        merged = params if lid == 0 else lora_merge(params, *ads[lid - 1])
        alone = kernel_run(ServeEngine, merged, cfg32, [[(p, n, False)]],
                           greedy=True)[0]
        flips += greedy_equal(f"f32 adapter {lid} in the mixed engine == "
                              f"its merged weights", merged, cfg32, [p],
                              [mixed[i]], alone, where="lora")
    phase("lora", f"f32 equalities hold, {flips} tie flips")
    return launches


# phase 21: bench_moe's published MoE config (bench.py:300-315): d 512, 4
# heads, 4 layers, ctx 256, vocab 65, 8 experts, top-1, einsum dispatch,
# batch 64; its T 1024 run: ctx 1024, batch 8, rope
MOE = ["--d_model", "512", "--heads", "4", "--layers", "4", "--ctx_len",
       "256", "--experts", "8", "--batch_size", "64"]
MOE_LONG = ["--d_model", "512", "--heads", "4", "--layers", "4",
            "--ctx_len", "1024", "--experts", "8", "--batch_size", "8",
            "--pos", "rope", "--dtype", "bfloat16", "--steps", "10",
            "--eval_every", "10"]
MOE_SAMPLE, MOE_GEN = 512, 64  # sample's tokens; gpt_generate's new tokens
MOE_SLOTS, MOE_CHUNK = 8, 16  # the slot engine of phase 21


def moe_requests(V, n=16, seed=0):
    """Phase 21's requests: prompts of 32-192 ids, budgets 16-48, from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, V, int(rng.integers(32, 193))).tolist(),
             int(rng.integers(16, 49)), False) for _ in range(n)]


def moe_train(tag, argv, env, counters):
    """One ``train`` run of the MoE CLI flags ``argv`` under the gate
    switches ``env``: (params, cfg, stoi, itos, metric rows, launches of
    ``counters``, ms/step over the steps after the first eval, peak GB).
    Losses must be finite and the last (train or val) under step 1's."""
    from linalg_tpu_torch.apps.gpt import build_parser
    from linalg_tpu_torch.train.trainer import train

    with tempfile.TemporaryDirectory() as tmp, switches(**env):
        log = f"{tmp}/metrics.jsonl"
        args = build_parser().parse_args(
            ["--train", *argv, "--ckpt_dir", f"{tmp}/ck", "--log_file", log,
             "--device", "cuda"])
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        params, cfg, stoi, itos = train(args)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = [json.loads(ln) for ln in open(log, encoding="utf-8")]
        saved, cfg2, same = checkpoint_reloads(f"{tmp}/ck", rows, params,
                                               cfg, stoi, itos)
    t = {(r["event"], r["step"]): r["elapsed_s"] for r in rows
         if "step" in r}
    first = min(s for e, s in t if e == "eval")
    ms = (t[("train", args.steps)] - t[("eval", first)]) / (
        args.steps - first) * 1e3 if args.steps > first else math.nan
    losses = [r.get("loss", r.get("val_loss")) for r in rows
              if r["event"] in ("train", "eval")]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"moe {tag}: a loss is not finite")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"moe {tag}: the loss did not fall")
    # the sidecar does not keep ``dispatch`` (as in JAX): a gather model
    # reloads with the default einsum
    if cfg2 != dataclasses.replace(cfg, dispatch="einsum") or (
            cfg.dispatch == "einsum" and not same):
        raise RuntimeError(f"moe {tag}: the checkpoint does not reload "
                           "equal")
    return (params, cfg, stoi, itos, rows, launches, ms, peak_gb, losses,
            saved)


def moe_single_stream(params, cfg, prompt, n, window):
    """Greedy tokens of one request through the window-padded
    ``moe_prefill`` and ``moe_decode_chunk`` a token at a time, with each
    step's top-2 logit gap (the engine's f32 contract)."""
    from linalg_tpu_torch.models.moe import moe_decode_chunk, moe_prefill

    ids = torch.zeros((1, window), dtype=torch.long, device="cuda")
    ids[0, :len(prompt)] = torch.tensor(prompt, device="cuda")
    logits, cache = moe_prefill(params, ids, cfg, len(prompt))
    gen = torch.Generator(device="cuda").manual_seed(0)
    toks, gaps = [], []
    for _ in range(n):
        gaps.append(top2_gap(logits))
        t, logits, cache = moe_decode_chunk(params, cache, logits, gen, cfg,
                                            1, 1.0, 1)
        toks.append(int(t[0, 0]))
    return toks, gaps


def moe_cli(ckpt_dir):
    """``--serve`` and ``--repl`` of the MoE checkpoint with --paged
    --speculative 4 --quant int8 --beam 2 (--prefix_file for --serve): the
    JAX CLI's fallbacks must be printed and both must finish. Returns the
    lines printed."""
    import io

    from linalg_tpu_torch.apps.gpt import main as cli

    notes = ["--quant supports the dense GPT only; serving full precision",
             "--paged supports the dense GPT",
             "--speculative serving supports",
             "--prefix_file supports the dense GPT only",
             "beam search needs prompt+gen_tokens <= ctx_len and a dense GPT",
             "speculative decode needs prompt+gen_tokens+K+1 <= ctx_len and "
             "a dense GPT",
             "--quant supports the dense GPT only; using full precision"]
    with tempfile.TemporaryDirectory() as tmp:
        prompts = f"{tmp}/prompts.txt"
        with open(prompts, "w", encoding="utf-8") as f:
            f.write("FIRST CITIZEN:\nALL:\nROMEO:\n")
        common = ["--ckpt_dir", ckpt_dir, "--device", "cuda", "--gen_tokens",
                  "32", "--paged", "--speculative", "4", "--quant", "int8",
                  "--beam", "2", "--top_k", "1"]
        out = io.StringIO()
        feed = iter(["FIRST CITIZEN:", "ROMEO:"])

        def fake_input(_):
            try:
                return next(feed)
            except StopIteration:
                raise EOFError from None

        with contextlib.redirect_stdout(out), mock.patch(
                "builtins.input", fake_input):
            cli(["--serve", "--prompts", prompts, "--prefix_file", prompts,
                 *common])
            cli(["--repl", *common])
    said = out.getvalue()
    missing = [n for n in notes if n not in said]
    if missing or not said.rstrip().endswith("bye"):
        raise RuntimeError(f"moe CLI: missing fallbacks {missing}")
    return said.splitlines()


def moe_phase(smi):
    """Phase 21: bench_moe's MoE config trained through K8 (f32, bf16, bf16
    with the gate off, top-2, gather), at T 1024 through K2, sampled,
    served on the slot engine (bf16 and f32, the f32 engine against single
    streams), and its checkpoint through the CLI's fallbacks. Returns the
    launches: ({"fused": [qkv fwd, qkv bwd], "flash": [fwd, dq, dkdv,
    delta]})."""
    from linalg_tpu_torch.kernels import fused_layer as kf
    from linalg_tpu_torch.kernels.flash_attention import (
        flash_delta_cuda, flash_dkdv_cuda, flash_dq_cuda, flash_fwd_cuda)
    from linalg_tpu_torch.models.gpt import gpt_generate
    from linalg_tpu_torch.serve import Request, ServeEngine
    from linalg_tpu_torch.train.checkpoint import save_ckpt
    from linalg_tpu_torch.train.trainer import sample

    t_phase = time.perf_counter()
    fused = (kf.ln_qkv_fwd_cuda, kf.ln_qkv_bwd_cuda, kf.ln_ffn_fwd_cuda,
             kf.ln_ffn_bwd_cuda)
    flash = (flash_fwd_cuda, flash_dq_cuda, flash_dkdv_cuda,
             flash_delta_cuda)
    on = {"LINALG_TPU_FUSED_LN": "1"}
    runs = [("f32", ["--dtype", "float32", "--steps", "40", "--eval_every",
                     "20"], on),
            ("bf16", ["--dtype", "bfloat16", "--steps", "40",
                      "--eval_every", "20"], on),
            ("bf16 gate off", ["--dtype", "bfloat16", "--steps", "40",
                               "--eval_every", "20"], {}),
            ("bf16 top-2", ["--dtype", "bfloat16", "--steps", "20",
                            "--eval_every", "20", "--router_top_k", "2"], on),
            ("bf16 gather", ["--dtype", "bfloat16", "--steps", "20",
                             "--eval_every", "20", "--dispatch", "gather"],
             on)]
    totals = {"fused": [0, 0], "flash": [0, 0, 0, 0]}
    ms = {}
    trained = None
    for tag, argv, env in runs:
        params, cfg, stoi, itos, rows, n, step_ms, peak, losses, saved = \
            moe_train(tag, MOE + argv, env, fused + flash)
        steps = rows[-1]["steps"]
        n_eval = sum(r["event"] == "eval" for r in rows)
        L = cfg.n_layers
        want = [0] * 8
        if env:
            want[:2] = [L * (steps + n_eval * EVAL_BATCHES), L * steps]
        ms[tag] = step_ms
        rate = (f"{step_ms:.2f} ms/step over steps 21-40, "
                f"{64 * cfg.ctx_len / (step_ms * 1e-3):.0f} tok/s"
                if math.isfinite(step_ms) else
                f"{rows[-1]['steps_per_sec']} steps/s over the whole run "
                f"(first use included)")
        phase("moe", f"{tag} (top-{cfg.router_top_k}, {cfg.dispatch}): "
              f"launches ln_qkv fwd/bwd {n[:2]}, ln_ffn fwd/bwd {n[2:4]}, "
              f"flash {n[4:]} (expected {want[:2]}, {want[2:4]}, "
              f"{want[4:]}: the routed FFN takes no K9; T 256 no flash); "
              f"losses {[round(v, 4) for v in losses]}; {rate}, peak "
              f"{peak:.2f} GB; checkpoint saved at {saved}, reloaded equal")
        if n != want:
            raise RuntimeError(f"moe {tag}: launch counts differ")
        totals["fused"] = [a + b for a, b in zip(totals["fused"], n[:2])]
        if tag == "f32":
            trained = (params, cfg, stoi, itos)
        del params
        torch.cuda.empty_cache()
    phase("moe", f"bf16 A/B K8: gate on {ms['bf16']:.2f} vs off "
          f"{ms['bf16 gate off']:.2f} ms/step "
          f"({ms['bf16 gate off'] / ms['bf16']:.3f}x); f32 "
          f"{ms['f32']:.2f} ms/step; {smi}")

    # T 1024 through K2 (rope, ctx 1024, batch 8)
    _, cfg_l, _, _, rows, n, _, peak, losses, _ = moe_train(
        "T 1024", MOE_LONG, on, fused + flash)
    L, steps = cfg_l.n_layers, rows[-1]["steps"]
    n_eval = sum(r["event"] == "eval" for r in rows)
    fwd = L * (steps + n_eval * EVAL_BATCHES)
    # the gate is open here too: K8 before the rotation, K2 after it
    want = [fwd, L * steps, 0, 0, fwd, L * steps, L * steps, L * steps]
    phase("moe", f"T 1024 (ctx 1024, B 8, rope, bf16, {steps} steps): "
          f"launches ln_qkv {n[:2]}, ln_ffn {n[2:4]}, flash "
          f"fwd/dq/dkdv/delta {n[4:]} (expected {want[:2]}, {want[2:4]}, "
          f"{want[4:]}); losses {[round(v, 4) for v in losses]}; "
          f"{rows[-1]['steps_per_sec']} steps/s over the whole run (first "
          f"use included); {peak:.2f} GB peak")
    if n != want:
        raise RuntimeError("moe T 1024: launch counts differ")
    totals["flash"] = n[4:]
    totals["fused"] = [a + b for a, b in zip(totals["fused"], n[:2])]

    # sampling from the f32 model
    params, cfg, stoi, itos = trained
    ident = {i: i for i in range(cfg.vocab_size)}
    list(sample(params, cfg, [1, 2, 3], ident, steps=64, seed=0))
    out, dt = timed(lambda: list(sample(params, cfg, [1, 2, 3], ident,
                                        steps=MOE_SAMPLE, seed=1)))
    if len(out) != MOE_SAMPLE or not all(0 <= t < cfg.vocab_size
                                         for t in out):
        raise RuntimeError("moe sample: wrong tokens")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=(int(n_),))
               for n_ in rng.integers(3, 120, size=(8,))]
    gpt_generate(params, cfg, prompts, MOE_GEN, seed=0)
    gen, gdt = timed(lambda: gpt_generate(params, cfg, prompts, MOE_GEN,
                                          seed=1).cpu())
    if tuple(gen.shape) != (8, MOE_GEN):
        raise RuntimeError("moe gpt_generate: wrong shape")
    phase("moe", f"f32 sample: {MOE_SAMPLE} tokens in {dt:.3f} s, "
          f"{MOE_SAMPLE / dt:.1f} tok/s (rollover every 128); gpt_generate "
          f"8 x {MOE_GEN}: {gdt:.3f} s, {8 * MOE_GEN / gdt:.1f} tok/s; {smi}")

    # serving on the slot engine, bf16 and f32
    reqs = moe_requests(cfg.vocab_size)
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        kw = dict(n_slots=MOE_SLOTS, chunk=MOE_CHUNK, device="cuda")
        eng = ServeEngine(params, c, **kw)
        eng.submit(Request(reqs[0][0], 8))
        eng.run()  # first-use costs out of the timing
        eng = ServeEngine(params, c, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = [eng.submit(Request(p, n_)) for p, n_, _ in reqs]
        done = {x.request_id: x for x in eng.run()}
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for i, (_, n_, _) in zip(ids, reqs):
            if len(done[i].tokens) != n_ or done[i].finish_reason != "length":
                raise RuntimeError("moe engine: a budget was not met")
        n_tok = sum(len(x.tokens) for x in done.values())
        phase("moe", f"{dtype} slot engine ({MOE_SLOTS} slots, chunk "
              f"{MOE_CHUNK}, prefill window {eng.prefill_window}): 16 "
              f"requests, {n_tok} tokens in {wall:.3f} s, "
              f"{n_tok / wall:.1f} tok/s useful, {eng.stats['prefills']} "
              f"prefills, {eng.stats['chunks']} chunks; every budget met")

    # the f32 engine against single streams (greedy)
    c32 = dataclasses.replace(cfg, dtype="float32")
    eng = ServeEngine(params, c32, n_slots=MOE_SLOTS, chunk=MOE_CHUNK,
                      top_k=1, device="cuda")
    ids = [eng.submit(Request(p, n_)) for p, n_, _ in reqs]
    done = {x.request_id: x.tokens for x in eng.run()}
    flips = 0
    for i, (p, n_, _) in zip(ids, reqs):
        want_t, gaps = moe_single_stream(params, c32, p, n_,
                                         eng.prefill_window)
        flips += tie_or_equal(f"f32 engine request {i} == its single "
                              "stream", "moe", done[i], want_t, gaps)
    phase("moe", f"f32 greedy: 16 engine requests == window-padded single "
          f"streams (moe_prefill + moe_decode_chunk), {flips} tie flips")

    # the checkpoint through the CLI's fallbacks
    with tempfile.TemporaryDirectory() as tmp:
        save_ckpt(f"{tmp}/ck", params, cfg, stoi, itos)
        (said, cdt) = timed(lambda: moe_cli(f"{tmp}/ck"))
    notes = [ln for ln in said if ln.startswith("(")]
    phase("moe", f"CLI --serve / --repl with --paged --speculative 4 --quant "
          f"int8 --beam 2 --prefix_file: {len(notes)} fallback notes, "
          f"{cdt:.1f} s: {sorted(set(notes))}")
    phase("moe", f"phase 21 in {time.perf_counter() - t_phase:.1f} s")
    del trained, params
    torch.cuda.empty_cache()
    return totals


def l2_phase():
    """Phase 22: the L2 stack on the card: ``train_reverse_demo`` in f32 for
    20 epochs against the same run on the CPU (step 1's loss), its greedy
    decoding; a ``Transformer``'s forward and backward (d 64) against the
    CPU's."""
    from linalg_tpu_torch.apps.reverse_demo import (greedy_decode,
                                                    train_reverse_demo)
    from linalg_tpu_torch.models.seq2seq import make_reverse_batch
    from linalg_tpu_torch.models.transformer import Transformer
    from linalg_tpu_torch.nn.functional import causal_mask

    t_phase = time.perf_counter()
    got, want = [], []
    (params, cfg, acc), dt = timed(lambda: train_reverse_demo(
        epochs=20, device="cuda", losses=got))
    train_reverse_demo(epochs=20, device="cpu", losses=want)
    rel = abs(got[0] - want[0]) / abs(want[0])
    src, _, tgt = make_reverse_batch(64, 10, 12,
                                     rng=np.random.default_rng(7))
    pred = greedy_decode(params, cfg, src)
    phase("l2", f"train_reverse_demo f32, 20 epochs on the card in "
          f"{dt:.2f} s: losses {got[0]:.6f} -> {got[-1]:.6f} (CPU "
          f"{want[0]:.6f} -> {want[-1]:.6f}); step 1 |diff| / loss "
          f"{rel:.3e} (bound 1e-5); greedy token accuracy {acc:.3f} of 4 "
          f"sequences, on 64 more {float((pred == tgt).mean()):.3f}, "
          f"sequences exact {float((pred == tgt).all(1).mean()):.3f}")
    if not rel <= 1e-5 or not all(math.isfinite(v) for v in got):
        raise RuntimeError("l2: the card's step-1 loss is off the CPU's")

    cpu = Transformer(2, 2, 64, 4, 256, seed=0)
    gpu = Transformer(2, 2, 64, 4, 256, seed=0).to("cuda")
    rng = np.random.default_rng(3)
    src, tgt, dy = (torch.tensor(rng.standard_normal((4, 10, 64)),
                                 dtype=torch.float32) for _ in range(3))
    mask = causal_mask(10)
    a = cpu.forward(src, tgt, None, mask, None) + cpu.backward(dy)
    b = gpu.forward(src.cuda(), tgt.cuda(), None, mask.cuda(), None) + \
        gpu.backward(dy.cuda())
    ga = [g for _, m in cpu.named_modules() if hasattr(m, "grads")
          for g in m.grads.values()]
    gb = [g for _, m in gpu.named_modules() if hasattr(m, "grads")
          for g in m.grads.values()]
    worst = max(float((x - y.cpu()).abs().max()) / float(x.abs().max())
                for x, y in zip(list(a) + ga, list(b) + gb))
    phase("l2", f"Transformer (2 + 2 layers, d 64, 4 heads) forward and "
          f"backward, {len(ga)} parameter gradients: card vs CPU max "
          f"|diff| / max|.| {worst:.3e} (bound 1e-5); phase 22 in "
          f"{time.perf_counter() - t_phase:.1f} s")
    if not worst <= 1e-5:
        raise RuntimeError("l2: the card's Transformer is off the CPU's")


def leaf_names(params, prefix=()):
    """The key paths of ``params``, in ``tree_leaves`` order."""
    out = []
    for k, v in params.items():
        if isinstance(v, dict):
            out += leaf_names(v, prefix + (k,))
        else:
            out.append(prefix + (k,))
    return out


# phase 23: the sharded trainers at train_big's widths (10 steps each,
# steps 3-10 timed; (b) 5 steps) and the MoE's T 1024 run under dp x ep
PAR_STEPS = ["--steps", "10", "--eval_every", "10"]
PAR_EVAL_BATCHES = 10  # the sharded trainers' eval batches (JAX's)
PAR_RUNS = [  # tag, flags, gate on, model (train_big or moe), ranks
    ("a dp2 x tp4", ["--dp", "2", "--tp", "4"], False, "big", 8),
    ("b tp4 fused", ["--tp", "4"], True, "big", 4),
    ("c fsdp4", ["--fsdp", "4"], False, "big", 4),
    ("d pp4 (1F1B, M 8)", ["--pp", "4"], False, "big", 4),
    ("e moe dp2 x ep4", ["--experts", "8", "--tp", "4", "--dp", "2"], True,
     "moe", 8),
]
# the kinds of collective each run must count (and no other)
PAR_KINDS = {"a": {"all_reduce"}, "b": {"all_reduce"},
             "c": {"all_gather", "reduce_scatter", "all_reduce"},
             "d": {"ppermute", "all_reduce"}, "e": {"all_reduce"}}
PAR_LOSS_ATOL = 1e-2  # step-1 loss, bf16: the --sp check's bound
PAR_F32_RTOL = 1e-5   # step-1 loss, f32 with TF32 off, 2 layers


def par_argv(model, steps=None):
    """The single-card CLI flags of a phase-23 model: train_big's widths
    (``TRAIN_BIG``) or the MoE's T 1024 run (``MOE_LONG``), at
    ``PAR_STEPS`` (or ``steps``)."""
    base = list(TRAIN_BIG if model == "big" else MOE_LONG)
    for flag in ("--steps", "--eval_every"):
        i = base.index(flag)
        del base[i:i + 2]
    n = steps or PAR_STEPS[1]
    return base + ["--steps", str(n), "--eval_every", str(n)]


def par_train(argv, env, counters):
    """One ``train`` run of ``argv`` under the gate switches ``env`` with
    every step timed (the card drained after each): (whole params, cfg,
    stoi, itos, metric rows, launches of ``counters``, collectives by
    kind, step end times, peak GB, the ranks' final (params, opt states)
    or None for one card, checkpoint (saved, cfg, equal))."""
    from linalg_tpu_torch.apps.gpt import build_parser
    from linalg_tpu_torch.parallel import collectives
    from linalg_tpu_torch.train import trainer

    stamps, ranks = [], []
    real_loop = trainer._train_loop

    def loop(args, cfg, params, opt_state, generator, step_fn, *rest, **kw):
        def timed_step(*a):
            out = step_fn(*a)
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            return out
        out = real_loop(args, cfg, params, opt_state, generator, timed_step,
                        *rest, **kw)
        if isinstance(out, list):
            ranks.append((out, opt_state))
        return out

    with tempfile.TemporaryDirectory() as tmp, switches(**env), patched(
            (trainer, {"_train_loop": loop})):
        log = f"{tmp}/metrics.jsonl"
        args = build_parser().parse_args(
            ["--train", *argv, "--ckpt_dir", f"{tmp}/ck", "--log_file", log,
             "--device", "cuda"])
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.launches = 0
        collectives.clear()
        params, cfg, stoi, itos = trainer.train(args)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        kinds = dict(collectives)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = [json.loads(ln) for ln in open(log, encoding="utf-8")]
        ckpt = checkpoint_reloads(f"{tmp}/ck", rows, params, cfg, stoi, itos)
    losses = [r.get("loss", r.get("val_loss")) for r in rows
              if r["event"] in ("train", "eval")]
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"parallel {argv}: a loss is not finite")
    return (params, cfg, rows, launches, kinds, stamps, peak_gb,
            ranks[0] if ranks else None, ckpt)


def step_ms(stamps, first=2):
    """Mean ms of the steps after the first ``first`` (steps 3-10)."""
    return (stamps[-1] - stamps[first - 1]) / (len(stamps) - first) * 1e3


def par_want(tag, cfg, ranks, steps, n_eval, fused):
    """K2 (fwd, dq, dkdv, delta) and K8/K9 (qkv fwd, bwd, ffn fwd, bwd)
    launches of a phase-23 run, worked out beforehand. dp x tp, FSDP and
    dp x ep: every rank runs each layer once a forward (steps + evals x
    ``PAR_EVAL_BATCHES``) and once a backward. 1F1B (pp S, M
    microbatches): a step runs each stage M times in the forward slots
    (S - 1 stages: the last stage's forward is its backward slot's
    recompute) and M times recomputed in the backward slots, L/S layers a
    run; GPipe's eval runs each stage M times."""
    L = cfg.n_layers
    if tag.startswith("d"):
        S, M = 4, 8
        fwd = steps * (2 * S - 1) * M * L // S + n_eval * \
            PAR_EVAL_BATCHES * S * M * L // S
        bwd = steps * S * M * L // S
    else:
        fwd = ranks * L * (steps + n_eval * PAR_EVAL_BATCHES)
        bwd = ranks * L * steps
    flash = [fwd, bwd, bwd, bwd]
    fused_n = [0, 0, 0, 0]
    if fused:
        fused_n = [fwd, bwd] + ([0, 0] if tag.startswith("e") else [fwd, bwd])
    return flash, fused_n


def rank_bytes(tree):
    from linalg_tpu_torch.train.optim import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def parallel_phase(smi):
    """Phase 23: the sharded trainers through ``train`` with every rank on
    the card (PAR_RUNS), each against a single-card run of its config and
    seed: launches of K2 and K8/K9 as worked out, collectives by kind,
    step-1 loss, ms/step; FSDP's rank bytes; the dp x tp checkpoint
    reloaded; 1F1B's peak memory beside GPipe's at M 8; dp x tp in f32 at
    2 layers. Returns {"flash": [fwd, dq, dkdv, delta], "fused": [qkv
    fwd, qkv bwd, ffn fwd, ffn bwd]} over the sharded runs and
    "dp_tp_loss1", run a's step-1 loss."""
    from linalg_tpu_torch.kernels import fused_layer as kf
    from linalg_tpu_torch.kernels.flash_attention import (
        flash_delta_cuda, flash_dkdv_cuda, flash_dq_cuda, flash_fwd_cuda)
    from linalg_tpu_torch.parallel import (make_mesh, make_pp_1f1b_grads,
                                           make_pp_loss, pp_param_specs,
                                           shard_tree)
    from linalg_tpu_torch.parallel import sharding as tsh

    t_phase = time.perf_counter()
    flash = (flash_fwd_cuda, flash_dq_cuda, flash_dkdv_cuda, flash_delta_cuda)
    fused = (kf.ln_qkv_fwd_cuda, kf.ln_qkv_bwd_cuda, kf.ln_ffn_fwd_cuda,
             kf.ln_ffn_bwd_cuda)
    on = {"LINALG_TPU_FUSED_LN": "1"}
    totals = {"flash": [0] * 4, "fused": [0] * 4}
    singles = {}
    for model, gate, steps in (("big", False, None), ("big", True, 5),
                               ("moe", True, None)):
        out = par_train(par_argv(model, steps), on if gate else {},
                        flash + fused)
        singles[(model, gate)] = (out[2][0]["loss"], step_ms(out[5]),
                                  out[6])
        del out
        torch.cuda.empty_cache()
    for tag, flags, gate, model, n_ranks in PAR_RUNS:
        steps = 5 if tag.startswith("b") else None
        argv = par_argv(model, steps) + flags
        (params, cfg, rows, n, kinds, stamps, peak, ranks,
         ckpt) = par_train(argv, on if gate else {}, flash + fused)
        n_steps = rows[-1]["steps"]
        n_eval = sum(r["event"] == "eval" for r in rows)
        want_f, want_k = par_want(tag, cfg, n_ranks, n_steps, n_eval, gate)
        loss1, ms1, peak1 = singles[(model, gate)]
        d1 = abs(rows[0]["loss"] - loss1)
        ms = step_ms(stamps)
        phase("parallel", f"{tag} ({n_ranks} ranks, {cfg.n_layers} layers, "
              f"B {24 if model == 'big' else 8}, T {cfg.ctx_len}, bf16"
              f"{', LINALG_TPU_FUSED_LN=1' if gate else ''}, {n_steps} "
              f"steps): K2 fwd/dq/dkdv/delta {n[:4]} (expected {want_f}); "
              f"K8 fwd/bwd {n[4:6]}, K9 {n[6:]} (expected {want_k}); "
              f"collectives {dict(sorted(kinds.items()))}")
        phase("parallel", f"  step-1 loss {rows[0]['loss']:.6f}, single "
              f"card {loss1:.6f} (|diff| {d1:.3e}, bound {PAR_LOSS_ATOL}); "
              f"steps 3-{n_steps}: {ms:.2f} ms/step, single card "
              f"{ms1:.2f} ({ms / ms1:.2f}x); peak {peak:.2f} GB (single "
              f"{peak1:.2f}); {smi}")
        if n[:4] != want_f or n[4:] != want_k:
            raise RuntimeError(f"parallel {tag}: launch counts differ")
        if set(kinds) != PAR_KINDS[tag[0]] or not all(kinds.values()):
            raise RuntimeError(f"parallel {tag}: collectives {kinds}")
        if not d1 <= PAR_LOSS_ATOL:
            raise RuntimeError(f"parallel {tag}: step-1 loss off the "
                               "single card's")
        totals["flash"] = [a + b for a, b in zip(totals["flash"], n[:4])]
        totals["fused"] = [a + b for a, b in zip(totals["fused"], n[4:])]
        if tag.startswith("a"):
            totals["dp_tp_loss1"] = rows[0]["loss"]
            saved, _, same = ckpt
            phase("parallel", f"  checkpoint (saved at {saved}, gathered) "
                  f"reloaded on one card equal: {same}")
            if not same:
                raise RuntimeError("parallel: the dp x tp checkpoint does "
                                   "not reload equal")
        if tag.startswith("c"):
            from linalg_tpu_torch.parallel import fsdp_param_specs
            from linalg_tpu_torch.train.optim import tree_zip

            rp, ro = ranks
            whole = rank_bytes(params) * 3  # params, m, v
            got = [rank_bytes(p) + rank_bytes(o.m) + rank_bytes(o.v)
                   for p, o in zip(rp, ro)]
            specs = fsdp_param_specs(params, 4)
            repl = sum(w.numel() * 4 for w, s in tree_zip(params, specs)
                       if not s) * 3
            want_b = (whole - repl) // 4 + repl
            phase("parallel", f"  fsdp bytes (params + m + v) per rank "
                  f"{got}, one card {whole}: {got[0] / whole:.4f} of it "
                  f"(1/4 of the sharded leaves {whole - repl} + the "
                  f"replicated {repl} = {want_b})")
            if any(g != want_b for g in got):
                raise RuntimeError("parallel: fsdp rank bytes are not 1/4")
        if tag.startswith("d"):
            # 1F1B's and GPipe's peak memory for one step's gradients at M 8
            mesh = make_mesh((1, 4), ("dp", "pp"), ["cuda"] * 4)
            specs = pp_param_specs("dp")
            rp = shard_tree(params, specs, mesh)
            x = torch.randint(0, cfg.vocab_size, (24, cfg.ctx_len),
                              device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(0))
            peaks = {}
            for name, fn in (
                    ("1F1B", make_pp_1f1b_grads(cfg, mesh, 8, dp_axis="dp")),
                    ("GPipe", tsh._loss_and_grads(make_pp_loss(
                        cfg, mesh, 8, dp_axis="dp"), specs, mesh))):
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                fn(rp, x, x)
                torch.cuda.synchronize()
                peaks[name] = (torch.cuda.max_memory_allocated() - base) / 1e9
            phase("parallel", f"  peak memory above the parameters, one "
                  f"step's gradients at M 8: 1F1B {peaks['1F1B']:.2f} GB, "
                  f"GPipe {peaks['GPipe']:.2f} GB")
            del rp
        del params, ranks
        torch.cuda.empty_cache()

    # (a) again in f32 with TF32 off at 2 layers: step 1 against one card
    f32 = par_argv("big", 1)
    f32[f32.index("--dtype") + 1] = "float32"
    f32[f32.index("--layers") + 1] = "2"
    one = par_train(f32, {}, ())[2][0]["loss"]
    sharded = par_train(f32 + ["--dp", "2", "--tp", "4"], {}, ())[2][0][
        "loss"]
    rel = abs(sharded - one) / abs(one)
    phase("parallel", f"a dp2 x tp4 f32 (TF32 off), 2 layers: step-1 loss "
          f"{sharded:.8f}, single card {one:.8f} (rel {rel:.3e}, bound "
          f"{PAR_F32_RTOL})")
    if not rel <= PAR_F32_RTOL:
        raise RuntimeError("parallel: the f32 dp x tp step-1 loss is off")
    torch.cuda.empty_cache()
    phase("parallel", f"phase 23 in {time.perf_counter() - t_phase:.1f} s")
    return totals


# phase 24: GloVe 6B 300d's size (400,000 words x 300), seeded
GLOVE_V, GLOVE_D, GLOVE_K = 400_000, 300, 10


def mesh_phase(ServeEngine, params, cfg, cfg32):
    """Phase 25: tensor-parallel serving, multi-process initialisation and
    DCP checkpoints on the card. Phase 4's model and 16 requests on the
    slot cache, unsharded and under tp 2 and tp 4 (the kv_heads % tp != 0
    case), every rank on the card: bf16 wall and useful tok/s, all-reduces
    by ``mesh.collectives`` (two a layer and token, and a layer and
    prefill); f32 greedy tokens of 4 requests equal to the unsharded slot
    engine's (a first difference only on a tie, ``greedy_equal``); ``--serve
    --tp 2`` from a checkpoint; a DCP round trip of train_big's parameters
    bit-equal on the card with its bytes and seconds; ``init_distributed()``
    False and ``global_mesh_shape`` for the card count."""
    from linalg_tpu_torch.apps import gpt as tapp
    from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from linalg_tpu_torch.parallel import (collectives, global_mesh_shape,
                                           init_distributed, is_distributed,
                                           make_mesh)
    from linalg_tpu_torch.train.checkpoint import (_flat, load_ckpt_orbax,
                                                   save_ckpt, save_ckpt_orbax)

    t_phase = time.perf_counter()
    reqs = make_requests(16)
    warm = [[(list(range(1, 60)) * 9, 32, False)]]
    L = cfg.n_layers
    runs = {}
    for tp in (None, 2, 4):
        kw = dict(paged=False, mesh=None if tp is None else make_mesh(
            (1, tp), ("dp", "tp"), ["cuda"] * tp))
        serve_waves(ServeEngine, params, cfg, warm, **kw)
        collectives.clear()
        _, wall, n_tok, eng = serve_waves(ServeEngine, params, cfg, [reqs],
                                          **kw)
        runs[tp] = (wall, n_tok)
        st = eng.stats
        want = 2 * L * (st["chunks"] * eng.chunk + st["prefills"]) if tp \
            else 0
        got = collectives["all_reduce"]
        phase("mesh", f"{'unsharded' if tp is None else f'tp {tp}'} slot "
              f"engine bf16, 16 requests: {wall:.3f} s, {n_tok} tokens, "
              f"{n_tok / wall:.1f} tok/s useful"
              + ("" if tp is None else
                 f" ({runs[None][0] / wall:.3f}x the unsharded engine's "
                 f"rate); all-reduces {got} (2 x {L} layers x ("
                 f"{st['chunks']} chunks x {eng.chunk} steps + "
                 f"{st['prefills']} prefills) = {want})"))
        if got != want:
            raise RuntimeError(f"mesh tp {tp}: {got} all-reduces, expected "
                               f"{want}")
    reqs4 = make_requests(4)
    prompts4 = [p for p, _, _ in reqs4]
    slot = serve_waves(ServeEngine, params, cfg32, [reqs4], greedy=True,
                       paged=False)[0]
    for tp in (2, 4):
        mesh = make_mesh((1, tp), ("dp", "tp"), ["cuda"] * tp)
        got = serve_waves(ServeEngine, params, cfg32, [reqs4], greedy=True,
                          paged=False, mesh=mesh)[0]
        greedy_equal(f"tp {tp} f32 greedy == the unsharded slot engine",
                     params, cfg32, prompts4, got, slot, where="mesh")

    chars = "".join(chr(c) for c in range(48, 48 + cfg.vocab_size))
    stoi = {c: i for i, c in enumerate(chars)}
    with tempfile.TemporaryDirectory() as tmp:
        save_ckpt(tmp, params, cfg, stoi, dict(enumerate(chars)))
        with open(f"{tmp}/prompts.txt", "w", encoding="utf-8") as f:
            f.write(chars[:40] + "\n" + chars[20:] * 3 + "\n")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            tapp.main(["--serve", "--ckpt_dir", tmp, "--prompts",
                       f"{tmp}/prompts.txt", "--out", f"{tmp}/out.jsonl",
                       "--gen_tokens", "64", "--n_slots", "8", "--chunk",
                       "32", "--tp", "2", "--device", "cuda"])
        rows = [json.loads(ln) for ln in open(f"{tmp}/out.jsonl",
                                              encoding="utf-8")]
        phase("mesh", f"apps/gpt.py --serve --tp 2 from a checkpoint: "
              f"{len(rows)} completions of "
              f"{[len(r['text']) for r in rows]} characters in "
              f"{time.perf_counter() - t0:.2f} s")
        if len(rows) != 2 or any(len(r["text"]) != 64 for r in rows):
            raise RuntimeError("mesh: the --serve --tp 2 CLI did not serve")

    big = dict(zip(TRAIN_BIG[::2], TRAIN_BIG[1::2]))
    big_cfg = GPTConfig(vocab_size=cfg.vocab_size,
                        d_model=int(big["--d_model"]),
                        n_heads=int(big["--heads"]),
                        n_layers=int(big["--layers"]),
                        ctx_len=int(big["--ctx_len"]), dtype=big["--dtype"])
    big_params = init_gpt_params(big_cfg, seed=0, device="cuda")
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with warnings.catch_warnings():  # no process group: one process
            warnings.simplefilter("ignore", UserWarning)
            path = save_ckpt_orbax(tmp, big_params, big_cfg, stoi,
                                   dict(enumerate(chars)))
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            back, cfg_back, _, _ = load_ckpt_orbax(tmp)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in path.rglob("*")
                     if f.is_file())
        want, got = _flat(big_params), _flat(back)
        same = (cfg_back == big_cfg and want.keys() == got.keys()
                and all(got[k].is_cuda and torch.equal(got[k], want[k])
                        for k in want))
        n_param = sum(t.numel() for t in want.values())
        phase("mesh", f"DCP round trip of train_big's {n_param} parameters "
              f"(float32 masters): {nbytes} bytes, saved in {t_save:.3f} s, "
              f"loaded onto the card in {t_load:.3f} s (warm page cache); "
              f"bit-equal {same}")
        if not same:
            raise RuntimeError("mesh: the DCP round trip differs")
    del big_params, back

    n_cards = torch.cuda.device_count()
    tp = max(c for c in range(1, n_cards + 1)
             if n_cards % c == 0 and cfg.n_heads % c == 0)
    shape = global_mesh_shape(cfg.n_heads)
    dist0 = init_distributed()
    phase("mesh", f"init_distributed() with no launcher: {dist0}, "
          f"is_distributed() {is_distributed()}; global_mesh_shape("
          f"{cfg.n_heads}) {shape} for {n_cards} card(s), expected "
          f"{(n_cards // tp, tp)}; phase {time.perf_counter() - t_phase:.1f}"
          f" s")
    if dist0 or is_distributed() or shape != (n_cards // tp, tp):
        raise RuntimeError("mesh: init_distributed or global_mesh_shape")


def apps_phase():
    """Phase 24: the small apps on the card: both learned gates (their
    asserts), ``Vector``'s self-test, ``load_glove`` of a file written
    here, and ``top_k_neighbors`` over a seeded 400,000 x 300 float32
    matrix (480 MB on the card) against numpy's float64 top-10, its time
    beside the GEMV's bound."""
    import io
    import unittest

    from linalg_tpu_torch.apps import glovecompare, logic_gates
    from linalg_tpu_torch.apps.vectors import VectorTests

    t_phase = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as said:
        (models, dt) = timed(lambda: logic_gates.main(["--device", "cuda"]))
    n_ok = said.getvalue().count("all truth-table and fold asserts passed")
    phase("apps", f"logic_gates XOR and OR trained on the card in {dt:.2f} s "
          f"(400 full-batch SGD epochs each): {n_ok} of 2 passed their "
          f"asserts; predictions {[m.predict(logic_gates._INPUTS).tolist() for m in models]}")
    if n_ok != 2 or any(m.params["W1"].device.type != "cuda"
                        for m in models):
        raise RuntimeError("apps: the gates failed")
    res = unittest.TextTestRunner(stream=io.StringIO(), verbosity=0).run(
        unittest.defaultTestLoader.loadTestsFromTestCase(VectorTests))
    phase("apps", f"vectors self-test: {res.testsRun} tests, "
          f"{len(res.failures) + len(res.errors)} failures")
    if not res.wasSuccessful():
        raise RuntimeError("apps: Vector's self-test failed")

    rng = np.random.default_rng(0)
    small = rng.standard_normal((1000, 50)).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/glove.txt"
        with open(path, "w", encoding="utf-8") as f:
            for i, row in enumerate(small):
                f.write(f"w{i} " + " ".join(repr(float(v)) for v in row)
                        + "\n")
        stoi, itos, M_small = glovecompare.load_glove(path)
    if not (np.array_equal(M_small, small) and itos[999] == "w999"):
        raise RuntimeError("apps: load_glove parsed another matrix")
    phase("apps", "load_glove: 1,000 x 50 written and parsed back equal")

    M = rng.standard_normal((GLOVE_V, GLOVE_D), dtype=np.float32)
    words = [f"w{i}" for i in range(GLOVE_V)]
    stoi = {w: i for i, w in enumerate(words)}
    query = "w12345"
    got, dt = timed(lambda: glovecompare.top_k_neighbors(
        M, stoi, words, query, GLOVE_K, device="cuda"))
    M64 = M.astype(np.float64)
    unit64 = M64 / (np.linalg.norm(M64, axis=1, keepdims=True) + 1e-12)
    sims = unit64 @ unit64[stoi[query]]
    sims[stoi[query]] = -np.inf
    want = [words[i] for i in np.argsort(-sims)[:GLOVE_K]]
    same = [w for w, _ in got] == want
    # the GEMV alone, on the uploaded unit matrix
    M_unit = torch.as_tensor(
        M / (np.linalg.norm(M, axis=1, keepdims=True) + 1e-12),
        device="cuda")
    v_unit = M_unit[stoi[query]].clone()
    ms = median_ms(glovecompare._cosine_all, (M_unit, v_unit))
    nbytes = (GLOVE_V * GLOVE_D + GLOVE_D + GLOVE_V) * 4
    bms = nbytes / H100_BYTES_PER_S * 1e3
    phase("apps", f"top_k_neighbors over {GLOVE_V:,} x {GLOVE_D} f32 "
          f"({GLOVE_V * GLOVE_D * 4 / 1e6:.0f} MB on the card): top-{GLOVE_K} "
          f"== numpy float64's {same}; the call (normalize, upload, GEMV, "
          f"top-k on the host) {dt * 1e3:.1f} ms; the GEMV {ms:.4f} ms, "
          f"bound {bms:.4f} ms at 3.35 TB/s (bytes), {bms / ms:.1%} of it")
    if not same:
        raise RuntimeError("apps: top_k_neighbors differs from numpy's")
    del M_unit, v_unit
    torch.cuda.empty_cache()
    phase("apps", f"phase 24 in {time.perf_counter() - t_phase:.1f} s")


# phase 27: two processes on the card, one Gloo group, one mesh
PROC_BIG = ["--dp", "2", "--tp", "4"]
PROC_BIG_STEPS = 5
PROC_SMALL = (PUBLISHED[:PUBLISHED.index("--steps")]
              + ["--steps", "3", "--eval_every", "3", "--dp", "2", "--tp",
                 "2"])
PROC_F32_RTOL = 1e-5  # every loss of the f32 run against one process's
PROC_TIMEOUT_S = 600  # a pair of children, start to end
PROC_GROUP_S = 300    # the Gloo group's timeout inside them


def timed_train(argv, counters, ckpt_dir, log):
    """One ``trainer.train`` run of the CLI flags ``argv`` on the card,
    every step's loss read and its end time taken (the card drained), with
    the bytes staged through the host so far: {"losses", "stamps",
    "staged", "launches" of ``counters``, "collectives", "params", "cfg",
    "stoi", "itos"}."""
    from linalg_tpu_torch.apps.gpt import build_parser
    from linalg_tpu_torch.parallel import collectives
    from linalg_tpu_torch.train import trainer

    out = {"losses": [], "stamps": [], "staged": []}
    real_loop = trainer._train_loop

    def loop(args, cfg, params, opt_state, generator, step_fn, *rest, **kw):
        def timed_step(*a):
            res = step_fn(*a)
            out["losses"].append(float(res[3]))
            torch.cuda.synchronize()
            out["stamps"].append(time.perf_counter())
            out["staged"].append(collectives["host_staged_bytes"])
            return res
        return real_loop(args, cfg, params, opt_state, generator, timed_step,
                         *rest, **kw)

    with patched((trainer, {"_train_loop": loop})):
        args = build_parser().parse_args(
            ["--train", *argv, "--ckpt_dir", str(ckpt_dir), "--log_file",
             str(log), "--device", "cuda"])
        for c in counters:
            c.launches = 0
        collectives.clear()
        params, cfg, stoi, itos = trainer.train(args)
        torch.cuda.synchronize()
    out.update(launches=[c.launches for c in counters],
               collectives=dict(collectives), params=params, cfg=cfg,
               stoi=stoi, itos=itos)
    return out


def _proc_counters():
    from linalg_tpu_torch.kernels import fused_layer as kf
    from linalg_tpu_torch.kernels.flash_attention import (
        flash_delta_cuda, flash_dkdv_cuda, flash_dq_cuda, flash_fwd_cuda)

    return (flash_fwd_cuda, flash_dq_cuda, flash_dkdv_cuda, flash_delta_cuda,
            kf.ln_qkv_fwd_cuda, kf.ln_qkv_bwd_cuda, kf.ln_ffn_fwd_cuda,
            kf.ln_ffn_bwd_cuda)


def process_child(argv) -> int:
    """One of phase 27's two processes: ``URL RANK DIR FLAGS-JSON``. Joins
    the Gloo group, trains ``FLAGS`` over the job's mesh and writes
    ``DIR/proc{RANK}.json`` (process 0 also reloads its checkpoint)."""
    from linalg_tpu_torch.parallel import init_distributed

    url, rank, out_dir, flags = (argv[0], int(argv[1]),
                                 pathlib.Path(argv[2]), json.loads(argv[3]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not init_distributed(url, 2, rank, backend="gloo",
                            timeout_s=PROC_GROUP_S):
        raise RuntimeError("process child: no group of two")
    log = out_dir / "metrics.jsonl"
    run = timed_train(flags, _proc_counters(), out_dir / "ck", log)
    res = {k: run[k] for k in ("losses", "stamps", "staged", "launches",
                               "collectives")}
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["n_layers"] = run["cfg"].n_layers
    if rank == 0:
        res["rows"] = [json.loads(ln) for ln in open(log, encoding="utf-8")]
        saved, _, same = checkpoint_reloads(
            out_dir / "ck", res["rows"], run["params"], run["cfg"],
            run["stoi"], run["itos"])
        res["ckpt"] = [saved, same]
    (out_dir / f"proc{rank}.json").write_text(json.dumps(res))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def run_pair(out_dir, flags, env, mode="--process-child"):
    """Phase 27's (or with ``mode`` "--ipc-child" phase 28's) two children
    on ``flags`` under the extra ``env``, each on the one card (LOCAL_RANK
    0 and 1 of LOCAL_WORLD_SIZE 2, Gloo on the loopback interface); both
    stopped at the end, whatever happens. Returns their two result dicts;
    a child that fails fails the phase."""
    out_dir.mkdir()
    url = f"file://{out_dir}/rendezvous"
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK",
                                 "LOCAL_RANK", "LOCAL_WORLD_SIZE", "JAX_"))}
    base.update(GLOO_SOCKET_IFNAME="lo", LOCAL_WORLD_SIZE="2", **env)
    procs, logs = [], []
    try:
        for r in (0, 1):
            logs.append(open(out_dir / f"child{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode, url,
                 str(r), str(out_dir),
                 json.dumps(flags)], env=dict(base, LOCAL_RANK=str(r)),
                stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + PROC_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            tail = (out_dir / f"child{r}.log").read_text()[-3000:]
            raise RuntimeError(f"processes: child {r} exited with "
                               f"{p.returncode}:\n{tail}")
    return [json.loads((out_dir / f"proc{r}.json").read_text())
            for r in (0, 1)]


def processes_phase(smi, dp_tp_loss1):
    """Phase 27 (see the module docstring). Returns {"flash": K2's
    [fwd, dq, dkdv, delta], "fused": K8/K9's [qkv fwd, qkv bwd, ffn fwd,
    ffn bwd]}, both processes' launches over both runs."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    totals = {"flash": [0] * 4, "fused": [0] * 4}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        # train_big, dp 2 x tp 4, four ranks in each process
        flags = par_argv("big", PROC_BIG_STEPS) + PROC_BIG
        runs = run_pair(tmp / "big", flags, {})
        lead = runs[0]
        n = [a + b for a, b in zip(runs[0]["launches"], runs[1]["launches"])]
        n_eval = sum(r["event"] == "eval" for r in lead["rows"])
        want_f, want_k = par_want(
            "a", types.SimpleNamespace(n_layers=lead["n_layers"]), 8,
            PROC_BIG_STEPS, n_eval, False)
        ms = step_ms(lead["stamps"])
        staged = [b - a for a, b in zip(lead["staged"], lead["staged"][1:])]
        d1 = abs(lead["losses"][0] - dp_tp_loss1)
        phase("processes", f"train_big dp 2 x tp 4 over 2 processes (Gloo, "
              f"4 ranks each, one card; {PROC_BIG_STEPS} steps, {n_eval} "
              f"eval): K2 fwd/dq/dkdv/delta {n[:4]} (expected {want_f}), "
              f"each process {runs[0]['launches'][:4]} and "
              f"{runs[1]['launches'][:4]}; collectives (process 0) "
              f"{dict(sorted(lead['collectives'].items()))}")
        phase("processes", f"  step-1 loss {lead['losses'][0]:.6f}, one "
              f"process (phase 23 a) {dp_tp_loss1:.6f} (|diff| {d1:.3e}, "
              f"bound {PAR_LOSS_ATOL}); both processes' losses "
              f"{runs[0]['losses'] == runs[1]['losses']}; steps 3-"
              f"{PROC_BIG_STEPS}: {ms:.2f} ms/step; bytes staged through "
              f"the host a step (process 0, steps 2-{PROC_BIG_STEPS}) "
              f"{staged}; peak {lead['peak_gb']:.2f} GB and "
              f"{runs[1]['peak_gb']:.2f} GB; checkpoint saved at "
              f"{lead['ckpt'][0]} (gathered, process 0) reloaded equal: "
              f"{lead['ckpt'][1]}; {smi}")
        if n[:4] != want_f or n[4:] != want_k:
            raise RuntimeError("processes: train_big launch counts differ")
        if not d1 <= PAR_LOSS_ATOL:
            raise RuntimeError("processes: step-1 loss off the one-process "
                               "run's")
        if runs[0]["losses"] != runs[1]["losses"] or not all(
                math.isfinite(v) for v in runs[0]["losses"]):
            raise RuntimeError("processes: the two processes' losses differ "
                               "or are not finite")
        if not lead["ckpt"][1] or not all(staged):
            raise RuntimeError("processes: checkpoint or host staging")
        totals["flash"] = n[:4]

        # the published widths in f32 with K8/K9, against one process
        on = {"LINALG_TPU_FUSED_LN": "1"}
        runs = run_pair(tmp / "small", PROC_SMALL, on)
        counters = _proc_counters()
        with switches(**on):
            one = timed_train(PROC_SMALL, counters, tmp / "one_ck",
                              tmp / "one.jsonl")
        rows1 = [json.loads(ln) for ln in open(tmp / "one.jsonl",
                                               encoding="utf-8")]
        del one["params"]
        torch.cuda.empty_cache()
        n = [a + b for a, b in zip(runs[0]["launches"], runs[1]["launches"])]
        val = [[r["val_loss"] for r in rows if r["event"] == "eval"]
               for rows in (runs[0]["rows"], rows1)]
        got, want = runs[0]["losses"] + val[0], one["losses"] + val[1]
        rel = max(abs(g - w) / abs(w) for g, w in zip(got, want))
        want_k = par_want("b", types.SimpleNamespace(
            n_layers=runs[0]["n_layers"]), 4, 3, len(val[0]), True)[1]
        phase("processes", f"published widths f32 (TF32 off), dp 2 x tp 2 "
              f"over 2 processes, LINALG_TPU_FUSED_LN=1: K8 fwd/bwd "
              f"{n[4:6]}, K9 {n[6:]} (expected {want_k}; one process "
              f"{one['launches'][4:]}), "
              f"K2 {n[:4]}; losses (3 steps, val) {got} vs one process "
              f"{want} (max rel {rel:.3e}, bound {PROC_F32_RTOL})")
        if n != one["launches"] or n[4:] != want_k:
            raise RuntimeError("processes: K8/K9 launches differ from one "
                               "process's")
        if not (len(got) == len(want) == 4 and rel <= PROC_F32_RTOL):
            raise RuntimeError("processes: f32 losses off the one-process "
                               "run's")
        totals["fused"] = n[4:]
        totals["flash"] = [a + b for a, b in zip(totals["flash"], n[:4])]
    phase("processes", f"phase 27 in {time.perf_counter() - t_phase:.1f} s")
    return totals


IPC_STEPS = 5  # phase 28 (b): train_big's widths, 2 layers, --sp 4
IPC_MEMBERS = [[0, 1], [2, 3]]  # phase 28's ring positions, per process


def ipc_argv():
    """Phase 28 (b)'s CLI flags: train_big at 2 layers, ``IPC_STEPS`` steps
    and one eval, --sp 4 (phase 15's second run, shorter)."""
    argv = par_argv("big", IPC_STEPS)
    argv[argv.index("--layers") + 1] = "2"
    return argv + ["--sp", str(SP)]


def ipc_kernel_cases(rank):
    """Phase 28 (a) in process ``rank``: K10/K11 at ``RING_TABLE_CASES``
    over the ring positions ``IPC_MEMBERS`` (two ranks a process), the
    other process's chunks read through the ring's ``RingArena``; this
    process's rows held bit for bit against the one-process call on the
    same per-rank tensors (phase 26's "tables" layout, every rank here),
    launches counted, CUDA-event ms of a call and the host µs it spends in
    the handshake. {case: {...}}."""
    from linalg_tpu_torch.kernels import ring_attention as kr
    from linalg_tpu_torch.parallel.distributed import subgroup
    from linalg_tpu_torch.parallel.ring_pallas import _heads, _ranks

    counters = (kr.ring_fwd_cuda, kr.ring_bwd_cuda)
    mine = IPC_MEMBERS[rank]
    arena = kr.ring_arena((0, 1), IPC_MEMBERS, rank, 0, subgroup([0, 1]))
    out = {}
    for i, (name, B, h, T, d, n, dtype, window) in enumerate(
            RING_TABLE_CASES):
        gen = torch.Generator(device="cuda").manual_seed(2800 + i)
        x = [torch.randn((B, h, T, d), generator=gen, device="cuda",
                         dtype=dtype) for _ in range(4)]
        kw = dict(H=h, causal=True, window=window, slopes=None,
                  scale=1.0 / math.sqrt(d))
        devs = [torch.device("cuda")] * n
        q, k, v, do = (_ranks(_heads(t, d), n, devs) for t in x)
        del x
        like = lambda ts: [torch.empty_like(t) for t in ts]
        o1, L1 = like(q), [torch.empty(t.shape[:2], dtype=torch.float32,
                                       device="cuda") for t in q]
        kr.ring_fwd_cuda(q, k, v, o1, L1, **kw)
        dl = [torch.sum(a.float() * b.float(), dim=-1).contiguous()
              for a, b in zip(do, o1)]
        g1 = [like(q) for _ in range(3)]
        kr.ring_bwd_cuda(q, k, v, do, L1, dl, *g1, **kw)

        def sel(ts):
            return [t if x in mine else None for x, t in enumerate(ts)]

        fin = [sel(t) for t in (q, k, v)]
        bin_ = fin + [sel(do), sel(L1), sel(dl)]
        fout, bout = [sel(like(o1)), sel(like(L1))], [sel(like(q))
                                                      for _ in range(3)]
        for c in counters:
            c.launches = 0
        kr.ring_fwd_cuda(*fin, *fout, arena=arena, **kw)
        kr.ring_bwd_cuda(*bin_, *bout, arena=arena, **kw)
        torch.cuda.synchronize()
        launches = [c.launches for c in counters]
        same = [all(torch.equal(a[x], b[x]) for x in mine)
                for a, b in zip(fout + bout, [o1, L1] + g1)]
        ms, hs_us = [], []
        for fn, args in ((kr.ring_fwd_cuda, fin + fout),
                         (kr.ring_bwd_cuda, bin_ + bout)):
            s0, c0 = arena.handshake_s, arena.handshakes
            ms.append(median_ms(lambda: fn(*args, arena=arena, **kw), (),
                                trials=7, reps=3))
            hs_us.append((arena.handshake_s - s0)
                         / (arena.handshakes - c0) * 1e6)
        out[name] = dict(same=same, launches=launches, ms=ms,
                         handshake_us=hs_us, opened=arena.opened)
        del q, k, v, do, o1, L1, dl, g1, fin, bin_, fout, bout
        torch.cuda.empty_cache()
    # the handshake alone (its all-reduce, no card work between): the
    # group's latency on this host
    times = []
    for _ in range(50):
        t0 = time.perf_counter()
        arena.ops.handshake([0] * 8)
        times.append(time.perf_counter() - t0)
    out["bare_handshake_us"] = float(np.median(times)) * 1e6
    return out


def ipc_child(argv) -> int:
    """One of phase 28's two processes: ``URL RANK DIR FLAGS-JSON``. Joins
    the Gloo group, runs (a) ``ipc_kernel_cases``, then (b) trains
    ``FLAGS`` (``--sp 4`` over the job's mesh: K10/K11 reading the other
    process's chunks through CUDA IPC) with every plain ring call counted,
    and writes ``DIR/proc{RANK}.json``."""
    from linalg_tpu_torch.kernels import ring_attention as kr
    from linalg_tpu_torch.parallel import init_distributed
    from linalg_tpu_torch.parallel import ring as plain_ring
    from linalg_tpu_torch.parallel import ring_pallas, sharding

    url, rank, out_dir, flags = (argv[0], int(argv[1]),
                                 pathlib.Path(argv[2]), json.loads(argv[3]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not init_distributed(url, 2, rank, backend="gloo",
                            timeout_s=PROC_GROUP_S):
        raise RuntimeError("ipc child: no group of two")
    t0 = time.perf_counter()
    res = {"cases": ipc_kernel_cases(rank)}
    kr.release_ring_arenas()
    res["cases_s"] = time.perf_counter() - t0
    plain = []

    def counted(fn):
        return lambda *a, **k: plain.append(1) or fn(*a, **k)

    with patched((plain_ring, {"ring_attention_local": counted(
            plain_ring.ring_attention_local)}),
                 (sharding, {"ring_attention_ranks": counted(
                     sharding.ring_attention_ranks)}),
                 (ring_pallas, {"ring_fwd_step_ref": counted(
                     ring_pallas.ring_fwd_step_ref), "ring_bwd_step_ref":
                     counted(ring_pallas.ring_bwd_step_ref)})):
        run = timed_train(flags, (kr.ring_fwd_cuda, kr.ring_bwd_cuda),
                          out_dir / "ck", out_dir / "metrics.jsonl")
    res.update({k: run[k] for k in ("losses", "stamps", "launches",
                                    "collectives")})
    res.update(plain=len(plain), n_layers=run["cfg"].n_layers,
               train_s=time.perf_counter() - t0 - res["cases_s"],
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    if rank == 0:
        res["rows"] = [json.loads(ln) for ln in open(
            out_dir / "metrics.jsonl", encoding="utf-8")]
    (out_dir / f"proc{rank}.json").write_text(json.dumps(res))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def ipc_ring_phase(smi, tables, sp_one):
    """Phase 28 (see the module docstring): ``tables`` phase 26's records
    (the one-process call's times), ``sp_one`` phase 15's one-process
    train_big 2-layer run ({"loss1", "ms"}). Returns {"fwd", "bwd": both
    processes' K10/K11 launches in the training run, "cases": (a)'s
    records}."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        runs = run_pair(pathlib.Path(tmp) / "ipc", ipc_argv(), {},
                        mode="--ipc-child")
    records = {"bare_handshake_us": [r["cases"]["bare_handshake_us"]
                                     for r in runs]}
    phase("ipc ring", f"a bare handshake (Gloo all-reduce of 8 int64, no "
          f"card work): median {records['bare_handshake_us'][0]:.1f} / "
          f"{records['bare_handshake_us'][1]:.1f} µs (processes 0 / 1)")
    for name, B, h, T, d, n, dtype, window in RING_TABLE_CASES:
        got = [r["cases"][name] for r in runs]
        dt = str(dtype).split(".")[1]
        one = tables[name]["tables_ms"]
        phase("ipc ring", f"{name} B,h,T,d,n={B},{h},{T},{d},{n} {dt}"
              f"{f' window {window}' if window else ''}, two ranks in each "
              f"of 2 processes: == the one-process call (o, L, dq, dk, dv) "
              f"{[g['same'] for g in got]}; launches a process "
              f"{[g['launches'] for g in got]}; K10 "
              f"{got[0]['ms'][0]:.4f} / {got[1]['ms'][0]:.4f} ms "
              f"(processes 0 / 1), one process (phase 26) {one[0]:.4f} ms; "
              f"K11 {got[0]['ms'][1]:.4f} / {got[1]['ms'][1]:.4f} ms, one "
              f"process {one[1]:.4f} ms; handshake µs a call (fwd, bwd) "
              f"{[round(u, 1) for u in got[0]['handshake_us']]} / "
              f"{[round(u, 1) for u in got[1]['handshake_us']]}; peer "
              f"handles opened {[g['opened'] for g in got]}")
        if not all(all(g["same"]) for g in got) or any(
                g["launches"] != [1, 1] for g in got):
            raise RuntimeError(f"ipc ring {name}: the ring across processes "
                               "differs from one process's, or launched "
                               "other than once a direction")
        records[name] = dict(ms=[[g["ms"][i] for g in got]
                                 for i in range(2)],
                             handshake_us=[[g["handshake_us"][i]
                                            for g in got] for i in range(2)],
                             one_process_ms=list(one))
    lead = runs[0]
    n_eval = sum(r["event"] == "eval" for r in lead["rows"])
    L = lead["n_layers"]
    want = [L * (IPC_STEPS + n_eval * SP_EVAL_BATCHES), L * IPC_STEPS]
    ms = step_ms(lead["stamps"])
    d1 = abs(lead["losses"][0] - sp_one["loss1"])
    phase("ipc ring", f"train_big 2 layers --sp {SP} over 2 processes "
          f"(Gloo, 2 ranks each, one card; {IPC_STEPS} steps, {n_eval} "
          f"eval): K10/K11 launches a process {runs[0]['launches']} and "
          f"{runs[1]['launches']} (expected {want}: {L} layers x "
          f"({IPC_STEPS} steps + {n_eval} evals x {SP_EVAL_BATCHES} "
          f"batches) forward, x {IPC_STEPS} backward); plain ring calls "
          f"{runs[0]['plain']} and {runs[1]['plain']}; collectives "
          f"(process 0) {dict(sorted(lead['collectives'].items()))}")
    phase("ipc ring", f"  step-1 loss {lead['losses'][0]:.6f}, one process "
          f"(phase 15) {sp_one['loss1']:.6f} (|diff| {d1:.3e}, bound "
          f"{PAR_LOSS_ATOL}); both processes' losses "
          f"{runs[0]['losses'] == runs[1]['losses']}; steps 3-{IPC_STEPS}: "
          f"{ms:.2f} ms/step, one process (phase 15, steps 2-20) "
          f"{sp_one['ms']:.2f} ms/step; peak {lead['peak_gb']:.2f} GB and "
          f"{runs[1]['peak_gb']:.2f} GB; children's seconds (a) "
          f"{lead['cases_s']:.1f}, (b) {lead['train_s']:.1f}; {smi}")
    if any(r["launches"] != want for r in runs) or any(
            r["plain"] for r in runs):
        raise RuntimeError("ipc ring: launch counts differ, or a plain ring "
                           "ran")
    if not d1 <= PAR_LOSS_ATOL:
        raise RuntimeError("ipc ring: step-1 loss off the one-process run's")
    if runs[0]["losses"] != runs[1]["losses"] or not all(
            math.isfinite(v) for v in runs[0]["losses"]):
        raise RuntimeError("ipc ring: the two processes' losses differ or "
                           "are not finite")
    phase("ipc ring", f"phase 28 in {time.perf_counter() - t_phase:.1f} s")
    return {"fwd": sum(r["launches"][0] for r in runs),
            "bwd": sum(r["launches"][1] for r in runs), "cases": records,
            "ms_step": ms}


# -- phase 29: K13 at Mellum's routed shapes, and the cell's main path ------

# the routed layer of ``mellum2-ep8-train`` (B 1 x T 8192, top-8, 8 held
# experts of width 896 at d_model 2304): its buffers hold the most rows any
# routing gives, 8192 * 8 + 1 = 65,537; each case's group rows sum to the
# rows routed to the held experts, the rest of the 65,537 is the zero tail
GROUPED_D, GROUPED_F, GROUPED_TOKENS, GROUPED_TOP_K = 2304, 896, 8192, 8
GROUPED_CASES = {
    "even": None,  # 8,192 rows over the 8 experts by a seeded multinomial
    "skewed": [6000, 1500, 0, 391, 200, 99, 2, 0],
    "full": [8192] * 8,  # every assignment on a held expert: a tail of 1
    "empty": [0] * 8,  # nothing routed here: every row is the tail
}
# max |kernel - plain| over max |plain|: rounding an f32 sum to bf16 (8
# significant bits, to nearest) moves it by at most 2^-8 of its size, and
# the two f32 accumulation orders differ by ~1e-6 of it
GROUPED_TOL = 4e-3
MELLUM_CONFIG = "portbench/configs/mellum2-12b-ep8.json"
MELLUM_TRAFFIC = "portbench/traffic/train-moe-b1-t8192.json"


def grouped_builds(lib):
    """Phase 29's build check: registers and spills of K13's kernels; any
    stack frame or spill fails."""
    kernels = ptxas_kernels(lib)
    for name, (regs, *frame) in sorted(kernels.items()):
        phase("grouped", f"{name}: {regs} registers, stack frame {frame[0]}, "
              f"spill stores {frame[1]}, loads {frame[2]}")
    spills = ptxas_spills(lib)
    if not kernels or spills:
        raise RuntimeError(f"K13 spills registers: {spills}" if spills
                           else "no ptxas lines in the K13 build log")


def grouped_inputs(counts, seed):
    """Random bf16 operands of one routed layer on the card, with the
    group offsets of ``counts``; the inputs' tail rows are random too, so a
    kernel that read past ``offs[El]`` would show."""
    D, F, El = GROUPED_D, GROUPED_F, len(counts)
    M = GROUPED_TOKENS * GROUPED_TOP_K + 1
    g = torch.Generator(device="cuda").manual_seed(seed)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda")
                * scale).bfloat16()

    return {"offs": torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                                 dtype=torch.int32, device="cuda"),
            "M": M, "x": r(GROUPED_TOKENS, D),
            "tok": torch.randint(0, GROUPED_TOKENS, (M,), generator=g,
                                 device="cuda", dtype=torch.int32),
            "W1g": r(El, D, 2 * F, scale=0.02), "W2": r(El, F, D, scale=0.02),
            "H": r(M, F), "dY": r(M, D), "dUG": r(M, 2 * F)}


def grouped_calls(t):
    """The six K13 calls of a routed layer's training step, in
    ``portbench.flops_moe.expert_gemm_calls``' order: (name, kernel call,
    its plain version over float32 copies, "rows" or "dw")."""
    from linalg_tpu_torch.kernels import grouped_gemm as gg

    o, M, tok = t["offs"], t["M"], t["tok"]
    f = {k: t[k].float() for k in ("x", "W1g", "W2", "H", "dY", "dUG")}

    def rows(a, idx, w, trans=False):
        return (lambda: gg.grouped_rows(t[a], idx, o, t[w], M, trans),
                lambda: gg.grouped_rows_ref(f[a], idx, o, f[w], M, trans),
                "rows")

    def dw(a, idx, d):
        return (lambda: gg.grouped_dw(t[a], idx, t[d], o),
                lambda: gg.grouped_dw_ref(f[a], idx, f[d], o), "dw")

    return [("[U|G] = x[tok] W1g", *rows("x", tok, "W1g")),
            ("Y = H W2", *rows("H", None, "W2")),
            ("dH = dY W2^T", *rows("dY", None, "W2", True)),
            ("dW2 = H^T dY", *dw("H", None, "dY")),
            ("dW1g = x[tok]^T dUG", *dw("x", tok, "dUG")),
            ("dx = dUG W1g^T", *rows("dUG", None, "W1g", True))]


def grouped_check(tag, name, kind, got, want, counts):
    """The worst error of one call over max |plain| (per group for dW);
    the tail's rows and empty groups' gradients must be exactly zero."""
    torch.cuda.synchronize()
    if kind == "rows":
        live = int(sum(counts))
        if got[live:].abs().max().item() != 0:
            raise RuntimeError(f"grouped {tag} {name}: a tail row past "
                               f"{live} is not zero")
        pairs = [(got[:live], want[:live])] if live else []
    else:
        for e, c in enumerate(counts):
            if c == 0 and got[e].abs().max().item() != 0:
                raise RuntimeError(f"grouped {tag} {name}: empty group {e}'s "
                                   "gradient is not zero")
        pairs = [(got[e], want[e]) for e, c in enumerate(counts) if c]
    err = max([((a.float() - b).abs().max()
                / b.abs().max().clamp_min(1e-30)).item() for a, b in pairs],
              default=0.0)
    if not err <= GROUPED_TOL:
        raise RuntimeError(f"grouped {tag} {name}: max error {err:.3g} of "
                           f"the largest entry, over {GROUPED_TOL}")
    return err


def grouped_library_ms(t, rows):
    """cuBLAS ``bmm`` over 8 equal groups of ``rows`` for the six calls
    (no gather, no tail): the yardstick of the even case."""
    D, El = GROUPED_D, t["W1g"].shape[0]
    a = {k: t[k][:El * rows].reshape(El, rows, -1)
         for k in ("H", "dY", "dUG")}
    a["x"] = t["x"][:El * rows].reshape(El, rows, D)
    W1gT, W2T = t["W1g"].transpose(1, 2), t["W2"].transpose(1, 2)
    calls = [lambda: torch.bmm(a["x"], t["W1g"]),
             lambda: torch.bmm(a["H"], t["W2"]),
             lambda: torch.bmm(a["dY"], W2T),
             lambda: torch.bmm(a["H"].transpose(1, 2), a["dY"]),
             lambda: torch.bmm(a["x"].transpose(1, 2), a["dUG"]),
             lambda: torch.bmm(a["dUG"], W1gT)]
    return [median_ms(c, (), trials=10, reps=5) for c in calls]


def mellum_step(steps=2):
    """The main path of ``mellum2-ep8-train``: the benchmark's Mellum
    configuration (28 layers, 8 of 64 experts held, the grouped dispatch)
    through ``make_device_train_step`` at its traffic's B 1 x T 8192, one
    warm step, then ``steps`` with K13's launch counters set to 0 just
    before them and CUDA's sync debug mode at "error" (a host round trip
    inside them raises). Returns ((rows launches, dw launches), ms a step,
    peak bytes, losses, layers)."""
    from linalg_tpu_torch.kernels import grouped_gemm as gg
    from linalg_tpu_torch.models.moe import MoEGPTConfig
    from linalg_tpu_torch.nn.functional import YaRN
    from linalg_tpu_torch.train.optim import adamw_init
    from linalg_tpu_torch.train.trainer import make_device_train_step
    from portbench import weights_moe
    from portbench.traffic.train import _corpus
    from portbench.traffic.train_moe import _CFG_KEYS

    root = pathlib.Path(__file__).resolve().parent
    conf = json.loads((root / MELLUM_CONFIG).read_text())
    mix = json.loads((root / MELLUM_TRAFFIC).read_text())
    shape = conf["port"]
    cfg = MoEGPTConfig(**{k: shape[k] for k in _CFG_KEYS if k in shape},
                       rope_scaling=YaRN(**shape["rope_scaling"]))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = weights_moe.make_params(shape, conf["init"], 0, "cuda")
    opt = adamw_init(params)
    data = _corpus(mix, shape["vocab_size"], 0, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    step = make_device_train_step(cfg, mix["batch"],
                                  grad_accum=mix["grad_accum"],
                                  **mix["schedule"])
    params, opt, gen, loss = step(params, opt, data, gen)
    losses = [loss]
    torch.cuda.synchronize()
    gg.grouped_rows.launches = gg.grouped_dw.launches = 0
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.set_sync_debug_mode("error")
    try:
        a.record()
        for _ in range(steps):
            params, opt, gen, loss = step(params, opt, data, gen)
            losses.append(loss)
        b.record()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n = (gg.grouped_rows.launches, gg.grouped_dw.launches)
    ms = a.elapsed_time(b) / steps
    peak = torch.cuda.max_memory_allocated()
    losses = [float(v) for v in losses]
    del params, opt, data, step
    torch.cuda.empty_cache()
    return n, ms, peak, losses, cfg.n_layers


def grouped_phase(smi):
    """Phase 29: K13 at the Mellum cell's routed shapes against its plain
    version, then the cell's main path with K13's launches counted.
    Returns the kernel's JSON record."""
    from portbench.flops_moe import expert_gemm_calls

    El = 8
    shape = {"d_model": GROUPED_D, "d_ff": GROUPED_F, "experts_held": El}
    rng = np.random.default_rng(0)
    record = {"tolerance": GROUPED_TOL, "cases": {}}
    for i, (tag, counts) in enumerate(GROUPED_CASES.items()):
        if counts is None:
            counts = rng.multinomial(GROUPED_TOKENS, [1 / El] * El).tolist()
        t = grouped_inputs(counts, seed=i)
        calls = grouped_calls(t)
        errs = []
        for name, kern, plain, kind in calls:
            errs.append(grouped_check(tag, name, kind, kern(), plain(),
                                      counts))
        ms = [median_ms(kern, (), trials=10, reps=5)
              for _, kern, _, _ in calls]
        live = int(sum(counts))
        bms = sum(bound_ms(fl, nb, torch.bfloat16)[0]
                  for fl, nb in expert_gemm_calls(shape, live))
        rec = {"rows": counts, "tail": t["M"] - live,
               "max_err": max(errs), "ms": [round(v, 4) for v in ms],
               "layer_ms": round(sum(ms), 4), "bound_ms": round(bms, 4),
               "pct_of_bound": round(100 * bms / sum(ms), 2)}
        if tag == "even":
            lib = grouped_library_ms(t, GROUPED_TOKENS // El)
            rec["bmm_ms"] = [round(v, 4) for v in lib]
            rec["bmm_layer_ms"] = round(sum(lib), 4)
        record["cases"][tag] = rec
        phase("grouped", f"{tag} (group rows {counts}, tail {rec['tail']}): "
              f"max error {rec['max_err']:.3g} of the largest entry; "
              f"ms {rec['ms']} = {rec['layer_ms']} a layer, bound "
              f"{rec['bound_ms']} ({rec['pct_of_bound']}%)"
              + (f"; cuBLAS bmm over 8 groups of 1,024 {rec['bmm_ms']} = "
                 f"{rec['bmm_layer_ms']}" if "bmm_ms" in rec else ""))
        del t, calls
    phase("grouped", f"{torch.cuda.memory_allocated()} bytes held on the "
          "card before the Mellum step")
    (rows, dw), ms, peak, losses, L = mellum_step()
    steps = len(losses) - 1
    phase("grouped", f"mellum2-ep8-train's step ({L} layers, B 1 x T 8192, "
          f"{smi}): K13 launches rows {rows}, dw {dw} in {steps} steps; "
          f"{ms:.1f} ms a step, peak {peak} bytes, losses "
          f"{[round(v, 4) for v in losses]}; no host round trip inside the "
          "steps (sync debug mode 'error')")
    if (rows, dw) != (4 * L * steps, 2 * L * steps):
        raise RuntimeError(f"grouped: {rows} rows and {dw} dw launches in "
                           f"{steps} steps, not {4 * L} and {2 * L} a step")
    if not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"grouped: a Mellum loss is not finite: {losses}")
    record.update(launches=rows + dw, launches_rows_dw=[rows, dw],
                  mellum_steps=steps, mellum_ms=round(ms, 2),
                  mellum_peak_bytes=peak)
    return record


def main() -> int:
    # -- 1. device ------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from linalg_tpu_torch.kernels import build as kbuild
    from linalg_tpu_torch.kernels.paged_attention import paged_attention_cuda
    from linalg_tpu_torch.models.gpt import GPTConfig, init_gpt_params
    from linalg_tpu_torch.serve import ServeEngine

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
    lib, seconds = built["paged_attention"]
    phase("build", f"{lib.name} in {seconds:.2f} s")
    paged_builds(lib)

    # -- 3. kernel vs plain version -------------------------------------
    record, shared_record = paged_phase()

    # -- 4. engine ------------------------------------------------------
    cfg = GPTConfig(dtype="bfloat16", **SERVE_CFG)
    params = init_gpt_params(cfg, seed=0, device="cuda")
    reqs = make_requests(16)
    warm = [[(list(range(1, 60)) * 9, 32, False)]]
    for mode in ("kernel", "gather"):  # first-use costs out of the timing
        serve_waves(ServeEngine, params, cfg, warm, paged_attn=mode)
    paged_attention_cuda.launches = 0
    _, wall_k, n_tok, eng, launches = kernel_run(ServeEngine, params, cfg,
                                                 [reqs])
    chunks = eng.stats["chunks"]
    _, wall_g, n_tok_g, _ = serve_waves(ServeEngine, params, cfg, [reqs],
                                        paged_attn="gather")
    if paged_attention_cuda.launches != launches:
        raise RuntimeError("the gather engine launched the kernel")
    phase("engine", f"16 requests, {n_tok} tokens, {chunks} chunks,"
          f" {launches} kernel launches")
    phase("engine", f"kernel: {wall_k:.3f} s, {n_tok / wall_k:.1f} tok/s")
    phase("engine", f"gather: {wall_g:.3f} s, {n_tok_g / wall_g:.1f} tok/s")

    # -- 5. f32 greedy equality -----------------------------------------
    cfg32 = GPTConfig(dtype="float32", **SERVE_CFG)
    reqs4 = make_requests(4)
    out_k = kernel_run(ServeEngine, params, cfg32, [reqs4], greedy=True)[0]
    out_g = serve_waves(ServeEngine, params, cfg32, [reqs4], greedy=True,
                        paged_attn="gather")[0]
    same = [a == b for a, b in zip(out_k, out_g)]
    phase("equality", f"f32 greedy, 4 requests, "
          f"{sum(len(t) for t in out_k)} tokens: kernel == gather "
          f"per request {same}")
    if not all(same):
        raise RuntimeError("f32 greedy tokens differ between the kernel and "
                           "gather engines")

    # -- 17. prefix: shared pages, chunked prefill, speculation ----------
    prefix_launches = prefix_phase(ServeEngine, params, cfg, cfg32,
                                   (wall_k, n_tok))

    # -- 19. quant: int8 weights under K5/K6, int8 KV pages --------------
    quant_launches = quant_phase(ServeEngine, params, cfg, cfg32,
                                 (wall_k, n_tok), smi)

    # -- 20. lora: mixed adapters under K5/K6 ------------------------------
    lora_launches = lora_phase(ServeEngine, params, cfg, cfg32,
                               (wall_k, n_tok), smi)

    # -- 6. qr -----------------------------------------------------------
    report_build("qr", built["qr_panel"])
    qr_builds(built["qr_panel"][0])
    qr_record, qr_grid_record = qr_phase()

    # -- 7. flash --------------------------------------------------------
    report_build("flash", built["flash_attention"])
    flash_builds(built["flash_attention"][0])
    flash_record = flash_phase()

    # -- 8. train --------------------------------------------------------
    train_launches, big_cfg, big_batch = train_phase(smi)

    # -- 9. stream -------------------------------------------------------
    stream_record = stream_phase()

    # -- 10. long ----------------------------------------------------------
    long_launches, long_cfg, long_batch, long_trained = long_phase(smi)

    # -- 18. window: the ring stream, the ring engine, a LoRA finetune -----
    window_launches = window_phase(smi, long_cfg, *long_trained)
    del long_trained

    # -- 11. btd -----------------------------------------------------------
    btd_record = btd_phase()

    # -- 12. fused ---------------------------------------------------------
    report_build("fused", built["fused_layer"])
    fused_builds(built["fused_layer"][0])
    fused_record = fused_phase()

    # -- 13. short ---------------------------------------------------------
    short_launches, short_cfgs = short_phase(smi)

    # -- 14. ring ----------------------------------------------------------
    report_build("ring", built["ring_attention"])
    k10_record, k11_record = ring_phase(built["ring_attention"])

    # -- 15. sp ------------------------------------------------------------
    sp_launches = sp_phase(smi)

    # -- 16. sample --------------------------------------------------------
    sample_phase(smi)

    # -- 21. moe: the routed MoE through K8 and K2 -------------------------
    moe_launches = moe_phase(smi)

    # -- 22. l2: the reversal demo and the Transformer classes -------------
    l2_phase()

    # -- 23. parallel: the sharded trainers, every rank on the card --------
    par_launches = parallel_phase(smi)

    # -- 24. apps: the gates, Vector, GloVe neighbours ----------------------
    apps_phase()

    # -- 25. mesh: tp serving, init_distributed, DCP ------------------------
    mesh_phase(ServeEngine, params, cfg, cfg32)

    # -- 26. ring tables: K10/K11 over one tensor per rank ------------------
    tables = ring_tables_phase()

    # -- 27. processes: one mesh over two processes on the card -------------
    proc_launches = processes_phase(smi, par_launches["dp_tp_loss1"])

    # -- 28. ipc ring: K10/K11 across two processes through CUDA IPC --------
    ipc = ipc_ring_phase(smi, tables, sp_launches["train_big 2 layers"])

    # -- 29. grouped: K13 at Mellum's routed shapes, the Mellum cell's step -
    report_build("grouped", built["grouped_gemm"])
    grouped_builds(built["grouped_gemm"][0])
    grouped_record = grouped_phase(smi)

    # the profiler breakdowns last: the profiler stays attached to the card
    ring_copies()
    profile_qr()
    profile_step("train", big_cfg, big_batch)
    profile_step("long", long_cfg, long_batch)
    for name, env in (("btd", {}), ("fused", {"LINALG_TPU_FUSED_LN": "1"})):
        cfg_, batch_ = short_cfgs[name]
        with switches(**env):
            profile_step(f"short {name}",
                         dataclasses.replace(cfg_, dtype="bfloat16"), batch_)
    from linalg_tpu_torch.parallel import make_mesh
    from linalg_tpu_torch.parallel.sharding import _sp_ring

    profile_step("sp", long_cfg, long_batch, _sp_ring(
        make_mesh((1, SP), ("dp", "sp"), ["cuda"] * SP), True, long_cfg))
    profile_parallel()
    # last: a profiler session after this one's launches recorded no
    # kernels. Four of phase 4's requests, for the script's time limit:
    # all 16 made a trace of ~210k kernel launches
    profile_engine(ServeEngine, params, cfg, reqs[:4])

    flash_launches = [sum(n) for n in zip(
        train_launches, long_launches, short_launches["btd"],
        window_launches, moe_launches["flash"], par_launches["flash"],
        proc_launches["flash"])]
    fused_launches = [sum(n) for n in zip(
        short_launches["fused"], moe_launches["fused"] + [0, 0],
        par_launches["fused"], proc_launches["fused"])]
    phase("time", phase_seconds())
    print(json.dumps({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "linalg_tpu_torch/kernels/csrc/paged_attention.cu",
        "replaces": "linalg_tpu/serve/paged.py:433, :267",
        "launches": launches + prefix_launches + quant_launches
        + lora_launches,
        "launches_phase4_prefix_quant_lora": [
            launches, prefix_launches, quant_launches, lora_launches],
        **record,
        "shared_prefix": shared_record}, {
        "name": "qr_panel", "route": "cuda",
        "source": "linalg_tpu_torch/kernels/csrc/qr_panel.cu",
        "replaces": "linalg_tpu/ops/pallas/qr_panel.py:143",
        **qr_record}, {
        "name": "qr_panel_grid", "route": "cuda",
        "source": "linalg_tpu_torch/kernels/csrc/qr_panel.cu",
        "replaces": "linalg_tpu/ops/pallas/qr_panel.py:143, :173",
        **qr_grid_record}, {
        "name": "flash_attention", "route": "cuda",
        "source": "linalg_tpu_torch/kernels/csrc/flash_attention.cu",
        "replaces": "linalg_tpu/nn/flash.py:169, "
                    "linalg_tpu/nn/flash_long.py:190, "
                    "linalg_tpu/nn/flash_stream.py:327, "
                    "linalg_tpu/nn/flash_btd.py:178",
        "launches": sum(flash_launches),
        "launches_fwd_dq_dkdv_delta": flash_launches,
        "launches_train_big_long_window_btd_lora_moe": [
            sum(train_launches), sum(long_launches),
            sum(short_launches["btd"]), sum(window_launches),
            sum(moe_launches["flash"])],
        "launches_parallel": par_launches["flash"],
        "launches_processes": proc_launches["flash"],
        **flash_record, "stream": stream_record, "btd": btd_record}, {
        "name": "fused_layer", "route": "cuda",
        "source": "linalg_tpu_torch/kernels/csrc/fused_layer.cu",
        "replaces": "linalg_tpu/nn/fused_layer.py:166, :312",
        "launches": sum(fused_launches),
        "launches_qkv_fwd_bwd_ffn_fwd_bwd": fused_launches,
        "launches_short_moe": [sum(short_launches["fused"]),
                               sum(moe_launches["fused"])],
        "launches_parallel": par_launches["fused"],
        "launches_processes": proc_launches["fused"],
        **fused_record}, {
        "name": "ring_attention_fwd", "route": "cuda",
        "source": "linalg_tpu_torch/kernels/csrc/ring_attention.cu",
        "replaces": "linalg_tpu/parallel/ring_pallas.py:209",
        "launches": sp_launches["fwd"] + ipc["fwd"],
        "launches_sp_processes": [sp_launches["fwd"], ipc["fwd"]],
        **k10_record,
        "tables": {k: {"stacked_ms": v["stacked_ms"][0],
                       "tables_ms": v["tables_ms"][0]}
                   for k, v in tables.items()},
        "processes": {k: {"ms_process_0_1": v["ms"][0],
                          "handshake_us_process_0_1": v["handshake_us"][0],
                          "one_process_ms": v["one_process_ms"][0]}
                      for k, v in ipc["cases"].items() if k in tables},
        "bare_handshake_us": ipc["cases"]["bare_handshake_us"]}, {
        "name": "ring_attention_bwd", "route": "cuda",
        "source": "linalg_tpu_torch/kernels/csrc/ring_attention.cu",
        "replaces": "linalg_tpu/parallel/ring_pallas.py:439",
        "launches": sp_launches["bwd"] + ipc["bwd"],
        "launches_sp_processes": [sp_launches["bwd"], ipc["bwd"]],
        **k11_record,
        "tables": {k: {"stacked_ms": v["stacked_ms"][1],
                       "tables_ms": v["tables_ms"][1]}
                   for k, v in tables.items()},
        "processes": {k: {"ms_process_0_1": v["ms"][1],
                          "handshake_us_process_0_1": v["handshake_us"][1],
                          "one_process_ms": v["one_process_ms"][1]}
                      for k, v in ipc["cases"].items() if k in tables}}, {
        "name": "grouped_gemm", "route": "cuda",
        "source": "linalg_tpu_torch/kernels/csrc/grouped_gemm.cu",
        "replaces": "none: linalg_tpu/models/moe.py's experts are einsums "
                    "over capacity slots",
        **grouped_record}]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--process-child"]:
        sys.exit(process_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--ipc-child"]:
        sys.exit(ipc_child(sys.argv[2:]))
    sys.exit(main())
