"""char-GPT CLI of the port: ``python -m linalg_tpu_torch.apps.gpt
--train``, ``--serve --ckpt_dir D --prompts F`` and/or ``--repl --ckpt_dir
D`` (prompts on stdin; ``--beam B`` for beam search).

The ``--train``, ``--serve`` and ``--repl`` parts of ``linalg_tpu.apps.gpt``
with the same flags, defaults and outputs (``--out`` JSON lines), plus
``--device``; ``--tokenizer bpe --vocab_size N`` trains byte-level BPE.
Checkpoints load and save in the JAX package's format. ``--serve`` takes
``--prefix_file``, ``--auto_prefix``, ``--page_cache``, ``--speculative
K``, ``--quant int8`` and ``--paged --kv8``; ``--repl`` takes
``--speculative K``, ``--draft_ckpt`` and ``--quant int8|int8kv``.
``--train --lora_rank R`` (with ``--lora_alpha``, ``--lora_targets``,
``--lora_dir``) finetunes adapters on a trained checkpoint; ``--serve``
and ``--repl`` merge the adapters found in ``--lora_dir`` (default
<ckpt_dir>/lora) at load. A windowed RoPE/ALiBi model samples and serves
through the ring cache. ``--train --experts E`` (``--router_top_k``,
``--dispatch``) trains the routed MoE GPT; ``--serve`` and ``--repl`` on
its checkpoint print the JAX CLI's fallbacks for what the MoE does not
take (int8, paged KV, speculation, registered prefixes, beam search,
prompts past the prefill window). ``--train`` with ``--dp``, ``--tp``
(experts with ``--experts``), ``--sp``, ``--pp`` (``--microbatches``) or
``--fsdp`` trains over a mesh dealt over the job's devices: every card
of the process (one CPU device with ``--device cpu``), or, once the
caller has called ``parallel.init_distributed``, every process's, as the
JAX CLI's mesh spans the hosts after ``jax.distributed.initialize``.
``--serve --tp N`` serves tensor-parallel (``ServeEngine(mesh=...)``)
over a (1, N) (dp, tp) mesh dealt over this process's cards (each an
equal block of the N ranks; all N on a card that ``--device`` names, or
on the CPU), as the JAX CLI takes N devices of its host. Under ``--tp``
it prints the JAX CLI's fallbacks for ``--paged`` and ``--speculative``
and serves without them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--ctx_len", type=int, default=256)
    ap.add_argument("--d_model", type=int, default=256)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv_heads", type=int, default=None,
                    help="grouped-query attention: number of K/V heads "
                         "(must divide --heads); default = --heads")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--eval_every", type=int, default=200)
    ap.add_argument("--lr_model", type=float, default=3e-4)
    ap.add_argument("--lr_embed", type=float, default=3e-4,
                    help="lr for the (tied) token embedding matrix")
    ap.add_argument("--lr_head", type=float, default=3e-4,
                    help="lr for the output-head bias (weights are tied)")
    ap.add_argument("--pos", type=str, default="sinusoidal",
                    choices=("sinusoidal", "rope", "learned", "alibi"),
                    help="positional encoding for a fresh model")
    ap.add_argument("--ffn", type=str, default="relu",
                    choices=("relu", "gelu", "swiglu", "geglu"),
                    help="FFN nonlinearity for a fresh model")
    ap.add_argument("--window", type=int, default=None,
                    help="sliding-window attention: each token sees the "
                         "last N positions, itself included")
    ap.add_argument("--dtype", type=str, default="float32",
                    choices=("float32", "bfloat16"),
                    help="compute dtype for a fresh model (params stay f32)")
    ap.add_argument("--weight_decay", type=float, default=0.01)
    ap.add_argument("--data", type=str, default=None,
                    help="path to a local corpus text file (optional)")
    ap.add_argument("--profile", type=str, default=None,
                    help="record a torch.profiler trace of training into "
                         "DIR/trace.json")
    ap.add_argument("--log_file", type=str, default=None,
                    help="append training/eval metrics as JSON lines here")
    ap.add_argument("--clip_norm", type=float, default=0.0,
                    help="clip gradients to this global L2 norm before "
                         "AdamW (0 = off)")
    ap.add_argument("--grad_accum", type=int, default=1,
                    help="split each batch into N sequential microbatches; "
                         "one optimizer update on the averaged grads")
    ap.add_argument("--repl", action="store_true",
                    help="sampling REPL: read prompts from stdin, stream "
                         "each completion (KV-cached decode)")
    ap.add_argument("--tokenizer", type=str, default="char",
                    choices=("char", "bpe"),
                    help="tokenizer for a fresh model: char or byte-level "
                         "BPE")
    ap.add_argument("--vocab_size", type=int, default=512,
                    help="BPE vocabulary size (with --tokenizer bpe; the "
                         "char vocabulary is the corpus's character set)")
    ap.add_argument("--beam", type=int, default=0, metavar="B",
                    help="REPL: beam-search decoding with B beams instead "
                         "of sampling (ignores temperature/top_k/top_p; "
                         "needs prompt+gen_tokens <= ctx_len)")
    ap.add_argument("--speculative", type=int, default=0, metavar="K",
                    help="draft K tokens a round by prompt-lookup "
                         "speculative decoding (the plain sampler's law). "
                         "REPL: single-stream, plain decode when the block "
                         "does not fit ctx_len; --serve: per-slot draft + "
                         "verify inside continuous batching")
    ap.add_argument("--draft_ckpt", type=str, default="",
                    help="REPL: checkpoint of a smaller DRAFT model of the "
                         "same vocabulary for --speculative K (it drafts "
                         "greedily, the target verifies); empty = prompt "
                         "lookup")
    ap.add_argument("--quant", type=str, default="none",
                    choices=("none", "int8", "int8kv"),
                    help="decode with int8 weight-only matvecs (int8), "
                         "REPL: plus an int8 KV cache (int8kv); the prefill "
                         "stays full precision. --serve takes int8")
    ap.add_argument("--experts", type=int, default=0,
                    help="train mode: routed mixture-of-experts FFN with "
                         "this many experts per layer (0 = the dense FFN)")
    ap.add_argument("--router_top_k", type=int, default=1, choices=(1, 2),
                    help="MoE experts per token: 1 = Switch, 2 = GShard "
                         "top-2")
    ap.add_argument("--dispatch", type=str, default="einsum",
                    choices=("einsum", "gather"),
                    help="MoE token dispatch: dense one-hot einsums or "
                         "slot -> token index gathers (the same routing)")
    ap.add_argument("--lora_rank", type=int, default=0,
                    help="train mode: LoRA-finetune rank-N adapters on a "
                         "frozen base checkpoint (0 = full training); "
                         "repl/serve merge adapters from --lora_dir")
    ap.add_argument("--lora_alpha", type=float, default=16.0,
                    help="LoRA delta scale = alpha/rank (PEFT convention)")
    ap.add_argument("--lora_targets", type=str, default="attn",
                    choices=("attn", "all"),
                    help="which weights get adapters: attention "
                         "projections, or + FFN matmuls")
    ap.add_argument("--lora_dir", type=str, default="",
                    help="adapter checkpoint dir (default <ckpt_dir>/lora); "
                         "repl/serve merge adapters from here when present")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="pipeline microbatch count (0 = auto: 2*pp when "
                         "the batch divides, else pp)")
    ap.add_argument("--dp", type=int, default=1,
                    help="data-parallel mesh axis (the ranks share the "
                         "device)")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel mesh axis (ring attention over "
                         "the sequence; the ranks share the device)")
    ap.add_argument("--ring", type=str, default="auto",
                    choices=("auto", "pallas", "xla"),
                    help="sp attention ring: the ring kernels K10/K11 "
                         "(pallas; across processes, after "
                         "init_distributed, each reads the others' chunks "
                         "through CUDA IPC; their plain versions on the "
                         "CPU) or the plain ring (xla); auto = the kernels "
                         "on a CUDA device, the plain ring on the CPU")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel mesh axis (heads/FFN sharding; "
                         "with --experts it shards experts instead)")
    ap.add_argument("--pp", type=int, default=1,
                    help="pipeline-parallel mesh axis (layer stack sharded "
                         "over stages, 1F1B microbatch schedule)")
    ap.add_argument("--fsdp", type=int, default=1,
                    help="fully-sharded data parallelism (ZeRO-3): batch "
                         "split like --dp, parameter and optimizer storage "
                         "sharded 1/N per rank, weights gathered per layer")
    ap.add_argument("--serve", action="store_true",
                    help="batch-serve mode: run every prompt in --prompts "
                         "through the continuous-batching engine "
                         "(serve.ServeEngine) and print/write completions")
    ap.add_argument("--ckpt_dir", type=str, default="checkpoints_np")
    ap.add_argument("--prompts", type=str, default="-",
                    help="file with one prompt per line ('-' = stdin)")
    ap.add_argument("--gen_tokens", type=int, default=200)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top_k", type=int, default=0)
    ap.add_argument("--top_p", type=float, default=0.0,
                    help="nucleus sampling: keep the smallest probability "
                         "mass >= p (0 = off; composes with --top_k)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--n_slots", type=int, default=8,
                    help="concurrent decode slots in the engine")
    ap.add_argument("--chunk", type=int, default=32,
                    help="decode-chunk length (tokens per host round trip)")
    ap.add_argument("--out", type=str, default="",
                    help="write completions as JSON lines to this file "
                         "instead of stdout")
    ap.add_argument("--page_cache", action="store_true",
                    help="serve mode (with --paged): automatic prefix "
                         "caching — retired requests leave their full "
                         "prompt pages in the pool under content-"
                         "addressed keys; admissions reuse the longest "
                         "cached block run (refcounted, LRU-evicted under "
                         "page pressure)")
    ap.add_argument("--auto_prefix", action="store_true",
                    help="serve mode: submit full prompts and let the "
                         "engine reuse the longest registered prefix "
                         "(ServeEngine(auto_prefix=True)); with "
                         "--prefix_file, prompts are submitted as "
                         "prefix+line with no explicit prefix_id")
    ap.add_argument("--prefix_file", type=str, default="",
                    help="serve mode: file whose text is a shared prompt "
                         "PREFIX prepended to every prompt; its KV is "
                         "prefilled once and reused per request "
                         "(ServeEngine.register_prefix)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache (page pool + per-slot tables; "
                         "admission control by memory, prefix pages "
                         "shared across slots)")
    ap.add_argument("--page", type=int, default=64,
                    help="paged mode: rows per KV page (must divide ctx_len)")
    ap.add_argument("--n_pages", type=int, default=0,
                    help="paged mode: pool size in pages (0 = dense-"
                         "equivalent n_slots*ctx_len/page + trash page)")
    ap.add_argument("--schedule", type=str, default="fifo",
                    choices=("fifo", "best-fit"),
                    help="admission under page pressure: strict arrival "
                         "order or first-fit past a blocked request")
    ap.add_argument("--kv8", action="store_true",
                    help="serve: store the paged KV pool int8 with per-row "
                         "scales (requires --paged; read by the gather)")
    ap.add_argument("--paged_attn", type=str, default="auto",
                    choices=("auto", "kernel", "gather"),
                    help="paged mode attention read: the CUDA paged-"
                         "attention kernel vs the table gather (auto = "
                         "kernel on a CUDA device from ctx 2048 at d_head "
                         "128)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device: cuda (the default; raises on a "
                         "machine without a card) or cpu")
    return ap


def _decode_text(tok, itos, toks) -> str:
    """Token ids -> text through whichever tokenizer the checkpoint
    uses."""
    if hasattr(tok, "token_bytes"):  # byte-level BPE
        return b"".join(tok.token_bytes(int(t)) for t in toks).decode(
            "utf-8", "replace")
    return "".join(itos[int(t)] for t in toks)


def _maybe_lora(params, args, device):
    """Merge the LoRA adapters of ``--lora_dir`` (default <ckpt_dir>/lora)
    into the loaded base params when that directory holds an adapter
    checkpoint: every inference path then runs the adapted model (a
    merged windowed model serves in ring mode)."""
    import pathlib

    from ..models.lora import load_lora, lora_merge

    lora_dir = getattr(args, "lora_dir", "") or str(
        pathlib.Path(args.ckpt_dir) / "lora")
    try:
        adapters, lcfg = load_lora(lora_dir, device=device)
    except Exception:
        if getattr(args, "lora_dir", ""):
            print(f"(no LoRA adapters at {lora_dir}; using the base model)")
        return params
    print(f"merged LoRA adapters from {lora_dir} "
          f"(rank {lcfg.rank}, targets {lcfg.targets})")
    return lora_merge(params, adapters, lcfg)


def serve_cli(args) -> None:
    """Serve a batch of prompts through the continuous-batching engine.

    Prompts keep their LAST admissible tokens (the reference's context
    truncation); within the ctx budget any length admits (chunked
    prefill). ``--prefix_file`` registers a shared prefix (prefilled
    once), tail-truncated to leave a prompt token and the decode budget;
    with ``--auto_prefix`` the prompts go in whole and the engine finds
    the prefix itself. An MoE checkpoint serves full precision on the
    slot cache without speculation, its prefix prepended to each prompt
    and prompts capped at the prefill window (the JAX CLI's fallbacks,
    printed)."""
    from ..models.moe import MoEGPTConfig
    from ..serve.engine import Request, ServeEngine
    from ..train.checkpoint import load_ckpt, load_tokenizer
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    params, cfg, _, itos = load_ckpt(args.ckpt_dir, device=device)
    params = _maybe_lora(params, args, device)
    tok = load_tokenizer(args.ckpt_dir)
    moe = isinstance(cfg, MoEGPTConfig)
    quant = args.quant
    if quant != "none" and moe:
        print("(--quant supports the dense GPT only; serving full "
              "precision)")
        quant = "none"

    if args.prompts == "-":
        lines = [ln.rstrip("\n") for ln in sys.stdin]
    else:
        with open(args.prompts, encoding="utf-8") as f:
            lines = [ln.rstrip("\n") for ln in f]
    lines = [ln for ln in lines if ln.strip()]
    if not lines:
        print("serve: no prompts")
        return

    mesh = None
    if args.tp > 1:
        # tensor-parallel serving over this process's cards, each an equal
        # block of the tp ranks (the JAX CLI's mesh over the host's first
        # tp devices, linalg_tpu/apps/gpt.py:290-304); a named card or the
        # CPU takes them all
        from ..parallel import make_mesh

        mesh = (make_mesh((1, args.tp), ("dp", "tp"), device_type="cuda",
                          local=True)
                if device.type == "cuda" and device.index is None else
                make_mesh((1, args.tp), ("dp", "tp"), [device] * args.tp))
    paged = args.paged
    ring = cfg.window is not None and cfg.pos in ("rope", "alibi")
    if paged and (mesh is not None or ring or moe):
        print("(--paged supports the dense GPT outside ring/tp mode; "
              "serving with the slot cache)")
        paged = False
    kv8 = paged and args.kv8
    spec = args.speculative
    # (--lora_dir adapters are merged into params at load: they do not
    # constrain speculation)
    if spec and (quant != "none" or ring or moe or kv8 or mesh is not None
                 or (paged and args.paged_attn == "kernel")):
        print("(--speculative serving supports the full-precision dense "
              "slot/paged(gather) engine; serving without speculation)")
        spec = 0
    eng = ServeEngine(params, cfg, n_slots=args.n_slots, chunk=args.chunk,
                      top_k=args.top_k, seed=args.seed, quant=quant,
                      paged=paged, page=args.page,
                      n_pages=(args.n_pages or None),
                      paged_attn=args.paged_attn, speculative=spec, kv8=kv8,
                      schedule=args.schedule, auto_prefix=args.auto_prefix,
                      page_cache=args.page_cache, mesh=mesh, device=device)
    # the engine reserves ceil(gen/chunk)*chunk cache rows per request
    # (speculative: gen + 2(K + 1)): cap gen so one prompt token always
    # fits, then keep each prompt's tail
    if spec:
        gen = min(args.gen_tokens, max(cfg.ctx_len - 1 - 2 * (spec + 1), 1))
        reserved = gen + 2 * (spec + 1)
    else:
        gen_max = (cfg.ctx_len - 1) // args.chunk * args.chunk
        gen = min(args.gen_tokens, max(gen_max, 1))
        reserved = -(-gen // args.chunk) * args.chunk
    if gen < args.gen_tokens:
        print(f"(gen_tokens capped to {gen}: the decode budget "
              f"reservation must fit ctx_len {cfg.ctx_len})")
    pid, pref_ids, pref_raw = None, [], []
    if args.prefix_file:
        with open(args.prefix_file, encoding="utf-8") as f:
            pref_ids = list(tok.encode(f.read().rstrip("\n")))
        pref_cap = min(cfg.ctx_len - args.chunk - 1,
                       cfg.ctx_len - reserved - 1)
        if len(pref_ids) > pref_cap:
            print(f"(prefix truncated to its last {pref_cap} tokens)")
            pref_ids = pref_ids[-pref_cap:]
        if moe:
            print("(--prefix_file supports the dense GPT only; prefix "
                  "prepended per-prompt instead)")
            pref_raw, pref_ids = pref_ids, []
        elif pref_ids:
            pid = eng.register_prefix(pref_ids)
    plen_max = cfg.ctx_len - reserved - len(pref_ids)
    if moe:  # no chunked prefill: the window caps the prompt
        plen_max = min(eng.prefill_window, plen_max)
    prompts = []
    for ln in lines:
        ids = list(tok.encode(ln))
        if ids and pref_raw:  # the MoE fallback: a per-prompt prepend
            ids = pref_raw + ids
        prompts.append(ids[-plen_max:] or None)  # empty: empty completion

    t0 = time.perf_counter()
    rid_to_line = {}
    for i, ids in enumerate(prompts):
        if ids is None:
            continue
        use_pid = pid
        if args.auto_prefix and pid is not None:
            # the submit-time matcher: the full prompt, no prefix_id
            ids, use_pid = pref_ids + ids, None
        rid = eng.submit(Request(
            prompt=ids, max_new_tokens=gen, temperature=args.temperature,
            top_p=args.top_p, top_k=args.top_k if args.top_k > 0 else None,
            prefix_id=use_pid))
        rid_to_line[rid] = i
    done = {rid_to_line[c.request_id]: c for c in eng.run()}
    wall = time.perf_counter() - t0

    out_f = open(args.out, "w", encoding="utf-8") if args.out else None
    try:
        for i, ln in enumerate(lines):
            c = done.get(i)
            text = _decode_text(tok, itos, c.tokens) if c else ""
            reason = c.finish_reason if c else "empty"
            if out_f is not None:
                out_f.write(json.dumps({
                    "id": i, "prompt": ln, "text": text,
                    "finish_reason": reason,
                    "new_tokens": len(c.tokens) if c else 0,
                }) + "\n")
            else:
                print(f"--- [{i}] {ln!r}")
                print(text)
    finally:
        if out_f is not None:
            out_f.close()
    n_tok = sum(len(c.tokens) for c in done.values())
    print(f"[serve: {len(done)} completions, {n_tok} tokens in {wall:.2f}s "
          f"= {n_tok / max(wall, 1e-9):.0f} tok/s useful; "
          f"slots={args.n_slots} chunk={args.chunk} "
          f"prefills={eng.stats['prefills']} device={device}]")
    if spec:
        rounds = max(eng.stats.get("spec_rounds", 0), 1)
        print(f"[speculative K={spec}: {rounds} verify rounds, "
              f"{eng.stats['emitted_tokens'] / rounds:.2f} tok/round "
              f"(ceiling {spec + 1})]")
    if args.page_cache:
        print(f"[page cache: {eng.stats['page_cache_hits']} page hits, "
              f"{eng.stats['page_cache_evicted']} evicted]")
    if done:
        lat = np.array([c.latency_s for c in done.values()])
        qws = np.array([c.queue_s for c in done.values()])
        print(f"[latency p50/p95: {np.percentile(lat, 50):.3f}/"
              f"{np.percentile(lat, 95):.3f}s  queue-wait p50/p95: "
              f"{np.percentile(qws, 50):.3f}/"
              f"{np.percentile(qws, 95):.3f}s]")


def repl(args) -> None:
    """Read prompts from stdin until EOF; print each completion: beam
    search with ``--beam B`` (when prompt + gen_tokens fit ctx_len),
    speculative decoding with ``--speculative K`` (prompt lookup, or the
    ``--draft_ckpt`` model; when prompt + gen_tokens + K + 1 fit ctx_len),
    else ``train.trainer.sample`` streaming its text pieces. An MoE
    checkpoint takes none of beam search, speculation and ``--quant``: it
    samples in full precision, with the JAX CLI's notes printed."""
    from ..models.beam import gpt_generate_beam
    from ..models.moe import MoEGPTConfig
    from ..models.speculative import (gpt_generate_speculative,
                                      gpt_generate_speculative_draft)
    from ..train.checkpoint import load_ckpt, load_tokenizer
    from ..train.trainer import sample
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    params, cfg, _, itos = load_ckpt(args.ckpt_dir, device=device)
    params = _maybe_lora(params, args, device)
    tok = load_tokenizer(args.ckpt_dir)  # char or BPE, from the sidecar
    draft = None
    if args.draft_ckpt:
        dparams, dcfg, _, _ = load_ckpt(args.draft_ckpt, device=device)
        if dcfg.vocab_size != cfg.vocab_size:
            print(f"(--draft_ckpt vocab {dcfg.vocab_size} != target "
                  f"{cfg.vocab_size}; ignoring the draft model)")
        elif dcfg.ctx_len < cfg.ctx_len:
            print(f"(--draft_ckpt ctx_len {dcfg.ctx_len} < target "
                  f"{cfg.ctx_len}; ignoring the draft model)")
        else:
            draft = (dparams, dcfg)
    moe = isinstance(cfg, MoEGPTConfig)
    print("\nREPL — type a prompt, Ctrl+C to exit.\n")
    while True:
        try:
            s = input("> ")
        except (KeyboardInterrupt, EOFError):
            print("\nbye")
            break
        if not s.strip():
            continue
        ctx = np.asarray(tok.encode(s), dtype=np.int32)
        if ctx.size == 0:
            print("(no known characters in prompt)")
            continue
        beam_ok = (args.beam > 0 and not moe
                   and ctx.size + args.gen_tokens <= cfg.ctx_len)
        if args.beam > 0 and not beam_ok:
            print("(beam search needs prompt+gen_tokens <= ctx_len and a "
                  "dense GPT; using plain decode)")
        if beam_ok:
            toks, score = gpt_generate_beam(params, cfg, ctx,
                                            args.gen_tokens, beam=args.beam)
            print(_decode_text(tok, itos, toks))
            print(f"[beam={args.beam}: log-prob {score:.2f}, "
                  f"{score / max(len(toks), 1):.3f}/token]")
            continue
        K = args.speculative
        spec_ok = (K > 0 and not moe
                   and ctx.size + args.gen_tokens + K + 1 <= cfg.ctx_len)
        if K > 0 and not spec_ok:
            print("(speculative decode needs prompt+gen_tokens+K+1 <= "
                  "ctx_len and a dense GPT; using plain decode)")
        if spec_ok:
            kw = dict(n_draft=K, temperature=args.temperature,
                      top_k=args.top_k, top_p=args.top_p, seed=args.seed)
            if draft is not None:
                toks, rounds = gpt_generate_speculative_draft(
                    params, cfg, draft[0], draft[1], ctx, args.gen_tokens,
                    **kw)
            else:
                toks, rounds = gpt_generate_speculative(
                    params, cfg, ctx, args.gen_tokens, **kw)
            print(_decode_text(tok, itos, toks))
            print(f"[speculative: {len(toks)} tokens in {rounds} rounds, "
                  f"{len(toks) / max(rounds, 1):.2f} tok/round]")
            continue
        quant = args.quant
        if quant != "none" and moe:
            print("(--quant supports the dense GPT only; using full "
                  "precision)")
            quant = "none"
        for piece in sample(params, cfg, ctx, tok, steps=args.gen_tokens,
                            temperature=args.temperature, top_k=args.top_k,
                            top_p=args.top_p, seed=args.seed,
                            chunk=min(max(args.gen_tokens, 1), 256),
                            quant=quant):
            print(piece, end="", flush=True)
        print()


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.train:
        from ..train.trainer import train

        train(args)
    if args.serve:
        serve_cli(args)
    if args.repl:
        repl(args)
    if not args.train and not args.repl and not args.serve:
        print("Nothing to do. Pass --train, --repl, and/or --serve.")


if __name__ == "__main__":
    main()
