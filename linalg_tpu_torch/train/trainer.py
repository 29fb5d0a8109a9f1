"""Char-GPT trainer — the counterpart of ``linalg_tpu/train/trainer.py``
for one device.

AdamW (betas (0.9, 0.95), the reference's weight-decay rules), linear
warmup + cosine schedule, 90/10 split, random-window batches, loss prints
every 20 steps, val eval every ``eval_every`` with save-best-checkpoint,
resume-or-init on start.

PyTorch idiom: the step runs eagerly — forward, the hand-derived
backwards (``autograd.Function``s, the flash kernels on the card), AdamW
in place. The corpus lives on the device and each step draws its windows
there from a ``torch.Generator``, so no batch crosses from the host; the
every-20-steps loss print is the loop's only host sync besides evals.
While a profiler records, ``make_device_train_step``'s step is traced as
``train.step`` around ``train.forward``, ``train.backward`` (once per
microbatch) and ``train.optimizer``; those three also time their work on
the card (``utils.profiling.device_ms``).

``--dp``, ``--tp``, ``--sp``, ``--pp`` and ``--fsdp`` train over a mesh
(``train_sharded``) whose ranks share one device: dp x tp (megatron), dp
x ep for an MoE, sequence-parallel through the ring kernels, the 1F1B
pipeline, or FSDP.
``--tokenizer bpe --vocab_size N`` trains byte-level BPE on the corpus
first (its merges ride the checkpoint). ``--lora_rank R`` finetunes
rank-R adapters on a trained base checkpoint (``train_lora``): the
gradients are the adapters' only, through ``models.lora.lora_merge``,
and the model's backwards stay its hand-derived ones. ``sample`` streams
text from a model through the KV-cached decode: int8 weights (and int8
KV) with ``quant``, and a windowed RoPE/ALiBi model through the
O(window) ring of ``models.stream``, with no rollover.
``--experts E`` (with ``--router_top_k`` and ``--dispatch``) trains the
routed mixture-of-experts GPT of ``models.moe`` (its loss adds the
load-balance term); its checkpoints, sampling and serving follow.
"""

from __future__ import annotations

import codecs
import json
import math
import time
from typing import Iterator, Tuple

import numpy as np
import torch

from ..models.gpt import (GPTConfig, gpt_decode_chunk, gpt_loss,
                          gpt_prefill, init_gpt_params)
from ..models.moe import (MoEGPTConfig, init_moe_params, moe_decode_chunk,
                          moe_gpt_loss, moe_prefill)
from ..nn.tokenizers import BPETokenizer, CharTokenizer
from ..utils.device import resolve_device
from ..utils.profiling import span
from .checkpoint import load_ckpt, load_tokenizer, save_ckpt
from .data import load_text
from .optim import (adamw_init, adamw_update, gpt_lr_scales, gpt_wd_mask,
                    tree_leaves, tree_map, warmup_cosine)

__all__ = ["train", "train_sharded", "make_train_step",
           "make_device_train_step", "eval_avg", "sample"]


def _loss_fn_for(cfg: GPTConfig):
    """The loss of the config's model: the routed MoE's or the dense
    GPT's."""
    return moe_gpt_loss if isinstance(cfg, MoEGPTConfig) else gpt_loss


def _value_and_grad(params, x, y, cfg, attn_fn=None, lora=None):
    """(loss, grads shaped like params) of the model's loss (attention
    ``attn_fn``, default the model's pick). With ``lora`` = (frozen base
    params, LoRAConfig), ``params`` are the adapters and the loss runs on
    ``lora_merge(base, adapters)``: the gradients flow into A/B only."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    model = params
    if lora is not None:
        from ..models.lora import lora_merge

        model = lora_merge(lora[0], params, lora[1])
    with span("train.forward", x.device):
        loss = _loss_fn_for(cfg)(model, x, y, cfg, attn_fn=attn_fn)
    with span("train.backward", x.device):
        grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def make_train_step(cfg: GPTConfig, *, base_lr: float, min_lr: float,
                    warmup: int, max_steps: int, weight_decay: float):
    """Build ``train_step(params, opt_state, x, y, step) -> (params,
    opt_state, loss)`` over explicit (x, y) id batches; the lr follows
    ``warmup_cosine`` at ``step``."""

    def train_step(params, opt_state, x, y, step):
        loss, grads = _value_and_grad(params, x, y, cfg)
        lr = warmup_cosine(step, base=base_lr, min_lr=min_lr, warmup=warmup,
                           max_steps=max_steps)
        params, opt_state = adamw_update(params, grads, opt_state, lr,
                                         gpt_wd_mask(params, weight_decay))
        return params, opt_state, loss

    return train_step


def _windows(data_ids, batch: int, T: int, generator):
    """(x, y) (batch, T) windows at random starts, drawn on the data's
    device."""
    ix = torch.randint(0, data_ids.shape[0] - T - 1, (batch,),
                       generator=generator, device=data_ids.device)
    offs = ix[:, None] + torch.arange(T, device=data_ids.device)[None, :]
    return data_ids[offs], data_ids[offs + 1]


def make_device_train_step(cfg: GPTConfig, batch_size: int, *,
                           base_lr: float, min_lr: float, warmup: int,
                           max_steps: int, weight_decay: float,
                           lr_embed_scale: float = 1.0,
                           lr_head_scale: float = 1.0, grad_accum: int = 1,
                           clip_norm: float = 0.0, attn_fn=None, lora=None):
    """Build ``train_step(params, opt_state, data_ids, generator) ->
    (params, opt_state, generator, loss)``: batch windows are sampled on
    the device holding ``data_ids`` from ``generator``.

    ``grad_accum`` > 1 splits the batch into that many sequential
    microbatches and applies ONE update on the averaged gradients — the
    full-batch step at 1/grad_accum the activation memory. The schedule is
    driven by the optimizer's own step count. ``attn_fn`` replaces the
    model's attention pick (the sequence-parallel ring).

    ``lora`` = (frozen base params, LoRAConfig) makes it a LoRA finetune
    step: ``params`` are the adapter dict, the loss runs on the merged
    weights, and the base stays constant. The name-keyed wd and lr masks
    see adapter names (``Wq_A``, ...): no decay, unit lr scale."""
    B, T = batch_size, cfg.ctx_len
    if grad_accum < 1 or B % grad_accum:
        raise ValueError(
            f"grad_accum must divide batch_size: {grad_accum} vs {B}")
    micro = B // grad_accum

    def train_step(params, opt_state, data_ids, generator):
        with span("train.step"):
            return step(params, opt_state, data_ids, generator)

    def step(params, opt_state, data_ids, generator):
        x, y = _windows(data_ids, B, T, generator)
        if grad_accum == 1:
            loss, grads = _value_and_grad(params, x, y, cfg, attn_fn, lora)
        else:
            loss, grads = 0.0, None
            for i in range(grad_accum):
                sl = slice(i * micro, (i + 1) * micro)
                l, g = _value_and_grad(params, x[sl], y[sl], cfg, attn_fn,
                                       lora)
                loss = loss + l
                grads = g if grads is None else tree_map(torch.add, grads, g)
            loss = loss / grad_accum
            grads = tree_map(lambda g: g / grad_accum, grads)
        with span("train.optimizer", data_ids.device):
            lr = warmup_cosine(opt_state.t + 1, base=base_lr, min_lr=min_lr,
                               warmup=warmup, max_steps=max_steps)
            params, opt_state = adamw_update(
                params, grads, opt_state, lr,
                gpt_wd_mask(params, weight_decay),
                lr_scales=gpt_lr_scales(params, embed=lr_embed_scale,
                                        head=lr_head_scale),
                clip_norm=clip_norm)
        return params, opt_state, generator, loss

    return train_step


@torch.no_grad()
def _eval_loss(params, x, y, cfg: GPTConfig):
    return _loss_fn_for(cfg)(params, x, y, cfg)


def eval_avg(params, cfg: GPTConfig, it: Iterator, batches: int = 10
             ) -> float:
    """Mean loss over ``batches`` host (x, y) batches from ``it``."""
    dev = params["tok_W"].device
    losses = [float(_eval_loss(params, torch.as_tensor(x, device=dev),
                               torch.as_tensor(y, device=dev), cfg))
              for x, y in (next(it) for _ in range(batches))]
    return float(np.mean(losses))


@torch.no_grad()
def _eval_device(params, val_ids, generator, cfg: GPTConfig, batch: int,
                 batches: int, attn_fn=None):
    """Mean val loss over ``batches`` random device windows; one scalar
    tensor, no host sync."""
    loss_fn = _loss_fn_for(cfg)
    total = 0.0
    for _ in range(batches):
        total = total + loss_fn(params, *_windows(val_ids, batch,
                                                  cfg.ctx_len, generator),
                                cfg, attn_fn=attn_fn)
    return total / batches


def _make_tokenizer(args, text: str):
    """Fresh-model tokenizer from the flags: the corpus's characters, or
    byte-level BPE trained on it (``--tokenizer bpe --vocab_size N``)."""
    if (getattr(args, "tokenizer", "char") or "char") == "bpe":
        return BPETokenizer.train(
            text, int(getattr(args, "vocab_size", 512) or 512))
    return CharTokenizer(text)


def _tok_maps(tok) -> Tuple[dict, dict]:
    """(stoi, itos) for the sidecar: the char maps, or empty dicts for BPE
    (whose state is its merge table)."""
    if hasattr(tok, "stoi"):
        return tok.stoi, tok.itos
    return {}, {}


def _resume_or_init(args, device):
    """The reference's resume-or-init: load ``args.ckpt_dir``; on any
    failure to load, build a fresh model from the flags (weights from
    seed 123, as the JAX package draws them): the routed MoE GPT with
    ``--experts`` > 0 (``--router_top_k``, ``--dispatch``), else the dense
    GPT.

    Returns (text, params, cfg, tok, stoi, itos)."""
    text = load_text(getattr(args, "data", None))
    try:
        params, cfg, stoi, itos = load_ckpt(args.ckpt_dir, device=device)
        tok = load_tokenizer(args.ckpt_dir)
        print(f"resumed from {args.ckpt_dir}")
        return text, params, cfg, tok, stoi, itos
    except (OSError, ValueError, KeyError):
        print("Error loading checkpoint, starting from scratch")
    tok = _make_tokenizer(args, text)
    stoi, itos = _tok_maps(tok)
    common = dict(
        vocab_size=tok.vocab_size, d_model=args.d_model, n_heads=args.heads,
        n_layers=args.layers, ctx_len=args.ctx_len,
        pos=getattr(args, "pos", "sinusoidal") or "sinusoidal",
        dtype=getattr(args, "dtype", "float32") or "float32",
        n_kv_heads=getattr(args, "kv_heads", None),
        window=getattr(args, "window", None),
        ffn=getattr(args, "ffn", "relu") or "relu")
    n_experts = int(getattr(args, "experts", 0) or 0)
    if n_experts > 0:
        cfg = MoEGPTConfig(
            n_experts=n_experts,
            router_top_k=int(getattr(args, "router_top_k", 1) or 1),
            dispatch=getattr(args, "dispatch", "einsum") or "einsum",
            **common)
        params = init_moe_params(cfg, seed=123, device=device)
    else:
        cfg = GPTConfig(**common)
        params = init_gpt_params(cfg, seed=123, device=device)
    return text, params, cfg, tok, stoi, itos


class _MetricsLog:
    """Append-mode JSONL metrics sink (``--log_file``); None path = no-op.
    Rows are written only at the loop's existing host-sync points."""

    def __init__(self, path):
        self._f = open(path, "a", encoding="utf-8") if path else None

    def write(self, **row):
        if self._f is not None:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()


def _train_loop(args, cfg, params, opt_state, generator, step_fn, eval_fn,
                train_ids, val_ids, tok, stoi, itos, desc: str = "",
                save_fn=None):
    """The training loop: ``step_fn(params, opt_state, train_ids,
    generator)`` per step, ``eval_fn(params, val_ids, generator)`` every
    ``args.eval_every`` steps, the best checkpoint saved on improvement
    (``save_fn(params) -> path`` instead of ``save_ckpt`` when given: LoRA
    saves the adapters only). Printing every 20 steps is the host sync.
    In a process group only process 0 prints and writes the metrics log;
    every process calls ``save_fn`` (a sharded trainer's gathers its
    shards collectively) and the checkpoint writers write from process 0
    only."""
    from ..parallel.distributed import process_index
    from ..utils.profiling import StepTimer, trace

    lead = process_index() == 0
    say = print if lead else (lambda *a, **k: None)
    best = 1e9
    t0 = time.time()
    tokens_per_step = args.batch_size * cfg.ctx_len
    timer = StepTimer(tokens_per_step, window=10)
    last_sync = 0
    mlog = _MetricsLog(getattr(args, "log_file", None) if lead else None)
    with trace(getattr(args, "profile", None)):
        for step in range(1, args.steps + 1):
            params, opt_state, generator, loss = step_fn(
                params, opt_state, train_ids, generator)
            if step % 20 == 0 or step == 1:
                loss_f = float(loss)  # the host sync point
                timer.tick(step - last_sync)
                last_sync = step
                rate = (f"  ({timer.steps_per_sec:.1f} steps/s, "
                        f"{timer.tokens_per_sec:.0f} tok/s)"
                        if step > 1 else "")
                say(f"step {step:6d}  loss {loss_f:.4f}{rate}")
                mlog.write(event="train", step=step, loss=loss_f,
                           steps_per_sec=(timer.steps_per_sec
                                          if step > 1 else None),
                           tokens_per_sec=(timer.tokens_per_sec
                                           if step > 1 else None),
                           elapsed_s=round(time.time() - t0, 3))
            if step % args.eval_every == 0:
                val_loss = float(eval_fn(params, val_ids, generator))
                say(f"[eval] step {step:6d}  val_loss {val_loss:.4f}")
                saved = None
                if val_loss < best:
                    best = val_loss
                    path = (save_fn(params) if save_fn is not None else
                            save_ckpt(args.ckpt_dir, params, cfg, stoi, itos,
                                      tokenizer=tok))
                    say(f"  saved best -> {path}  (val {best:.4f})")
                    saved = str(path)
                mlog.write(event="eval", step=step, val_loss=val_loss,
                           best=best, ckpt=saved,
                           elapsed_s=round(time.time() - t0, 3))
    dt = time.time() - t0
    say(f"done in {dt:.1f}s  ({desc}{args.steps / dt:.2f} steps/s, "
          f"{args.steps * tokens_per_step / dt:.0f} tok/s)")
    mlog.write(event="done", steps=args.steps, wall_s=round(dt, 3),
               steps_per_sec=round(args.steps / dt, 3),
               tokens_per_sec=round(args.steps * tokens_per_step / dt, 1),
               best_val_loss=(best if best < 1e9 else None))
    mlog.close()
    return params


def _lr_kwargs(args):
    base_lr = args.lr_model
    return dict(
        base_lr=base_lr, min_lr=base_lr / 10, warmup=200,
        max_steps=args.steps, weight_decay=args.weight_decay,
        lr_embed_scale=(getattr(args, "lr_embed", base_lr) / base_lr
                        if base_lr else 1.0),
        lr_head_scale=(getattr(args, "lr_head", base_lr) / base_lr
                       if base_lr else 1.0),
    )


def _corpus(tok, text, device):
    """The 90/10 split of the corpus, encoded once on the host (char or
    BPE) and moved to the device once."""
    ids = tok.encode(text)
    split = int(0.9 * len(ids))
    return (torch.as_tensor(ids[:split], dtype=torch.long, device=device),
            torch.as_tensor(ids[split:], dtype=torch.long, device=device))


def _placement(mesh) -> str:
    """Where a mesh's ranks lie, for the trainer's mesh line."""
    devs = list(dict.fromkeys(str(mesh.rank_devices[r])
                              for r in mesh.local_ranks))
    if mesh.spans_processes:
        return (f"{mesh.size} ranks over {len(mesh.processes)} processes "
                f"({len(mesh.local_ranks)} here on {', '.join(devs)})")
    if len(devs) == 1:
        return f"{mesh.size} ranks share {devs[0]}"
    return f"{mesh.size} ranks over {', '.join(devs)}"


def train_sharded(args, dp: int, tp: int, device):
    """Multi-rank training over a dp x {tp|sp|pp|ep} or fsdp mesh dealt
    over the job's devices of ``device``'s type (``parallel.mesh
    .make_mesh``): every card of this process, or after
    ``init_distributed`` every card of every process, each an equal
    contiguous block of the ranks (on one card they all share it; with
    ``--device cpu`` one CPU device a process). The JAX package's
    ``train_sharded``, with its branches, refusals and messages. Each
    process computes its own ranks; every process draws the same batches
    and gets the same loss.

    Axis selection: ``--tp`` splits heads/FFN (megatron), or EXPERTS when
    the model is an MoE (``--experts``); ``--sp`` splits the sequence (the
    ring: kernels with ``--ring pallas``, the default on CUDA, or the
    plain ring); ``--pp`` splits the layer stack (1F1B, ``--microbatches``
    or 2*pp when the batch divides, else pp); ``--fsdp`` splits parameter
    and optimizer storage over the data axis (ZeRO-3). Same loop as
    ``train``; eval averages 10 batches, as JAX's sharded evals do. The
    best checkpoint is gathered to whole arrays (across processes first)
    and saved as ``train`` saves it, from process 0; the whole parameters
    are returned in every process. A ``--sp`` mesh across processes runs
    per-rank blocks (``make_sp_ranks_*``): through K10/K11 with ``--ring
    pallas`` (and ``auto`` on the card), each process reading the others'
    chunks through CUDA IPC (the kernels' plain versions on the CPU), or
    the plain ring with ``--ring xla``; the rings' arenas are released in
    every process at the end."""
    from ..parallel.distributed import local_devices, process_count
    from ..parallel.mesh import make_mesh, shard_tree, unshard_tree

    if device.type == "cuda" and device.index is None:
        device = local_devices("cuda")[0]  # this process's (LOCAL_RANK's)
    text, params, cfg, tok, stoi, itos = _resume_or_init(args, device)
    if args.batch_size % dp:
        raise AssertionError("batch_size must divide by dp")
    sp = int(getattr(args, "sp", 1) or 1)
    pp = int(getattr(args, "pp", 1) or 1)
    fsdp = int(getattr(args, "fsdp", 1) or 1)
    is_moe = isinstance(cfg, MoEGPTConfig)
    is_sp, is_pp, is_fsdp = sp > 1, pp > 1, fsdp > 1
    microbatches = 0

    def refuse(ok, msg):
        if not ok:
            raise AssertionError(msg)

    if is_fsdp:
        from ..parallel.fsdp import fsdp_param_specs

        refuse(dp == 1 and tp == 1 and not (is_sp or is_pp),
               "--fsdp is itself the data axis; it does not compose with "
               "--dp/--tp/--sp/--pp")
        refuse(not is_moe, "--fsdp with --experts is not supported")
        refuse(args.batch_size % fsdp == 0, "batch_size must divide by fsdp")
        shape, names = (fsdp,), ("fsdp",)
        specs = fsdp_param_specs(params, fsdp)
    elif is_pp:
        from ..parallel.pipeline import pp_param_specs

        refuse(tp == 1 and not is_sp, "--pp composes with --dp only")
        refuse(cfg.pos != "learned",
               "--pos learned is not supported with --pp (the pipeline "
               "stages hardcode sinusoidal/rope position handling)")
        refuse(not is_moe, "--pp with --experts is not supported")
        refuse(cfg.n_layers % pp == 0, "layers must divide by pp")
        microbatches = int(getattr(args, "microbatches", 0) or 0)
        if microbatches <= 0:  # auto: 2*pp keeps the 1F1B bubble small
            microbatches = (2 * pp if args.batch_size % (dp * 2 * pp) == 0
                            else pp)
        refuse(args.batch_size % (dp * microbatches) == 0,
               "batch_size must divide by dp * microbatches")
        shape, names = (dp, pp), ("dp", "pp")
        specs = pp_param_specs("dp")
    elif is_sp:
        refuse(tp == 1, "--sp composes with --dp only (not --tp)")
        refuse(not is_moe, "--sp with --experts is not supported")
        refuse(cfg.ctx_len % sp == 0, "ctx_len must divide by sp")
        shape, names, specs = (dp, sp), ("dp", "sp"), None
    elif is_moe:
        from ..parallel.expert import moe_param_specs

        refuse(cfg.n_experts % tp == 0, "n_experts must divide by tp (=ep)")
        shape, names = (dp, tp), ("dp", "ep")
        specs = moe_param_specs(cfg)
    else:
        from ..parallel.sharding import gpt_param_specs

        refuse(cfg.n_heads % tp == 0, "n_heads must divide by tp")
        shape, names = (dp, tp), ("dp", "tp")
        specs = gpt_param_specs(None, cfg)
    if int(getattr(args, "grad_accum", 1) or 1) > 1:
        raise ValueError("--grad_accum composes with the single-chip "
                         "trainer only; use --dp to split the batch "
                         "across devices instead")
    n = math.prod(shape)
    mesh = make_mesh(shape, names, device_type=device.type)
    if len(mesh.processes) != process_count():
        raise ValueError(f"the mesh's {n} ranks leave a process of the "
                         f"job without a rank")
    train_ids, val_ids = _corpus(tok, text, device)
    lr_kwargs = dict(_lr_kwargs(args),
                     clip_norm=float(getattr(args, "clip_norm", 0.0) or 0.0))
    B = args.batch_size
    if is_fsdp:
        from ..parallel.fsdp import (make_fsdp_device_train_step,
                                     make_fsdp_eval)

        step_fn = make_fsdp_device_train_step(cfg, mesh, params, B,
                                              **lr_kwargs)
        eval_fn = make_fsdp_eval(cfg, mesh, params, B, 10)
        desc = f"mesh fsdp={fsdp}, "
    elif is_pp:
        from ..parallel.pipeline import make_pp_device_train_step, make_pp_eval

        step_fn = make_pp_device_train_step(
            cfg, mesh, B, n_microbatches=microbatches, **lr_kwargs)
        eval_fn = make_pp_eval(cfg, mesh, B, 10, n_microbatches=microbatches)
        desc = f"mesh dp={dp} pp={pp}, "
    elif is_sp:
        from ..parallel.sharding import (make_sp_device_train_step,
                                         make_sp_eval)

        ring = getattr(args, "ring", "auto") or "auto"
        if ring not in ("auto", "pallas", "xla"):
            raise ValueError(f"--ring must be auto, pallas or xla, got "
                             f"{ring!r}")
        pallas = device.type == "cuda" if ring == "auto" else ring == "pallas"
        if mesh.spans_processes:  # per-rank blocks, this process's ranks
            from ..parallel.sharding import (make_sp_ranks_device_train_step,
                                             make_sp_ranks_eval,
                                             sp_param_specs)

            specs = sp_param_specs(cfg)
            step_fn = make_sp_ranks_device_train_step(cfg, mesh, B,
                                                      pallas=pallas,
                                                      **lr_kwargs)
            eval_fn = make_sp_ranks_eval(cfg, mesh, B, 10, pallas=pallas)
        else:
            step_fn = make_sp_device_train_step(cfg, mesh, B, pallas=pallas,
                                                **lr_kwargs)
            eval_fn = make_sp_eval(cfg, mesh, B, 10, pallas=pallas)
        desc = f"mesh dp={dp} sp={sp}, "
    elif is_moe:
        from ..parallel.expert import make_ep_device_train_step, make_ep_eval

        step_fn = make_ep_device_train_step(cfg, mesh, B, **lr_kwargs)
        eval_fn = make_ep_eval(cfg, mesh, B, 10)
        desc = f"mesh dp={dp} {'ep' if tp > 1 else 'tp'}={tp}, "
    else:
        from ..parallel.sharding import (make_sharded_device_train_step,
                                         make_sharded_eval)

        step_fn = make_sharded_device_train_step(cfg, mesh, B, **lr_kwargs)
        eval_fn = make_sharded_eval(cfg, mesh, B, 10)
        desc = f"mesh dp={dp} tp={tp}, "
    what = (f"ring {'kernels (K10/K11)' if pallas else 'plain'}"
            + (", other processes' chunks through CUDA IPC"
               if pallas and mesh.spans_processes and device.type == "cuda"
               else "") if is_sp
            else f"{microbatches} microbatches (1F1B)" if is_pp
            else "parameters and moments sharded" if is_fsdp else
            "experts sharded" if is_moe and tp > 1 else "heads/FFN sharded")
    if mesh.process == 0:
        print(f"{desc[:-2]}: {_placement(mesh)}; {what}")
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if specs is None:  # sp: parameters replicated, the ring shares them
        params = _train_loop(args, cfg, params, adamw_init(params),
                             generator, step_fn, eval_fn, train_ids, val_ids,
                             tok, stoi, itos, desc=desc)
    else:
        rank_params = shard_tree(params, specs, mesh)
        del params

        def save_fn(rp):
            return save_ckpt(args.ckpt_dir, unshard_tree(rp, specs, mesh),
                             cfg, stoi, itos, tokenizer=tok)

        rank_params = _train_loop(
            args, cfg, rank_params,
            [None if p is None else adamw_init(p) for p in rank_params],
            generator, step_fn, eval_fn, train_ids, val_ids, tok, stoi, itos,
            desc=desc, save_fn=save_fn)
        params = unshard_tree(rank_params, specs, mesh)
    if is_sp and mesh.spans_processes:  # no peer reads an arena any more
        from ..kernels.ring_attention import release_ring_arenas

        release_ring_arenas()
    for p in tree_leaves(params):
        p.requires_grad_(False)
    return params, cfg, stoi, itos


def train_lora(args) -> Tuple[dict, GPTConfig, dict, dict]:
    """LoRA finetune: freeze the trained base checkpoint in
    ``args.ckpt_dir``, train rank-``args.lora_rank`` adapters on the
    corpus and save adapter-only checkpoints to ``--lora_dir`` (default
    <ckpt_dir>/lora), resuming from adapters found there. Returns the
    MERGED params (the JAX package's ``train_lora``)."""
    import pathlib

    from ..models.lora import (LoRAConfig, init_lora_params, load_lora,
                               lora_merge, save_lora)

    device = resolve_device(getattr(args, "device", None))
    text = load_text(getattr(args, "data", None))
    try:
        params, cfg, stoi, itos = load_ckpt(args.ckpt_dir, device=device)
        tok = load_tokenizer(args.ckpt_dir)
    except Exception as e:
        raise ValueError(
            "LoRA finetuning adapts a TRAINED base model: --ckpt_dir must "
            "hold a loadable checkpoint (train one first, without "
            "--lora_rank)") from e
    lora_dir = getattr(args, "lora_dir", "") or str(
        pathlib.Path(args.ckpt_dir) / "lora")
    lcfg = LoRAConfig(rank=int(args.lora_rank),
                      alpha=float(getattr(args, "lora_alpha", 16.0)),
                      targets=getattr(args, "lora_targets", "attn"))
    try:
        adapters, lcfg = load_lora(lora_dir, device=device)
        print(f"resumed LoRA adapters from {lora_dir} "
              f"(rank {lcfg.rank}, targets {lcfg.targets})")
    except Exception:
        adapters = init_lora_params(params, lcfg, seed=args.seed,
                                    device=device)
        n_ad = sum(x.numel() for x in tree_leaves(adapters))
        n_base = sum(x.numel() for x in tree_leaves(params))
        print(f"fresh LoRA adapters: rank {lcfg.rank}, targets "
              f"{lcfg.targets}, {n_ad:,} trainable params "
              f"({100 * n_ad / n_base:.1f}% of the base model)")
    train_ids, val_ids = _corpus(tok, text, device)
    step_fn = make_device_train_step(
        cfg, args.batch_size, lora=(params, lcfg),
        grad_accum=int(getattr(args, "grad_accum", 1) or 1),
        clip_norm=float(getattr(args, "clip_norm", 0.0) or 0.0),
        **_lr_kwargs(args))

    def eval_fn(a, v, g):
        return _eval_device(lora_merge(params, a, lcfg), v, g, cfg,
                            args.batch_size, 20)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    adapters = _train_loop(args, cfg, adapters, adamw_init(adapters),
                           generator, step_fn, eval_fn, train_ids, val_ids,
                           tok, stoi, itos, desc="lora: ",
                           save_fn=lambda a: save_lora(lora_dir, a, lcfg))
    for p in tree_leaves(adapters):
        p.requires_grad_(False)
    return lora_merge(params, adapters, lcfg), cfg, stoi, itos


def train(args) -> Tuple[dict, GPTConfig, dict, dict]:
    """Run the training loop on ``args.device`` (default: the card; the
    CPU only when asked for); returns (params, cfg, stoi, itos). A mesh
    (dp * tp * sp * pp * fsdp > 1) trains sharded (``train_sharded``),
    ``--lora_rank`` finetunes adapters (``train_lora``)."""
    axes = {a: int(getattr(args, a, 1) or 1)
            for a in ("dp", "tp", "sp", "pp", "fsdp")}
    if int(getattr(args, "lora_rank", 0) or 0) > 0:
        if math.prod(axes.values()) > 1:
            raise ValueError("LoRA finetuning runs single-device; drop the "
                             "--dp/--tp/--sp/--pp/--fsdp flags")
        return train_lora(args)
    device = resolve_device(getattr(args, "device", None))
    if math.prod(axes.values()) > 1:
        return train_sharded(args, axes["dp"], axes["tp"], device)
    text, params, cfg, tok, stoi, itos = _resume_or_init(args, device)
    train_ids, val_ids = _corpus(tok, text, device)

    opt_state = adamw_init(params)
    step_fn = make_device_train_step(
        cfg, args.batch_size,
        grad_accum=int(getattr(args, "grad_accum", 1) or 1),
        clip_norm=float(getattr(args, "clip_norm", 0.0) or 0.0),
        **_lr_kwargs(args))

    def eval_fn(p, v, g):
        return _eval_device(p, v, g, cfg, args.batch_size, 20)

    generator = torch.Generator(device=device).manual_seed(args.seed)
    params = _train_loop(args, cfg, params, opt_state, generator, step_fn,
                         eval_fn, train_ids, val_ids, tok, stoi, itos)
    for p in tree_leaves(params):
        p.requires_grad_(False)
    return params, cfg, stoi, itos


def _emitter(itos):
    """Token id -> text piece: a BPE tokenizer's bytes through an
    incremental UTF-8 decoder (a character split across tokens comes out
    whole), a char tokenizer's ``itos``, or a plain id -> char dict."""
    if hasattr(itos, "token_bytes"):
        utf8 = codecs.getincrementaldecoder("utf-8")("replace")
        return lambda t: utf8.decode(itos.token_bytes(t))
    if hasattr(itos, "itos"):
        return itos.itos.__getitem__
    return itos.__getitem__


def sample(params, cfg: GPTConfig, ctx_ids, itos, steps: int = 200,
           temperature: float = 1.0, top_k: int = 0, seed: int = 0,
           chunk: int = 256, top_p: float = 0.0, quant: str = "none"):
    """Streaming generator of text pieces: KV-cached incremental decode,
    the JAX package's ``sample``.

    ``itos`` is the char id -> char dict, a char tokenizer, or a BPE
    tokenizer (bytes through an incremental UTF-8 decoder). The prompt is
    prefilled once (right-padded to the fixed window ``keep``), then each
    chunk samples n = max(1, min(chunk, ctx_len // 2)) tokens on the
    device and one copy brings them to the host. Draws come from one
    generator on the parameters' device seeded with ``seed``.

    - A windowed RoPE/ALiBi model in full precision streams through the
      O(window) ring (``models.stream``): positions run past ctx_len with
      no rollover and no second prefill.
    - Otherwise, when fewer than n cache rows are left, the last ``keep``
      = ctx_len - n ids are prefilled again (context rollover).
    - ``quant="int8"`` decodes through int8 weights
      (``models.quant.gpt_decode_chunk_q``, mode "deq"), ``"int8kv"`` with
      the KV cache int8 too; the prefill stays full precision.
    - An MoE model prefills through ``moe_prefill`` and decodes through
      ``moe_decode_chunk`` (a windowed one re-prefills: no ring); ``quant``
      raises, as in the JAX package."""
    moe = isinstance(cfg, MoEGPTConfig)
    if moe:
        if quant not in ("", "none"):
            raise ValueError("quant decode supports the dense GPT only")
        decode_chunk, prefill_fn = moe_decode_chunk, moe_prefill
    elif quant in ("int8", "int8kv"):
        from ..models.quant import (gpt_decode_chunk_q, quantize_gpt_params,
                                    quantize_kv_cache)

        qparams = quantize_gpt_params(params, cfg)
        kv8 = quant == "int8kv"

        def decode_chunk(p, *a):
            return gpt_decode_chunk_q(qparams, *a, kv8=kv8)

        def prefill_fn(p, ids, c, length):
            logits, cache = gpt_prefill(p, ids, c, length)
            return logits, (quantize_kv_cache(cache) if kv8 else cache)
    elif quant in ("", "none"):
        decode_chunk, prefill_fn = gpt_decode_chunk, gpt_prefill
    else:
        raise ValueError(f"unknown quant mode: {quant!r}")
    emit = _emitter(itos)
    dev = params["tok_W"].device
    generator = torch.Generator(device=dev).manual_seed(seed)
    ids = [int(i) for i in np.asarray(ctx_ids).ravel()]
    n = max(1, min(chunk, cfg.ctx_len // 2))
    keep = cfg.ctx_len - n  # the window that always leaves n rows free

    def prefill(ids):
        ids = ids[-keep:]
        buf = np.zeros((1, keep), dtype=np.int64)
        buf[0, :len(ids)] = ids
        logits, cache = prefill_fn(params, torch.as_tensor(buf, device=dev),
                                   cfg, len(ids))
        return logits, cache, len(ids)

    logits, cache, length = prefill(ids)
    stream = (cfg.window is not None and cfg.pos in ("rope", "alibi")
              and not moe and quant in ("", "none"))
    if stream:
        from ..models.stream import (gpt_stream_chunk, init_stream_cache,
                                     stream_fill)

        ring = stream_fill(init_stream_cache(cfg, device=dev), cache, length,
                           cfg)
    remaining = steps
    while remaining > 0:
        if stream:
            toks, logits, ring = gpt_stream_chunk(
                params, ring, logits, generator, cfg, n, temperature, top_k,
                top_p)
        else:
            if cfg.ctx_len - length < n:  # context full: slide the window
                logits, cache, length = prefill(ids)
            toks, logits, cache = decode_chunk(
                params, cache, logits, generator, cfg, n, temperature,
                top_k, top_p)
            length += n
        emit_n = min(n, remaining)
        for t in toks[0, :emit_n].cpu().tolist():  # one copy per chunk
            ids.append(t)
            yield emit(t)
        remaining -= emit_n
