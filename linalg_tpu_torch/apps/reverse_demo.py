"""Reversal-task seq2seq demo — the counterpart of
``linalg_tpu/apps/reverse_demo.py``: train the encoder-decoder of
``models.seq2seq`` to reverse random sequences (teacher forcing, AdamW
without decay), print the loss and token accuracy every 20 epochs and
check greedy decoding at the end.

    python -m linalg_tpu_torch.apps.reverse_demo [--epochs N] [--device cpu]

Runs on the card unless ``--device cpu``. The batches come from the
JAX package's numpy stream for the same seed; the step is eager PyTorch
(forward, the hand-derived backwards, AdamW in place).
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from ..models.seq2seq import (Seq2SeqConfig, init_seq2seq_params,
                              make_reverse_batch, seq2seq_apply,
                              seq2seq_loss)
from ..train.optim import adamw_init, adamw_update, tree_leaves, tree_map
from ..utils.device import resolve_device

__all__ = ["greedy_decode", "train_reverse_demo", "main"]


@torch.no_grad()
def greedy_decode(params, cfg: Seq2SeqConfig, src, bos_id: int = 0):
    """Autoregressive greedy decode of the whole target: (B, T) numpy
    int32 ids."""
    src = np.asarray(src)
    B, T = src.shape
    tgt = np.full((B, 1), bos_id, dtype=np.int32)
    for _ in range(T):
        logits = seq2seq_apply(params, src, tgt, cfg)
        nxt = torch.argmax(logits[:, -1], dim=-1).cpu().numpy().astype(
            np.int32)
        tgt = np.concatenate([tgt, nxt[:, None]], axis=1)
    return tgt[:, 1:]


def train_reverse_demo(epochs: int = 200, B: int = 64, T: int = 10,
                       V: int = 12, lr: float = 3e-4, seed: int = 0,
                       device=None, losses: Optional[List[float]] = None):
    """Train the reversal task for ``epochs`` steps on ``device`` (default
    the card); returns (params, cfg, greedy token accuracy). ``losses``,
    when given, receives every epoch's loss (a host copy per epoch)."""
    dev = resolve_device(device)
    cfg = Seq2SeqConfig(vocab_size=V, d_model=64, n_heads=4, n_enc_layers=2,
                        n_dec_layers=2, d_ff=256, max_len=max(T + 1, 16))
    params = init_seq2seq_params(cfg, seed=seed, device=dev)
    opt_state = adamw_init(params)
    rng = np.random.default_rng(seed)
    wd_tree = tree_map(lambda _: 0.0, params)
    leaves = tree_leaves(params)

    def step(src, tgt_in, tgt_out):
        for p in leaves:
            p.requires_grad_(True)
        loss = seq2seq_loss(params, src, tgt_in, tgt_out, cfg)
        grads = iter(torch.autograd.grad(loss, leaves))
        adamw_update(params, tree_map(lambda _: next(grads), params),
                     opt_state, lr, wd_tree)
        return loss.detach()

    t0 = time.time()
    for ep in range(epochs):
        src, tgt_in, tgt_out = make_reverse_batch(B, T, V, rng=rng)
        loss = step(src, tgt_in, tgt_out)
        if losses is not None:
            losses.append(float(loss))
        if ep % 20 == 0 or ep == epochs - 1:
            with torch.no_grad():
                pred = torch.argmax(seq2seq_apply(params, src, tgt_in, cfg),
                                    -1).cpu().numpy()
            acc = float((pred == tgt_out).mean())
            print(f"epoch {ep:4d}  loss {float(loss):.4f}  token-acc "
                  f"{acc:.3f}")
    print(f"trained in {time.time() - t0:.1f}s")
    for p in leaves:
        p.requires_grad_(False)

    src, _, tgt_out = make_reverse_batch(4, T, V, rng=rng)
    pred = greedy_decode(params, cfg, src)
    print("src :", src[0])
    print("pred:", pred[0])
    print("want:", tgt_out[0])
    acc = (pred == tgt_out).mean()
    print(f"greedy decode token-acc: {acc:.3f}")
    return params, cfg, acc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--seq_len", type=int, default=10)
    ap.add_argument("--vocab", type=int, default=12)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--device", type=str, default=None,
                    help="torch device: cuda (the default; raises on a "
                         "machine without a card) or cpu")
    args = ap.parse_args(argv)
    train_reverse_demo(epochs=args.epochs, T=args.seq_len, V=args.vocab,
                       lr=args.lr, device=args.device)


if __name__ == "__main__":
    main()
