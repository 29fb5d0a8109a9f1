"""Learned boolean gates — the counterpart of
``linalg_tpu/apps/logic_gates.py``: a 2 -> H -> 2 ReLU-softmax MLP learns
a gate's truth table (XOR, OR) by full-batch SGD, then folds over bit
sequences with hard asserts against ``functools.reduce``.

    python -m linalg_tpu_torch.apps.logic_gates [--gate xor|or|both]
        [--device cpu]

Runs on the card unless ``--device cpu``. The weights are the JAX
package's numpy draws for the same seed; the step differentiates the loss
with torch autograd (the JAX module takes ``jax.value_and_grad`` of plain
``jnp``, no ``custom_vjp``).
"""

from __future__ import annotations

import argparse
import functools
import operator
from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["GateMLP", "train_gate", "gate_apply", "gate_reduce",
           "XOR_TABLE", "OR_TABLE", "main"]

XOR_TABLE = ([0, 1, 1, 0], "XOR", operator.xor)
OR_TABLE = ([0, 1, 1, 1], "OR", operator.or_)

_INPUTS = np.array([[0.0, 0.0], [0.0, 1.0], [1.0, 0.0], [1.0, 1.0]],
                   dtype=np.float32)


class GateMLP:
    """2 -> H -> 2 MLP with a ReLU hidden layer and softmax output, on
    ``device`` (default: the card)."""

    def __init__(self, H: int = 8, seed: int = 0, device=None):
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)
        std1, std2 = np.sqrt(2.0 / 2), np.sqrt(2.0 / H)

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=self.device)

        self.params = {
            "W1": t(rng.normal(0, std1, (2, H))),
            "b1": t(np.zeros(H)),
            "W2": t(rng.normal(0, std2, (H, 2))),
            "b2": t(np.zeros(2)),
        }

    @staticmethod
    def apply(params, X):
        # max(0, z) as jnp.maximum takes it: a tie's gradient is split in
        # half (the (0, 0) row meets b1 = 0 exactly at the start), where
        # torch.relu would give it all to one side
        z = X @ params["W1"] + params["b1"]
        return torch.maximum(z.new_zeros(()), z) @ params["W2"] + params["b2"]

    def predict_proba(self, X):
        X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        with torch.no_grad():
            return torch.softmax(self.apply(self.params, X), dim=-1)

    def predict(self, X):
        return self.predict_proba(X).argmax(dim=-1).cpu().numpy()


def train_gate(labels: Sequence[int], H: int = 8, epochs: int = 400,
               lr: float = 0.1, weight_decay: float = 1e-4, seed: int = 0,
               verbose: bool = True, device=None) -> GateMLP:
    """Full-batch SGD on the truth table: mean CE plus 0.5 * weight_decay *
    sum of the squared weight matrices."""
    model = GateMLP(H=H, seed=seed, device=device)
    X = torch.as_tensor(_INPUTS, device=model.device)
    y = torch.as_tensor(np.asarray(labels, np.int64), device=model.device)
    params = model.params
    for p in params.values():
        p.requires_grad_(True)
    for ep in range(epochs):
        logits = GateMLP.apply(params, X)
        ce = torch.mean(torch.logsumexp(logits, dim=-1)
                        - logits.gather(-1, y[:, None])[:, 0])
        l2 = sum(torch.sum(w ** 2) for k, w in params.items()
                 if k.startswith("W"))
        loss = ce + 0.5 * weight_decay * l2
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for p, g in zip(params.values(), grads):
                p.sub_(lr * g)
        if verbose and (ep % 100 == 0 or ep == epochs - 1):
            acc = float((model.predict(_INPUTS) == np.asarray(labels)).mean())
            print(f"epoch {ep:4d}  loss(tt) {float(loss.detach()):.6f}  "
                  f"acc(tt) {acc:.3f}")
    for p in params.values():
        p.requires_grad_(False)
    return model


def gate_apply(model: GateMLP, a, b) -> int:
    """Apply the learned gate to two bits."""
    return int(model.predict(np.array([[float(a), float(b)]],
                                      dtype=np.float32))[0])


def gate_reduce(model: GateMLP, bits: Sequence[int]) -> Tuple[int, list]:
    """Left fold of the learned gate over a bit sequence."""
    bits = [int(b) for b in bits]
    acc = bits[0]
    intermediates = [acc]
    for nxt in bits[1:]:
        acc = gate_apply(model, acc, nxt)
        intermediates.append(acc)
    return acc, intermediates


def _demo(table, device=None):
    labels, name, op = table
    print(f"=== {name} gate ===")
    model = train_gate(labels, device=device)
    print("Truth table preds:", model.predict(_INPUTS))
    seq = [1, 0, 1, 1, 0]
    final_bit, steps = gate_reduce(model, seq)
    print(f"Sequence {seq} -> {name} fold {final_bit}, steps={steps}")
    for (a, b), want in zip([(0, 0), (0, 1), (1, 0), (1, 1)], labels):
        assert gate_apply(model, a, b) == want, (a, b, want)
    assert final_bit == functools.reduce(op, seq)
    print(f"{name}: all truth-table and fold asserts passed")
    return model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gate", choices=["xor", "or", "both"], default="both")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    models = []
    if args.gate in ("xor", "both"):
        models.append(_demo(XOR_TABLE, args.device))
    if args.gate in ("or", "both"):
        models.append(_demo(OR_TABLE, args.device))
    return models


if __name__ == "__main__":
    main()
