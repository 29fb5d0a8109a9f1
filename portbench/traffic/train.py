"""Training traffic: batches of random token ids from the seed, through the
program's device training step with AdamW.

The mix file gives ``batch``, ``seq`` (the configuration's ``ctx_len``),
``grad_accum``, ``corpus_tokens`` (the corpus the step draws its windows
from, ids uniform over the vocabulary) and ``schedule`` (the optimizer's
learning-rate schedule and weight decay).

Set-up makes the weights and the corpus on the card, builds the step
(``train.trainer.make_device_train_step``) and runs its first three
steps, which warm every shape and are the ones the check follows: their
losses, the first gradient as AdamW holds it (its first moment over
1 - beta1), and how far the weights moved. The window runs the same step
on the same objects until ``--seconds`` have passed, then synchronises.
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch

from portbench import flops, weights
from portbench.reference import gpt as ref

CHECK_STEPS = 3
TRACE_STEPS = 3  # the steps a traced run profiles
BETA1 = 0.9


def _corpus(mix: Dict, vocab: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2654435761 + 17) % (1 << 63))
    return torch.randint(0, vocab, (int(mix["corpus_tokens"]),),
                         generator=g, device=device)


def windows(data: torch.Tensor, batch: int, seq: int, gen):
    """The (x, y) rows the training step draws from ``data`` with ``gen``:
    ``batch`` random starts, each row ``seq`` ids and its shift by one."""
    ix = torch.randint(0, data.shape[0] - seq - 1, (batch,), generator=gen,
                       device=data.device)
    offs = ix[:, None] + torch.arange(seq, device=data.device)[None, :]
    return data[offs], data[offs + 1]


class Run:
    def __init__(self, cell: Dict, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg = cell["config"]
        self.shape, self.init = self.cfg["port"], self.cfg["init"]
        self.mix = cell["mix"]
        self.B, self.T = int(self.mix["batch"]), int(self.mix["seq"])
        if self.T != self.shape["ctx_len"]:
            raise ValueError("the step trains on ctx_len-token rows: seq "
                             f"{self.T} != ctx_len {self.shape['ctx_len']}")
        self.step_flops = flops.train_step_flops(self.shape, self.B,
                                                 self.T)["total"]

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- the program ----------------------------------------------------

    def setup(self) -> None:
        from linalg_tpu_torch.models.gpt import GPTConfig
        from linalg_tpu_torch.train.optim import adamw_init
        from linalg_tpu_torch.train.trainer import make_device_train_step

        shape, mix = self.shape, self.mix
        cfg = GPTConfig(**{k: shape[k] for k in (
            "vocab_size", "d_model", "n_heads", "n_layers", "d_ff",
            "ctx_len", "pos", "dtype", "n_kv_heads", "window", "ffn")
            if k in shape})
        self.params = weights.make_params(shape, self.init, self.seed,
                                          self.device, torch.float32)
        self.opt = adamw_init(self.params)
        self.data = _corpus(mix, shape["vocab_size"], self.seed,
                            self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed((self.seed * 40503 + 7) % (1 << 63))
        # the rows of the checked steps, drawn as the step will draw them
        twin = torch.Generator(device=self.device)
        twin.set_state(self.gen.get_state())
        self.batches = [tuple(t.cpu() for t in windows(
            self.data, self.B, self.T, twin)) for _ in range(CHECK_STEPS)]
        self.step = make_device_train_step(
            cfg, self.B, grad_accum=int(mix.get("grad_accum", 1)),
            **mix["schedule"])
        self.losses = []
        for i in range(CHECK_STEPS):
            self._one()
            self.losses.append(float(self.last_loss))
            if i == 0:
                self.grad_norms = weights.leaf_norms(
                    self.opt.m, shape, 1.0 / (1.0 - BETA1))
        self.change = weights.change_norms(self.params, shape, self.init,
                                           self.seed)
        self._sync()

    def _one(self):
        self.params, self.opt, self.gen, self.last_loss = self.step(
            self.params, self.opt, self.data, self.gen)

    def segment(self) -> Dict:
        from torch.profiler import record_function

        n = TRACE_STEPS
        for _ in range(n):
            with record_function("train_step"):
                self._one()
        return {"steps": n, "step_flops": self.step_flops,
                "attn_least_s": flops.attn_train_least_seconds(
                    self.shape, self.B, self.T)}

    def measure(self, seconds: float) -> Dict:
        self._sync()
        losses, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._one()
            losses.append(self.last_loss)
        self._sync()
        dt = time.perf_counter() - t0
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        tokens = len(losses) * self.B * self.T
        return {"attempted": len(losses), "failed": bad, "seconds": dt,
                "steps": len(losses), "model_flops": len(losses)
                * self.step_flops,
                "metrics": {"train_tok_s": tokens / dt}}

    def release(self) -> None:
        for name in ("params", "opt", "data", "gen", "step", "last_loss"):
            self.__dict__.pop(name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check --------------------------------------------------------

    def reference(self, mm=torch.matmul, rows: int = 0) -> Dict:
        """The plain reference over the same rows from the same starting
        weights: (losses, first-gradient norms, change norms)."""
        p0 = weights.make_params(self.shape, self.init, self.seed,
                                 self.device, torch.float32)
        batches = [(x.to(self.device), y.to(self.device))
                   for x, y in self.batches]
        with ref.full_precision():
            losses, first, p = ref.train_steps(
                p0, batches, self.shape, self.mix["schedule"], mm, rows)
        out = {"losses": losses,
               "grad_norms": weights.leaf_norms(first, self.shape),
               "change": weights.change_norms(p, self.shape, self.init,
                                              self.seed)}
        del p0, first, p
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def readings(self, ref_out: Dict) -> Dict[str, float]:
        return compare(self.losses, self.grad_norms, self.change, ref_out)

    def check(self) -> Dict[str, Dict[str, float]]:
        got = self.readings(self.reference())
        limits = self.cell["spec"]["limits"]
        return {k: {"value": got[k], "limit": limits[k]} for k in limits}


def _worst(prog: Dict[str, float], ref_n: Dict[str, float], keep) -> float:
    med = sorted(ref_n[k] for k in keep)[len(keep) // 2]
    return max(abs(prog[k] - ref_n[k]) / max(ref_n[k], med) for k in keep)


def compare(losses, grad_norms, change, ref_out: Dict) -> Dict[str, float]:
    """The numbers the check compares.

    - ``loss_gap``: the largest relative gap of a checked step's loss;
    - ``grad_gap``: over the leaves, the largest gap between the program's
      and the reference's first-gradient norms, over the reference's norm
      of that leaf or of the median leaf, whichever is larger;
    - ``change_gap``: the same for how far each leaf moved in the checked
      steps.

    Leaves whose reference gradient is under a thousandth of the median
    leaf's (nought to rounding, moved by round-off alone) are left out."""
    rg = ref_out["grad_norms"]
    med = sorted(rg.values())[len(rg) // 2]
    keep = [k for k in rg if rg[k] >= 1e-3 * med]
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(losses, ref_out["losses"]))
    out = {"loss_gap": loss_gap,
           "grad_gap": _worst(grad_norms, rg, keep),
           "change_gap": _worst(change, ref_out["change"], keep)}
    return {k: (v if math.isfinite(v) else math.inf) for k, v in out.items()}
