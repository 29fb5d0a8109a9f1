"""Training traffic of a routed MoE GPT (kind ``train_moe``): the ``train``
kind's batches of random token ids from the seed, corpus, schedule, check
and window (``portbench.traffic.train``), through the program's device
training step with the MoE configuration (``MoEGPTConfig``, the dropless
grouped dispatch), the MoE weights (``portbench.weights_moe``), counts
(``portbench.flops_moe``) and plain reference
(``portbench.reference.moe``).

A configuration's ``port`` section gives the program's settings; the
router spans ``n_experts`` and the card holds the first ``experts_held``
of them (one expert-parallel rank's share of each layer).
"""

from __future__ import annotations

from typing import Dict

import torch

from portbench import flops_moe, weights_moe
from portbench.reference import moe as ref
from portbench.traffic import train
from portbench.traffic.train import CHECK_STEPS, TRACE_STEPS, compare  # noqa

_CFG_KEYS = ("vocab_size", "d_model", "n_heads", "n_kv_heads", "head_dim",
             "n_layers", "d_ff", "ctx_len", "pos", "dtype", "window",
             "full_every", "ffn", "rope_theta", "n_experts", "router_top_k",
             "dispatch", "aux_weight")


class Run(train.Run):
    def __init__(self, cell: Dict, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.cfg = cell["config"]
        self.shape, self.init = self.cfg["port"], self.cfg["init"]
        self.mix = cell["mix"]
        self.B, self.T = int(self.mix["batch"]), int(self.mix["seq"])
        if self.T != self.shape["ctx_len"]:
            raise ValueError("the step trains on ctx_len-token rows: seq "
                             f"{self.T} != ctx_len {self.shape['ctx_len']}")
        self.step_flops = flops_moe.train_step_flops(self.shape, self.B,
                                                     self.T)["total"]

    def setup(self) -> None:
        from linalg_tpu_torch.models.moe import MoEGPTConfig
        from linalg_tpu_torch.nn.functional import YaRN
        from linalg_tpu_torch.train.optim import adamw_init
        from linalg_tpu_torch.train.trainer import make_device_train_step

        shape, mix = self.shape, self.mix
        yarn = shape.get("rope_scaling")
        cfg = MoEGPTConfig(
            **{k: shape[k] for k in _CFG_KEYS if k in shape},
            rope_scaling=None if yarn is None else YaRN(**yarn))
        self.params = weights_moe.make_params(shape, self.init, self.seed,
                                              self.device, torch.float32)
        self.opt = adamw_init(self.params)
        self.data = train._corpus(mix, shape["vocab_size"], self.seed,
                                  self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed((self.seed * 40503 + 7) % (1 << 63))
        twin = torch.Generator(device=self.device)
        twin.set_state(self.gen.get_state())
        self.batches = [tuple(t.cpu() for t in train.windows(
            self.data, self.B, self.T, twin)) for _ in range(CHECK_STEPS)]
        self.step = make_device_train_step(
            cfg, self.B, grad_accum=int(mix.get("grad_accum", 1)),
            **mix["schedule"])
        self.losses = []
        for i in range(CHECK_STEPS):
            self._one()
            self.losses.append(float(self.last_loss))
            if i == 0:
                self.grad_norms = weights_moe.leaf_norms(
                    self.opt.m, shape, 1.0 / (1.0 - train.BETA1))
        self.change = weights_moe.change_norms(self.params, shape,
                                               self.init, self.seed)
        self._sync()

    def segment(self) -> Dict:
        from torch.profiler import record_function

        for _ in range(TRACE_STEPS):
            with record_function("train_step"):
                self._one()
        return {"steps": TRACE_STEPS, "step_flops": self.step_flops,
                "attn_least_s": flops_moe.attn_train_least_seconds(
                    self.shape, self.B, self.T)}

    def reference(self, mm=torch.matmul, rows: int = 0) -> Dict:
        """The plain reference over the same rows from the same starting
        weights: (losses, first-gradient norms, change norms)."""
        p0 = weights_moe.make_params(self.shape, self.init, self.seed,
                                     self.device, torch.float32)
        batches = [(x.to(self.device), y.to(self.device))
                   for x, y in self.batches]
        with ref.full_precision():
            losses, first, p = ref.train_steps(
                p0, batches, self.cfg, self.mix["schedule"], mm, rows)
        out = {"losses": losses,
               "grad_norms": weights_moe.leaf_norms(first, self.shape),
               "change": weights_moe.change_norms(p, self.shape, self.init,
                                                  self.seed)}
        del p0, first, p
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out
