"""Parallelism — the counterpart of ``linalg_tpu/parallel``. Ported: the
mesh helpers, the plain ring and the ring kernels (K10/K11), and the
sequence-parallel training steps. The dp x tp, pipeline, expert, FSDP and
multi-host modules are ROADMAP.md queue 1, item 7."""

from .mesh import Mesh, make_mesh, pick_dp_tp
from .ring import make_ring_attention, ring_attention_local
from .ring_pallas import (make_ring_attention_pallas,
                          ring_attention_pallas_bwd_local,
                          ring_attention_pallas_local)
from .sharding import make_sp_device_train_step, make_sp_eval, make_sp_train_step

__all__ = [
    "Mesh",
    "make_mesh",
    "pick_dp_tp",
    "make_ring_attention",
    "ring_attention_local",
    "make_ring_attention_pallas",
    "ring_attention_pallas_local",
    "ring_attention_pallas_bwd_local",
    "make_sp_train_step",
    "make_sp_device_train_step",
    "make_sp_eval",
]
