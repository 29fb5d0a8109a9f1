"""Parallelism — the counterpart of ``linalg_tpu/parallel``: the mesh and
its collectives, the plain ring and the ring kernels (K10/K11), and the
sharded trainers (dp x tp, sequence parallelism, FSDP, the GPipe and 1F1B
pipelines, expert parallelism) over meshes that span the processes of a
``torch.distributed`` group once ``init_distributed`` has started it
(``distributed.py``), and tensor-parallel serving's shards and ops."""

from .distributed import (global_mesh_shape, host_local_batch_slice,
                          init_distributed, is_distributed)
from .expert import (make_ep_device_train_step, make_ep_eval,
                     make_ep_train_step, moe_param_specs)
from .fsdp import (fsdp_param_specs, fsdp_shardings,
                   make_fsdp_device_train_step, make_fsdp_eval)
from .mesh import (Mesh, all_gather, all_reduce, all_to_all, collectives,
                   make_mesh, pick_dp_tp, ppermute, reduce_scatter,
                   shard_tree, unshard_tree)
from .pipeline import (make_pp_1f1b_grads, make_pp_1f1b_train_step,
                       make_pp_device_train_step, make_pp_eval, make_pp_loss,
                       make_pp_train_step, pp_param_specs)
from .ring import make_ring_attention, ring_attention_local
from .ring_pallas import (make_ring_attention_pallas,
                          ring_attention_pallas_bwd_local,
                          ring_attention_pallas_local)
from .sharding import (dryrun_multichip, gpt_param_specs, make_sharded_attn,
                       make_sharded_device_train_step, make_sharded_eval,
                       make_sharded_train_step, make_sp_device_train_step,
                       make_sp_eval, make_sp_train_step, tp_kv_heads,
                       tp_prefill, tp_serve_ops, tp_serve_params)

__all__ = [
    "Mesh",
    "make_mesh",
    "pick_dp_tp",
    "collectives",
    "all_reduce",
    "all_gather",
    "reduce_scatter",
    "all_to_all",
    "ppermute",
    "shard_tree",
    "unshard_tree",
    "gpt_param_specs",
    "pp_param_specs",
    "moe_param_specs",
    "make_sharded_attn",
    "make_ring_attention",
    "ring_attention_local",
    "make_ring_attention_pallas",
    "ring_attention_pallas_local",
    "ring_attention_pallas_bwd_local",
    "make_sharded_train_step",
    "make_sharded_device_train_step",
    "make_sharded_eval",
    "make_sp_train_step",
    "make_sp_device_train_step",
    "make_sp_eval",
    "make_pp_loss",
    "make_pp_train_step",
    "make_pp_1f1b_grads",
    "make_pp_1f1b_train_step",
    "make_pp_device_train_step",
    "make_pp_eval",
    "make_ep_train_step",
    "make_ep_device_train_step",
    "make_ep_eval",
    "fsdp_param_specs",
    "fsdp_shardings",
    "make_fsdp_device_train_step",
    "make_fsdp_eval",
    "tp_kv_heads",
    "tp_serve_params",
    "tp_serve_ops",
    "tp_prefill",
    "dryrun_multichip",
    "init_distributed",
    "is_distributed",
    "host_local_batch_slice",
    "global_mesh_shape",
]
