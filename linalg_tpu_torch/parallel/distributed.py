"""Multi-process initialisation — the counterpart of
``linalg_tpu/parallel/distributed.py``, with its four names, and the
job's devices and process sub-groups that the meshes span.

JAX glues one process per host together with ``jax.distributed.initialize``;
the port starts a ``torch.distributed`` process group instead: NCCL on the
card, Gloo only where the caller asks for the CPU. The launcher's
environment is JAX's (``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID``) or ``torchrun``'s (``MASTER_ADDR`` / ``WORLD_SIZE`` /
``RANK``, where ``WORLD_SIZE > 1`` plays the part of JAX's pod markers).

As ``jax.devices()`` turns global after ``jax.distributed.initialize``,
the meshes follow the group: ``parallel.mesh.make_mesh`` without a device
list deals its ranks over ``job_devices()`` (every process's local cards
in process order, or one CPU device a process), and a collective whose
ranks lie in several processes crosses them through the sub-group of
those processes (``subgroup``). Every process is assumed to hold as many
devices as this one, as torchrun's one-process-per-card and
one-process-per-host layouts do.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

__all__ = [
    "init_distributed",
    "is_distributed",
    "host_local_batch_slice",
    "global_mesh_shape",
    "process_index",
    "process_count",
    "local_devices",
    "job_devices",
    "subgroup",
]


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def _backend(device, backend) -> str:
    """NCCL on the card; Gloo when the caller asks for the CPU. Without a
    card and without that request, raise: never a quiet CPU group."""
    if backend is not None:
        return backend
    if device is not None and torch.device(device).type == "cpu":
        return "gloo"
    if not torch.cuda.is_available():
        raise RuntimeError(
            "init_distributed: no CUDA device for the NCCL backend; pass "
            "device='cpu' (or backend='gloo') for a CPU process group")
    return "nccl"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *, device=None,
                     backend: Optional[str] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Start the process group; a no-op (returns False) single-process.

    With no arguments and no launcher environment this is a plain
    single-process run. Otherwise ``torch.distributed.init_process_group``
    runs once, with ``init_method`` the coordinator's address (a bare
    ``host:port`` becomes ``tcp://host:port``; ``file://`` and ``env://``
    pass as they are; torchrun's environment alone gives ``env://``), the
    world size and this process's rank. The backend is NCCL on the card
    (each process on its local card), Gloo only with ``device="cpu"`` or
    ``backend="gloo"``; with no card and no such request it raises. A
    failed initialisation raises, as JAX's late initialisation on a real
    multi-process run does. Returns True when the group has more than one
    process."""
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("JAX_NUM_PROCESSES", "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("JAX_PROCESS_ID", "RANK")
    torchrun = (os.environ.get("MASTER_ADDR")
                and (_env_int("WORLD_SIZE") or 1) > 1)
    if coordinator_address is None and not torchrun:
        return False  # plain single-process run (CPU tests, one card)
    if not dist.is_initialized():
        if coordinator_address is None:
            init_method = "env://"
        elif "://" in coordinator_address:
            init_method = coordinator_address
        else:
            init_method = f"tcp://{coordinator_address}"
        name = _backend(device, backend)
        if name == "nccl":
            local = _env_int("LOCAL_RANK")
            torch.cuda.set_device(local if local is not None else
                                  (process_id or 0)
                                  % torch.cuda.device_count())
        kw = {}
        if timeout_s is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(name, init_method=init_method,
                                world_size=num_processes, rank=process_id,
                                **kw)
    return dist.get_world_size() > 1


def _world() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_distributed() -> bool:
    return _world()[1] > 1


def host_local_batch_slice(global_batch: int) -> Tuple[int, int]:
    """(start, size) of this process's slice of a globally-sharded batch,
    for host-fed data paths where each process loads only its share."""
    rank, n = _world()
    assert global_batch % n == 0, (
        f"global batch {global_batch} must divide by process count {n}"
    )
    size = global_batch // n
    return rank * size, size


def process_index() -> int:
    """This process's rank in the group (0 without one)."""
    return _world()[0]


def process_count() -> int:
    """The number of processes in the group (1 without one)."""
    return _world()[1]


def local_devices(device_type: str = "cuda") -> list:
    """This process's devices: one CPU device for ``"cpu"``; else its share
    of the visible cards, block ``LOCAL_RANK`` of ``LOCAL_WORLD_SIZE``
    equal blocks (all of them without a launcher), or the one card
    ``LOCAL_RANK`` shares with the host's other processes where there are
    fewer cards than processes. Without a card, raise."""
    if torch.device(device_type).type == "cpu":
        return [torch.device("cpu")]
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=[...] (e.g. "
                           "['cpu'] * n) or device_type='cpu' to build a "
                           "mesh without a card")
    count = torch.cuda.device_count()
    procs = _env_int("LOCAL_WORLD_SIZE") or 1
    local = _env_int("LOCAL_RANK") or 0
    if count < procs:
        return [torch.device("cuda", local % count)]
    per = count // procs
    return [torch.device("cuda", i)
            for i in range(local * per, (local + 1) * per)]


def job_devices(device_type: str = "cuda") -> list:
    """(process, device) of every device of the job, in process order:
    this process's ``local_devices`` under its index, None for the
    devices of the other processes (they are not addressable here)."""
    mine = local_devices(device_type)
    me, n = _world()
    return [(p, d if p == me else None) for p in range(n) for d in mine]


# sub-groups by the processes they join, in creation order
_subgroups: dict = {}


def subgroup(processes):
    """The ``torch.distributed`` group of ``processes`` (sorted ranks),
    made once and cached: the default group when they are all of them.
    ``dist.new_group`` must run in every process in the same order, so
    the meshes call this for each process set they span when they are
    built, in every process, members or not."""
    import torch.distributed as dist

    key = tuple(sorted(processes))
    if key == tuple(range(_world()[1])):
        return dist.group.WORLD
    if key not in _subgroups:
        _subgroups[key] = dist.new_group(list(key))
    return _subgroups[key]


def global_mesh_shape(n_heads: int) -> Tuple[int, int]:
    """Default (dp, tp) over every device of the job: n_global = processes
    x local cards (a process without a card counts its one CPU device);
    tp = the largest divisor of n_global, n_heads AND the local count, so
    a tp group never straddles a host; dp takes the rest."""
    n_local = (len(local_devices()) if torch.cuda.is_available() else 1)
    n_global = _world()[1] * n_local
    tp = 1
    for cand in range(1, min(n_local, n_global) + 1):
        if n_global % cand == 0 and n_heads % cand == 0 and n_local % cand == 0:
            tp = cand
    return n_global // tp, tp
