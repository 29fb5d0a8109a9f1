"""Device meshes — the counterpart of ``linalg_tpu/parallel/mesh.py``.

A ``Mesh`` names its axes and holds a numpy array of ``torch.device``s of
the mesh's shape. A device may appear more than once: the ranks of a mesh
then share it, which is how sequence parallelism runs its n ranks on one
card (each rank's rows are a slice of rank-stacked buffers there).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "pick_dp_tp"]


class Mesh:
    """Axis names and a device array: ``shape`` maps each name to its size,
    in order, as ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"device array of rank {devices.ndim} for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))


def pick_dp_tp(n_devices: int, n_heads: int) -> Tuple[int, int]:
    """Choose (dp, tp): the largest tp that divides both n_devices and
    n_heads, remainder to data parallelism."""
    tp = 1
    for cand in range(1, n_devices + 1):
        if n_devices % cand == 0 and n_heads % cand == 0:
            tp = cand
    return n_devices // tp, tp


def _cuda_devices():
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass devices=[...] (e.g. "
                           "['cpu'] * n) to build a mesh without a card")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def make_mesh(shape: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("dp", "tp"),
              devices=None) -> Mesh:
    """Build a Mesh over ``devices`` (default: every CUDA card; without
    one, raise), the first ``prod(shape)`` of them in row-major order.

    ``shape`` defaults to all devices on the first axis. Devices may
    repeat (``[torch.device("cuda")] * 4`` puts four ranks on one card);
    fewer devices than the shape needs raise."""
    devices = [torch.device(d) for d in (
        devices if devices is not None else _cuda_devices())]
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} needs {n} devices, "
                         f"have {len(devices)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(tuple(shape)), axis_names)
