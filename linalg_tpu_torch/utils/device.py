"""Device selection."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` when given, else ``cuda``: the port runs on the card
    unless the caller asks for the CPU (``device="cpu"``, ``--device
    cpu``). Asking for ``cuda`` (or nothing) on a machine without a card
    raises here, at construction or at the CLI; nothing falls back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card on this machine: pass device='cpu' (--device cpu "
            "on the command line) to run on the CPU")
    return dev
