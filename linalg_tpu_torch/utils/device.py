"""Device selection."""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``device`` when given; else ``cuda`` when a card is present, else
    ``cpu``. An explicit device always wins: asking for ``cuda`` on a
    machine without one fails at first use, never falls back."""
    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")
