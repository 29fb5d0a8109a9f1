"""Readings of the program's own counters
(``linalg_tpu_torch.utils.profiling.count``) kept in the traced segment's
profiler session, for the per-layer readers. A program without the
counter, or without counters at all, leaves nothing to read: the function
then returns None and raises nothing.
"""

from __future__ import annotations

from typing import List, Optional


def program_counts(name: str) -> Optional[List[list]]:
    """The values the program counted under ``name`` in the newest
    profiler session (the traced segment's), in order; None where it
    counted none."""
    try:
        from linalg_tpu_torch.utils.profiling import counts
    except ImportError:
        return None
    return counts(name) or None
