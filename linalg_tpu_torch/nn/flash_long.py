"""Fused attention for long context — the counterpart of
``linalg_tpu/nn/flash_long.py`` (K3).

On the TPU this is a second kernel set (row strips for the forward and dq,
column strips for dk/dv) because the (T, T) tile of ``nn.flash`` stops
fitting VMEM past T = 1024. The Hopper kernels tile both axes at any T, so
``flash_attention_long`` runs the same forward, dq and dk/dv kernels (and
the same plain versions on the CPU) as ``flash_attention``, under K3's
contract: T a multiple of 256, at most ``LONG_MAX_T``.
"""

from __future__ import annotations

from .flash import _Flash

__all__ = ["flash_attention_long", "LONG_MAX_T"]

LONG_MAX_T = 8192
_BLOCK = 256  # K3's row and column strip


def flash_attention_long(q, k, v, causal: bool = True):
    """Fused attention for T in (1024, 8192]; same semantics as
    ``nn.flash.flash_attention``. T % 256 == 0."""
    T = q.shape[-2]
    if T % _BLOCK or T > LONG_MAX_T:
        raise ValueError(f"flash_attention_long needs T % {_BLOCK} == 0 and "
                         f"T <= {LONG_MAX_T}, got T = {T}")
    return _Flash.apply(q, k, v, causal, None, False)
