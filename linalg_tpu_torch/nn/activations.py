"""Activation registry — the counterpart of ``linalg_tpu/nn/activations.py``.

relu/gelu/silu with their explicit derivatives, and the GATED units
swiglu/geglu: two-argument entries whose forward is ``f(a, g)`` over the
activation branch ``a`` and the linear gate ``g``, and whose backward
``b(a, g)`` returns the elementwise factors ``(d/da, d/dg)``. The
functions are ``nn.functional``'s, each forward an ``autograd.Function``
whose backward is the ``*_backward`` listed here.
"""

from __future__ import annotations

from .functional import (geglu, geglu_backward, gelu, gelu_backward, relu,
                         relu_backward, silu, silu_backward, swiglu,
                         swiglu_backward)

__all__ = ["relu", "relu_backward", "gelu", "gelu_backward",
           "silu", "silu_backward", "swiglu", "swiglu_backward",
           "geglu", "geglu_backward", "ACTIVATIONS", "GATED_ACTIVATIONS",
           "get_activation"]

ACTIVATIONS = {
    "relu": (relu, relu_backward),
    "gelu": (gelu, gelu_backward),
    "silu": (silu, silu_backward),
}

# FFN(x) = f(x @ W1 + b1, x @ Wg + bg) @ W2 + b2
GATED_ACTIVATIONS = {
    "swiglu": (swiglu, swiglu_backward),
    "geglu": (geglu, geglu_backward),
}


def get_activation(name: str):
    """(forward, backward) by name; KeyError on an unknown one. Gated
    names return two-argument pairs."""
    if name in ACTIVATIONS:
        return ACTIVATIONS[name]
    if name in GATED_ACTIVATIONS:
        return GATED_ACTIVATIONS[name]
    raise KeyError(
        f"Unknown activation: {name}. Available: "
        f"{list(ACTIVATIONS) + list(GATED_ACTIVATIONS)}")
