"""LayerNorm / RMSNorm with the reference's stateful contract — the
counterpart of ``linalg_tpu/nn/normalization.py``.

``forward(x) -> y``, ``backward(dy) -> dx`` (parameter gradients in
``grads``), ``step(lr, weight_decay)`` (SGD; the decay applies to
``gamma``). Thin ``nn.stateful.Stateful`` wrappers over ``nn.functional``'s
``layer_norm``/``rms_norm``, whose closed-form backwards are the single
source of truth. ``functional(params, x)`` is the pure form (the JAX
class's ``__call__``; here ``__call__`` is the module's ``forward``).
"""

from __future__ import annotations

import torch

from .functional import layer_norm, rms_norm
from .stateful import Stateful

__all__ = ["LayerNorm", "RMSNorm", "get_norm"]


class LayerNorm(Stateful):
    """y = gamma * (x - mean) / std + beta over the last axis."""

    DECAY = ("gamma",)

    def __init__(self, d_model: int = 512, device=None) -> None:
        super().__init__()
        self.d_model = d_model
        self._param("gamma", torch.ones(d_model, device=device))
        self._param("beta", torch.zeros(d_model, device=device))

    @staticmethod
    def functional(params, x, eps: float = 1e-5):
        """Pure functional apply; ``params`` is {'gamma', 'beta'}."""
        return layer_norm(x, params["gamma"], params["beta"], eps)

    def init(self):
        return {"gamma": self.gamma, "beta": self.beta}

    def forward(self, x, eps: float = 1e-5):
        return self._record(lambda xx: layer_norm(xx, self.gamma, self.beta,
                                                  eps), x)

    def backward(self, dy):
        return self._pull(dy)[0]


class RMSNorm(Stateful):
    """y = gamma * x / rms(x). No mean centering."""

    DECAY = ("gamma",)

    def __init__(self, d_model: int = 512, eps: float = 1e-6,
                 device=None) -> None:
        super().__init__()
        self.d_model = d_model
        self.eps = eps
        self._param("gamma", torch.ones(d_model, device=device))

    def functional(self, params, x):
        return rms_norm(x, params["gamma"], self.eps)

    def init(self):
        return {"gamma": self.gamma}

    def forward(self, x):
        return self._record(lambda xx: rms_norm(xx, self.gamma, self.eps), x)

    def backward(self, dy):
        return self._pull(dy)[0]


def get_norm(name: str, d_model: int, **kwargs):
    """Factory: 'layernorm' | 'rmsnorm'."""
    norms = {"layernorm": LayerNorm, "rmsnorm": RMSNorm}
    if name not in norms:
        raise KeyError(f"Unknown norm: {name}. Available: {list(norms)}")
    return norms[name](d_model, **kwargs)
