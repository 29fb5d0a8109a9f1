"""The reference's stateful component contract on ``nn.Module``s.

The JAX package's L2 classes (``nn.normalization``, ``nn.attention``,
``nn.positional``, ``models.transformer``, ``models.gpt_modules``) keep
the reference's interface: ``forward(x)`` runs the component and
remembers what its backward needs, ``backward(dy)`` returns the input
gradients and leaves the parameter gradients in ``grads``, ``step(lr,
weight_decay)`` takes one SGD step and zeroes them. There ``forward``
holds a ``jax.vjp`` pullback; here it keeps the autograd graph of the
forward (the functional ops underneath are ``nn.functional``'s
hand-derived ``autograd.Function``s) and ``backward`` is
``torch.autograd.grad`` of that graph.

Parameters are ``nn.Parameter``s, each with a gradient buffer
``grad<name>`` (``gradW``, ``gradgamma``, ...), so ``.to(device)`` and
``.double()`` move both. ``load_numpy`` copies a dict of numpy arrays
keyed like ``state_dict`` (JAX-trained weights, say) into the module.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
from torch import nn

__all__ = ["Stateful"]


class Stateful(nn.Module):
    """Base of the stateful components: parameter registry, the recorded
    forward, its pullback, SGD ``step`` and ``load_numpy``.

    ``DECAY`` names the parameters ``step`` applies weight decay to."""

    DECAY: Sequence[str] = ()

    def _param(self, name: str, value: torch.Tensor) -> None:
        self.register_parameter(name, nn.Parameter(value))
        self.register_buffer("grad" + name, torch.zeros_like(value),
                             persistent=False)

    def _own(self):
        return list(self.named_parameters(recurse=False))

    def _record(self, fn, *inputs):
        """``fn(*inputs)`` with its graph kept for ``_pull``; the inputs
        are detached leaves, the result is returned detached."""
        xs = [torch.as_tensor(x).detach().requires_grad_(True)
              for x in inputs]
        with torch.enable_grad():
            y = fn(*xs)
        self._tape = (y, xs)
        return y.detach()

    def _pull(self, dy):
        """Gradients of the recorded forward for the output cotangent
        ``dy`` (cast to the output's dtype): parameter gradients into
        their buffers, input gradients returned."""
        y, xs = self._tape
        own = self._own()
        dy = torch.as_tensor(dy).to(dtype=y.dtype, device=y.device)
        gs = torch.autograd.grad(y, [p for _, p in own] + xs, dy,
                                 allow_unused=True)
        for (name, p), g in zip(own, gs):
            setattr(self, "grad" + name, torch.zeros_like(p) if g is None
                    else g)
        self._tape = None
        return [torch.zeros_like(x) if g is None else g
                for x, g in zip(xs, gs[len(own):])]

    @property
    def grads(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, "grad" + name) for name, _ in self._own()}

    @torch.no_grad()
    def step(self, lr: float = 1e-3, weight_decay: float = 0.0) -> None:
        """SGD on the own parameters (decay on those in ``DECAY``), then
        zero their gradients. Composite components step their parts."""
        for name, p in self._own():
            g = getattr(self, "grad" + name)
            if weight_decay != 0.0 and name in self.DECAY:
                g = g + weight_decay * p
            p.sub_(lr * g)
            setattr(self, "grad" + name, torch.zeros_like(p))

    def load_numpy(self, arrays) -> None:
        """Copy ``arrays`` ({state_dict name: numpy array}, every
        parameter) into the parameters, keeping their dtype and device."""
        self.load_state_dict({k: torch.as_tensor(np.asarray(v))
                              for k, v in arrays.items()})
