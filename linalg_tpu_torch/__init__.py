"""linalg_tpu_torch — the PyTorch/CUDA port of ``linalg_tpu``.

A second package beside the JAX reference, with the same sub-package and
module names so each module's counterpart is easy to find. It imports
``torch`` and never ``jax`` or ``linalg_tpu``. Hand-written CUDA kernels
for NVIDIA Hopper live in ``linalg_tpu_torch.kernels`` and are built from
their sources at first use, never at import.

Ported so far: the paged-KV serving path (``serve``), with the GPT forward,
prefill and decode it runs (``models.gpt``), the char tokenizer and the npz
checkpoint loader. See ROADMAP.md for what comes next.
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
