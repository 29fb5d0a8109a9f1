"""linalg_tpu_torch — the PyTorch/CUDA port of ``linalg_tpu``.

A second package beside the JAX reference, with the same sub-package and
module names so each module's counterpart is easy to find. It imports
``torch`` and never ``jax`` or ``linalg_tpu``. Hand-written CUDA kernels
for NVIDIA Hopper live in ``linalg_tpu_torch.kernels`` and are built from
their sources at first use, never at import.

Ported so far: the paged-KV serving path (``serve``), with the GPT forward,
prefill and decode it runs (``models.gpt``), the char tokenizer and the npz
checkpoints; the linear-algebra toolkit (``ops``: QR, SVD, elimination,
eigen methods, projections, batched variants), whose Householder QR runs
its panels through a CUDA kernel on the card; and char-GPT training
(``train``: ``gpt_loss`` through the hand-derived backwards, AdamW, the
trainer), whose causal attention runs through CUDA flash-attention
kernels on the card (``nn.flash``, ``nn.flash_long``), and long-context
training (RoPE, ALiBi, gated FFNs, a sliding window and grouped K/V read
in place by the same kernels, ``nn.flash_stream``), and
sharded training over a mesh dealt over the job's devices, across
processes after ``parallel.init_distributed`` (``parallel``:
sequence parallelism through the ring kernels K10/K11, dp x tp, FSDP,
the GPipe and 1F1B pipelines and expert parallelism, their collectives
explicit in ``parallel.mesh``), and sampling (KV-cached decode, ``gpt_generate``, beam search in
``models.beam``, ``train.trainer.sample``, the REPL), byte-level BPE with
its host C loops (``native``) and the wide-vocabulary chunked loss
(``nn.losses``), the routed MoE GPT, the L2 stack and the small apps
(``apps``).
The toolkit's public functions are re-exported here, as ``linalg_tpu``
does. See ROADMAP.md for what comes next.
"""

from .ops.eigen import matrix_power_binary, matrix_power_eig, power_iteration
from .ops.elimination import (
    back_substitute,
    forward_eliminate,
    gaussian_solve,
    nullspace_basis_elimination,
    rank_elimination,
    rref,
)
from .ops.matrix_functions import adj, det, rank_numpy
from .ops.projections import project_onto_colspace
from .ops.qr import (
    householder_qr,
    least_squares_householder_qr,
    least_squares_qr,
    qr,
)
from .ops.svd import pca, svd
from .utils.device import resolve_device
from .utils.numerics import (
    EPS,
    permutation_sign,
    random_nonsingular_qr,
    random_nonsingular_upper,
    scale_tol,
)

__all__ = [
    # decompositions
    "qr",
    "householder_qr",
    "svd",
    "pca",
    # matrix utilities
    "det",
    "adj",
    "rank_numpy",
    "matrix_power_eig",
    "matrix_power_binary",
    # linear systems
    "gaussian_solve",
    "least_squares_qr",
    "least_squares_householder_qr",
    "forward_eliminate",
    "back_substitute",
    # iterative methods
    "power_iteration",
    # rank / null-space tools
    "rank_elimination",
    "nullspace_basis_elimination",
    "rref",
    # projections
    "project_onto_colspace",
    # utils
    "EPS",
    "scale_tol",
    "permutation_sign",
    "random_nonsingular_upper",
    "random_nonsingular_qr",
    "resolve_device",
]
