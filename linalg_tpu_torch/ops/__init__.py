"""The linear-algebra toolkit (L1): port of ``linalg_tpu/ops``.

Same modules and public functions; the Householder panel kernel behind
``householder_qr`` is ``kernels/csrc/qr_panel.cu``.
"""

from .eigen import matrix_power_binary, matrix_power_eig, power_iteration
from .elimination import (
    back_substitute,
    forward_eliminate,
    gaussian_solve,
    nullspace_basis_elimination,
    rank_elimination,
    rref,
)
from .matrix_functions import adj, det, rank_numpy
from .projections import project_onto_colspace
from .qr import (
    householder_qr,
    least_squares_householder_qr,
    least_squares_qr,
    qr,
)
from .svd import pca, svd

__all__ = [
    "qr",
    "householder_qr",
    "least_squares_qr",
    "least_squares_householder_qr",
    "forward_eliminate",
    "back_substitute",
    "gaussian_solve",
    "rref",
    "rank_elimination",
    "nullspace_basis_elimination",
    "svd",
    "pca",
    "power_iteration",
    "matrix_power_eig",
    "matrix_power_binary",
    "det",
    "adj",
    "rank_numpy",
    "project_onto_colspace",
]
