"""Matrix-free solver layer: Krylov solvers, operator handles, Jacobi, and
the fused-CG kernel."""

from .assemble import MatrixHandle
from .krylov import SolveInfo, bicgstab, cg, gmres, solve
from .precond import extract_diagonal, jacobi, make_preconditioner, safe_inv_diag

__all__ = [
    "MatrixHandle",
    "SolveInfo",
    "bicgstab",
    "cg",
    "gmres",
    "solve",
    "extract_diagonal",
    "jacobi",
    "make_preconditioner",
    "safe_inv_diag",
]
