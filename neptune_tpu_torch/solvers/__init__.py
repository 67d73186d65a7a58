"""Matrix-free solver layer: Krylov solvers and the direct solve, operator
handles, Jacobi and SSOR, the fused-CG kernel, Newton–Krylov and Picard,
implicit derivatives, mixed-precision refinement and time loops."""

from .assemble import MatrixHandle
from .krylov import SolveInfo, bicgstab, cg, direct, gmres, solve
from .newton import NewtonInfo, newton_krylov, picard
from .precond import (
    extract_diagonal,
    jacobi,
    make_preconditioner,
    safe_inv_diag,
    ssor_dense,
    ssor_stencil,
)
from .diff import differentiable_root, differentiable_solve
from .refine import RefineInfo, refined_solve
from .time import simulate

__all__ = [
    "MatrixHandle",
    "SolveInfo",
    "bicgstab",
    "cg",
    "direct",
    "gmres",
    "solve",
    "NewtonInfo",
    "newton_krylov",
    "picard",
    "extract_diagonal",
    "jacobi",
    "make_preconditioner",
    "safe_inv_diag",
    "ssor_dense",
    "ssor_stencil",
    "RefineInfo",
    "refined_solve",
    "simulate",
    "differentiable_root",
    "differentiable_solve",
]
