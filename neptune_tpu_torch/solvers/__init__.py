"""Matrix-free solver layer: Krylov solvers, Chebyshev and the direct solve,
operator handles, Jacobi, SSOR and geometric multigrid, the fused-CG kernel,
Newton–Krylov and Picard, implicit derivatives, mixed-precision refinement
and time loops."""

from .assemble import MatrixHandle
from .krylov import SolveInfo, bicgstab, cg, direct, gmres, solve
from .chebyshev import SpectrumBounds, chebyshev, estimate_spectrum, power_method
from .newton import NewtonInfo, newton_krylov, picard
from .multigrid import (
    build_levels,
    fmg_start,
    mg_preconditioner,
    multigrid_solve,
    v_cycle,
)
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
    "chebyshev",
    "SpectrumBounds",
    "estimate_spectrum",
    "power_method",
    "direct",
    "gmres",
    "solve",
    "NewtonInfo",
    "newton_krylov",
    "picard",
    "build_levels",
    "fmg_start",
    "mg_preconditioner",
    "multigrid_solve",
    "v_cycle",
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
