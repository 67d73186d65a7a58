"""Mixed-precision iterative refinement: f64 accuracy from f32 inner solves.

The port of `neptune_tpu/solvers/refine.py`. The Krylov solve runs in
float32 against the float32 twin of the operator (`passes.retype`, whose
applies take kernel A on the card); residuals are evaluated and the
solution accumulated in float64, round after round, until the f64 residual
meets the tolerance. The loop runs on the host and reads the test after
every round.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.tree import tnorm
from . import krylov


class RefineInfo(NamedTuple):
    rounds: int
    inner_iters: int
    resnorm: float
    converged: bool


def refined_solve(
    matvec_hi: Callable,
    matvec_lo: Callable,
    b,
    *,
    solver: str = "cg",
    tol: float = 1e-12,
    inner_tol: float = 1e-5,
    inner_iters: int = 500,
    max_rounds: int = 6,
    M_lo: Optional[Callable] = None,
):
    """Solve A x = b to f64 tolerance using f32 inner Krylov solves.

    matvec_hi: float64 operator (residual evaluation)
    matvec_lo: float32 twin (inner solves)
    """
    b = torch.as_tensor(b).to(torch.float64)
    bnorm = tnorm(b)
    target = tol * torch.where(bnorm == 0, torch.ones_like(bnorm), bnorm)
    x = torch.zeros_like(b)
    r = b
    rnorm = tnorm(r)
    k = inner = 0
    while k < max_rounds and bool(rnorm > target):
        dx32, info = krylov.solve(
            matvec_lo, r.to(torch.float32), solver=solver, tol=inner_tol,
            maxiter=inner_iters, M=M_lo,
        )
        x = x + dx32.to(torch.float64)
        r = b - matvec_hi(x)
        rnorm = tnorm(r)
        k += 1
        inner += info.iters
    return x, RefineInfo(k, inner, float(rnorm), bool(rnorm <= target))
