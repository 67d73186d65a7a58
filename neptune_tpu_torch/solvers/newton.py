"""Newton–Krylov nonlinear solver (JFNK) and damped Picard iteration.

The port of `neptune_tpu/solvers/newton.py`. J·v is the exact
Jacobian-vector product, `torch.func.jvp` of the residual (an opdef routed
to a kernel differentiates through its derivative rule, see
`lowering.executor._OpdefRule`); the inner solve is the port's restarted
GMRES; an Armijo backtracking line search globalizes. States are tensors or
tuples of tensors (multi-field systems).

The JAX package runs a `lax.while_loop`; here the loop runs on the host and
reads the convergence test after every iteration, so the iteration counts
are the reference's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.tree import taxpy, tnorm, tscale
from .krylov import gmres


class NewtonInfo(NamedTuple):
    iters: int  # Newton iterations taken
    resnorm: float  # final ||F(x)||
    converged: bool
    krylov_iters: int  # total inner Krylov iterations


def newton_krylov(
    residual: Callable,
    x0,
    *,
    tol: float = 1e-8,
    atol: float = 1e-12,
    max_iters: int = 50,
    krylov_tol: float = 1e-6,
    krylov_iters: int = 200,
    restart: int = 30,
    M: Optional[Callable] = None,
    line_search: bool = True,
    max_backtracks: int = 25,
    max_step: Optional[float] = None,
    jac_mv: Optional[Callable] = None,
    group=None,
):
    """Solve F(x) = 0 by Newton's method with GMRES inner solves.

    residual: state -> state (same structure).
    Convergence: ||F(x)|| <= max(tol * ||F(x0)||, atol), SNES-style rtol+atol;
    two consecutive non-descent steps stop the iteration.
    max_step caps ||dx|| per Newton iteration (PETSc -snes_linesearch_maxstep).
    jac_mv: optional user linearization `(x, v) -> J(x)·v` (the `jacobian=`
    attr of solve_nonlinear); default is the exact jvp of `residual`.
    group: the process group of a sharded state (`krylov`'s `group=`):
    every norm, and the inner GMRES's, reduces over it.
    """
    F = residual(x0)
    fnorm = tnorm(F, group)
    target = torch.clamp(tol * fnorm, min=atol)
    x = x0
    k = kry = stall = 0
    while k < max_iters and bool(fnorm > target) and stall < 2:

        def jv(v, x=x):
            if jac_mv is not None:
                return jac_mv(x, v)
            return torch.func.jvp(residual, (x,), (v,))[1]

        # solve J dx = -F, matrix-free
        dx, info = gmres(
            jv, tscale(-1.0, F), tol=krylov_tol, maxiter=krylov_iters, restart=restart, M=M,
            group=group,
        )
        if max_step is not None:
            dxnorm = tnorm(dx, group)
            cap = torch.as_tensor(max_step, dtype=dxnorm.dtype, device=dxnorm.device)
            dx = tscale(
                torch.where(dxnorm > cap, cap / torch.clamp(dxnorm, min=1e-30), 1.0), dx
            )

        F_new = None
        lam = 1.0
        if line_search:
            # Armijo backtracking: the longest lambda with
            # ||F(x + lambda dx)|| <= (1 - 1e-4 lambda) ||F(x)||, else the
            # lambda of smallest ||F||. The JAX package runs all
            # max_backtracks trials but takes the first accepted lambda, so
            # stopping there gives the same lambda and saves the remaining
            # residual evaluations; the accepted trial's residual is the
            # new residual (the same inputs give the same values).
            trial_lam, min_fn, min_lam = 1.0, float("inf"), 1.0
            for _ in range(max_backtracks):
                F_trial = residual(taxpy(trial_lam, dx, x))
                fn = tnorm(F_trial, group)
                if bool(fn <= (1.0 - 1e-4 * trial_lam) * fnorm):
                    lam, F_new = trial_lam, F_trial
                    break
                if bool(fn < min_fn):
                    min_fn, min_lam = fn, trial_lam
                trial_lam *= 0.5
            else:
                lam = min_lam

        x_new = taxpy(lam, dx, x)
        if F_new is None:
            F_new = residual(x_new)
        fnorm_new = tnorm(F_new, group)
        stall = stall + 1 if bool(fnorm_new >= fnorm) else 0
        x, F, fnorm = x_new, F_new, fnorm_new
        k += 1
        kry += info.iters
    return x, NewtonInfo(k, float(fnorm), bool(fnorm <= target), kry)


def picard(
    residual: Callable,
    x0,
    *,
    tol: float = 1e-8,
    max_iters: int = 200,
    damping: float = 1.0,
    group=None,
):
    """Damped Picard / Richardson iteration for F(x) = 0: x <- x - w F(x).

    Takes the same residual as newton_krylov and converges when
    I - w dF/dx is a contraction. Convergence test: ||F(x)|| <= tol, the
    norm reduced over `group` on a sharded state.
    """
    x = x0
    F = residual(x)
    fnorm = tnorm(F, group)
    k = 0
    while k < max_iters and bool(fnorm > tol):
        x = taxpy(-damping, F, x)
        F = residual(x)
        fnorm = tnorm(F, group)
        k += 1
    return x, NewtonInfo(k, float(fnorm), bool(fnorm <= tol), 0)
