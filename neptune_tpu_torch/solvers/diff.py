"""Differentiable solves: implicit gradients through linear and nonlinear
solvers, one adjoint solve each.

The port of `neptune_tpu/solvers/diff.py`, where `lax.custom_linear_solve`
and `lax.custom_root` carry the rule. Here the operator and the residual
close over their parameters, which therefore cannot be inputs of a
`torch.autograd.Function`. So each solve

  1. finds x* without a graph;
  2. evaluates the residual r = b - A(x*) (or F(x*)) once *with* the graph,
     x* held constant;
  3. returns x* + C(r), where C's forward returns zeros and its backward
     solves the adjoint system with Aᵀ (or Jᵀ, through `torch.func.vjp`).

Autograd of that one residual evaluation then carries the gradient to `b`,
to `u_prev` and to every closed-over leaf tensor. C's `jvp` solves the
forward system, so forward-mode derivatives (`torch.func.jvp`) work too.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils.tree import _leaves, tscale, tsub
from . import krylov
from .newton import newton_krylov


def _detach(a):
    if isinstance(a, (tuple, list)):
        return tuple(t.detach() for t in a)
    return a.detach()


def _pack(structure, leaves):
    return tuple(leaves) if isinstance(structure, (tuple, list)) else leaves[0]


class _Implicit(torch.autograd.Function):
    """x* + C(r): `apply(inverse, *r_leaves)` returns zeros shaped like r.

    `inverse.solve(v)` is A⁻¹ v (the tangent), `inverse.solve_t(v)` is
    A⁻ᵀ v (the cotangent), each over a state of r's structure."""

    @staticmethod
    def forward(inverse, *r):
        return tuple(torch.zeros_like(t) for t in r)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.inverse = inputs[0]

    @staticmethod
    def jvp(ctx, _inverse_tangent, *r_t):
        like = ctx.inverse.like
        r_t = [torch.zeros_like(t) if v is None else v for t, v in zip(_leaves(like), r_t)]
        return tuple(_leaves(ctx.inverse.solve(_pack(like, r_t))))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_leaves(ctx.inverse.solve_t(_pack(ctx.inverse.like, grads))))


def _attach(x_star, r, inverse):
    """x* + C(r): x* in value, with C's derivative rule on r."""
    zeros = _Implicit.apply(inverse, *_leaves(r))
    return _pack(x_star, [x + z for x, z in zip(_leaves(x_star), zeros)])


class _LinearInverse:
    def __init__(self, matvec, like, solve, symmetric):
        self.matvec, self.like, self._solve, self.symmetric = matvec, like, solve, symmetric

    def solve(self, v):
        return self._solve(self.matvec, v)

    def solve_t(self, v):
        if self.symmetric:
            return self.solve(v)
        _, pull = torch.func.vjp(self.matvec, self.like)
        return self._solve(lambda w: pull(w)[0], v)


def differentiable_solve(
    matvec: Callable,
    b,
    *,
    solver: str = "cg",
    symmetric: bool = False,
    tol: float = 1e-10,
    maxiter: int = 1000,
    M: Optional[Callable] = None,
):
    """Solve A x = b with implicit differentiation.

    `matvec` may close over differentiable parameters; gradients with
    respect to both `b` and those parameters are exact (up to the solver's
    tolerance), computed with one adjoint solve with Aᵀ (the operator itself
    when symmetric=True, else Aᵀ through `torch.func.vjp`), by the same
    solver and preconditioner, as in the JAX package.
    """

    def solve(mv, rhs):
        with torch.no_grad():
            return krylov.solve(mv, _detach(rhs), solver=solver, tol=tol, maxiter=maxiter, M=M)[0]

    x_star = solve(matvec, b)
    r = tsub(b, matvec(x_star))
    return _attach(x_star, r, _LinearInverse(matvec, x_star, solve, symmetric))


class _RootInverse:
    """The linearized system at the root: dx = -J⁻¹ dF (tangent) and
    g -> -J⁻ᵀ g (cotangent), each by GMRES."""

    def __init__(self, residual, x_star, tol, maxiter):
        self.residual, self.like, self.tol, self.maxiter = residual, x_star, tol, maxiter

    def _gmres(self, mv, v):
        with torch.no_grad():
            x, _ = krylov.gmres(mv, _detach(v), tol=self.tol, maxiter=self.maxiter)
        return tscale(-1.0, x)

    def solve(self, v):
        def jv(w):
            return torch.func.jvp(self.residual, (self.like,), (w,))[1]

        return self._gmres(jv, v)

    def solve_t(self, v):
        _, pull = torch.func.vjp(self.residual, self.like)
        return self._gmres(lambda w: pull(w)[0], v)


def differentiable_root(
    residual: Callable,
    x0,
    *,
    tol: float = 1e-10,
    max_iters: int = 50,
    krylov_tol: float = 1e-8,
    krylov_iters: int = 300,
):
    """Solve F(x) = 0 with implicit differentiation.

    `residual` may close over differentiable parameters; the backward pass
    solves one linear system with ∂F/∂x at the root (its transpose through
    `torch.func.vjp`, by GMRES), with no differentiation through the Newton
    iterations.
    """
    x0 = _detach(x0)
    with torch.no_grad():
        x_star, _ = newton_krylov(
            residual,
            x0,
            tol=tol,
            max_iters=max_iters,
            krylov_tol=krylov_tol,
            krylov_iters=krylov_iters,
        )

    F = residual(x_star)
    return _attach(x_star, F, _RootInverse(residual, x_star, krylov_tol, krylov_iters))
