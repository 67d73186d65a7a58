"""Chebyshev iteration: the solver and smoother that needs no inner products.

The port of `neptune_tpu/solvers/chebyshev.py`. Each iteration is one
matvec and a few axpys; the recurrence needs bounds [lam_min, lam_max] of
the (preconditioned) SPD operator's spectrum, estimated by power iteration
when not given. Each `fori_loop` of the JAX package is a Python loop over
tensors on their device:

  * `check_every=0` runs exactly `maxiter` iterations and reads nothing on
    the host until the final residual norm;
  * `check_every=k` reads the residual norm on the host once every k
    iterations (`_unconverged`) and stops early.

Bounds given as Python floats keep the recurrence's scalars on the host;
estimated bounds are 0-d tensors, and the scalars stay on the device.
Multigrid's "cheb" smoother runs `smooth`, the fixed-count loop without the
final residual that `chebyshev` computes for its `SolveInfo`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..utils.tree import taxpy, tnorm, tscale, tsub, tzeros_like
from .krylov import SOLVERS, SolveInfo, _identity, _tolerances


class SpectrumBounds(NamedTuple):
    lam_min: torch.Tensor
    lam_max: torch.Tensor


def _normalized(w, group=None):
    return tscale(1.0 / torch.clamp(tnorm(w, group), min=1e-300), w)


def power_method(
    matvec: Callable, probe, iters: int = 40, M: Optional[Callable] = None, group=None
):
    """Largest-eigenvalue estimate of (M o matvec) by power iteration, as a
    0-d tensor on the probe's device; reads nothing on the host.

    `probe` seeds the iteration (any vector with a component along the top
    eigenvector; the right-hand side works). group: the process group of a
    sharded grid (`krylov`'s `group=`): the norms reduce over it."""
    M = M or _identity
    v = _normalized(probe, group)
    for _ in range(iters):
        v = _normalized(M(matvec(v)), group)
    return tnorm(M(matvec(v)), group)  # ||v|| == 1


def estimate_spectrum(
    matvec: Callable,
    probe,
    iters: int = 40,
    M: Optional[Callable] = None,
    safety: float = 1.05,
    group=None,
):
    """[lam_min, lam_max] bounds for an SPD (preconditioned) operator.

    lam_max by power iteration (inflated by `safety`); lam_min by power
    iteration on the reflected operator lam_max*I - A, which maps the
    smallest eigenvalue to the largest. 2*iters matvecs, once."""
    M = M or _identity
    lam_max = power_method(matvec, probe, iters, M, group) * safety

    def reflected(v):
        return tsub(tscale(lam_max, v), M(matvec(v)))

    lam_min = lam_max - power_method(reflected, probe, iters, group=group)
    # clamp away from 0 (a singular/near-null mode would zero the interval)
    lam_min = torch.maximum(lam_min, lam_max * 1e-8)
    return SpectrumBounds(lam_min, lam_max)


class _Recurrence:
    """The Chebyshev recurrence's constants and one iteration of it."""

    def __init__(self, matvec, M, lam_min, lam_max):
        self.matvec, self.M = matvec, M
        self.theta = 0.5 * (lam_max + lam_min)
        self.delta = 0.5 * (lam_max - lam_min)
        self.sigma1 = self.theta / self.delta

    def start(self, b, x0):
        """(x1, r1, d0, rho0): the first iteration from x0."""
        r0 = tsub(b, self.matvec(x0))
        d0 = tscale(1.0 / self.theta, self.M(r0))
        return taxpy(1.0, d0, x0), tsub(r0, self.matvec(d0)), d0, 1.0 / self.sigma1

    def step(self, x, r, d, rho_prev):
        z = self.M(r)
        rho = 1.0 / (2.0 * self.sigma1 - rho_prev)
        d = taxpy(2.0 * rho / self.delta, z, tscale(rho * rho_prev, d))
        x = taxpy(1.0, d, x)
        r = tsub(r, self.matvec(d))
        return x, r, d, rho


def _fixed(rec: _Recurrence, b, x0, maxiter: int, replace_every: int = 0):
    """(x, r) after exactly `maxiter` iterations, with no reduction; r is the
    recurrence residual, rebased on b - A x every `replace_every`."""
    x, r, d, rho = rec.start(b, x0)
    for i in range(maxiter - 1):
        x, r, d, rho = rec.step(x, r, d, rho)
        if replace_every > 0 and (i + 2) % replace_every == 0:  # i=0 is global iter 2
            r = tsub(b, rec.matvec(x))
    return x, r


def smooth(matvec: Callable, b, x0, *, M: Callable, lam_min, lam_max, maxiter: int):
    """`chebyshev(...)[0]` for fixed bounds and `check_every=0`, without the
    final residual: the multigrid smoother. Reads nothing on the host."""
    return _fixed(_Recurrence(matvec, M, lam_min, lam_max), b, x0, maxiter)[0]


def _unconverged(k: int, maxiter: int, rnorm, target) -> bool:
    """The early-stopping loop's condition, read on the host (one sync)."""
    return k < maxiter and bool((rnorm > target).item())


def chebyshev(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    M: Optional[Callable] = None,
    lam_min: Optional[float] = None,
    lam_max: Optional[float] = None,
    check_every: int = 0,
    spectrum_iters: int = 40,
    residual_replacement: bool = True,
    replace_every: int = 0,
    group=None,
):
    """Preconditioned Chebyshev iteration for SPD operators.

    check_every=0 (default): no reduction in the loop; run exactly `maxiter`
    iterations and measure the residual once at the end.
    check_every=k: test ||r|| <= max(tol*||b||, atol) every k iterations and
    stop early.

    Residual replacement: over thousands of f32 iterations the recurrence
    residual drifts from b - A x. With residual_replacement=True every
    check boundary (and the end of a check_every=0 solve) uses the true
    residual, one extra matvec each; in the check_every=0 loop,
    replace_every=m rebases the recurrence every m iterations.

    Missing bounds are estimated by `estimate_spectrum` from b. group: the
    process group of a sharded grid; every norm reduces over it."""
    M = M or _identity
    x0 = tzeros_like(b) if x0 is None else x0

    if lam_max is None or lam_min is None:
        est = estimate_spectrum(matvec, b, spectrum_iters, M, group=group)
        lam_min = est.lam_min if lam_min is None else lam_min
        lam_max = est.lam_max if lam_max is None else lam_max
    rec = _Recurrence(matvec, M, lam_min, lam_max)
    target, _ = _tolerances(b, tol, atol, group)

    if check_every <= 0:
        x, r = _fixed(rec, b, x0, maxiter, replace_every)
        rnorm = tnorm(tsub(b, matvec(x)) if residual_replacement else r, group)
        return x, SolveInfo(maxiter, float(rnorm), bool(rnorm <= target))

    x, r, d, rho = rec.start(b, x0)
    k, rnorm = 1, tnorm(r, group)
    while _unconverged(k, maxiter, rnorm, target):
        for _ in range(check_every):
            x, r, d, rho = rec.step(x, r, d, rho)
        if residual_replacement:
            # rebase the recurrence on the true residual at the check point
            r = tsub(b, matvec(x))
        k, rnorm = k + check_every, tnorm(r, group)
    return x, SolveInfo(k, float(rnorm), bool(rnorm <= target))


# the solver-name dispatch (`krylov.solve`); registered here, as in the JAX
# package, to avoid a krylov <-> chebyshev import cycle
SOLVERS["chebyshev"] = chebyshev
