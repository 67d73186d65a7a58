"""Communication-avoiding (s-step) restarted GMRES on sharded fields.

The port of `neptune_tpu/parallel/ca_gmres.py`. Per restart cycle, ONE
(s+1)-deep strip exchange builds the s+1-vector Krylov basis with the
matrix-powers kernel (`ca_common`), ONE reduction gives the (s+1)² Gram
matrix, and the least-squares problem

    min_y || r0 - Ã (V[:, :s] y) ||_2

is then solved on the host in coefficient space: with the change of basis
B (Ã V_j = Σ_i B[i,j] V_i), the residual in basis coordinates is
c(y) = e0 - B[:, :s] y and ||V c||² = cᵀ G c, so a factor G = L̃L̃ᵀ turns
the problem into an ordinary (s+1)×s dense LS min ||L̃ᵀc(y)|| (Gram-based
QR, the CA-GMRES construction of Mohiyuddin, Hoemmen, Demmel & Yelick).

Numerics (as the JAX package's):
  * Restart-cycle residual replacement: every cycle re-seeds the chain
    from the TRUE residual r0 = b̃ - Ã x recomputed inside the
    matrix-powers kernel (x rides the strip exchange).
  * Jacobi preconditioning as a split similarity transform Ã = S A S with
    S = sqrt(inv_diag): split-preconditioned GMRES, minimising
    ||S(b - A x)||.
  * basis="monomial" (fine for s >= 6) or "chebyshev" (needs lam_min /
    lam_max bounding the spectrum's real part; keeps κ(V) bounded at
    larger s).

Communication per s iterations: one exchange of (s+1)·reach-deep strips of
ONE field (x) + one (s+1)² reduction, versus s exchanges + O(s²/2) dot
reductions for per-iteration MGS-GMRES. `maxiter` rounds up to a multiple
of s (convergence is tested per cycle).
"""

from __future__ import annotations

import os
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from .ca_cg import _basis_matrix
from .ca_common import MatrixPowers, plan_ca_solver, run_ca_solver
from .mesh import GridMesh


def _upper_solve(R, rhs, hdt):
    """R y = rhs by back-substitution (R upper triangular, nonzero
    diagonal)."""
    n = rhs.shape[0]
    y = np.zeros(n, hdt)
    for i in range(n - 1, -1, -1):
        y[i] = (rhs[i] - R[i, i + 1 :] @ y[i + 1 :]) / R[i, i]
    return y


def _ls_update(G, Bred, s, basis, hdt):
    """The cycle's LS solution y (coefficients of V[:s], unscaled) from the
    Gram matrix: column-normalised Gram, clamped eigendecomposition factor,
    Householder QR with rank masking and one refinement step -- the JAX
    package's algebra, in the field's dtype on the host."""
    eps = np.finfo(hdt).eps
    one = hdt(1.0)
    # column normalisation (zero extra communication): V' = V diag(1/||V_j||),
    # G' = D G D, B'[i,j] = B[i,j] d_i/d_j, y = y'/||V_j||
    dG = np.sqrt(np.clip(np.diag(G), 0.0, None)).astype(hdt)
    dsafe = np.where(dG > 0, dG, one).astype(hdt)
    Gs = (G / (dsafe[:, None] * dsafe[None, :])).astype(hdt)
    Bs = (Bred * (dsafe[:, None] / dsafe[None, :s])).astype(hdt)
    # G' = L̃L̃ᵀ from the clamped eigendecomposition (a Cholesky NaNs out
    # when the basis degenerates; eigh is NaN-free)
    w_ev, Q_ev = np.linalg.eigh(Gs)
    if basis == "chebyshev":
        # the Chebyshev basis is well-conditioned by design, so normalised
        # Gram eigenvalues below the f32 dot-product noise floor are noise;
        # the monomial basis keeps its whole spectrum (its small
        # eigenvalues carry the trailing Krylov directions)
        tau = hdt(2500.0) * hdt(eps) * np.max(w_ev)
        w_ev = np.where(w_ev > tau, w_ev, hdt(0.0)).astype(hdt)
    Lt = (np.sqrt(np.maximum(w_ev, hdt(0.0)))[:, None] * Q_ev.T).astype(hdt)
    A_ls = Lt @ Bs  # m x s
    b_ls = Lt[:, 0] * dsafe[0]  # = L̃ᵀ e0'
    # Householder QR + one step of iterative refinement, not lstsq; columns
    # whose R diagonal underflows the rank tolerance are dropped whole
    Q_ls, R_ls = np.linalg.qr(A_ls)
    rdiag = np.abs(np.diag(R_ls))
    keep = rdiag > hdt(eps * s) * np.max(rdiag)
    R_safe = (np.where(keep[None, :], R_ls, hdt(0.0)) + np.diag(np.where(keep, hdt(0.0), one))).astype(hdt)

    def tri_solve(rhs):
        yk = _upper_solve(R_safe, (Q_ls.T @ rhs).astype(hdt), hdt)
        return np.where(keep, yk, hdt(0.0)).astype(hdt)

    y = tri_solve(b_ls)
    y = y + tri_solve(b_ls - A_ls @ y)
    return (y / dsafe[:s]).astype(hdt)


def gmres_sharded(
    cm,
    name: str,
    gmesh: GridMesh,
    *,
    s: int = 6,
    maxiter: int = 200,
    tol: float = 1e-6,
    inv_diag=None,
    basis: str = "monomial",
    lam_min: Optional[float] = None,
    lam_max: Optional[float] = None,
) -> Callable:
    """Build a communication-avoiding restarted GMRES(s) solve for A =
    @name (any invertible operator -- symmetry NOT required).

    Returns solve(b) -> (x, SolveInfo) over this process's blocks, as
    `cg_sharded`. inv_diag, if given, is the Jacobi preconditioner diagonal
    (positive). basis="chebyshev" requires lam_min/lam_max bounding the
    (real part of the) spectrum of Ã = S A S."""
    # the chain applies Ã s+1 times from x (1 for the true-residual seed,
    # s for the basis), so the strips must carry (s+1)-deep reach
    sp = plan_ca_solver(
        cm, name, gmesh, s=s, kdepth=s + 1, kdepth_desc="(s+1)",
        solver="gmres_sharded", basis=basis, lam_min=lam_min, lam_max=lam_max,
    )
    # The JAX package's monomial small-s guard: there, monomial CA-GMRES at
    # s=4 stalled at ~2e-4 in f32 on a TPU (its measurement); it refuses the
    # configuration on a TPU and warns elsewhere. The port warns.
    if (
        basis == "monomial"
        and s <= 4
        and sp.dtype == torch.float32
        and not os.environ.get("NEPTUNE_ALLOW_MONOMIAL_SMALL_S")
    ):
        warnings.warn(
            f"gmres_sharded(basis='monomial', s={s}) in f32 stalled at ~2e-4 on a TPU in "
            "the JAX package's measurement (not measured on this port's devices). Use "
            "basis='chebyshev' (with lam_min/lam_max), raise s to >= 6, or set "
            "NEPTUNE_ALLOW_MONOMIAL_SMALL_S=1 to silence this warning.",
            stacklevel=2,
        )
    m = s + 1
    need_k = [((s + 1) * lo, (s + 1) * hi) for lo, hi in sp.need]

    def local_fn(bl, sl):
        mp = MatrixPowers(sp, basis=basis, need_k=need_k, bl=bl, sl=sl)
        hdt = mp.hdt
        Bred = _basis_matrix((m,), basis, sp.theta, sp.delta, hdt)[:, :s]
        b2 = mp.host_sum(mp.btl * mp.btl)
        target2 = hdt(tol * tol) * b2

        x = torch.zeros(mp.nloc, dtype=sp.dtype, device=bl.device)
        rr, it, done, stall = b2 + hdt(1.0), 0, False, 0
        best_x, best_rr = x, hdt(np.inf)
        while not done and it < maxiter and stall < 2:
            # one exchange: (s+1)-deep strips of x; basis = [r, Ãr, ..,
            # Ã^s r], r = b̃ - Ã x (the TRUE residual)
            V = mp.basis_with_replay([x], (s + 1,))
            # one reduction: the Gram matrix
            Vs, G = mp.gram(V)
            # convergence is decided on the cycle seed ||r0||² = G[0,0], a
            # direct sum of squares of the true residual; the LS objective
            # is not used for control
            rr_seed = G[0, 0]
            if rr_seed < best_rr:
                best_x, best_rr = x, rr_seed
            done_now = bool(rr_seed <= target2)
            if not done_now:
                y = _ls_update(G, Bred, s, basis, hdt)
                (dx,) = mp.combine(y[None, :], Vs[:s], mp.nloc)
                x = x + dx
                it += s
            # two consecutive cycles with no seed reduction = stagnated
            stall = stall + 1 if not done_now and rr_seed >= rr else 0
            rr, done = rr_seed, done_now

        # honest final report: when the loop exited mid-cycle (maxiter,
        # stall), rr is the seed of the PREVIOUS x; one extra exchanged
        # matvec reports the returned x's true residual. The best seeded
        # iterate is taken only when the final x is >100x worse.
        if not done:
            rr = mp.true_rr(x)
        if not rr <= hdt(100.0) * best_rr:
            x, rr = best_x, best_rr
        if mp.S_loc is not None:  # un-transform: x = S y
            x = mp.S_loc * x
        return x, rr, it, target2

    return run_ca_solver(local_fn, sp, inv_diag)
