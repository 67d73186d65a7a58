"""Communication-avoiding (s-step) conjugate gradient on sharded fields.

The port of `neptune_tpu/parallel/ca_cg.py`. Per outer step, ONE K-deep
strip exchange builds the 2s+1-vector Krylov basis with the matrix-powers
kernel (zero-ghost chains + trapezoid band replay, `ca_common`), ONE
reduction gives the (2s+1)² Gram matrix, and the s CG iterations then run
in coefficient space on the host with no communication at all -- alphas,
betas and every residual norm come from the Gram matrix.

Numerics (as the JAX package's):
  * Jacobi preconditioning is applied as a split similarity transform
    Ã = S A S with S = sqrt(inv_diag) (pointwise): the same x-iterates as
    left-preconditioned CG with M = diag(inv_diag) in exact arithmetic.
    Convergence is tested on ||S(b - A x)|| <= tol ||S b||.
  * Residual replacement every outer step: the basis R-chain is seeded
    from the TRUE residual r = S b - Ã x recomputed inside the
    matrix-powers kernel (x rides the same strip exchange as p).
  * basis="monomial" (default, fine for small s) or "chebyshev" (shifted,
    needs lam_min/lam_max of Ã; keeps the basis well-conditioned at larger
    s -- the Gram matrix of a monomial basis degrades as kappa^s).

Communication per s iterations: one exchange of s·reach-deep strips of two
fields (p, x) + one (2s+1)² reduction, versus s exchanges + 2s reductions
for per-iteration CG; ~2s matvecs per s iterations (the p-chain and the
r-chain).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .ca_common import MatrixPowers, plan_ca_solver, run_ca_solver
from .mesh import GridMesh


def _basis_matrix(lengths, basis: str, theta, delta, dtype) -> np.ndarray:
    """Change-of-basis matrix B with A·V_j = sum_i B[i,j]·V_i per chain.

    `lengths` gives the chain lengths laid out consecutively; CA-CG uses
    (s+1, s) -- columns 0..s the p-chain, s+1..2s the r-chain -- and CA-GMRES
    a single (s+1,) chain. The top-degree column of each chain is never
    applied by the coefficient recurrences, so those columns are zero."""
    m = sum(lengths)
    B = np.zeros((m, m))

    def fill(base, length):
        for j in range(length - 1):
            c = base + j
            if basis == "monomial":
                B[c + 1, c] = 1.0
            else:  # chebyshev: A v_j = theta v_j + (delta/2)(v_{j+1}+v_{j-1})
                B[c, c] = theta
                B[c + 1, c] = delta if j == 0 else delta / 2.0
                if j > 0:
                    B[c - 1, c] = delta / 2.0

    base = 0
    for length in lengths:
        fill(base, length)
        base += length
    return B.astype(dtype)


def _safe(v, one):
    return one if v == 0 else v


def _cg_block(G, Bmat, s, rr_seed, target2, it, maxiter, hdt):
    """The s CG iterations of one outer block in coefficient space (the
    JAX package's masked body as host control flow). Returns (x_c, p_c,
    rr_j, it_j): the coefficients of x's update and of the next p."""
    m = 2 * s + 1
    one = hdt(1.0)
    block_on = rr_seed > target2
    # conjugacy check on the carried search direction: <r0, p0> = ||r0||²
    # on every healthy trajectory; a p out of a degenerate block restarts
    # from the residual
    p_ok = abs(G[s + 1, 0] - rr_seed) <= hdt(0.5) * rr_seed
    x_c = np.zeros(m, hdt)
    r_c = np.zeros(m, hdt)
    r_c[s + 1] = one
    if p_ok:
        p_c = np.zeros(m, hdt)
        p_c[0] = one
    else:
        p_c = r_c.copy()
    rr_j, it_j = rr_seed, it
    brk = not block_on
    for j_in in range(s):
        # an r-seeded (restarted) block has only s-1 valid basis-image
        # applications (the r-chain's top-degree column is zero in B)
        valid = p_ok or j_in < s - 1
        active = valid and not brk and rr_j > target2 and it_j < maxiter
        if not active:
            continue
        w_c = Bmat @ p_c
        pAp = np.sum(p_c * (G @ w_c))
        ok = pAp > 0
        good = False
        if ok:
            alpha = rr_j / _safe(pAp, one)
            x_n = x_c + alpha * p_c
            r_n = r_c - alpha * w_c
            rr_new = np.sum(r_n * (G @ r_n))
            # a Gram quadratic form can stay positive while the step is
            # garbage: an in-block residual jump of >10x is breakdown, and
            # the step rolls back
            good = bool(rr_new >= 0) and bool(rr_new <= hdt(10.0) * rr_j)
        if not good:
            brk = True
            continue
        x_c, r_c = x_n, r_n
        beta = rr_new / _safe(rr_j, one)
        p_c = r_c + beta * p_c
        rr_j = rr_new
        it_j += 1
    # breakdown restart: the next block's search direction is the residual
    if brk and block_on:
        p_c = r_c
    return x_c, p_c, rr_j, it_j


def cg_sharded(
    cm,
    name: str,
    gmesh: GridMesh,
    *,
    s: int = 4,
    maxiter: int = 200,
    tol: float = 1e-6,
    inv_diag=None,
    basis: str = "monomial",
    lam_min: Optional[float] = None,
    lam_max: Optional[float] = None,
) -> Callable:
    """Build a communication-avoiding CG solve for A = @name.

    Returns solve(b) -> (x, SolveInfo): b and x are this process's blocks
    (tensors, or NumPy for b), info holds host values. A must be SPD on its
    interior (the boundary copy-through rows act as identity rows, which
    keeps SPD-ness when inv_diag is 1 there). inv_diag, if given, is this
    process's block of the Jacobi preconditioner diagonal.
    basis="chebyshev" requires lam_min/lam_max bounding the spectrum of
    Ã = S A S."""
    sp = plan_ca_solver(
        cm, name, gmesh, s=s, kdepth=s, kdepth_desc="s",
        solver="cg_sharded", basis=basis, lam_min=lam_min, lam_max=lam_max,
    )
    need_k = [(s * lo, s * hi) for lo, hi in sp.need]

    def local_fn(bl, sl):
        mp = MatrixPowers(sp, basis=basis, need_k=need_k, bl=bl, sl=sl)
        hdt = mp.hdt
        Bmat = _basis_matrix((s + 1, s), basis, sp.theta, sp.delta, hdt)
        b2 = mp.host_sum(mp.btl * mp.btl)
        target2 = hdt(tol * tol) * b2

        x = torch.zeros(mp.nloc, dtype=sp.dtype, device=bl.device)
        p, rr, it, stall = mp.btl, b2, 0, 0
        best_x, best_rr = x, hdt(np.inf)
        # two consecutive zero-progress blocks = the coefficient space is
        # numerically exhausted; stop and report honestly
        while it < maxiter and rr > target2 and stall < 2:
            # one exchange: s-deep strips of (x, p); basis = [p, Ãp, ..,
            # Ã^s p, r, Ãr, .., Ã^{s-1} r], r = b̃ - Ã x
            V = mp.basis_with_replay([x, p], (s + 1, s))
            # one reduction: the Gram matrix
            Vs, G = mp.gram(V)
            # convergence is decided on the block-seed norm ||r0||² (a
            # direct sum of squares of the true residual); the in-block
            # estimates only gate the s inner iterations
            rr_seed = G[s + 1, s + 1]
            # best-iterate tracking on the trusted seed metric
            if rr_seed < best_rr:
                best_x, best_rr = x, rr_seed
            block_on = rr_seed > target2
            x_c, p_c, rr_j, it_j = _cg_block(G, Bmat, s, rr_seed, target2, it, maxiter, hdt)
            # recover x, p from the basis (local, no communication)
            dx, p = mp.combine(np.stack([x_c, p_c]), Vs, mp.nloc)
            x = x + dx
            stall = stall + 1 if block_on and it_j <= it else 0
            # divergence exit: the trusted seed left the best iterate 1e4x
            # behind (a healthy CG block never regresses that far)
            if rr_seed > hdt(1e4) * best_rr:
                stall = 2
            rr = max(rr_j, hdt(0.0)) if block_on else rr_seed
            it = it_j

        # honest final report: ONE extra exchanged matvec gives the true
        # preconditioned residual of the returned x. The best x is a safety
        # net only, taken when the final iterate is pathologically worse
        # (>100x) than the best seeded one.
        rr_cur = mp.true_rr(x)
        if rr_cur <= hdt(100.0) * best_rr:
            rr = rr_cur
        else:
            x, rr = best_x, best_rr
        if mp.S_loc is not None:  # un-transform: x = S y
            x = mp.S_loc * x
        return x, rr, it, target2

    return run_ca_solver(local_fn, sp, inv_diag)
