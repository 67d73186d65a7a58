"""Communication-avoiding (s-step) BiCGStab on sharded fields.

The port of `neptune_tpu/parallel/ca_bicgstab.py`. Per outer block, ONE
strip exchange builds a two-seed Krylov basis with the matrix-powers kernel
(`ca_common`), and ONE reduction of the extended Gram matrix over
W = [V, r̃0] covers every inner product of the s iterations: the shadow
dots (r̃0, r)/(r̃0, v) are rows of the Gram against the carried shadow
field, the stabilisation dots (t,t)/(t,s) are coefficient-space quadratic
forms. The s BiCGStab iterations then run on the host with no
communication.

Chain depths: BiCGStab applies Ã twice per iteration, and block entry
reconstructs the invariant v = Ã·p of the carried direction, so the chains
run 2s+2 (p-seed) and 2s+1 (r-seed) deep -- m = 4s+3 basis vectors on a
(2s+1)·reach-deep exchange. Communication per s iterations: 1 exchange + 1
reduction, vs 2s exchanges + 4s reductions for per-iteration BiCGStab.

Numerics follow `ca_cg`: the split Jacobi transform Ã = S A S, residual
replacement every block, convergence on the block-seed norm, guards on
BiCGStab's breakdowns (rho/denom/tt ≈ 0) that restart the direction and
re-pin the shadow r̃0 on a fresh block, and an honest final `true_rr`.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .ca_cg import _basis_matrix
from .ca_common import MatrixPowers, plan_ca_solver, run_ca_solver
from .mesh import GridMesh


def _bicgstab_block(G, g, Bs, dsafe, s, R0, rr_seed, target2, it, maxiter, scal, hdt):
    """The s BiCGStab iterations of one outer block in (column-scaled)
    coefficient space, the JAX package's masked body as host control flow.
    scal = (rho, alpha, omega) carried across blocks. Returns (x_c, p_c,
    rr_j, it_j, scal, brk)."""
    m = G.shape[0]
    rho, alpha, omega = scal
    # seeds carry the inverse scaling c' = dG ⊙ c
    x_c = np.zeros(m, hdt)
    r_c = np.zeros(m, hdt)
    r_c[R0] = dsafe[R0]
    p_c = np.zeros(m, hdt)
    p_c[0] = dsafe[0]
    # invariant at block boundaries: v = Ã·p
    v_c = Bs @ p_c
    rr_j, it_j = rr_seed, it
    brk = not rr_seed > target2
    for _ in range(s):
        active = not brk and rr_j > target2 and it_j < maxiter
        if not active:
            continue
        rho_new = np.sum(g * r_c)
        good = False
        if rho_new != 0 and rho != 0 and omega != 0:
            beta = (rho_new / rho) * (alpha / omega)
            p_c = r_c + beta * (p_c - omega * v_c)
            v_c = Bs @ p_c
            denom = np.sum(g * v_c)
            if denom != 0:
                alpha_n = rho_new / denom
                s_c = r_c - alpha_n * v_c
                t_c = Bs @ s_c
                tt = np.sum(t_c * (G @ t_c))
                ts = np.sum(t_c * (G @ s_c))
                if tt > 0:
                    omega_n = ts / tt
                    x_n = x_c + alpha_n * p_c + omega_n * s_c
                    r_new = s_c - omega_n * t_c
                    rr_new = np.sum(r_new * (G @ r_new))
                    good = bool(rr_new >= 0)
        if not good:
            # roll back the half-steps of a breakdown iteration (its
            # alpha/omega came from garbage quadratic forms); p and v keep
            # the beta-update, as in the masked body
            brk = True
            continue
        x_c, r_c = x_n, r_new
        rho, alpha, omega = rho_new, alpha_n, omega_n
        rr_j = rr_new
        it_j += 1
    return x_c, p_c, rr_j, it_j, (rho, alpha, omega), brk


def bicgstab_sharded(
    cm,
    name: str,
    gmesh: GridMesh,
    *,
    s: int = 2,
    maxiter: int = 200,
    tol: float = 1e-6,
    inv_diag=None,
    basis: str = "monomial",
    lam_min: Optional[float] = None,
    lam_max: Optional[float] = None,
) -> Callable:
    """Build a communication-avoiding BiCGStab solve for A = @name.

    Returns solve(b) -> (x, SolveInfo) over this process's blocks, as
    `cg_sharded`. A may be nonsymmetric. inv_diag, if given, is the Jacobi
    preconditioner diagonal (positive). basis="chebyshev" requires
    lam_min/lam_max bounding the (real part of the) spectrum of Ã = S A S.
    Eligibility needs (2s+1)·reach to fit one block -- prefer small s."""
    # two operator applications per iteration: the chains run 2s+1 deep
    sp = plan_ca_solver(
        cm, name, gmesh, s=s, kdepth=2 * s + 1, kdepth_desc="(2s+1)",
        solver="bicgstab_sharded", basis=basis, lam_min=lam_min, lam_max=lam_max,
    )
    kdepth = 2 * s + 1
    len_p, len_r = 2 * s + 2, 2 * s + 1
    m = len_p + len_r  # 4s + 3
    R0 = len_p  # coefficient index of the R-chain seed (the residual)
    need_k = [(kdepth * lo, kdepth * hi) for lo, hi in sp.need]

    def local_fn(bl, sl):
        mp = MatrixPowers(sp, basis=basis, need_k=need_k, bl=bl, sl=sl)
        hdt = mp.hdt
        one = hdt(1.0)
        Bmat = _basis_matrix((len_p, len_r), basis, sp.theta, sp.delta, hdt)
        b2 = mp.host_sum(mp.btl * mp.btl)
        target2 = hdt(tol * tol) * b2

        x = torch.zeros(mp.nloc, dtype=sp.dtype, device=bl.device)
        p = torch.zeros_like(x)
        rhat = torch.zeros_like(x)
        scal = (one, one, one)
        rr, it, stall, fresh = b2, 0, 0, True
        best_x, best_rr = x, hdt(np.inf)
        while it < maxiter and rr > target2 and stall < 2:
            # one exchange: (2s+1)-deep strips of (x, p); basis = [p, Ãp, ..,
            # Ã^{2s+1} p, r, Ãr, .., Ã^{2s} r], r = b̃ - Ã x
            V = mp.basis_with_replay([x, p], (len_p, len_r))
            # a fresh block (solve start / post-breakdown) re-pins the
            # shadow to the block-seed residual and resets the scalars
            if fresh:
                rhat = V[R0]
                scal = (one, one, one)
            # one reduction: the extended Gram matrix over [V, r̃0]
            Ws, Gx = mp.gram(V + [rhat])
            G_raw = Gx[:m, :m]
            g_raw = Gx[m, :m]  # g[i] = (r̃0, V_i)
            # column normalisation (zero extra communication): scaled
            # basis V' = V diag(1/||V_j||), coefficients mapped back at
            # recovery by c = c'/||V_j||
            dG = np.sqrt(np.clip(np.diag(G_raw), 0.0, None)).astype(hdt)
            dsafe = np.where(dG > 0, dG, one).astype(hdt)
            G = (G_raw / (dsafe[:, None] * dsafe[None, :])).astype(hdt)
            g = (g_raw / dsafe).astype(hdt)
            Bs = (Bmat * (dsafe[:, None] / dsafe[None, :])).astype(hdt)
            # trustworthy block-seed norm (see ca_cg)
            rr_seed = G_raw[R0, R0]
            if rr_seed < best_rr:
                best_x, best_rr = x, rr_seed
            block_on = rr_seed > target2
            x_c, p_c, rr_j, it_j, scal, brk = _bicgstab_block(
                G, g, Bs, dsafe, s, R0, rr_seed, target2, it, maxiter, scal, hdt
            )
            # breakdown: zero the direction -- the next (fresh) block's first
            # beta-update then bootstraps p = r exactly
            fresh = bool(brk and block_on)
            if fresh:
                p_c = np.zeros_like(p_c)
            dx, p = mp.combine(np.stack([x_c / dsafe, p_c / dsafe]), Ws[:m], mp.nloc)
            x = x + dx
            stall = stall + 1 if block_on and it_j <= it else 0
            # divergence exit on the trusted seed (as ca_cg)
            if rr_seed > hdt(1e4) * best_rr:
                stall = 2
            rr = max(rr_j, hdt(0.0)) if block_on else rr_seed
            it = it_j

        # honest final report: one extra exchanged matvec; the best seeded
        # iterate only when the final x is >100x worse
        rr = mp.true_rr(x)
        if not rr <= hdt(100.0) * best_rr:
            x, rr = best_x, best_rr
        if mp.S_loc is not None:
            x = mp.S_loc * x
        return x, rr, it, target2

    return run_ca_solver(local_fn, sp, inv_diag)
