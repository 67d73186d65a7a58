"""Matrix-free Krylov solvers: CG, BiCGStab, restarted GMRES.

The port of `neptune_tpu/solvers/krylov.py`. The JAX solvers run a
`lax.while_loop` on the device; here each is a plain loop over tensors on
their own device, and the loop condition is checked on the host after every
iteration. That keeps the iteration counts identical to the reference's;
checking only every N iterations would save a device sync per iteration and
is later performance work.

All solvers:
  * operate on a grid tensor or a tuple of them (multi-field states);
  * stop at ||r|| <= max(tol * ||b||, atol), PETSc's default rtol test;
  * return (x, SolveInfo) with the iteration count, the residual norm and a
    convergence flag, as host values;
  * take `group=`, the process group of a sharded grid, or better the
    mesh's `GridMesh.mesh_group(rank)`: every process passes its block of b
    and a matvec over blocks (`parallel.shardmap_opdef`), and each inner
    product and norm is all-reduced over the group (`utils.tree`). Without
    a group they reduce locally, as before.

Under `config.pinned_arithmetic` CG's and BiCGStab's inner products and
norms sum through `utils.tree`'s pinned tree over the global vector (a
mesh group gathers the products), and their axpys fence the product, so a
solve is bitwise the same on every mesh shape. GMRES keeps `vdot`/`vnorm`
for its Arnoldi products, as the JAX package's GMRES keeps `jnp.vdot`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..utils.tree import (
    allreduce, taxpy, tdot, tdot_f64, tnorm, tscale, tsub, tzeros_like, vdot, vnorm,
)


class SolveInfo(NamedTuple):
    iters: int  # iteration count
    resnorm: float  # final residual norm
    converged: bool


def _tolerances(b, tol, atol, group=None, norm=None):
    bnorm = (norm or tnorm)(b, group)
    # guard ||b|| = 0: converge to x = 0 via the atol floor
    return torch.clamp(tol * bnorm, min=atol), bnorm


def _divergence_bound(bnorm, divtol):
    """||r|| above this is divergence (PETSc -ksp_divtol, relative to ||b||;
    off by default, opt in with options={'divtol': ...})."""
    big = torch.finfo(bnorm.dtype).max
    if divtol is None:
        return torch.full_like(bnorm, big)
    return torch.clamp(divtol * torch.clamp(bnorm, min=1.0), max=big)


def _norm_f64(a, group=None):
    return torch.sqrt(tdot_f64(a, a, group))


def _identity(x):
    return x


def _safe(d):
    """d, with 0 replaced by 1 (the reference's division guards)."""
    return torch.where(d == 0, torch.ones_like(d), d)


def _running(k, maxiter, rnorm, target, divbound) -> bool:
    """The while-loop condition, read on the host (one sync)."""
    return k < maxiter and bool(((rnorm > target) & (rnorm <= divbound)).item())


# ---------------------------------------------------------------------------
# Conjugate Gradient (preconditioned)
# ---------------------------------------------------------------------------


def cg(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    M: Optional[Callable] = None,
    divtol: Optional[float] = None,
    group=None,
):
    """Preconditioned conjugate gradient for SPD operators. Its inner
    products sum in float64 (`tdot_f64`), as kernel B's do: the iterates
    over a mesh are the whole grid's. Under pinned arithmetic they sum
    through the global pairwise tree instead (`utils.tree`). Without M,
    z is r, so ||r|| is the root of r.z: one reduction fewer a step, the
    same value."""
    plain = M is None
    M = M or _identity
    x = tzeros_like(b) if x0 is None else x0
    target, bnorm = _tolerances(b, tol, atol, group, norm=_norm_f64)
    divbound = _divergence_bound(bnorm, divtol)

    def norm_r(r, rz):
        return torch.sqrt(rz) if plain else _norm_f64(r, group)

    r = tsub(b, matvec(x))
    z = M(r)
    p = z
    rz = tdot_f64(r, z, group)
    k = 0
    rnorm = norm_r(r, rz)
    while _running(k, maxiter, rnorm, target, divbound):
        Ap = matvec(p)
        pAp = tdot_f64(p, Ap, group)
        alpha = rz / _safe(pAp)
        x = taxpy(alpha, p, x)
        r = taxpy(-alpha, Ap, r)
        z = M(r)
        rz_new = tdot_f64(r, z, group)
        beta = rz_new / _safe(rz)
        p = taxpy(beta, p, z)
        rz = rz_new
        k += 1
        rnorm = norm_r(r, rz)
    return x, SolveInfo(k, float(rnorm), bool(rnorm <= target))


# ---------------------------------------------------------------------------
# BiCGStab
# ---------------------------------------------------------------------------


def bicgstab(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    M: Optional[Callable] = None,
    divtol: Optional[float] = None,
    group=None,
):
    """Preconditioned BiCGStab for general (non-symmetric) operators."""
    M = M or _identity
    x = tzeros_like(b) if x0 is None else x0
    target, bnorm = _tolerances(b, tol, atol, group)
    divbound = _divergence_bound(bnorm, divtol)

    r = tsub(b, matvec(x))
    rhat = r  # shadow residual
    p = tzeros_like(b)
    v = tzeros_like(b)
    one = torch.ones_like(bnorm)
    rho = alpha = omega = one
    k = 0
    rnorm = tnorm(r, group)
    while _running(k, maxiter, rnorm, target, divbound):
        rho_new = tdot(rhat, r, group)
        beta = (rho_new / _safe(rho)) * (alpha / _safe(omega))
        p = taxpy(beta, tsub(p, tscale(omega, v)), r)
        phat = M(p)
        v = matvec(phat)
        alpha = rho_new / _safe(tdot(rhat, v, group))
        s = taxpy(-alpha, v, r)
        shat = M(s)
        t = matvec(shat)
        omega = tdot(t, s, group) / _safe(tdot(t, t, group))
        x = taxpy(alpha, phat, taxpy(omega, shat, x))
        r = taxpy(-omega, t, s)
        rho = rho_new
        k += 1
        rnorm = tnorm(r, group)
    return x, SolveInfo(k, float(rnorm), bool(rnorm <= target))


# ---------------------------------------------------------------------------
# Restarted GMRES (modified Gram-Schmidt + Givens rotations)
# ---------------------------------------------------------------------------


def _ravel(a):
    """Flatten a tensor or tuple of tensors; returns (vector, unravel)."""
    if isinstance(a, torch.Tensor):
        shape = a.shape
        return a.reshape(-1), lambda v: v.reshape(shape)
    shapes = [t.shape for t in a]
    sizes = [t.numel() for t in a]
    flat = torch.cat([t.reshape(-1) for t in a])

    def unravel(v):
        return tuple(c.reshape(s) for c, s in zip(torch.split(v, sizes), shapes))

    return flat, unravel


def gmres(
    matvec: Callable,
    b,
    x0=None,
    *,
    tol: float = 1e-6,
    atol: float = 0.0,
    maxiter: int = 1000,
    restart: int = 30,
    M: Optional[Callable] = None,
    divtol: Optional[float] = None,
    group=None,
):
    """Restarted GMRES(m), left-preconditioned with M. PETSc's default KSP.

    The Krylov basis and its Gram-Schmidt products stay on the device; the
    (m+1) x m Hessenberg system, its Givens rotations and the
    back-substitution run on the host in the working precision (f64 for f64
    states, f32 otherwise), one small transfer per Arnoldi step. On a
    sharded grid the basis holds this process's block of each vector, and
    the restart length is the global vector length's (all-reduced).
    """
    M = M or _identity
    x0 = tzeros_like(b) if x0 is None else x0
    flat_b, unravel = _ravel(b)
    n = flat_b.numel()
    n_global = n if group is None else int(allreduce(torch.tensor(n, dtype=torch.int64), group))
    dtype = flat_b.dtype
    hdt = np.float64 if dtype == torch.float64 else np.float32
    m = int(min(restart, maxiter, n_global))

    def flat_matvec(v):
        return _ravel(matvec(unravel(v)))[0]

    def flat_M(v):
        return _ravel(M(unravel(v)))[0]

    Mbnorm = vnorm(flat_M(flat_b), group)
    target_t = torch.clamp(tol * Mbnorm, min=atol)
    divbound = float(_divergence_bound(Mbnorm, divtol))
    target = hdt(target_t.item())

    x = _ravel(x0)[0]
    rnorm = hdt(vnorm(flat_M(flat_b - flat_matvec(x)), group).item())
    converged = rnorm <= target
    k = 0
    while k < maxiter and not converged and rnorm <= divbound:
        r = flat_M(flat_b - flat_matvec(x))
        beta_t = vnorm(r, group)
        beta = hdt(beta_t.item())
        V = torch.zeros((m + 1, n), dtype=dtype, device=flat_b.device)
        H = np.zeros((m + 1, m), hdt)
        cs = np.zeros(m, hdt)
        sn = np.zeros(m, hdt)
        g = np.zeros(m + 1, hdt)
        g[0] = beta
        V[0] = r / _safe(beta_t)
        resnorm = beta
        done = beta <= target
        niters = 0
        for j in range(m):
            if done:
                break
            w = flat_M(flat_matvec(V[j]))
            hs = []
            for i in range(j + 1):  # modified Gram-Schmidt against V[0..j]
                hij = vdot(V[i], w, group)
                w = w - hij * V[i]
                hs.append(hij)
            hjp1 = vnorm(w, group)
            V[j + 1] = w / _safe(hjp1)
            hcol = np.zeros(m + 1, hdt)
            hcol[: j + 2] = torch.stack(hs + [hjp1]).cpu().numpy()
            for i in range(j):  # apply the existing rotations
                hi = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
                hip1 = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
                hcol[i], hcol[i + 1] = hi, hip1
            denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            if denom == 0:
                c_new, s_new = hdt(1.0), hdt(0.0)
            else:
                c_new, s_new = hcol[j] / denom, hcol[j + 1] / denom
            hcol[j] = c_new * hcol[j] + s_new * hcol[j + 1]
            hcol[j + 1] = 0.0
            g_j, g_jp1 = c_new * g[j], -s_new * g[j]
            H[:, j] = hcol
            cs[j], sn[j] = c_new, s_new
            g[j], g[j + 1] = g_j, g_jp1
            resnorm = abs(g_jp1)
            niters += 1
            # stop mid-cycle once the total iteration budget is spent
            done = resnorm <= target or k + niters >= maxiter
        y = np.zeros(m, hdt)
        for i in range(niters - 1, -1, -1):  # back-substitution
            hii = H[i, i]
            y[i] = (g[i] - np.dot(H[i, :], y)) / (hii if hii != 0 else hdt(1.0))
        if niters:
            yt = torch.from_numpy(y[:niters]).to(device=flat_b.device, dtype=dtype)
            x = x + yt @ V[:niters]
        k += niters
        rnorm = resnorm
        converged = resnorm <= target
    return unravel(x), SolveInfo(k, float(rnorm), bool(converged))


@contextlib.contextmanager
def full_precision():
    """f32 matrix products at full precision, TF32 off, whatever the caller
    set: the H100's twin of the bf16 matrix-unit fault of the TPU."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def direct(matrix: torch.Tensor, b, **_kw):
    """LU solve against an assembled dense matrix (`MatrixHandle.dense`)."""
    flat_b, unravel = _ravel(b)
    with full_precision():
        x = torch.linalg.solve(matrix, flat_b)
        rnorm = torch.linalg.vector_norm(matrix @ x - flat_b)
    return unravel(x), SolveInfo(1, float(rnorm), True)


SOLVERS = {"cg": cg, "bicgstab": bicgstab, "gmres": gmres}


def solve(matvec: Callable, b, solver: str = "gmres", **kwargs):
    """Dispatch by solver name."""
    try:
        fn = SOLVERS[solver]
    except KeyError:
        raise ValueError(f"unknown linear solver {solver!r}; options: {sorted(SOLVERS)}")
    return fn(matvec, b, **kwargs)
