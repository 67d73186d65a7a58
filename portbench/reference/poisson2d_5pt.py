"""Plain PyTorch reference of the 2-D 5-point Poisson operator and its CG solve.

(A x)[i,j] = 4 x[i,j] - x[i-1,j] - x[i+1,j] - x[i,j-1] - x[i,j+1] on the
interior box, x copied through on the ring. `rel_residuals` judges a solve
by what it says, ||b - A x|| / ||b|| in float64; `cg` is textbook
Jacobi-preconditioned CG (x0 = 0, stop at ||r|| <= tol ||b||, the test
PETSc's KSP makes). Imports nothing of the program.
"""

from __future__ import annotations

import torch

# one multiply and four subtracts per interior cell
FLOPS_PER_CELL = 5
# per cell and CG iteration besides the matvec: z = r / diag (1), two dot
# products (2 each), x, r and p updated (2 each), ||r|| for the test (2)
CG_FLOPS_PER_CELL = 1 + 4 + 6 + 2


def matvec(x: torch.Tensor, interior) -> torch.Tensor:
    """A x over the last two dims of x (leading dims are a batch)."""
    (i0, j0), (i1, j1) = interior
    out = x.clone()
    out[..., i0:i1, j0:j1] = (
        4.0 * x[..., i0:i1, j0:j1]
        - x[..., i0 - 1:i1 - 1, j0:j1] - x[..., i0 + 1:i1 + 1, j0:j1]
        - x[..., i0:i1, j0 - 1:j1 - 1] - x[..., i0:i1, j0 + 1:j1 + 1]
    )
    return out


def rel_residuals(x: torch.Tensor, b: torch.Tensor, interior) -> torch.Tensor:
    """||b - A x|| / ||b|| per solve, in float64 (x, b: a batch of grids).
    A NaN anywhere in x reads as infinity."""
    x, b = x.double(), b.double()
    r = (b - matvec(x, interior)).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)
    return torch.nan_to_num(r, nan=float("inf"))


def inverse_diagonal(shape, interior, dtype, device) -> torch.Tensor:
    """1 / diag(A): 1/4 on the interior, 1 on the copied-through ring."""
    (i0, j0), (i1, j1) = interior
    d = torch.ones(shape, dtype=dtype, device=device)
    d[i0:i1, j0:j1] = 0.25
    return d


def cg(b: torch.Tensor, interior, tol: float, max_iters: int, dtype=None):
    """Jacobi-preconditioned CG in `dtype` (default b's): (x, iterations)."""
    dtype = dtype or b.dtype
    b = b.to(dtype)
    dinv = inverse_diagonal(b.shape, interior, dtype, b.device)

    def dot(u, v):
        return torch.sum(u * v)

    target = tol * torch.sqrt(dot(b, b))
    x = torch.zeros_like(b)
    r = b.clone()
    z = r * dinv
    p = z
    rz = dot(r, z)
    k = 0
    while k < max_iters and bool(torch.sqrt(dot(r, r)) > target):
        q = matvec(p, interior)
        alpha = rz / dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        z = r * dinv
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k


def lower_precision_solver(interior, tol: float, max_iters: int, dtype=torch.bfloat16):
    """The control: the reference CG computed in the precision below the
    configuration's (bfloat16 for float32), put in the program's place:
    b -> x, handed back in b's dtype."""

    def solve(b):
        return cg(b, interior, tol, max_iters, dtype)[0].to(b.dtype)

    return solve
