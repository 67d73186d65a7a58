"""Preconditioners for the matrix-free Krylov solvers.

The port of `neptune_tpu/solvers/precond.py`: Jacobi, the matrix-free
red-black SSOR and the dense SSOR. The operator diagonal comes from
stencil-period probing: for a stencil whose offsets satisfy |o_d| <= w_d,
probes that are 1 on the lattice { i : i = c (mod w_d+1) } never interact
through the stencil, so diag = sum over probes of probe * A(probe), in
prod_d (w_d + 1) applications. Multigrid's preconditioner is
`solvers.multigrid.mg_preconditioner`, behind `precond="mg"` in the
executor (`lowering/executor.py::auto_mg_preconditioner`).
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np
import torch

from .krylov import full_precision


def extract_diagonal(
    matvec: Callable, like: torch.Tensor, halo: Sequence[tuple[int, int]], origin=None
):
    """Exact operator diagonal via stencil-period probing.

    `like` is a zero template with the operator's grid shape, dtype and
    device; `halo` is the per-dim (lo, hi) reach of the operator. origin:
    per dim the global index of `like`'s cell 0 when `like` is one block of
    a sharded grid and `matvec` the sharded operator (default 0): the
    probes' lattice is then the global grid's, across block edges.
    """
    shape = tuple(like.shape)
    if not halo:
        raise ValueError(
            "operator halo metadata missing (empty halo): run "
            "verify_and_annotate on the module before building a Jacobi "
            "preconditioner — probing with an unknown stencil reach would "
            "silently return row sums instead of the diagonal"
        )
    periods = [max(lo, hi) + 1 for lo, hi in halo]
    if len(periods) != len(shape):
        periods = [max(periods)] * len(shape)

    origin = (0,) * len(shape) if origin is None else tuple(origin)
    grids = np.ogrid[tuple(slice(o, o + s) for o, s in zip(origin, shape))]
    diag = torch.zeros_like(like)
    for combo in itertools.product(*[range(p) for p in periods]):
        mask_np = np.ones(shape, dtype=bool)
        for g, c, p in zip(grids, combo, periods):
            mask_np &= (g % p) == c
        probe = torch.from_numpy(mask_np).to(device=like.device, dtype=like.dtype)
        diag = diag + probe * matvec(probe)
    return diag


def safe_inv_diag(d: torch.Tensor) -> torch.Tensor:
    """1/d with zero entries mapped to 1 (identity on those points)."""
    one = torch.ones_like(d)
    return torch.where(d == 0, one, 1.0 / torch.where(d == 0, one, d))


def jacobi(matvec: Callable, like: torch.Tensor, halo, origin=None) -> Callable:
    """M(x) = x / diag(A), with zero-diagonal entries passed through.
    origin: as `extract_diagonal`'s, for one block of a sharded grid."""
    inv = safe_inv_diag(extract_diagonal(matvec, like, halo, origin=origin))

    def M(x):
        return x * inv

    return M


def red_mask(shape, device, origin=None) -> torch.Tensor:
    """Checkerboard parity mask: True where the (global) index sum is even;
    origin: the global index of cell 0 of a block (default 0), so that the
    colours of a sharded grid's blocks are the whole grid's."""
    origin = (0,) * len(shape) if origin is None else origin
    s = 0
    for d, (n, o) in enumerate(zip(shape, origin)):
        iv = torch.arange(o, o + n, device=device)
        s = s + iv.reshape((1,) * d + (-1,) + (1,) * (len(shape) - d - 1))
    return (s % 2) == 0


def ssor_stencil(matvec: Callable, like: torch.Tensor, halo, omega: float = 1.0,
                 origin=None) -> Callable:
    """Matrix-free red-black SSOR: M^{-1} r with two operator applications
    and the probed diagonal, no assembled matrix.

    Factorization (equal to `ssor_dense` at every omega):
        M^{-1} = ω(2-ω) (D/ω + U)^{-1} D (D/ω + L)^{-1}
    as a = (D/ω + L)^{-1} r (red rows direct, black rows see red),
    y = D a, z = (D/ω + U)^{-1} y (black rows direct, red rows see black),
    result ω(2-ω)·z: each triangular solve is exact under the red/black
    ordering because star stencils have no same-color coupling. Stencils
    with same-color couplings (reach-2 offsets like (2,0)) have those
    dropped from L/U: still symmetric positive definite, a weaker smoother.

    origin: per dim the global index of `like`'s cell 0 when `like` is one
    block of a sharded grid and `matvec` the sharded operator: the probes
    and the colours then follow the whole grid's lattice.
    """
    diag = extract_diagonal(matvec, like, halo, origin=origin)
    dsafe = torch.where(diag == 0, torch.ones_like(diag), diag)
    inv = safe_inv_diag(diag)
    red = red_mask(tuple(like.shape), like.device, origin)
    scale = omega * (2.0 - omega)

    def offdiag(z):
        return matvec(z) - diag * z

    def M(r):
        zero = torch.zeros_like(r)
        # forward (D/ω + L)^{-1}: red rows have no L coupling, black rows
        # subtract the red sweep
        a = torch.where(red, omega * inv * r, zero)
        a = torch.where(red, a, omega * inv * (r - offdiag(a)))
        y = dsafe * a
        # backward (D/ω + U)^{-1}: black rows direct, red rows see black
        z = torch.where(red, zero, omega * inv * y)
        z = torch.where(red, omega * inv * (y - offdiag(z)), z)
        return scale * z

    return M


def ssor_dense(A: torch.Tensor, omega: float = 1.0) -> Callable:
    """SSOR preconditioner from an assembled dense matrix:
    M^{-1} = ω(2-ω) (D/ω + U)^{-1} D (D/ω + L)^{-1}."""
    D = torch.diagonal(A)
    Dsafe = torch.where(D == 0, torch.ones_like(D), D)
    lower = torch.diag(Dsafe / omega) + torch.tril(A, -1)
    upper = torch.diag(Dsafe / omega) + torch.triu(A, 1)
    scale = omega * (2.0 - omega)

    def M(r):
        with full_precision():
            y = torch.linalg.solve_triangular(lower, r.reshape(-1, 1), upper=False)
            y = Dsafe.reshape(-1, 1) * y
            z = torch.linalg.solve_triangular(upper, y, upper=True)
        return (scale * z).reshape(r.shape)

    return M


def make_preconditioner(
    name: str, matvec: Callable, like, halo=(), dense_matrix=None, omega: float = 1.0,
    origin=None,
):
    """Preconditioner factory keyed by the `precond` op attribute.

    "ssor" is matrix-free (red-black sweeps through the operator itself);
    "ssor_dense" is the assembled-triangular-solve variant for small
    systems and the exactness oracle. "mg" needs the module to coarsen and
    is built by the executor (`auto_mg_preconditioner`), not here. origin:
    the global index of `like`'s cell 0 when it is one block of a sharded
    grid (Jacobi and SSOR).
    """
    if name in (None, "none"):
        return None
    if name == "jacobi":
        return jacobi(matvec, like, halo, origin=origin)
    if name == "ssor":
        return ssor_stencil(matvec, like, halo, omega=omega, origin=origin)
    if name == "ssor_dense":
        if dense_matrix is None:
            raise ValueError("ssor_dense preconditioner requires an assembled matrix")
        return ssor_dense(dense_matrix, omega=omega)
    raise ValueError(f"unknown preconditioner {name!r}")
