"""Preconditioners for the matrix-free Krylov solvers.

The port of the Jacobi part of `neptune_tpu/solvers/precond.py`. The
operator diagonal comes from stencil-period probing: for a stencil whose
offsets satisfy |o_d| <= w_d, probes that are 1 on the lattice
{ i : i = c (mod w_d+1) } never interact through the stencil, so
diag = sum over probes of probe * A(probe), in prod_d (w_d + 1) applications.
SSOR and multigrid are not ported yet.
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np
import torch


def extract_diagonal(matvec: Callable, like: torch.Tensor, halo: Sequence[tuple[int, int]]):
    """Exact operator diagonal via stencil-period probing.

    `like` is a zero template with the operator's grid shape, dtype and
    device; `halo` is the per-dim (lo, hi) reach of the operator.
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

    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
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


def jacobi(matvec: Callable, like: torch.Tensor, halo) -> Callable:
    """M(x) = x / diag(A), with zero-diagonal entries passed through."""
    inv = safe_inv_diag(extract_diagonal(matvec, like, halo))

    def M(x):
        return x * inv

    return M


def make_preconditioner(name: str, matvec: Callable, like, halo=()):
    """Preconditioner factory keyed by the `precond` op attribute."""
    if name in (None, "none"):
        return None
    if name == "jacobi":
        return jacobi(matvec, like, halo)
    if name in ("ssor", "ssor_dense", "mg"):
        raise NotImplementedError(
            f"precond={name!r} is not ported yet: ROADMAP.md, queue 1, "
            f"items 4 and 7"
        )
    raise ValueError(f"unknown preconditioner {name!r}")
