"""Plain PyTorch reference of the 2-D 5-point Jacobi step.

u'[i,j] = 0.25 * (u[i-1,j] + u[i+1,j] + u[i,j-1] + u[i,j+1]) on the interior
box, every other cell copied through. The sum is taken in the order the
stencil is written, so in float32 (no fused multiply-add; the multiply by
0.25 is exact) it is bitwise what the stencil means. Imports nothing of the
program.
"""

from __future__ import annotations

import torch

# three adds and one multiply per interior cell and step
FLOPS_PER_CELL = 4


def step(u: torch.Tensor, interior) -> torch.Tensor:
    """One Jacobi step of `u` (a new tensor, in u's dtype)."""
    (i0, j0), (i1, j1) = interior
    out = u.clone()
    out[i0:i1, j0:j1] = 0.25 * (
        u[i0 - 1:i1 - 1, j0:j1] + u[i0 + 1:i1 + 1, j0:j1]
        + u[i0:i1, j0 - 1:j1 - 1] + u[i0:i1, j0 + 1:j1 + 1]
    )
    return out


def steps(u: torch.Tensor, interior, k: int) -> torch.Tensor:
    """k Jacobi steps of `u`."""
    for _ in range(k):
        u = step(u, interior)
    return u


def lower_precision_stepper(interior, k: int, dtype=torch.bfloat16):
    """The control: the reference in the precision below the
    configuration's (bfloat16 for float32), put in the program's place:
    u -> k steps computed in `dtype`, handed back in u's dtype."""

    def call(u):
        return steps(u.to(dtype), interior, k).to(u.dtype)

    return call
