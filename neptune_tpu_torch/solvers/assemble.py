"""Operator handles — the `assemble_matrix` result object.

The port of `neptune_tpu/solvers/assemble.py`: the handle holds the operator
callable plus the structural metadata (structure-key hash, halo, interior)
the solvers use, and dense assembly (`dense`) for small systems, SSOR and
the direct solve.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..config import default_device
from ..ir.core import Function
from ..ir.types import TempType


def single_apply_interior(fn: Function):
    """The apply bounds of a unary single-apply opdef whose copy-through
    seed is the opdef argument — the structure MatrixHandle.ring_lift
    needs ((A z)_ring = z_ring exactly). None for anything else."""
    ap = None
    for op in fn.body.ops:
        if op.name == "neptune.apply":
            if ap is not None:
                return None
            ap = op
        elif op.name not in ("neptune.return", "arith.constant"):
            return None
    if ap is None or not fn.body.args:
        return None
    if not ap.operands or ap.operands[0].uid != fn.body.args[0].uid:
        return None
    return ap.attrs.get("bounds")


def ring_box(interior, outer) -> Optional[tuple]:
    """`interior` (a single-apply opdef's copy-through bounds, or None) as
    per-dim (start, stop) indices of `outer`, or None where it leaves no
    ring: unknown structure, or the whole domain."""
    if interior is None or interior == outer:
        return None
    return tuple((s.start, s.stop) for s in interior.rel_slices(outer))


def lift_outside(b, box):
    """The Dirichlet lift: b outside the interior `box` (per dim (start,
    stop), as `ring_box` gives it), 0 inside."""
    inside = torch.zeros(b.shape, dtype=torch.bool, device=b.device)
    inside[tuple(slice(lo, hi) for lo, hi in box)] = True
    return torch.where(inside, torch.zeros_like(b), b)


@dataclass
class MatrixHandle:
    """Lazy linear-operator handle over a grid-shaped vector space."""

    symbol: str
    matvec: Callable  # grid-shaped tensor -> grid-shaped tensor
    temp_type: TempType  # operand/result temp type (grid shape, dtype)
    structure_key_hash: int = 0
    halo: tuple = ()  # per-dim (lo, hi) reach, for diagonal probing
    # interior apply bounds of a SINGLE-apply opdef whose out-of-interior
    # cells are exact copy-through ((A z)_ring = z_ring): enables the
    # Dirichlet-lift solve below. None for composite/unknown structure.
    interior: Optional[object] = None
    _dense_cache: Optional[torch.Tensor] = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return self.temp_type.bounds.size

    @property
    def grid_shape(self) -> tuple[int, ...]:
        return self.temp_type.bounds.shape

    @property
    def dtype(self) -> torch.dtype:
        from ..lowering.torch_backend import DTYPES

        return DTYPES[self.temp_type.element]

    def __call__(self, x):
        return self.matvec(x)

    def dense(self, device=None) -> torch.Tensor:
        """The full n×n matrix on `device` (default `config.device`), the
        operator applied to the identity basis through `torch.func.vmap`
        (a kernel-routed opdef launches its kernel once per column):
        A[:, j] = A e_j, flattened in C order of the grid."""
        device = torch.empty(0, device=default_device(device)).device  # "cuda" -> "cuda:0"
        if self._dense_cache is None or self._dense_cache.device != device:
            eye = torch.eye(self.n, dtype=self.dtype, device=device)
            cols = torch.func.vmap(lambda e: self.matvec(e.reshape(self.grid_shape)).reshape(-1))(
                eye
            )
            self._dense_cache = cols.T.contiguous()
        return self._dense_cache

    def ring_lift(self, b):
        """Dirichlet lift for the copy-through ring, or None when the
        structure is unknown / the operator is full-domain.

        The copy-through contract makes the system nonsymmetric at the
        boundary ring; with lift = b masked to the ring, CG solves
        A x_int = b - A lift (whose ring is 0, so the iterates stay in the
        symmetric interior subspace) and returns x_int + lift. One matvec,
        exact.
        """
        box = ring_box(self.interior, self.temp_type.bounds)
        return None if box is None else lift_outside(b, box)

    def diagonal(self, device=None) -> torch.Tensor:
        """Exact diagonal via stencil-period probing (see solvers.precond)."""
        from .precond import extract_diagonal

        like = torch.zeros(self.grid_shape, dtype=self.dtype, device=device)
        halo = self.halo or tuple((1, 1) for _ in self.grid_shape)
        return extract_diagonal(self.matvec, like, halo)
