"""Operator handles — the `assemble_matrix` result object.

The port of `neptune_tpu/solvers/assemble.py`: the handle holds the operator
callable plus the structural metadata (structure-key hash, halo, interior)
the solvers use. Dense assembly (`dense`) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ir.types import TempType


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

    def dense(self):
        raise NotImplementedError(
            "dense assembly is not ported yet: ROADMAP.md, queue 1, item 4"
        )

    def ring_lift(self, b):
        """Dirichlet lift for the copy-through ring, or None when the
        structure is unknown / the operator is full-domain.

        The copy-through contract makes the system nonsymmetric at the
        boundary ring; with lift = b masked to the ring, CG solves
        A x_int = b - A lift (whose ring is 0, so the iterates stay in the
        symmetric interior subspace) and returns x_int + lift. One matvec,
        exact.
        """
        if self.interior is None:
            return None
        outer = self.temp_type.bounds
        if self.interior == outer:
            return None
        from ..lowering.torch_backend import interior_mask

        inside = interior_mask(self.interior, outer, b.device)
        return torch.where(inside, torch.zeros_like(b), b)

    def diagonal(self, device=None) -> torch.Tensor:
        """Exact diagonal via stencil-period probing (see solvers.precond)."""
        from .precond import extract_diagonal

        like = torch.zeros(self.grid_shape, dtype=self.dtype, device=device)
        halo = self.halo or tuple((1, 1) for _ in self.grid_shape)
        return extract_diagonal(self.matvec, like, halo)
