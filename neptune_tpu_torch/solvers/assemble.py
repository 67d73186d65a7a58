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
