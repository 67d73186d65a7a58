"""Explicit halo exchange between the processes of a mesh.

The port of `neptune_tpu/parallel/halo.py`: the same ghost layouts, with
`GridMesh.ring_shift` in place of `lax.ppermute` and `all_reduce` over the
mesh's group in place of `lax.psum`. Each function takes this process's
block. Ghost values beyond the global domain edge are zero-filled (or
wrapped, on a torus): reads outside the domain are unspecified by the
apply contract, so any finite fill is valid.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..utils.tree import allreduce
from .mesh import GridMesh


def halo_pad_local(
    u_loc: torch.Tensor,
    halo: Sequence[tuple[int, int]],
    axis_names: Sequence,
    gmesh: GridMesh,
    periodic: bool = False,
) -> torch.Tensor:
    """This process's block padded with its neighbours' data, per dim.

    halo[d] = (lo, hi) ghost widths for grid dim d; axis_names[d] is the
    mesh axis splitting that dim (None: whole, padded with zeros only).
    Returns the extended block, local + lo + hi per dim. periodic=True
    gives torus ghosts: the ring wraps at the mesh edge, and whole dims pad
    by wrapping.
    """
    out = u_loc
    for d, (lo, hi) in enumerate(halo):
        if lo == 0 and hi == 0:
            continue
        name = axis_names[d] if d < len(axis_names) else None
        if name:
            idx, n = gmesh.axis_index(name), gmesh.axis_size(name)
            parts = []
            if lo > 0:
                # my high-edge slab goes to the right neighbour's low ghost
                ghost = gmesh.ring_shift(out.narrow(d, out.shape[d] - lo, lo), name, 1)
                parts.append(ghost if periodic or idx != 0 else torch.zeros_like(ghost))
            parts.append(out)
            if hi > 0:
                ghost = gmesh.ring_shift(out.narrow(d, 0, hi), name, -1)
                parts.append(ghost if periodic or idx != n - 1 else torch.zeros_like(ghost))
            out = torch.cat(parts, dim=d)
        else:
            parts = []
            if lo > 0:
                parts.append(
                    out.narrow(d, out.shape[d] - lo, lo)
                    if periodic
                    else torch.zeros_like(out.narrow(d, 0, lo))
                )
            parts.append(out)
            if hi > 0:
                parts.append(
                    out.narrow(d, 0, hi) if periodic else torch.zeros_like(out.narrow(d, 0, hi))
                )
            out = torch.cat(parts, dim=d)
    return out


def sharded_stencil(
    local_sweep: Callable,
    gmesh: GridMesh,
    halo: Sequence[tuple[int, int]],
    rank: int,
    periodic: bool = False,
) -> Callable:
    """A sweep over halo-extended blocks as a function of this process's
    block: `local_sweep(ext_block, {"start": per-dim global start of the
    block}) -> block`. periodic=True gives torus ghosts at the global
    domain edge."""
    names = list(gmesh.axis_names[:rank]) + [None] * (rank - len(gmesh.axis_names))

    def local_fn(u_loc):
        ext = halo_pad_local(u_loc, halo, names, gmesh, periodic=periodic)
        starts = tuple(
            gmesh.axis_index(names[d]) * u_loc.shape[d] if names[d] else 0 for d in range(rank)
        )
        return local_sweep(ext, {"start": starts})

    return local_fn


def allreduce_sum(x: torch.Tensor, gmesh: GridMesh) -> torch.Tensor:
    """x summed over every process of the mesh (solver reductions)."""
    return allreduce(x, gmesh.group)
