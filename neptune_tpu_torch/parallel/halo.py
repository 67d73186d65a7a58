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


def _widths(n: int, depth: int) -> list:
    """The cells each hop of `_ghost` brings: a block's worth, then the rest."""
    out = []
    while depth > 0:
        out.append(min(n, depth))
        depth -= out[-1]
    return out


def _ghost(out: torch.Tensor, d: int, depth: int, side: str, name, gmesh: GridMesh,
           periodic: bool) -> torch.Tensor:
    """The `depth` cells beyond the block's `side` edge along dim d.

    A sharded dim takes them from the neighbours along the ring: one hop
    for a depth the neighbour's block holds, and beyond that each hop
    relays the strip that the previous hop brought, so hop k brings the
    block k positions away. Bounded ghosts from beyond the domain edge are
    zeros, periodic ones wrap. A whole dim wraps (periodic) or reads 0."""
    n = out.shape[d]
    lo = side == "lo"
    if not name:
        if not periodic:
            return torch.zeros_like(out.narrow(d, 0, 1)).expand(
                *out.shape[:d], depth, *out.shape[d + 1:]).contiguous()
        idx = torch.arange(-depth, 0) if lo else torch.arange(n, n + depth)
        return out.index_select(d, (idx % n).to(out.device))
    pos, size = gmesh.axis_index(name), gmesh.axis_size(name)
    shift = 1 if lo else -1
    pieces, recv = [], out
    for hop, width in enumerate(_widths(n, depth), 1):
        # hop 1 sends the block's edge; each later hop relays the part of
        # the previous strip beyond it
        strip = recv.narrow(d, recv.shape[d] - width, width) if lo else recv.narrow(d, 0, width)
        recv = gmesh.ring_shift(strip, name, shift)
        src = pos - hop if lo else pos + hop
        if not periodic and not 0 <= src < size:
            recv = torch.zeros_like(recv)
        pieces.append(recv)
    return torch.cat(pieces[::-1] if lo else pieces, dim=d)


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
    by wrapping. A ghost deeper than the block comes over several hops
    (`_ghost`). Dims pad in order, each from the blocks already extended
    in the earlier dims, so corners come from the diagonal neighbours.
    """
    out = u_loc
    for d, (lo, hi) in enumerate(halo):
        if lo == 0 and hi == 0:
            continue
        name = axis_names[d] if d < len(axis_names) else None
        parts = [out]
        if lo > 0:
            parts.insert(0, _ghost(out, d, lo, "lo", name, gmesh, periodic))
        if hi > 0:
            parts.append(_ghost(out, d, hi, "hi", name, gmesh, periodic))
        out = torch.cat(parts, dim=d)
    return out


def _ghost_transpose(core: torch.Tensor, g: torch.Tensor, d: int, side: str, name,
                     gmesh: GridMesh, periodic: bool) -> None:
    """The adjoint of `_ghost`: add the cotangent `g` of the `side` ghost
    zone along dim d to the cells of `core` its values came from. A sharded
    dim sends it back hop by hop, the opposite way around the ring: hop k's
    piece joins what the deeper hops returned to the strip it relayed, and
    the whole returns one block. Zones that came from beyond a bounded
    domain's edge drop theirs; periodic ones, and a whole dim, wrap."""
    n, depth = core.shape[d], g.shape[d]
    lo = side == "lo"
    if not name:
        if periodic:  # ghost cell i is cell (i - depth) % n (lo) or i % n (hi)
            i = 0
            while i < depth:
                p = (i - depth) % n if lo else i % n
                w = min(n - p, depth - i)
                core.narrow(d, p, w).add_(g.narrow(d, i, w))
                i += w
        return
    pos, size = gmesh.axis_index(name), gmesh.axis_size(name)
    widths = _widths(n, depth)
    # the ghost zone's pieces, hop 1 next to the block
    offs = [sum(widths[:k]) for k in range(len(widths))]
    pieces = [g.narrow(d, depth - o - w, w) if lo else g.narrow(d, o, w)
              for o, w in zip(offs, widths)]
    back = None  # what the deeper hops returned to the strip hop k relayed
    for k in reversed(range(len(widths))):
        cot = pieces[k].clone()
        if back is not None:
            w = back.shape[d]
            (cot.narrow(d, cot.shape[d] - w, w) if lo else cot.narrow(d, 0, w)).add_(back)
        src = pos - (k + 1) if lo else pos + k + 1
        if not periodic and not 0 <= src < size:
            cot = torch.zeros_like(cot)
        back = gmesh.ring_shift(cot, name, -1 if lo else 1)
    w = back.shape[d]
    (core.narrow(d, n - w, w) if lo else core.narrow(d, 0, w)).add_(back)


def halo_pad_local_transpose(
    ext: torch.Tensor,
    halo: Sequence[tuple[int, int]],
    axis_names: Sequence,
    gmesh: GridMesh,
    periodic: bool = False,
) -> torch.Tensor:
    """The adjoint of `halo_pad_local`: a cotangent of the extended block
    becomes one of the block. Each ghost zone's cotangent travels back the
    way its values came (the opposite way around the ring, over as many
    hops as it came) and is added to the owner's cells; zones that padded
    with zeros beyond a bounded domain's edge drop theirs, periodic ones
    wrap. Dims unpad in reverse order, so corners travel on both axes."""
    out = ext
    for d in reversed(range(len(halo))):
        lo, hi = halo[d]
        if lo == 0 and hi == 0:
            continue
        name = axis_names[d] if d < len(axis_names) else None
        n = out.shape[d] - lo - hi
        core = out.narrow(d, lo, n).clone()
        if lo:
            _ghost_transpose(core, out.narrow(d, 0, lo), d, "lo", name, gmesh, periodic)
        if hi:
            _ghost_transpose(core, out.narrow(d, lo + n, hi), d, "hi", name, gmesh, periodic)
        out = core
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
