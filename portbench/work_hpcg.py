"""The work of HPCG's solve and of kernel A's float64 launches, counted from
HPCG's algorithm and from each launch's own sizes, never from the port's
plans, and the least time the card could take for it.

A solve is HPCG's `CG_ref.cpp`: the start (r = b - A x from x = 0, one
SpMV) and `iters` iterations, each one V-cycle, one SpMV, three dot
products and three vector updates, so 50 iterations are 50 V-cycles and
51 SpMVs. (The port's CG applies M once more, after the last iteration,
to a residual no answer uses; that cycle is not counted.) Bytes are the
matrix-free minimum of float64 vector passes over each level's unknowns,
each operation on its own (a pass reads or writes one vector once):

  CG, finest level, an iteration: SpMV p -> Ap 2, p.Ap 2, x += a p 3,
    r -= a Ap 3, ||r|| 1, r.z 2, p = z + b p 3: 16 passes;
  each level above the coarsest, a V-cycle: symmetric Gauss-Seidel before
    and after, each a forward and a backward sweep reading x and b and
    writing x, 2 * 2 * 3 = 12; the residual at the coarse unknowns, reading
    x and 1/8 of b and writing 1/8 of r: 1.25; the correction added back,
    reading the coarse 1/8 and updating 1/8 of x: 0.375; 13.625 passes;
  the coarsest level: one symmetric sweep, 6 passes.

Operations are HPCG's own count (`src/ReportResults.cpp`): 2 nnz an SpMV,
2 n a dot product or vector update, and a V-cycle 4 nnz for each sweep,
2 nnz for each residual and 4 nnz on the coarsest level, with nnz the
27-point operator's nonzeros on each level's unknowns.
"""

from __future__ import annotations

import math

from portbench.work import PEAK_BYTES_PER_S, ITEMSIZE, Work

CG_PASSES = 16
LEVEL_PASSES = 12 + 1.25 + 0.375
COARSEST_PASSES = 6


def level_unknowns(interior, levels: int) -> list:
    """Each level's unknowns per dim, finest first."""
    n = [h - l for l, h in zip(*interior)]
    out = []
    for _ in range(levels):
        out.append(tuple(n))
        n = [e // 2 for e in n]
    return out


def nnz(dims) -> int:
    """Nonzeros of the 3^rank-point operator on `dims` unknowns, neighbours
    outside absent: 3n - 2 pairs within one cell along each dim."""
    return math.prod(3 * n - 2 for n in dims)


def solve_work(interior, levels: int, iters: int, dtype: str = "float64") -> Work:
    """One HPCG solve of `iters` iterations with a `levels`-level V-cycle."""
    lv = level_unknowns(interior, levels)
    cells = [math.prod(d) for d in lv]
    nz = [nnz(d) for d in lv]
    passes = LEVEL_PASSES * sum(cells[:-1]) + COARSEST_PASSES * cells[-1]
    mg_flops = sum((4 + 2 + 4) * z for z in nz[:-1]) + 4 * nz[-1]
    per_iter_bytes = (CG_PASSES * cells[0] + passes) * ITEMSIZE[dtype]
    per_iter_flops = 2 * nz[0] + 6 * 2 * cells[0] + mg_flops
    start_bytes = 2 * cells[0] * ITEMSIZE[dtype]
    start_flops = 2 * nz[0]
    return Work(flops=float(start_flops + iters * per_iter_flops),
                bytes=float(start_bytes + iters * per_iter_bytes), dtype=dtype)


def apply_least_s(cells: int, grids: int, itemsize: int) -> float:
    """The least time of one apply: each of its grids (inputs and outputs)
    read or written once, over the card's peak bandwidth."""
    return cells * grids * itemsize / PEAK_BYTES_PER_S
