"""Plain PyTorch reference of HPCG 3.1's problem and its timed solve.

HPCG (https://github.com/hpcg-benchmark/hpcg): the 27-point operator on
nx*ny*nz unknowns, diagonal 26 and every one of the 26 neighbours -1,
neighbours outside the grid absent (`GenerateProblem_ref.cpp`); b = A x*
with x* = 1, so b_i = 27 - nnz_i; preconditioned CG from x = 0, 50
iterations, tolerance 0, in float64 (`CG_ref.cpp`); the preconditioner one
V-cycle of 4 levels, each coarse level the same operator unscaled on half
the unknowns, coarse unknown i on fine unknown 2i (`GenerateCoarseProblem
.cpp`), and on each level x = 0, one symmetric Gauss-Seidel sweep, the
residual restricted by injection, the recursion, the correction added back
by injection and one more sweep; the coarsest level one sweep alone
(`ComputeMG_ref.cpp`).

Departures from HPCG's `*_ref.cpp`, each the port's as well:

* the unknowns are the interior of a grid one cell larger on every side,
  whose ring is 0: the ring stands for HPCG's absent neighbours (a read of
  it adds 0), and every vector keeps it 0;
* Gauss-Seidel runs in multicolour order, not lexicographic: 2^rank colours
  by the parity of the unknown's index along each dim (dim 0 highest bit),
  colours 0, 1, ..., 2^rank - 1 and back, 2^rank - 1, ..., 0, a sweep (HPCG
  allows such a reordered smoother in an optimized run; its validation
  checks the symmetry this order keeps);
* the operator is applied matrix-free, and rank 2 (a 9-point operator,
  diagonal 8) is allowed beside rank 3.

Everything is plain `torch` in the dtype it is given (float64 for HPCG;
float32 for the control), and imports nothing of the program.
"""

from __future__ import annotations

import itertools

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

LEVELS = 4
ITERS = 50


def offsets(rank: int) -> list:
    """The stencil's neighbours, in the order the program writes them."""
    return [o for o in itertools.product((-1, 0, 1), repeat=rank) if any(o)]


def box_slices(interior, shift=None, step=1, start=None):
    """Slices of the grid's interior box, shifted by `shift` (per dim), every
    `step`th cell from `start` (offsets into the box, per dim)."""
    (lo, hi), rank = interior, len(interior[0])
    shift = shift or (0,) * rank
    start = start or (0,) * rank
    return tuple(slice(lo[d] + start[d] + shift[d], hi[d] + shift[d], step) for d in range(rank))


def matvec(x: torch.Tensor, interior) -> torch.Tensor:
    """A x over the trailing grid dims of x (leading dims are a batch): the
    27-point (3-D) or 9-point (2-D) operator on the interior box, the ring
    copied through (it is 0 in every vector of HPCG's)."""
    rank = len(interior[0])
    lead = (slice(None),) * (x.ndim - rank)
    out = x.clone()
    acc = float(3**rank - 1) * x[lead + box_slices(interior)]
    for o in offsets(rank):
        acc = acc - x[lead + box_slices(interior, o)]
    out[lead + box_slices(interior)] = acc
    return out


def rel_residuals(x: torch.Tensor, b: torch.Tensor, interior) -> torch.Tensor:
    """||b - A x|| / ||b|| per solve, in float64 (x, b: a batch of grids).
    A NaN anywhere in x reads as infinity."""
    x, b = x.double(), b.double()
    r = (b - matvec(x, interior)).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)
    return torch.nan_to_num(r, nan=float("inf"))


def rel_diffs(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """||x - x_ref|| / ||x_ref|| per solve, in float64 (batches of grids)."""
    x, ref = x.double(), ref.double()
    d = (x - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)
    return torch.nan_to_num(d, nan=float("inf"))


def unknowns(shape, interior, dtype, device) -> torch.Tensor:
    """1 on the unknowns, 0 on the ring."""
    x = torch.zeros(shape, dtype=dtype, device=device)
    x[box_slices(interior)] = 1.0
    return x


def hpcg_rhs(shape, interior, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """HPCG's own b: A x* with x* = 1 on the unknowns (b_i = 27 - nnz_i)."""
    return matvec(unknowns(shape, interior, dtype, device), interior)


def random_rhs(shape, interior, generator, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """b = A x* with x* uniform on [0, 2) on the unknowns, from `generator`."""
    xs = 2.0 * torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return matvec(xs * unknowns(shape, interior, dtype, device), interior)


def coarse(interior) -> tuple:
    """The next level's (grid shape, interior): half the unknowns, the same
    one-cell ring."""
    (lo, hi) = interior
    n = [(h - l) // 2 for l, h in zip(lo, hi)]
    if any((h - l) % 2 for l, h in zip(lo, hi)):
        raise ValueError(f"interior {interior} has an odd extent: no coarser level")
    shape = tuple(l + m + 1 for l, m in zip(lo, n))
    return shape, (tuple(lo), tuple(l + m for l, m in zip(lo, n)))


def colour_order(rank: int) -> list:
    """The colours of one symmetric sweep, forward then backward."""
    k = 2**rank
    return list(range(k)) + list(range(k))[::-1]


def symgs(x: torch.Tensor, b: torch.Tensor, interior) -> torch.Tensor:
    """One symmetric multicolour Gauss-Seidel sweep, in place on x: each
    colour's unknowns x_i += (b_i - (A x)_i) / 26, from the others'
    current values."""
    rank = len(interior[0])
    inv = 1.0 / float(3**rank - 1)
    for c in colour_order(rank):
        bits = [(c >> (rank - 1 - d)) & 1 for d in range(rank)]
        cells = box_slices(interior, step=2, start=bits)
        ax = float(3**rank - 1) * x[cells]
        for o in offsets(rank):
            ax = ax - x[box_slices(interior, o, 2, bits)]
        x[cells] = x[cells] + inv * (b[cells] - ax)
    return x


def injected(interior, coarse_interior) -> tuple:
    """(fine slices, coarse slices): coarse unknown i on fine unknown 2i."""
    (flo, _), (clo, chi) = interior, coarse_interior
    return (tuple(slice(f, f + 2 * (h - c), 2) for f, c, h in zip(flo, clo, chi)),
            tuple(slice(c, h) for c, h in zip(clo, chi)))


def v_cycle(r: torch.Tensor, interior, levels: int) -> torch.Tensor:
    """HPCG's ComputeMG from x = 0, with `levels` levels below and this."""
    x = torch.zeros_like(r)
    symgs(x, r, interior)
    if levels == 1:
        return x
    shape, ci = coarse(interior)
    fine, cs = injected(interior, ci)
    rf = r - matvec(x, interior)
    rc = torch.zeros(shape, dtype=r.dtype, device=r.device)
    rc[cs] = rf[fine]
    xc = v_cycle(rc, ci, levels - 1)
    x[fine] += xc[cs]
    return symgs(x, r, interior)


def dot(u, v):
    return torch.sum(u * v)


def pcg(b: torch.Tensor, interior, iters: int = ITERS, levels: int = LEVELS,
        dtype=None, history=None) -> torch.Tensor:
    """HPCG's CG: preconditioned by one V-cycle, from x = 0, `iters`
    iterations and tolerance 0, in `dtype` (default b's). `history`, a
    list, gets x after each iteration."""
    dtype = dtype or b.dtype
    b = b.to(dtype)
    x = torch.zeros_like(b)
    r = b - matvec(x, interior)
    z = v_cycle(r, interior, levels)
    p = z
    rz = dot(r, z)
    for _ in range(iters):
        ap = matvec(p, interior)
        alpha = rz / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = v_cycle(r, interior, levels)
        rz_new = dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        if history is not None:
            history.append(x)
    return x


def lower_precision_solver(interior, iters: int = ITERS, levels: int = LEVELS,
                           dtype=torch.float32):
    """The control: the reference computed in the precision below the
    configuration's (float32 for float64), put in the program's place:
    b -> x, handed back in b's dtype."""

    def solve(b):
        return pcg(b, interior, iters, levels, dtype).to(b.dtype)

    return solve
