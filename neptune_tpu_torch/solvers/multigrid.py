"""Geometric multigrid: V-cycle solver and preconditioner, matrix-free.

The port of `neptune_tpu/solvers/multigrid.py`:

  * every level's operator is a matrix-free stencil callable (a
    `MatrixHandle` of the operator rediscretized on the coarser grid, or a
    bare matvec); on the card each is a kernel-A launch per apply;
  * grid transfers are cell-centred and rank-agnostic: restriction is the
    mean over each 2^rank-cell block, prolongation multilinear
    interpolation with half-pixel alignment and clamped edges
    (`F.interpolate`, as `jax.image.resize(..., "linear")` upsamples);
  * smoothing uses the exact operator diagonal from stencil-period probing
    (`precond.extract_diagonal`), so boundary-ring cells (copy-through
    identity rows, diagonal 1) relax to their boundary values;
  * the V-cycle is Python recursion over the level list. A preconditioner
    cycle has fixed counts and reads nothing on the host; the solver's
    outer loop and the coarsest CG test their residuals on the host, as
    the Krylov loops do.

Coarse-grid corrections are zeroed on each level's boundary ring (the
correction equation has homogeneous Dirichlet data there).

HPCG's cycle (`transfer="injection"`, `smoother="symgs"`): levels coarsened
about their interior box, which keeps the ring (`passes.coarsen`'s vertex
mode); coarse unknown i is fine unknown 2i, so restriction is injection of
the fine residual and prolongation adds the coarse correction onto the
fine unknowns it sits on (the transpose of the injection); each smoothing
sweep is one symmetric multicolour Gauss-Seidel sweep, 2^rank parity
colours forward then backward, each colour one call of the level's colour
pass in place (`passes.smoother`; on the card kernel A's colour form, a
launch over that colour's cells). The sweeps update a tensor the smoother
owns: the cycle's own zeros, or a copy of the caller's x made once when
smoothing starts.

On a mesh of processes (`parallel.GridMesh`) the same cycle runs on
blocks: when the finest operator carries a `gmesh` (a
`parallel.shardmap_opdef` matvec, or a handle or wrapper around one),
`like`, `b` and every level's tensors are this process's blocks. The
diagonal probes, the boundary-ring mask, the red-black parity and the
power iteration's seed follow the global grid; every norm, and the
coarsest CG's, reduces over the mesh's group; `restrict` is block-local
(each sharded level above the coarsest needs even block extents);
`prolong` exchanges a one-cell coarse halo with the neighbours and
replicates the edge cell at the domain edge, as the whole-grid
interpolation clamps.

A hierarchy may end in whole-grid levels: operators without a `gmesh`
after sharded ones (`executor.auto_mg_preconditioner` builds them from
the first level whose block turns odd). Those levels are replicated on
every process and reduce over no group. On the way down the restricted
residual's blocks are joined once (`GridMesh.gather`); on the way up each
process interpolates its own block of the correction, its one-cell coarse
halo read from the replicated grid (`prolong_block`), as `prolong` does.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import default_device
from ..utils.profiling import span
from .chebyshev import power_method
from .chebyshev import smooth as _cheb_smooth
from ..utils.tree import tnorm
from .krylov import SolveInfo
from .krylov import cg as _cg
from .precond import extract_diagonal, red_mask, safe_inv_diag


class MGLevel(NamedTuple):
    matvec: Callable
    inv_diag: torch.Tensor  # exact 1/diag(A) on this level's grid
    interior: torch.Tensor  # bool mask: True inside the boundary ring
    # estimated lam_max of D^-1 A (the "cheb" smoother's interval is
    # [lmax/4, lmax]), read to the host once, when the level is built
    cheb_lmax: Optional[float] = None
    # communication-avoiding smoothing (the sharded path's CA multigrid):
    # when set, v_cycle smooths with these instead of per-matvec sweeps,
    # k fused Chebyshev iterations per call, returning the recurrence
    # residual so pre-smoothing needs no extra matvec
    ca_smooth: Optional[Callable] = None  # (b, x) -> (x', r')
    ca_smooth_zero: Optional[Callable] = None  # (b,) -> (x', r')
    ca_k: int = 0  # the smoother's fused iteration count
    # the mesh whose blocks this level's tensors are (None: the whole grid)
    mesh: Optional[object] = None
    # the "symgs" smoother's colour pass in place: (x, b, colour) -> x, the
    # cells of that colour relaxed in x itself (None: the level has none)
    colour: Optional[Callable] = None
    # per dim (start, stop): the cells inside the boundary ring
    box: Optional[tuple] = None


def _as_tensor(a) -> torch.Tensor:
    """A tensor stays where it is; anything else goes to `config.device`."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.require(np.asarray(a), requirements="C")).to(default_device())


def _halo_of(op) -> tuple:
    halo = getattr(op, "halo", None)
    return halo if halo else ()


def _matvec_of(op) -> Callable:
    return getattr(op, "matvec", None) or op


def _mesh_of(op):
    """The `GridMesh` an operator runs over (None: the whole grid)."""
    return getattr(op, "gmesh", None) or getattr(_matvec_of(op), "gmesh", None)


def _geometry(mesh, shape) -> tuple:
    """(global shape, global index of cell 0) of a block of `shape`."""
    if mesh is None:
        return tuple(shape), (0,) * len(shape)
    split = [d < len(mesh.shape) for d in range(len(shape))]
    gshape = tuple(n * mesh.shape[d] if split[d] else n for d, n in enumerate(shape))
    origin = tuple(mesh.coords[d] * n if split[d] else 0 for d, n in enumerate(shape))
    return gshape, origin


def _group(mesh, rank: int):
    """What a field of `rank` dims reduces over (None: nothing)."""
    return None if mesh is None else mesh.mesh_group(rank)


def first_whole_level(gshape, mesh, n_levels: int) -> int:
    """The first level of an `n_levels` hierarchy on the global grid
    `gshape` whose block on `mesh` has an odd extent above the coarsest
    level (block-local restriction needs even blocks): that level and the
    coarser ones run on the whole grid. n_levels when there is none."""
    for lvl in range(n_levels - 1):
        g = [s >> lvl for s in gshape]
        if any((n // mesh.shape[d] if d < len(mesh.shape) else n) % 2 for d, n in enumerate(g)):
            return lvl
    return n_levels


def build_levels(
    ops: Sequence, like, *, rings: Optional[Sequence[int]] = None,
    colour_ops: Optional[Sequence[Callable]] = None,
) -> list[MGLevel]:
    """Per-level smoother data, on `like`'s device and in its dtype.

    ops: finest-to-coarsest operators, `MatrixHandle`s (their halo gives
    exact diagonal probing) or bare matvec callables. like: a finest-grid
    tensor or array (shape, dtype and device template; on a mesh, this
    process's block). Each coarser level halves every dimension, or has
    the `level_shape` its operator names (a whole-grid level). rings:
    per-level boundary-ring width of the correction mask; by default each
    operator's largest halo (1 if unknown). colour_ops: per level, the
    colour pass of the "symgs" smoother in place, (x, b, inv_diag, colour)
    -> x (`CompiledModule.colour_form` of `passes.smoother.colour_pass`),
    given this level's inverse diagonal.

    On a mesh, operators without a `gmesh` after sharded ones are
    whole-grid levels, replicated on every process; a sharded level may
    not follow a whole-grid one.
    """
    like = _as_tensor(like)
    dtype, device, rank = like.dtype, like.device, like.ndim
    mesh0 = _mesh_of(ops[0])
    levels = []
    shape = tuple(like.shape)
    gshape = _geometry(mesh0, shape)[0]
    for i, op in enumerate(ops):
        mesh = _mesh_of(op) if mesh0 is not None else None
        if i and getattr(op, "level_shape", None) is not None and mesh is None:
            # a level that names its own grid (vertex coarsening keeps the
            # ring, so its grid is not half the finer one)
            shape = gshape = tuple(op.level_shape)
        if mesh is not None and levels and levels[-1].mesh is None:
            raise ValueError(
                f"multigrid level {i} is sharded on mesh {mesh.shape} below a whole-grid "
                "level: whole-grid levels must be the coarsest ones"
            )
        if mesh is None:
            shape = gshape
        origin = _geometry(mesh, shape)[1]
        if i + 1 < len(ops) and getattr(ops[i + 1], "level_shape", None) is None and any(
                s % 2 for s in shape):
            if mesh is not None:
                raise ValueError(
                    f"multigrid level {i} grid {gshape} on mesh {mesh.shape}: block {shape} "
                    "is not 2:1-coarsenable (every sharded block extent must be even above "
                    "the coarsest level): use precond='mg', which runs such levels on the "
                    f"whole grid, or pass whole-grid operators from level {i} on"
                )
            raise ValueError(
                f"multigrid level {i} grid {shape} is not 2:1-coarsenable "
                "(every extent must be even above the coarsest level)"
            )
        mv = _matvec_of(op)
        halo = _halo_of(op)
        lvl_like = torch.zeros(shape, dtype=dtype, device=device)
        inv_diag = safe_inv_diag(
            extract_diagonal(mv, lvl_like, halo or ((1, 1),) * rank, origin=origin)
        )
        ring = rings[i] if rings is not None else max((max(h) for h in halo), default=1)
        idx = np.ones(shape, bool)
        for d in range(rank):
            iv = np.arange(origin[d], origin[d] + shape[d])
            m = (iv >= ring) & (iv < gshape[d] - ring)
            idx = idx & m.reshape((1,) * d + (-1,) + (1,) * (rank - d - 1))

        # lam_max of the Jacobi-preconditioned operator D^-1 A, from the
        # JAX package's probe (seed 12345, 20 iterations, x1.1); on a mesh
        # each block is its part of the global seed
        seed = np.random.default_rng(12345).standard_normal(gshape)
        seed = seed[tuple(slice(o, o + n) for o, n in zip(origin, shape))]
        seed_vec = torch.from_numpy(np.ascontiguousarray(seed)).to(device=device, dtype=dtype)
        lmax = power_method(
            mv, seed_vec, iters=20, M=lambda v, iv=inv_diag: iv * v, group=_group(mesh, rank)
        ) * 1.1
        colour = None
        if colour_ops is not None:
            colour = lambda x, b, c, f=colour_ops[i], d=inv_diag: f(x, b, d, c)  # noqa: E731
        box = tuple((ring - o, gn - ring - o) for o, gn in zip(origin, gshape))
        levels.append(
            MGLevel(mv, inv_diag, torch.from_numpy(idx).to(device), float(lmax), mesh=mesh,
                    colour=colour, box=box)
        )
        shape = tuple(s // 2 for s in shape)
        gshape = tuple(s // 2 for s in gshape)
    return levels


def restrict(r: torch.Tensor) -> torch.Tensor:
    """Cell-centred full weighting: the mean over each 2^rank block."""
    split = []
    for s in r.shape:
        split += [s // 2, 2]
    return r.reshape(split).mean(dim=tuple(range(1, 2 * r.ndim, 2)))


_MODES = {1: "linear", 2: "bilinear", 3: "trilinear"}


def _interpolate(e: torch.Tensor, fine_shape) -> torch.Tensor:
    out = F.interpolate(
        e[None, None], size=tuple(fine_shape), mode=_MODES[e.ndim], align_corners=False
    )
    return out[0, 0]


def prolong(e: torch.Tensor, fine_shape, mesh=None) -> torch.Tensor:
    """Cell-centred multilinear interpolation up to fine_shape (2:1).

    On a mesh, e and the result are this process's blocks: each sharded
    dim in turn takes a one-cell halo from the neighbours (a later dim's
    strips are cut from the earlier dims' extended block, so the corner
    cell arrives), the extended block is interpolated and its centre
    carved out. At the domain edge nothing is added: the interpolation's
    own clamp replicates the edge cell there, as on the whole grid, so the
    blocks are those of the whole-grid result: bitwise on the card, whose
    kernel computes each cell alone; on the CPU, whose kernel orders its
    passes by the input's size, within a rounding where a block's coarse
    extent is odd."""
    if mesh is None:
        return _interpolate(e, fine_shape)
    lows = []
    for d in range(min(e.ndim, len(mesh.shape))):
        name, n, idx = mesh.axis_names[d], mesh.shape[d], mesh.coords[d]
        if n == 1:
            lows.append(0)
            continue
        lo = mesh.ring_shift(e.narrow(d, e.shape[d] - 1, 1), name, 1)
        hi = mesh.ring_shift(e.narrow(d, 0, 1), name, -1)
        e = torch.cat(([lo] if idx > 0 else []) + [e] + ([hi] if idx < n - 1 else []), dim=d)
        lows.append(int(idx > 0))
    out = _interpolate(e, [2 * s for s in e.shape])
    return out[tuple(slice(2 * lo, 2 * lo + f) for lo, f in zip(lows, fine_shape))]


def prolong_block(e: torch.Tensor, fine_shape, mesh) -> torch.Tensor:
    """This process's block (of shape fine_shape) of the interpolation of
    the whole coarse grid `e`, which every process holds: the coarse block
    with its one-cell halo (none at the domain edge) is sliced from `e`,
    interpolated and carved out as `prolong` does on a mesh, so the block is
    that of the whole-grid result (bitwise on the card; see `prolong`) and
    nothing is exchanged."""
    sl, lows = [], []
    for d in range(e.ndim):
        if d >= len(mesh.shape):
            sl.append(slice(None))
            lows.append(0)
            continue
        n, idx, cb = mesh.shape[d], mesh.coords[d], fine_shape[d] // 2
        lo = idx * cb - int(idx > 0)
        hi = (idx + 1) * cb + int(idx < n - 1)
        sl.append(slice(lo, hi))
        lows.append(int(idx > 0))
    ext = e[tuple(sl)]
    out = _interpolate(ext, [2 * s for s in ext.shape])
    return out[tuple(slice(2 * lo, 2 * lo + f) for lo, f in zip(lows, fine_shape))]


def _injected(L: MGLevel, Lc: MGLevel) -> tuple:
    """(fine slices, coarse slices): the fine unknowns that Lc's unknowns
    sit on, every second one from the start of L's box, and Lc's box."""
    fine, coarse = [], []
    for (flo, _), (clo, chi) in zip(L.box, Lc.box):
        fine.append(slice(flo, flo + 2 * (chi - clo), 2))
        coarse.append(slice(clo, chi))
    return tuple(fine), tuple(coarse)


def _add_injected(x: torch.Tensor, ec: torch.Tensor, L: MGLevel, Lc: MGLevel) -> torch.Tensor:
    """x with Lc's correction ec added onto the fine unknowns Lc's unknowns
    sit on, in place: the transpose of the injection."""
    fine, coarse = _injected(L, Lc)
    x[fine] += ec[coarse]
    return x


def _down(r: torch.Tensor, L: MGLevel, Lc: MGLevel, transfer: str = "mean") -> torch.Tensor:
    """The restriction of L's residual r to Lc's grid, its ring zeroed:
    joined once into the whole grid where Lc is the first whole-grid
    level. transfer "injection": Lc's unknowns take r at the fine unknowns
    they sit on."""
    if transfer == "injection":
        fine, coarse = _injected(L, Lc)
        rc = torch.zeros(Lc.inv_diag.shape, dtype=r.dtype, device=r.device)
        rc[coarse] = r[fine]
        return rc
    rc = restrict(r)
    if L.mesh is not None and Lc.mesh is None:
        rc = L.mesh.gather(rc)
    return torch.where(Lc.interior, rc, 0.0)


def _up(ec: torch.Tensor, fine_shape, L: MGLevel, Lc: MGLevel) -> torch.Tensor:
    """Lc's correction ec interpolated onto L's grid (L's block on a
    mesh)."""
    if L.mesh is not None and Lc.mesh is None:
        return prolong_block(ec, fine_shape, L.mesh)
    return prolong(ec, fine_shape, L.mesh)


def _check_smoother(smoother: str, transfer: str = "mean") -> None:
    if smoother not in ("rb", "jacobi", "cheb", "symgs"):
        raise ValueError(
            f"unknown smoother {smoother!r}; options: 'rb', 'jacobi', 'cheb', 'symgs'")
    if transfer not in ("mean", "injection"):
        raise ValueError(f"unknown transfer {transfer!r}; options: 'mean', 'injection'")


def _smoother(L: MGLevel, b, smoother: str, omega: float, level: int = 0) -> Callable:
    """smooth(x, n, owned=False): n sweeps of `smoother` for L's operator
    and rhs b, each call of it the span `nt.mg.smooth`. owned: x is the
    cycle's own to update in place; otherwise the "symgs" sweeps, whose
    colour passes run in place, start from a copy of it."""
    colours, in_place = 1, smoother == "symgs"
    if smoother == "symgs":
        if L.colour is None:
            raise ValueError(
                f"multigrid level {level} has no colour pass: the 'symgs' smoother needs "
                "levels built with colour_ops (precond='mg' builds them)")
        colours = 2**b.ndim
        order = [float(c) for c in list(range(colours)) + list(range(colours))[::-1]]

        def sweeps(x, n):
            for _ in range(n):
                for c in order:
                    L.colour(x, b, c)
            return x

    elif smoother == "cheb":
        lmax = L.cheb_lmax

        def sweeps(x, n):
            return _cheb_smooth(
                L.matvec, b, x, M=lambda v: L.inv_diag * v, lam_min=lmax / 4.0, lam_max=lmax,
                maxiter=n,
            )

    elif smoother == "rb":
        colours = 2
        red = red_mask(b.shape, b.device, _geometry(L.mesh, tuple(b.shape))[1])

        def sweeps(x, n):
            for _ in range(n):
                for color in (red, ~red):
                    x = torch.where(color, x + L.inv_diag * (b - L.matvec(x)), x)
            return x

    else:

        def sweeps(x, n):
            for _ in range(n):
                x = x + omega * L.inv_diag * (b - L.matvec(x))
            return x

    def smooth(x, n, owned=False):
        if n <= 0:
            return x
        with span("nt.mg.smooth", level=level, smoother=smoother, colours=colours, sweeps=n):
            return sweeps(x if owned or not in_place else x.clone(), n)

    return smooth


def v_cycle(
    levels: Sequence[MGLevel],
    b,
    x,
    *,
    pre: int = 2,
    post: int = 2,
    omega: float = 0.8,
    coarse_iters: int = 32,
    smoother: str = "rb",
    coarse_solver: str = "cg",
    transfer: str = "mean",
    _x_is_zero: bool = False,
):
    """One V(pre,post) cycle for A x = b on the finest grid.

    Levels carrying `ca_smooth` smooth communication-avoidingly: their
    fused degree k replaces the pre/post counts there, the pre-smoother's
    residual is restricted directly (no extra matvec), and a zero initial
    guess (every coarse level's correction equation; `_x_is_zero`) skips
    the residual matvec. `_x_is_zero` also says that x is zeros made for
    this cycle alone, which the cycle may update in place.

    smoother: "rb" (default), red-black sweeps: two checkerboard-masked
    undamped Jacobi half-updates per sweep (Gauss-Seidel order for star
    stencils); "jacobi", the omega-damped simultaneous update; "cheb",
    degree-n Chebyshev smoothing of D^-1 A on [lam_max/4, lam_max] (fixed
    degree and bounds keep the cycle linear, so it stays a valid CG
    preconditioner); "symgs", symmetric multicolour Gauss-Seidel (colours
    forward then backward, each level's colour pass). coarse_solver: "cg"
    (tol 1e-8, `coarse_iters` iterations at most, tested on the host) or
    "jacobi" (a fixed count of smoothing sweeps, of whichever smoother).
    transfer: "mean" (cell-centred mean and multilinear interpolation) or
    "injection" (see the module docstring). The whole cycle is the span
    `nt.mg.cycle`.
    """
    _check_smoother(smoother, transfer)
    kw = dict(pre=pre, post=post, omega=omega, coarse_iters=coarse_iters, smoother=smoother,
              coarse_solver=coarse_solver, transfer=transfer)
    with span("nt.mg.cycle", levels=len(levels)):
        return _cycle(levels, b, x, 0, _x_is_zero, kw)


def _cycle(levels, b, x, lvl, x_is_zero, kw):
    """`v_cycle` from level `lvl` down, `kw` its settings."""
    L = levels[lvl]
    smooth = _smoother(L, b, kw["smoother"], kw["omega"], lvl)
    pre, post, coarse_iters = kw["pre"], kw["post"], kw["coarse_iters"]
    coarse_solver, transfer = kw["coarse_solver"], kw["transfer"]

    if lvl == len(levels) - 1:
        if coarse_solver == "jacobi":
            # a fixed smoothing count keeps the cycle a LINEAR operator, as
            # a Krylov preconditioner must be (an inner CG is nonlinear in b)
            if L.ca_smooth is not None:
                calls = max(1, coarse_iters // max(L.ca_k, 1))
                if x_is_zero:
                    x, _ = L.ca_smooth_zero(b)
                    calls -= 1
                for _ in range(calls):
                    x, _ = L.ca_smooth(b, x)
                return x
            return smooth(x, coarse_iters, x_is_zero)
        # coarsest: matrix-free CG. The rhs ring is zero and every Krylov
        # vector keeps a zero ring (identity rows), so CG acts on the SPD
        # interior block only; an under-solved coarsest grid would cap the
        # V-cycle's rate
        x, _ = _cg(
            L.matvec, b, x0=x, tol=1e-8, maxiter=coarse_iters, group=_group(L.mesh, b.ndim)
        )
        return x

    given = x
    if L.ca_smooth is not None:
        x, r = L.ca_smooth_zero(b) if x_is_zero else L.ca_smooth(b, x)
    else:
        x = smooth(x, pre, x_is_zero)
        r = b - L.matvec(x)
    # the correction equation has homogeneous Dirichlet data: its rhs must
    # vanish on the coarse ring (identity rows would otherwise store the
    # restricted boundary-layer residual as boundary values, which interior
    # rows coupled at O(1/h^2) amplify once per level)
    Lc = levels[lvl + 1]
    rc = _down(r, L, Lc, transfer)
    ec = _cycle(levels, rc, torch.zeros_like(rc), lvl + 1, True, kw)
    if transfer == "injection":
        x = _add_injected(x.clone() if x is given and not x_is_zero else x, ec, L, Lc)
    else:
        # zero the correction's ring too before interpolating: keeps any
        # coarsest-level ring drift out of fine interior cells
        ec = torch.where(Lc.interior, ec, 0.0)
        e = _up(ec, x.shape, L, Lc)
        x = x + torch.where(L.interior, e, 0.0)
    if L.ca_smooth is not None:
        x, _ = L.ca_smooth(b, x)
        return x
    return smooth(x, post, True)


def multigrid_solve(
    ops: Sequence,
    b,
    x0=None,
    *,
    tol: float = 1e-8,
    maxiter: int = 50,
    pre: int = 2,
    post: int = 2,
    omega: float = 0.8,
    coarse_iters: int = 64,
    smoother: str = "rb",
    levels: Optional[Sequence[MGLevel]] = None,
):
    """Solve A x = b by V-cycle iteration. Returns (x, SolveInfo).

    ops[0] is the finest operator (matching b's grid); each later entry is
    the operator rediscretized on the 2:1-coarsened grid. The loop tests
    ||b - A x|| <= tol * ||b|| on the host after every cycle (on a mesh,
    both norms over the mesh's group).
    """
    _check_smoother(smoother)  # before any cycle, as the JAX package traces one
    b = _as_tensor(b)
    lv = list(levels) if levels is not None else build_levels(ops, b)
    group = _group(lv[0].mesh, b.ndim)
    bnorm = tnorm(b, group)
    limit = tol * torch.clamp(bnorm, min=1e-30)

    def resnorm(x):
        return tnorm(b - lv[0].matvec(x), group)

    if x0 is None:
        # copy-through ring rows are identity: x*_ring = b_ring exactly;
        # seeding it removes the O(1/h^2) boundary-layer transient that
        # otherwise dominates the first cycles on scaled operators
        x = torch.where(lv[0].interior, 0.0, b)
    else:
        x = _as_tensor(x0).to(device=b.device, dtype=b.dtype)
    it, rn = 0, resnorm(x)
    while it < maxiter and bool((rn > limit).item()):
        x = v_cycle(
            lv, b, x, pre=pre, post=post, omega=omega, coarse_iters=coarse_iters,
            smoother=smoother,
        )
        it, rn = it + 1, resnorm(x)
    return x, SolveInfo(iters=it, resnorm=float(rn), converged=bool(rn <= limit))


def fmg_start(
    levels: Sequence[MGLevel],
    b,
    *,
    pre: int = 2,
    post: int = 2,
    omega: float = 0.8,
    coarse_iters: int = 64,
    smoother: str = "rb",
):
    """Full-multigrid initial guess: restrict b down the hierarchy, solve on
    the coarsest grid, then interpolate up with one V-cycle per level. About
    two V-cycles' work; pass the result as `x0=` to `multigrid_solve`."""
    b = _as_tensor(b)
    # restrict the rhs down (ring zeroed: correction-equation data)
    rhs = [b]
    for L, Lc in zip(levels, levels[1:]):
        rhs.append(_down(rhs[-1], L, Lc))
    x = torch.zeros_like(rhs[-1])
    kw = dict(pre=pre, post=post, omega=omega, coarse_iters=coarse_iters, smoother=smoother)
    for lvl in range(len(levels) - 1, -1, -1):
        bl = rhs[lvl] if lvl > 0 else b
        if lvl < len(levels) - 1:
            x = _up(x, bl.shape, levels[lvl], levels[lvl + 1])
            # the finest level takes the true boundary values (see
            # multigrid_solve); coarser levels carry zero-ring data
            x = torch.where(levels[lvl].interior, x, bl if lvl == 0 else 0.0)
        x = v_cycle(levels[lvl:], bl, x, **kw)
    return x


def mg_preconditioner(
    ops: Sequence,
    like,
    *,
    pre: int = 1,
    post: int = 1,
    omega: float = 0.8,
    coarse_iters: int = 32,
    smoother: str = "jacobi",
    levels: Optional[Sequence[MGLevel]] = None,
    transfer: str = "mean",
    colour_ops: Optional[Sequence[Callable]] = None,
) -> Callable:
    """M(r) ~= A^-1 r: one V-cycle from a zero guess, the `M` of the Krylov
    solvers (`cg(..., M=mg_preconditioner(...))`). Pass `levels=` to reuse
    a built hierarchy.

    CG needs a FIXED symmetric positive linear M, so this cycle smooths
    symmetrically (equal pre/post counts) and ends in a fixed-count
    coarsest smooth (`coarse_iters` sweeps); it reads nothing on the host.
    smoother: "jacobi" or "cheb" (self-adjoint in the D-inner product), or
    "symgs" (each sweep a palindrome of colour passes, so self-adjoint in
    the A-inner product; needs `colour_ops`, see `build_levels`); red-black
    ordering is not symmetric and is refused. transfer: "mean" or
    "injection" (restriction the transpose of prolongation, as symmetry
    asks).
    """
    if smoother not in ("jacobi", "cheb", "symgs"):
        raise ValueError(
            "mg_preconditioner smoother must be 'jacobi', 'cheb' or 'symgs' "
            f"(got {smoother!r}; 'rb' ordering is not symmetric)"
        )
    _check_smoother(smoother, transfer)
    lv = list(levels) if levels is not None else build_levels(ops, like, colour_ops=colour_ops)

    def M(r):
        return v_cycle(
            lv, r, torch.zeros_like(r), pre=pre, post=post, omega=omega,
            coarse_iters=coarse_iters, smoother=smoother, coarse_solver="jacobi",
            transfer=transfer, _x_is_zero=True,
        )

    return M
