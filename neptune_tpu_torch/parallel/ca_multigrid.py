"""Communication-avoiding multigrid smoothing: k Chebyshev smoothing
iterations per halo exchange on every V-cycle level.

The port of `neptune_tpu/parallel/ca_multigrid.py`. A V(k,k) cycle over
per-matvec sharded smoothers pays 2k+1 exchange rounds per level per cycle
(k pre-sweeps, the residual matvec, k post-sweeps), and the rounds shrink
with the level: coarse grids are pure latency. Each smoothing pass here
runs the overlapping-trapezoid scheme of `ca_chebyshev`: exchange k-deep
(x, r) strips once, run k zero-ghost Chebyshev iterations on the core (each
core matvec on kernel A's window form where `sharded_apply.window_route`
takes the op, as `ca_common.core_matvec` routes it), and recompute the
k·reach edge zones exactly by replaying the same k iterations eagerly on
strip-stitched bands. Per level per cycle:

    pre-smooth (zero guess)   1 round   (against k)
    post-smooth               2 rounds  (against k+1: residual + sweeps)

The pre-smoother's residual falls out of the recurrence, so the
restriction needs no extra matvec. The inverse diagonal's k-deep strips
are iteration-constant: they are exchanged once, when the smoother is
built.

The smoothing is the "cheb" smoother's (`solvers.multigrid`): degree-k
Chebyshev on [lam_max/4, lam_max] of D^-1 A, so convergence is that of
per-matvec smoothing and the cycle stays a fixed linear, D-self-adjoint
operator (a valid CG preconditioner).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..ir.types import TempType
from ..lowering import torch_backend
from .ca_common import block_of, core_matvec
from .mesh import GridMesh
from .sharded_apply import (
    _block_apply,
    _fused_plan,
    _gstart,
    _owned,
    _run_band_fixups,
    _single_apply,
    _stitch_band,
    _strip_exchange,
    shardmap_opdef,
)


def ca_smoother(
    cm,
    name: str,
    gmesh: GridMesh,
    *,
    k: int,
    lam_min: float,
    lam_max: float,
    inv_diag=None,
):
    """The fused k-iteration Chebyshev smoother for A = @name, over this
    process's blocks.

    Returns (smooth, smooth_zero):
      smooth(b, x) -> (x', r'): k Chebyshev iterations from x (2 exchange
        rounds: one fused sharded matvec for r = b - A x, one k-deep strip
        exchange for the fused iterations);
      smooth_zero(b) -> (x', r'): the same from x = 0, where r0 = b needs
        no matvec (1 exchange round).
    r' is the recurrence residual b - A x' (to roundoff): a V-cycle
    restricts it directly.

    lam_min/lam_max bound the spectrum of (M A), M = diag(inv_diag) (this
    process's block) or the identity; smoothing uses the whole interval
    (pass [lam_max/4, lam_max] for the standard smoothing range). Raises
    ValueError when @name is ineligible for the fused path at depth k.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    fn = cm.module.lookup(name)
    tt: TempType = fn.ftype.inputs[0]
    rank = tt.bounds.rank
    if len(fn.ftype.inputs) != 1 or len(fn.ftype.results) != 1:
        raise ValueError("ca_smoother needs a unary, single-result opdef")
    op = _single_apply(fn)
    if op is None:
        raise ValueError("ca_smoother needs a single-apply opdef body")
    names = list(gmesh.axis_names[:rank]) + [None] * (rank - len(gmesh.axis_names))
    plan = _fused_plan(fn, op, gmesh, names, sweeps_k=k)
    if plan is None:
        raise ValueError(
            f"@{name} is not eligible at k={k} "
            "(non-constant scalars, or k*reach exceeds a shard)"
        )
    need, scalar_vals, _ret_index, _arg_order = plan
    outer = op.results[0].type.bounds
    dtype = torch_backend.DTYPES[op.results[0].type.element]
    periodic = bool(op.attrs.get("periodic"))

    theta = 0.5 * (float(lam_max) + float(lam_min))
    delta = 0.5 * (float(lam_max) - float(lam_min))
    sigma1 = theta / delta
    # the recurrence's (d <- c1 z + c2 d) pairs: the seed step, then k-1
    # steps, in the exact arithmetic of solvers.chebyshev at maxiter=k
    pairs, rho_prev = [(1.0 / theta, 0.0)], 1.0 / sigma1
    for _ in range(k - 1):
        rho = 1.0 / (2.0 * sigma1 - rho_prev)
        pairs.append((2.0 * rho / delta, rho * rho_prev))
        rho_prev = rho
    need_k = [(k * lo, k * hi) for lo, hi in need]

    matvec_block = _block_apply(op, names, scalar_vals)
    core_mv = core_matvec(op, scalar_vals, names, cm.backend)

    idl = None if inv_diag is None else block_of(inv_diag, gmesh, dtype)
    id_strips = id_ext = None
    if idl is not None:
        # iteration-constant: its k-deep strips are exchanged once, here
        id_strips, id_ext, _ = _strip_exchange(
            [idl], tuple(idl.shape), rank, names, need_k, periodic, gmesh
        )

    def k_iters(x, r, idiag, mv):
        """k iterations from (x, r): k matvecs, the recurrence of
        solvers.chebyshev restarted each smoothing pass."""
        d = None
        for i, (c1, c2) in enumerate(pairs):
            z = r if idiag is None else idiag * r
            d = c1 * z if i == 0 else c1 * z + c2 * d
            x = x + d
            r = r - mv(d)
        return x, r

    def smooth_core(xl, rl, nloc, gstart):
        """One fused smoothing pass from a locally complete residual."""
        strips, ext_slice, sharded_dims = _strip_exchange(
            [xl, rl], nloc, rank, names, need_k, periodic, gmesh
        )
        xm, rm = (
            _owned(t, [xl, rl]) for t in k_iters(xl, rl, idl, lambda u: core_mv(u, gstart))
        )

        def replay(bands, zone):
            bx, br = (bb.to(dtype) for bb in bands)
            bid = None
            if idl is not None:
                bid = _stitch_band(
                    id_ext, id_strips, 0, zone.d, zone.side, zone.lo_n, zone.hi_n, nloc
                )
            mv = lambda u: matvec_block(u, zone.bases, u.shape)  # noqa: E731
            return list(k_iters(bx, br, bid, mv))

        return tuple(_run_band_fixups(
            [xm, rm], 2, strips, ext_slice, sharded_dims, need_k, nloc, rank, gstart, replay
        ))

    def smooth(b, x):
        bl, xl = block_of(b, gmesh, dtype), block_of(x, gmesh, dtype)
        nloc = tuple(bl.shape)
        gstart = _gstart(nloc, rank, names, outer, gmesh)
        # round 1: r = b - A x (a fused sharded matvec, 1x-reach band fixup)
        strips, ext_slice, dims = _strip_exchange([xl], nloc, rank, names, need, periodic, gmesh)
        Ax = _owned(core_mv(xl, gstart), [xl])
        (Ax,) = _run_band_fixups(
            [Ax], 1, strips, ext_slice, dims, need, nloc, rank, gstart,
            lambda bands, zone: [matvec_block(bb, zone.bases, bb.shape) for bb in bands],
        )
        return smooth_core(xl, bl - Ax, nloc, gstart)

    def smooth_zero(b):
        bl = block_of(b, gmesh, dtype)
        nloc = tuple(bl.shape)
        return smooth_core(
            torch.zeros_like(bl), bl, nloc, _gstart(nloc, rank, names, outer, gmesh)
        )

    return smooth, smooth_zero


def build_ca_levels(
    cm,
    names: Sequence[str],
    gmesh: GridMesh,
    like,
    *,
    k: int = 2,
    matvecs: Optional[Sequence[Callable]] = None,
):
    """A multigrid level list with CA smoothers: `names` are the opdefs,
    finest to coarsest; `like` is this process's block of the finest grid.

    Each level's matvec is `shardmap_opdef`'s; its ca_smooth/ca_smooth_zero
    run k Chebyshev smoothing iterations on [lam_max/4, lam_max] of D^-1 A
    per 1-2 exchange rounds. A level whose fused plan is ineligible (k·reach
    exceeding a small coarse block) gets ca_smooth=None, and `v_cycle`
    smooths there with its per-matvec "cheb" smoother, as the JAX package
    routes it. From the first level whose block turns odd above the
    coarsest (`solvers.multigrid.first_whole_level`) the levels run on the
    whole grid, replicated on every process: their matvec is `opdef` of
    the whole grid (`matvecs`' entries there must be whole-grid callables)
    and they smooth per matvec.
    """
    from ..solvers.multigrid import _geometry, build_levels, first_whole_level

    def _with_halo(mv, halo, mesh):
        """A user callable without `.halo` would be probed at period (1, 1),
        which aliases taps of reach > 1 into the diagonal: a fresh wrapper
        with the verifier's halo (and the mesh, None on a whole-grid level)
        probes exactly, without touching the caller's callable."""

        def shim(v, _mv=mv):
            return _mv(v)

        shim.halo, shim.gmesh = halo, mesh
        return shim

    sharded = first_whole_level(_geometry(gmesh, tuple(like.shape))[0], gmesh, len(names))
    if sharded == 0:
        raise ValueError(
            f"the finest block {tuple(like.shape)} on mesh {gmesh.shape} is odd: no level "
            "can smooth on blocks (precond='mg' gathers r and runs a whole-grid cycle)"
        )
    mvs = (
        list(matvecs)
        if matvecs is not None
        else [
            shardmap_opdef(cm, nm, gmesh) if i < sharded else cm.opdef(nm)
            for i, nm in enumerate(names)
        ]
    )
    mvs = [
        mv if i < sharded and getattr(mv, "halo", None) and getattr(mv, "gmesh", None) is gmesh
        else _with_halo(mv, cm.module.lookup(nm).attrs["halo"], gmesh if i < sharded else None)
        for i, (mv, nm) in enumerate(zip(mvs, names))
    ]
    levels = build_levels(mvs, like)
    out = []
    for lvl, nm in zip(levels, names):
        if lvl.mesh is None:
            out.append(lvl)
            continue
        lmax = float(lvl.cheb_lmax)
        try:
            sm, sm0 = ca_smoother(
                cm, nm, gmesh, k=k, lam_min=lmax / 4.0, lam_max=lmax, inv_diag=lvl.inv_diag
            )
        except ValueError:
            sm = sm0 = None
        out.append(lvl._replace(ca_smooth=sm, ca_smooth_zero=sm0, ca_k=k if sm else 0))
    return out

