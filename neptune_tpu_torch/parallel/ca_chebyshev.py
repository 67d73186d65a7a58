"""Communication-avoiding Chebyshev: K solver iterations per halo exchange.

The port of `neptune_tpu/parallel/ca_chebyshev.py`. Chebyshev iteration is
reduction-free (`solvers.chebyshev`: no inner products in the loop), so on
a mesh its only per-iteration communication is the matvec's ghost
exchange. This module removes that too: the whole (x, r, d) recurrence
advances K iterations per exchange via the overlapping-trapezoid scheme of
`shardmap_sweeps`.

Per iteration d and x update POINTWISE (z = M r is diagonal) and only
`r <- r - A d` reads neighbours, so after K zero-ghost iterations on the
core only the K·reach edge zones are wrong; they are recomputed exactly
from strip-stitched bands of the chunk-start state (x, r, d) plus the
diagonal preconditioner's ghosts (exchanged once per solve). The Chebyshev
scalars (the rho recurrence) are host values, the same on every process
and in every band.

Communication: ceil((maxiter-1)/K) exchanges of 3 K-deep field strips
instead of maxiter exchanges of one reach-deep strip, and one reduction at
the end (plus one per check with check_every).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..ir.types import TempType
from ..lowering import torch_backend
from ..solvers.krylov import SolveInfo
from .ca_common import block_of, core_matvec, host_dtype
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
)


def chebyshev_sharded(
    cm,
    name: str,
    gmesh: GridMesh,
    *,
    lam_min,
    lam_max,
    k_fuse: int = 8,
    maxiter: int = 96,
    tol: float = 1e-6,
    inv_diag=None,
    check_every: int = 0,
) -> Callable:
    """Build a communication-avoiding Chebyshev solve for A = @name.

    Returns solve(b) -> (x, SolveInfo) over this process's blocks, as
    `cg_sharded`. lam_min/lam_max bound the spectrum of (M A)
    with M = diag(inv_diag) (or identity; this process's block). The loop runs whole chunks:
    1 + ceil((maxiter-1)/k_fuse) * k_fuse iterations (the seed step plus
    full chunks, at most k_fuse-1 beyond maxiter). The residual norm is
    reduced ONCE at the end; check_every=c (chunks) opts into a convergence
    test -- one reduction, read on the host, per c*k_fuse iterations -- that
    stops the chunk loop early. The reported iteration count includes any
    early stop.

    Residual replacement (as `solvers.chebyshev`): every check boundary,
    and the final report, recompute the TRUE b - A·x with one extra
    exchanged matvec and rebase the recurrence on it.
    """
    if k_fuse < 1:
        raise ValueError("k_fuse must be >= 1")
    fn = cm.module.lookup(name)
    tt: TempType = fn.ftype.inputs[0]
    rank = tt.bounds.rank
    if len(fn.ftype.inputs) != 1 or len(fn.ftype.results) != 1:
        raise ValueError("chebyshev_sharded needs a unary, single-result opdef")
    op = _single_apply(fn)
    if op is None:
        raise ValueError("chebyshev_sharded needs a single-apply opdef body")
    names = list(gmesh.axis_names[:rank]) + [None] * (rank - len(gmesh.axis_names))
    plan = _fused_plan(fn, op, gmesh, names, sweeps_k=k_fuse)
    if plan is None:
        raise ValueError(
            f"@{name} is not eligible at k_fuse={k_fuse} "
            "(non-constant scalars, or K*reach exceeds a shard)"
        )
    need, scalar_vals, _ret_index, _arg_order = plan
    out_type: TempType = op.results[0].type
    outer = out_type.bounds
    dtype = torch_backend.DTYPES[out_type.element]
    hdt = host_dtype(dtype)
    periodic = bool(op.attrs.get("periodic"))

    # the seeding step counts as iteration 1 (as in solvers.chebyshev), so
    # the chunk loop covers the remaining maxiter-1 iterations
    n_chunks = -(-(maxiter - 1) // k_fuse)
    theta = 0.5 * (float(lam_max) + float(lam_min))
    delta = 0.5 * (float(lam_max) - float(lam_min))
    sigma1 = theta / delta
    need_k = [(k_fuse * lo, k_fuse * hi) for lo, hi in need]

    matvec_block = _block_apply(op, names, scalar_vals)
    core_mv = core_matvec(op, scalar_vals, names, cm.backend)

    def coefficients(rho_prev):
        """The chunk's K (d <- c1 z + c2 d) pairs and the next rho_prev, in
        the field's dtype on the host."""
        pairs = []
        for _ in range(k_fuse):
            rho = hdt(1.0) / (hdt(2.0 * sigma1) - rho_prev)
            pairs.append((float(hdt(2.0) * rho / hdt(delta)), float(rho * rho_prev)))
            rho_prev = rho
        return pairs, rho_prev

    idl = None if inv_diag is None else block_of(inv_diag, gmesh, dtype)

    def local_fn(bl):
        nloc = tuple(bl.shape)
        gstart = _gstart(nloc, rank, names, outer, gmesh)

        def gsum(v):
            # a sum over the processes that shard this field only: extra
            # mesh axes hold replicas
            return gmesh.allreduce(v, rank)

        def Mz(r, idiag):
            return r if idiag is None else idiag * r

        def k_iters(x, r, d, pairs, idiag, mv):
            """K Chebyshev iterations with a zero-ghost matvec."""
            for c1, c2 in pairs:
                d = c1 * Mz(r, idiag) + c2 * d
                x = x + d
                r = r - mv(d)
            return x, r, d

        def true_residual(xc):
            """b - A·x with a 1x-reach exchange + band fixup (one extra
            matvec): the seed, every check's rebase, the final report."""
            ts, te, td = _strip_exchange([xc], nloc, rank, names, need, periodic, gmesh)
            Ax = _owned(core_mv(xc, gstart), [xc])
            (Ax,) = _run_band_fixups(
                [Ax], 1, ts, te, td, need, nloc, rank, gstart,
                lambda bands, zone: [matvec_block(bb, zone.bases, bb.shape) for bb in bands],
            )
            return bl - Ax

        # ---- initial step (matches solvers.chebyshev's first move) ----
        # r0 = b; d0 = z0/theta; x1 = d0; r1 = b - A d0 = true_residual(x1)
        d0 = Mz(bl, idl) / theta
        x = d0
        r = true_residual(x)
        rho_prev = hdt(1.0 / sigma1)

        # the preconditioner diagonal is iteration-constant: its K-deep
        # strips are exchanged ONCE
        id_strips = id_ext = None
        if idl is not None:
            id_strips, id_ext, _ = _strip_exchange([idl], nloc, rank, names, need_k, periodic, gmesh)

        def chunk(x, r, d, rho_prev):
            pairs, rho_next = coefficients(rho_prev)
            strips, ext_slice, sharded_dims = _strip_exchange(
                [x, r, d], nloc, rank, names, need_k, periodic, gmesh
            )
            xm, rm, dm = (
                _owned(t, [x, r, d])
                for t in k_iters(x, r, d, pairs, idl, lambda u: core_mv(u, gstart))
            )

            # band fixups: replay the K iterations on strip-stitched bands
            # of the chunk-start state (plus the preconditioner's band)
            def replay(bands, zone):
                bx, br, bd = (b.to(dtype) for b in bands)
                bid = (
                    _stitch_band(id_ext, id_strips, 0, zone.d, zone.side, zone.lo_n, zone.hi_n, nloc)
                    if idl is not None
                    else None
                )
                mv = lambda u: matvec_block(u, zone.bases, u.shape)  # noqa: E731
                return list(k_iters(bx, br, bd, pairs, bid, mv))

            xm, rm, dm = _run_band_fixups(
                [xm, rm, dm], 3, strips, ext_slice, sharded_dims, need_k, nloc, rank, gstart, replay
            )
            return xm, rm, dm, rho_next

        d = d0
        if check_every <= 0:
            for _ in range(n_chunks):
                x, r, d, rho_prev = chunk(x, r, d, rho_prev)
            # the loop itself is reduction-free; the final report rebases on
            # the true residual (solvers.chebyshev parity)
            r = true_residual(x)
            done_chunks = n_chunks
        else:
            target2 = tol * tol * hdt(gsum(torch.sum(bl * bl)).item())
            ic, r2 = 0, hdt(gsum(torch.sum(r * r)).item())
            while ic < n_chunks and r2 > target2:
                # check_every chunks (clamped at the tail), then rebase on
                # the true residual and test it
                for _ in range(min(check_every, n_chunks - ic)):
                    x, r, d, rho_prev = chunk(x, r, d, rho_prev)
                ic += min(check_every, n_chunks - ic)
                r = true_residual(x)
                r2 = hdt(gsum(torch.sum(r * r)).item())
            done_chunks = ic

        # ---- one final reduction: residual and rhs norms ----
        r2b2 = gsum(torch.stack([torch.sum(r * r), torch.sum(bl * bl)])).cpu().numpy()
        return x, hdt(r2b2[0]), hdt(r2b2[1]), done_chunks

    def solve(b):
        x, r2, b2, done_chunks = local_fn(block_of(b, gmesh, dtype))
        resnorm, bnorm = float(np.sqrt(r2)), float(np.sqrt(b2))
        return x, SolveInfo(
            iters=1 + done_chunks * k_fuse, resnorm=resnorm, converged=resnorm <= tol * bnorm
        )

    return solve
