"""Shared per-process machinery for the s-step CA-Krylov solvers.

The port of `neptune_tpu/parallel/ca_common.py`. `ca_cg`, `ca_gmres` and
`ca_bicgstab` run the same choreography per outer block: exchange K-deep
strips of their carried fields ONCE, build basis chains with the
matrix-powers kernel (zero-ghost on the core, trapezoid band replay at the
edges -- the machinery of `sharded_apply`), reduce ONE Gram matrix, and
iterate in coefficient space. This module holds the solver-independent
parts:

  * the split-preconditioned operator Ã = S A S (S = sqrt(inv_diag)),
  * monomial/chebyshev basis chains,
  * `basis_with_replay`: strip exchange + core chains + band replays for
    any (carried fields, chain lengths) combination; the r-chain is always
    seeded from the TRUE residual b̃ - Ã x (residual replacement),
  * `gram`: the Gram matrix of a basis, reduced once and read on the host,
  * `true_rr`: the honest final-report matvec (one extra exchange), and
  * `gsum`: a sum over exactly the processes that shard the field.

Where the JAX package runs one `shard_map` body with `lax.while_loop`s,
a solve here is a function of this process's blocks and a Python loop.
The coefficient space (the s inner iterations, the small dense factors)
runs on the host in NumPy, in the field's dtype: the Gram matrix is read
once per outer block, which is also where the convergence test reads it,
and nothing is read more often. The core-block matvec of every chain goes
to kernel A's window form where `sharded_apply.window_route` takes the op
(bounded, `cuda_backend.supported`, a kernel backend); the band replays
and torus ops run eagerly. `CompiledModule(module, "torch")` gives the
same solver with the kernels off.

`ca_chebyshev` keeps its own body: it replays a three-field recurrence,
not seed chains.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ir.types import TempType
from ..lowering import cuda_backend, torch_backend
from ..solvers.krylov import SolveInfo, full_precision
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
    window_route,
)


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32-exact matmul for the Gram matrices and the recombinations on the
    device: TF32 off whatever the caller set (the H100's twin of the TPU's
    bf16 matrix-unit passes, which stalled the recurrences there). The
    host's NumPy products are exact already."""
    with full_precision():
        return a @ b


def host_dtype(dtype: torch.dtype):
    """The NumPy dtype of the coefficient space: the field's."""
    return {torch.float64: np.float64, torch.float32: np.float32}[dtype]


class SolverPlan(NamedTuple):
    """Everything the CA solver frontends share: validated opdef geometry,
    the fused-exchange plan, and the per-block matvecs."""

    rank: int
    names: list
    need: list
    outer: object
    dtype: torch.dtype
    periodic: bool
    theta: float
    delta: float
    matvec_block: Callable  # eager (u, bases, shape) -> A u over any block
    core_mv: Callable  # (u, gstart) -> A u over this process's core block
    gmesh: GridMesh


def core_matvec(op, scalar_vals, names, backend: str) -> Callable:
    """The zero-ghost matvec of a core block at its global start: kernel
    A's window form on `window_route`, the eager apply otherwise."""
    eager = _block_apply(op, names, scalar_vals)
    if not window_route(op, backend):
        return lambda u, gstart: eager(u, gstart, u.shape)
    return lambda u, gstart: cuda_backend.apply_window(op, [u], scalar_vals, gstart)


def plan_ca_solver(
    cm, name, gmesh, *, s, kdepth, kdepth_desc, solver, basis, lam_min, lam_max,
):
    """Shared frontend for the CA-Krylov trio: validate the opdef (unary,
    single-result, single-apply), check basis arguments, run `_fused_plan`
    at the solver's chain depth, and build the per-block matvecs.

    kdepth: how many times the basis chains apply Ã per exchange (CG: s,
    GMRES: s+1, BiCGStab: 2s+1); kdepth_desc names it in the eligibility
    error."""
    if s < 1:
        raise ValueError("s must be >= 1")
    if basis not in ("monomial", "chebyshev"):
        raise ValueError(f"unknown basis {basis!r}")
    if basis == "chebyshev" and (lam_min is None or lam_max is None):
        raise ValueError("basis='chebyshev' needs lam_min and lam_max")
    fn = cm.module.lookup(name)
    tt: TempType = fn.ftype.inputs[0]
    rank = tt.bounds.rank
    if len(fn.ftype.inputs) != 1 or len(fn.ftype.results) != 1:
        raise ValueError(f"{solver} needs a unary, single-result opdef")
    op = _single_apply(fn)
    if op is None:
        raise ValueError(f"{solver} needs a single-apply opdef body")
    names = list(gmesh.axis_names[:rank]) + [None] * (rank - len(gmesh.axis_names))
    plan = _fused_plan(fn, op, gmesh, names, sweeps_k=kdepth)
    if plan is None:
        raise ValueError(
            f"@{name} is not eligible at s={s} "
            f"(non-constant scalars, or {kdepth_desc}*reach exceeds a shard)"
        )
    need, scalar_vals, _ret_index, _arg_order = plan

    out_type: TempType = op.results[0].type
    if basis == "chebyshev":
        theta = 0.5 * (float(lam_max) + float(lam_min))
        delta = 0.5 * (float(lam_max) - float(lam_min))
    else:
        theta = delta = 0.0
    return SolverPlan(
        rank=rank,
        names=names,
        need=need,
        outer=out_type.bounds,
        dtype=torch_backend.DTYPES[out_type.element],
        periodic=bool(op.attrs.get("periodic")),
        theta=theta,
        delta=delta,
        matvec_block=_block_apply(op, names, scalar_vals),
        core_mv=core_matvec(op, scalar_vals, names, cm.backend),
        gmesh=gmesh,
    )


def block_of(a, gmesh: GridMesh, dtype: torch.dtype) -> torch.Tensor:
    """This process's block of a field (a tensor or a NumPy array) on the
    mesh's device, in the operator's dtype."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device=gmesh.device, dtype=dtype)


def run_ca_solver(local_fn, sp: SolverPlan, inv_diag) -> Callable:
    """Shared solve tail: `solve(b_block) -> (x_block, SolveInfo)` around
    `local_fn(b_block, inv_diag_block) -> (x, rr, it, target2)` (host
    values)."""
    idl = None if inv_diag is None else block_of(inv_diag, sp.gmesh, sp.dtype)

    def solve(b):
        x, rr, it, target2 = local_fn(block_of(b, sp.gmesh, sp.dtype), idl)
        info = SolveInfo(
            iters=int(it), resnorm=float(np.sqrt(rr)), converged=bool(rr <= target2)
        )
        return x, info

    return solve


class MatrixPowers:
    """Per-process state + operations for one CA solve."""

    def __init__(self, sp: SolverPlan, *, basis, need_k, bl, sl):
        self.sp = sp
        self.gm = sp.gmesh
        self.names = sp.names
        self.rank = sp.rank
        self.dtype = sp.dtype
        self.hdt = host_dtype(sp.dtype)
        self.periodic = sp.periodic
        self.basis = basis
        self.theta = sp.theta
        self.delta = sp.delta
        self.need_k = need_k
        self.need_1 = sp.need
        self.matvec_block = sp.matvec_block
        self.nloc = tuple(bl.shape)
        self.gstart = _gstart(self.nloc, self.rank, self.names, sp.outer, self.gm)
        # split-preconditioner S and b̃ = S b; their strips are
        # iteration-constant: exchanged ONCE here, outside any solver loop
        self.S_loc = None if sl is None else torch.sqrt(sl.to(self.dtype))
        self.btl = bl.to(self.dtype) if self.S_loc is None else self.S_loc * bl
        cfields = [self.btl] if self.S_loc is None else [self.btl, self.S_loc]
        self.c_strips, self.c_ext, _ = _strip_exchange(
            cfields, self.nloc, self.rank, self.names, need_k, self.periodic, self.gm
        )

    # ---- operator and chains -------------------------------------------
    def core(self, u):
        """A u over the core block (kernel A's window form on its route)."""
        return self.sp.core_mv(u, self.gstart)

    def band_mv(self, zone):
        """A u over one replay band (eager)."""
        return lambda u: self.matvec_block(u, zone.bases, u.shape)

    def Amv(self, v, S_blk, mv):
        """Ã v = S * A(S * v) (S=None: plain A); mv applies A."""
        u = v if S_blk is None else S_blk * v
        w = mv(u)
        return w if S_blk is None else S_blk * w

    def chain(self, seed, length, S_blk, mv):
        """[v, Ãv, ...] (monomial) or the shifted Chebyshev chain."""
        vs = [seed]
        for j in range(length - 1):
            Av = self.Amv(vs[-1], S_blk, mv)
            if self.basis == "monomial":
                vs.append(Av)
            elif j == 0:
                vs.append((Av - self.theta * vs[-1]) / self.delta)
            else:
                vs.append(2.0 * (Av - self.theta * vs[-1]) / self.delta - vs[-2])
        return vs

    def _band_consts(self, zone):
        """Stitched (b̃, S) bands for a replay zone."""
        bbt = _stitch_band(
            self.c_ext, self.c_strips, 0, zone.d, zone.side, zone.lo_n, zone.hi_n, self.nloc
        ).to(self.dtype)
        bS = (
            _stitch_band(
                self.c_ext, self.c_strips, 1, zone.d, zone.side, zone.lo_n, zone.hi_n, self.nloc
            ).to(self.dtype)
            if self.S_loc is not None
            else None
        )
        return bbt, bS

    def basis_with_replay(self, fields, lengths):
        """The matrix-powers kernel: ONE strip exchange of `fields`
        (fields[0] must be x), core chains, trapezoid band replays.

        lengths = (len_seed1, ..., len_r): one chain per carried seed
        field fields[1:], in order, followed by the r-chain seeded from
        the TRUE residual b̃ - Ã·fields[0]. Returns the 'sum(lengths)'
        basis vectors, boundary-exact.
        """

        def chains_on(blk_fields, bbt, bS, mv):
            out = []
            for seed, L in zip(blk_fields[1:], lengths[:-1]):
                out += self.chain(seed, L, bS, mv)
            r0 = bbt - self.Amv(blk_fields[0], bS, mv)
            out += self.chain(r0, lengths[-1], bS, mv)
            return out

        strips, ext_slice, sharded_dims = _strip_exchange(
            fields, self.nloc, self.rank, self.names, self.need_k, self.periodic, self.gm
        )
        # the band fixups write in place: a seed vector is a carried field
        V = [_owned(v, fields) for v in chains_on(fields, self.btl, self.S_loc, self.core)]

        def replay(bands, zone):
            bf = [bb.to(self.dtype) for bb in bands]
            bbt, bS = self._band_consts(zone)
            return chains_on(bf, bbt, bS, self.band_mv(zone))

        return _run_band_fixups(
            V, len(fields), strips, ext_slice, sharded_dims, self.need_k, self.nloc,
            self.rank, self.gstart, replay,
        )

    # ---- reductions and honest reporting --------------------------------
    def gsum(self, v: torch.Tensor) -> torch.Tensor:
        """A sum over exactly the processes that shard this field (extra
        mesh axes hold replicas; summing them would inflate the norms)."""
        return self.gm.allreduce(v, self.rank)

    def host_sum(self, v: torch.Tensor):
        """gsum of sum(v), read on the host in the field's dtype."""
        return self.hdt(self.gsum(torch.sum(v)).item())

    def gram(self, vectors):
        """(stacked flat basis, its Gram matrix on the host): one matmul,
        one reduction, one read."""
        Vs = torch.stack([v.reshape(-1) for v in vectors])
        G = self.gsum(_mm(Vs, Vs.T))
        return Vs, G.cpu().numpy().astype(self.hdt, copy=False)

    def combine(self, coefs, Vs, shape):
        """Fields sum_i coefs[k][i] V_i for each row k of the host array
        `coefs` (one f32-exact product)."""
        c = torch.from_numpy(np.ascontiguousarray(coefs, dtype=self.hdt)).to(Vs.device)
        out = _mm(c, Vs)
        return [row.reshape(shape) for row in out]

    def true_rr(self, x):
        """||b̃ - Ã x||² with a fresh exchange + band fixup -- the honest
        final report (coefficient-space estimates bottom out at
        ~sqrt(eps); see the solver docstrings).

        One matvec needs only 1x-reach ghosts, so the exchange here is
        1-deep. Exchanging w = S·x (not x) makes the band replay a pure
        stencil apply: r = b̃ - S·(A w), so the subtraction and both S
        multiplies act on core rows only."""
        w = x if self.S_loc is None else self.S_loc * x
        ts, te, td = _strip_exchange(
            [w], self.nloc, self.rank, self.names, self.need_1, self.periodic, self.gm
        )
        u_main = _owned(self.core(w), [w])

        def rreplay(bands, zone):
            bw = bands[0].to(self.dtype)
            return [self.matvec_block(bw, zone.bases, bw.shape)]

        (uf,) = _run_band_fixups(
            [u_main], 1, ts, te, td, self.need_1, self.nloc, self.rank, self.gstart, rreplay
        )
        rf = self.btl - (uf if self.S_loc is None else self.S_loc * uf)
        return self.host_sum(rf * rf)
