"""The JAX package's GSPMD entry points, on the port's one distributed mode.

`neptune_tpu/parallel/sharded.py` jits the whole-array executor with mesh
shardings and leaves the communication to XLA's partitioner. PyTorch has
no such partitioner, so the port runs the explicit halo exchange of
`sharded_apply` everywhere: `sharded_opdef` is `shardmap_opdef`, and
`sharded_function` runs a compiled function through a mesh view of the
executor (`_MeshModule`), each op on this process's blocks. Every executor
op that the JAX package's `sharded_function` runs, this one runs:

  * every `apply` of the function body takes the fused-strip route of
    `shardmap_opdef` (the main sweep at the block's global start, on
    kernel A's window form where `window_route` takes it; a strip exchange
    as deep as the apply's reach; the band fixups); an apply whose reach
    exceeds a block pads its inputs over several hops of the ring and runs
    on the extended blocks (`far_apply`); an apply with no field input is
    computed on the block at its global start, with no exchange;
  * every opdef call is `shardmap_opdef`'s matvec, with its forward- and
    reverse-mode derivative rule;
  * every `solve_linear` (and an un-lowered implicit-linear
    `time_advance`) runs `krylov.solve` (CG, GMRES, BiCGStab or Chebyshev,
    with its options) over that matvec with the group that shards the
    field, Jacobi's diagonal probed and CG's Dirichlet lift masked in
    global coordinates; kernel B's fused site is not taken (it solves a
    whole grid), as the JAX package's GSPMD path pins its jnp backend;
  * `precond="ssor"` is the red-black SSOR over the sharded matvec, its
    diagonal probed and its colours taken in global coordinates;
  * `precond="ssor_dense"` and `solver="direct"` assemble the whole
    operator's dense matrix on every process (the operator is the same
    program everywhere, so no communication; its handle keeps it), gather
    the vector they apply to, and keep this process's block (small grids
    only, as the JAX package's dense operators);
  * `precision="mixed"` refines in f64 over the sharded matvec with f32
    inner solves over the sharded matvec of the f32 twin, every norm
    reduced over the group;
  * `precond="mg"` builds `auto_mg_preconditioner` over the mesh: every
    level's matvec is `shardmap_opdef` of the coarsened module, and the
    V-cycle runs on blocks (`solvers.multigrid`), its hierarchy cached per
    solve site and mesh; from the first level whose block turns odd above
    the coarsest, the levels run on the whole grid, replicated on every
    process, where the JAX package's GSPMD reshards;
  * `solve_nonlinear` and implicit-nonlinear `time_advance` run
    `newton_krylov` (or `picard`) over the sharded residual with the
    mesh's group: J·v is `torch.func.jvp` through the sharded opdef's
    derivative rule, or the `jacobian=` opdef's sharded matvec;
  * reductions and bounded stores work in global coordinates; a bounded
    store between different bounds, whose blocks do not line up, gathers
    the stored temp (counted in `GridMesh.gathers`).

What the JAX package refuses, this refuses with the same kind of error: a
grid that the mesh does not split evenly (ValueError, as its shardings),
and an apply whose inputs and result differ in shape (ValueError; neither
package's whole-grid executor reads such inputs either).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..ir.core import Operation
from ..ir.types import TempType, TimeMethod
from ..lowering import cuda_backend, torch_backend
from ..lowering.executor import CompiledModule, _verbose, report_solve
from ..lowering.torch_backend import _block_index
from ..solvers import krylov
from ..solvers.precond import make_preconditioner
from ..utils.options import (
    linear_option_kwargs,
    merged_linear_options,
    split_precond_options,
)
from .mesh import GridMesh
from .sharded_apply import (
    _reach_fits,
    apply_reach,
    far_apply,
    fused_apply,
    shardmap_opdef,
    window_route,
)


def sharded_opdef(cm, name: str, gmesh: GridMesh) -> Callable:
    """An opdef's matvec over this process's blocks (for distributed
    Krylov solves: pass the mesh's group to the solver)."""
    return shardmap_opdef(cm, name, gmesh)


def _grid_rank(t) -> Optional[int]:
    """The rank of a grid-typed argument or result (None: a scalar)."""
    bounds = getattr(t, "bounds", None)
    if bounds is not None:
        return bounds.rank
    if hasattr(t, "shape"):
        return len(t.shape)
    return None


class _MeshModule(CompiledModule):
    """The executor over this process's blocks of a mesh (see the module
    docstring): the same module, backend and op walk, with the ops that
    read across blocks or reduce over the grid replaced."""

    def __init__(self, cm: CompiledModule, gmesh: GridMesh):
        super().__init__(cm.module, cm.backend, gmesh.device)
        self.gm = gmesh
        # the whole-grid view of the module, whose handles assemble and keep
        # the dense matrices
        self._whole = CompiledModule(cm.module, cm.backend, gmesh.device)

    # ---- geometry -------------------------------------------------------
    def _arg_shape(self, shape) -> tuple:
        self.gm.check_divisible(shape)
        return tuple(
            n // self.gm.shape[d] if d < len(self.gm.shape) else n for d, n in enumerate(shape)
        )

    def _names(self, rank: int) -> list:
        names = self.gm.axis_names
        return list(names[:rank]) + [None] * (rank - len(names))

    def _start(self, shape) -> list:
        """Global index of the block's cell 0, per dim."""
        return [
            self.gm.coords[d] * n if d < len(self.gm.shape) else 0 for d, n in enumerate(shape)
        ]

    _origin = _start

    def _inside(self, bounds, outer, shape, device) -> torch.Tensor:
        """Mask of the block's cells whose global logical coordinates lie in
        `bounds` (the block's values have logical bounds `outer`)."""
        mask = None
        for d, g in enumerate(self._start(shape)):
            iv = _block_index(shape, d, g + outer.lb[d], device)
            m = (iv >= bounds.lb[d]) & (iv < bounds.ub[d])
            mask = m if mask is None else mask & m
        return mask.expand(shape)

    # ---- ops ------------------------------------------------------------
    def opdef(self, name: str, differentiable: bool = False) -> Callable:
        if name not in self._opdef_cache:
            self._opdef_cache[name] = shardmap_opdef(self, name, self.gm, self.backend)
        return self._opdef_cache[name]

    def low_precision_opdef(self, name: str) -> Callable:
        """The sharded matvec of the opdef's float32 twin."""
        if self._lo_cm is None:
            from ..passes.retype import retype_module

            twin = CompiledModule(retype_module(self.module, "float32"), self.backend)
            self._lo_cm = _MeshModule(twin, self.gm)
        return self._lo_cm.opdef(name)

    def _execute_apply(self, op: Operation, operand_arrays):
        n_in = op.attrs.get("num_inputs", len(op.operands))
        outer = op.results[0].type.bounds
        inputs, scalars = list(operand_arrays[:n_in]), list(operand_arrays[n_in:])
        if any(v.type.bounds.shape != outer.shape for v in op.operands[:n_in]):
            raise ValueError(
                f"apply on {outer}: inputs of shapes "
                f"{[v.type.bounds.shape for v in op.operands[:n_in]]} differ from the result's "
                f"{outer.shape}; the executor reads inputs of the result's shape only"
            )
        names = self._names(outer.rank)
        shape = self._arg_shape(outer.shape)
        if n_in == 0:
            outs = self._no_input_apply(op, scalars, shape, names)
        else:
            need = apply_reach(op)
            fits = _reach_fits(need, outer, self.gm, names)
            route = fused_apply if fits else far_apply
            outs = route(op, inputs, scalars, need, names, self.gm, self.backend)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _no_input_apply(self, op: Operation, scalars, shape, names) -> list:
        """An apply with no field input, computed on the block at its global
        start: it reads no neighbour, so nothing is exchanged."""
        start = [s + lb for s, lb in zip(self._start(shape), op.results[0].type.bounds.lb)]
        if window_route(op, self.backend):
            res = cuda_backend.apply_window(op, [], scalars, start, shape=shape, device=self.device)
        else:
            wrap = tuple(bool(op.attrs.get("periodic")) and not nm for nm in names)
            res = torch_backend.execute_apply_window(
                op, [], scalars, start, wrap=wrap, shape=shape, device=self.device
            )
        return list(res) if isinstance(res, tuple) else [res]

    def _eval_op(self, op: Operation, env: dict, cells: dict):
        if op.name == "neptune.store" and op.attrs.get("bounds") is not None:
            temp = env[op.operands[0].uid]
            field = op.operands[1]
            ft, tt = field.type, op.operands[0].type
            cur = self._cell_of(field, env, cells)
            box = op.attrs["bounds"]
            if ft.bounds == tt.bounds:
                inside = self._inside(box, ft.bounds, tuple(cur.shape), cur.device)
                cells[field.uid] = torch.where(inside, temp.to(cur.dtype), cur)
            else:
                cells[field.uid] = self._gathered_store(temp, tt.bounds, cur, ft.bounds, box)
            return None
        if op.name == "neptune.reduce":
            env[op.results[0].uid] = self._reduce(op, env[op.operands[0].uid])
            return None
        return super()._eval_op(op, env, cells)

    def _gathered_store(self, temp, t_bounds, cur, f_bounds, box):
        """A bounded store whose temp and field blocks do not line up: the
        temp is gathered whole, and the field's block takes the box's cells
        that fall in it."""
        whole = self.gm.gather(temp)
        start = self._start(tuple(cur.shape))
        lo = [max(b, f + s) for b, f, s in zip(box.lb, f_bounds.lb, start)]
        hi = [min(b, f + s + n) for b, f, s, n in zip(box.ub, f_bounds.lb, start, cur.shape)]
        out = cur.clone()  # buffers are values: never write a caller's tensor
        if all(a < b for a, b in zip(lo, hi)):
            dst = tuple(slice(a - f - s, b - f - s) for a, b, f, s in zip(lo, hi, f_bounds.lb, start))
            src = tuple(slice(a - t, b - t) for a, b, t in zip(lo, hi, t_bounds.lb))
            out[dst] = whole[src].to(out.dtype)
        return out

    def _reduce(self, op: Operation, arr: torch.Tensor) -> torch.Tensor:
        """A reduce over the global grid: the block's partial, then one
        reduction over the processes that shard it."""
        tt: TempType = op.operands[0].type
        kind = op.attrs["kind"]
        bounds = op.attrs.get("bounds")
        inside = None
        if bounds is not None:
            inside = self._inside(bounds, tt.bounds, tuple(arr.shape), arr.device)
        if kind in ("max", "min"):
            fill = torch.finfo(arr.dtype).min if kind == "max" else torch.finfo(arr.dtype).max
            v = arr if inside is None else torch.where(inside, arr, torch.full_like(arr, fill))
            part = torch.max(v) if kind == "max" else torch.min(v)
            return self.gm.allreduce(part, tt.bounds.rank, op=kind)
        v = {"sum": arr, "l1": torch.abs(arr), "l2": arr * arr}[kind]
        if inside is not None:
            v = torch.where(inside, v, torch.zeros_like(v))
        total = self.gm.allreduce(torch.sum(v), tt.bounds.rank)
        return torch.sqrt(total) if kind == "l2" else total

    # ---- solves ---------------------------------------------------------
    def _solve_linear(self, op: Operation, env):
        handle = env[op.operands[0].uid]
        b = env[op.operands[1].uid]
        if op.attrs.get("precision", "full") == "mixed":
            return self.solve_mixed(
                handle, b, solver=op.attrs["solver"], tol=op.attrs["tol"],
                max_iters=op.attrs["max_iters"], precond=op.attrs.get("precond", "none"),
                options=op.attrs.get("options"), verbose=_verbose(op),
            )
        return self._mesh_solve(
            op, handle, b, op.attrs["solver"], op.attrs["tol"],
            op.attrs["max_iters"], op.attrs.get("precond", "none"), op.attrs.get("options"),
            lift=True, verbose=_verbose(op),
        )

    def _time_advance(self, op: Operation, env):
        method = TimeMethod(op.attrs["method"])
        if method == TimeMethod.IMPLICIT_LINEAR and op.attrs.get("precond") != "mg":
            # the base's direct interpretation: krylov.solve without the
            # lift (with "mg" the base raises, as the JAX package's does)
            return self._mesh_solve(
                op, self._handle_for(op.attrs["system"]), env[op.operands[0].uid],
                op.attrs["solver"], op.attrs["tol"], op.attrs["max_iters"],
                op.attrs.get("precond", "none"), op.attrs.get("options"), lift=False,
            )
        return super()._time_advance(op, env)

    def _reduction_group(self, states):
        t = states[0] if isinstance(states, (tuple, list)) else states
        return self.gm.mesh_group(t.ndim) if t.ndim else None

    def _on_whole(self, f: Callable, v: torch.Tensor) -> torch.Tensor:
        """f of the whole vector that `v` is this process's block of, cut
        back to this process's block."""
        whole = f(self.gm.gather(v))
        return whole[self.gm.block_slices(tuple(whole.shape))].contiguous()

    def _mesh_solve(self, op, handle, b, solver, tol, max_iters, precond, options, *, lift,
                    verbose=False):
        """krylov.solve over the handle's sharded matvec, reducing over the
        group that shards the field; the dense solves on the whole grid."""
        opts = merged_linear_options(options, solver)
        pc_opts = split_precond_options(opts, precond)
        rank = handle.temp_type.bounds.rank
        M = None
        if precond == "mg":
            M = self._mg_site(op, handle, b.device, pc_opts, gmesh=self.gm)
        elif precond == "ssor_dense":
            A = self._whole._handle_for(handle.symbol).dense(b.device)
            M_whole = make_preconditioner(precond, None, None, dense_matrix=A, **pc_opts)
            M = lambda r: self._on_whole(M_whole, r)  # noqa: E731
        elif precond not in (None, "none"):
            halo = handle.halo or tuple((1, 1) for _ in range(rank))
            M = make_preconditioner(
                precond, handle.matvec, torch.zeros_like(b), halo,
                origin=self._start(tuple(b.shape)), **pc_opts,
            )
        if solver == "direct":
            if opts:
                raise ValueError(f"solver='direct' takes no runtime options (got {sorted(opts)})")
            A = self._whole._handle_for(handle.symbol).dense(b.device)
            infos = []

            def lu(whole_b):
                x, info = krylov.direct(A, whole_b)
                infos.append(info)
                return x

            x, info = self._on_whole(lu, b), infos[0]
        else:
            # the Dirichlet lift of CG (MatrixHandle.ring_lift), masked in
            # global coordinates
            ring = None
            outer = handle.temp_type.bounds
            if lift and solver == "cg" and handle.interior is not None and handle.interior != outer:
                inside = self._inside(handle.interior, outer, tuple(b.shape), b.device)
                ring = torch.where(inside, torch.zeros_like(b), b)
            b_eff = b if ring is None else b - handle.matvec(ring)
            x, info = krylov.solve(
                handle.matvec, b_eff, solver=solver, tol=tol, maxiter=max_iters, M=M,
                group=self.gm.mesh_group(rank), **linear_option_kwargs(solver, opts),
            )
            if ring is not None:
                x = x + ring
        if verbose:
            report_solve(f"KSP({solver})", handle.symbol, info)
        return x


def sharded_function(
    cm: CompiledModule,
    name: str,
    gmesh: GridMesh,
    arg_ranks: Optional[Sequence[Optional[int]]] = None,
) -> Callable:
    """A compiled function over this process's blocks of the mesh.

    The returned callable takes this process's block of each grid argument
    (scalars: the same value on every process) and returns its blocks of
    the results; `gmesh.gather` assembles a whole array. arg_ranks: the
    rank of each grid argument (None entries: scalars), as the JAX
    package's; inferred from the signature when omitted, and refused when
    it differs from it (a grid argument is always a block here). The
    executor ops run as the module docstring says."""
    irfn = cm.module.lookup(name)
    ranks = [_grid_rank(a.type) for a in irfn.body.args]
    if arg_ranks is not None and [r or None for r in arg_ranks] != ranks:
        raise ValueError(
            f"sharded_function(@{name}): arg_ranks {list(arg_ranks)} differ from the "
            f"signature's {ranks}; every grid argument is a block of the mesh"
        )
    return _MeshModule(cm, gmesh).function(name)
