"""The JAX package's GSPMD entry points, on the port's one distributed mode.

`neptune_tpu/parallel/sharded.py` jits the whole-array executor with mesh
shardings and leaves the communication to XLA's partitioner. PyTorch has
no such partitioner, so the port runs the explicit halo exchange of
`sharded_apply` everywhere: `sharded_opdef` is `shardmap_opdef`, and
`sharded_function` runs a compiled function through a mesh view of the
executor (`_MeshModule`), each op on this process's blocks:

  * every `apply` of the function body takes the fused-strip route of
    `shardmap_opdef` (the main sweep at the block's global start, on
    kernel A's window form where `window_route` takes it; a strip exchange
    as deep as the apply's reach; the band fixups);
  * every opdef call is `shardmap_opdef`'s matvec;
  * every `solve_linear` (and an un-lowered implicit-linear
    `time_advance`) runs `krylov.solve` (CG, GMRES, BiCGStab or Chebyshev,
    with its options) over that matvec with the group that shards the
    field, Jacobi's diagonal probed and CG's Dirichlet lift masked in
    global coordinates; kernel B's fused site is not taken (it solves a
    whole grid), as the JAX package's GSPMD path pins its jnp backend;
  * `precond="mg"` builds `auto_mg_preconditioner` over the mesh: every
    level's matvec is `shardmap_opdef` of the coarsened module, and the
    V-cycle runs on blocks (`solvers.multigrid`), its hierarchy cached per
    solve site and mesh;
  * `solve_nonlinear` and implicit-nonlinear `time_advance` run
    `newton_krylov` (or `picard`) over the sharded residual with the
    mesh's group: J·v is `torch.func.jvp` through the sharded opdef's
    derivative rule, or the `jacobian=` opdef's sharded matvec;
  * reductions and bounded stores work in global coordinates.

An op this view cannot shard yet raises NotImplementedError naming it:
`precond="ssor"` and "ssor_dense", `solver="direct"`,
`precision="mixed"`, applies with no field input, applies whose inputs
and result differ in shape or whose reach exceeds a block, and bounded
stores between different bounds.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..ir.core import Operation
from ..ir.types import TempType, TimeMethod
from ..lowering.executor import CompiledModule, _verbose, report_solve
from ..lowering.torch_backend import _block_index
from ..solvers import krylov
from ..solvers.precond import extract_diagonal, safe_inv_diag
from ..utils.options import (
    linear_option_kwargs,
    merged_linear_options,
    split_precond_options,
)
from .mesh import GridMesh
from .sharded_apply import _reach_fits, apply_reach, fused_apply, shardmap_opdef


def sharded_opdef(cm, name: str, gmesh: GridMesh) -> Callable:
    """An opdef's matvec over this process's blocks (for distributed
    Krylov solves: pass the mesh's group to the solver)."""
    return shardmap_opdef(cm, name, gmesh)


def _refuse(what: str):
    raise NotImplementedError(
        f"sharded_function does not shard {what} yet: ROADMAP.md, queue 1, item 9"
    )


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

    def _execute_apply(self, op: Operation, operand_arrays):
        n_in = op.attrs.get("num_inputs", len(op.operands))
        outer = op.results[0].type.bounds
        if n_in == 0:
            _refuse("an apply with no field input")
        if any(v.type.bounds.shape != outer.shape for v in op.operands[:n_in]):
            _refuse("an apply whose inputs and result differ in shape")
        names = self._names(outer.rank)
        need = apply_reach(op)
        if not _reach_fits(need, outer, self.gm, names):
            _refuse("an apply whose reach exceeds a block")
        outs = fused_apply(
            op, list(operand_arrays[:n_in]), list(operand_arrays[n_in:]), need, names, self.gm,
            self.backend,
        )
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _eval_op(self, op: Operation, env: dict, cells: dict):
        if op.name == "neptune.store" and op.attrs.get("bounds") is not None:
            temp = env[op.operands[0].uid]
            field = op.operands[1]
            ft, tt = field.type, op.operands[0].type
            if ft.bounds != tt.bounds:
                _refuse("a bounded store between different bounds")
            cur = self._cell_of(field, env, cells)
            inside = self._inside(op.attrs["bounds"], ft.bounds, tuple(cur.shape), cur.device)
            cells[field.uid] = torch.where(inside, temp.to(cur.dtype), cur)
            return None
        if op.name == "neptune.reduce":
            env[op.results[0].uid] = self._reduce(op, env[op.operands[0].uid])
            return None
        return super()._eval_op(op, env, cells)

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
        if op.attrs.get("precision", "full") == "mixed":
            _refuse('solve_linear with precision="mixed"')
        return self._mesh_solve(
            op, handle, env[op.operands[1].uid], op.attrs["solver"], op.attrs["tol"],
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
        return self.gm.sum_group(t.ndim) if t.ndim else None

    def _mesh_solve(self, op, handle, b, solver, tol, max_iters, precond, options, *, lift,
                    verbose=False):
        """krylov.solve over the handle's sharded matvec, reducing over the
        group that shards the field."""
        if solver not in ("cg", "gmres", "bicgstab", "chebyshev"):
            _refuse(f'solve_linear with solver="{solver}"')
        if precond not in (None, "none", "jacobi", "mg"):
            _refuse(f'solve_linear with precond="{precond}"')
        opts = merged_linear_options(options, solver)
        pc_opts = split_precond_options(opts, precond)
        rank = handle.temp_type.bounds.rank
        M = None
        if precond == "mg":
            M = self._mg_site(op, handle, b.device, pc_opts, gmesh=self.gm)
        elif precond == "jacobi":
            halo = handle.halo or tuple((1, 1) for _ in range(rank))
            diag = extract_diagonal(
                handle.matvec, torch.zeros_like(b), halo, origin=self._start(tuple(b.shape))
            )
            inv = safe_inv_diag(diag)
            M = lambda r: r * inv  # noqa: E731
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
            group=self.gm.sum_group(rank), **linear_option_kwargs(solver, opts),
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
    it differs from it (a grid argument is always a block here). Ops this
    view cannot shard raise NotImplementedError when they run (see the
    module docstring)."""
    irfn = cm.module.lookup(name)
    ranks = [_grid_rank(a.type) for a in irfn.body.args]
    if arg_ranks is not None and [r or None for r in arg_ranks] != ranks:
        raise ValueError(
            f"sharded_function(@{name}): arg_ranks {list(arg_ranks)} differ from the "
            f"signature's {ranks}; every grid argument is a block of the mesh"
        )
    return _MeshModule(cm, gmesh).function(name)
