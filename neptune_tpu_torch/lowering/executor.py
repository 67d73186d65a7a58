"""Module executor: runs Neptune IR functions as PyTorch callables.

The port of `neptune_tpu/lowering/executor.py`:

  * opdefs become cached callables, shared between structurally identical
    opdefs through the verifier's structure-key hash;
  * solver ops dispatch into `neptune_tpu_torch.solvers`;
  * field buffer semantics (wrap/load/store/unwrap) run against a per-call
    storage-cell environment.

Each apply goes to kernel A (`cuda_backend`) where `cuda_backend.supported`
holds and to the eager path otherwise. A composite opdef that
`chain.chain_plan` takes runs as one launch of kernel D; `sweeps` runs an
operator that `sweeps.sweep_plan` takes as launches of kernel C. CG solves
route to kernel B (`solvers.fused`) under exactly the conditions the JAX
package routes them to its fused TPU kernel. Every route is chosen by plan,
before any launch and whatever the device, so both packages take the same
routes; only the kernel wrappers look at the device, and each runs its plain
version for CPU tensors and launches its kernel, or raises, for CUDA ones.

`device=None` keeps tensors where the caller put them and puts NumPy
inputs, and applies that have no tensor input, on `config.device` (the
card by default; asking for CUDA where there is none raises); a device
given here receives every input. Nothing moves work to another device on
its own.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import config, default_device
from ..ir.core import Function, Module, Operation
from ..ir.types import Bounds, FieldType, ScalarType, TempType, TensorType, TimeMethod
from ..solvers import fused, krylov
from ..solvers.assemble import MatrixHandle
from ..solvers.precond import make_preconditioner, safe_inv_diag
from ..utils.options import (
    linear_option_kwargs,
    merged_linear_options,
    split_precond_options,
)
from . import chain, cuda_backend, sweeps, torch_backend

_BACKENDS = ("auto", "torch", "cuda")


def _roadmap(what: str, where: str):
    return NotImplementedError(
        f"{what} is not ported to neptune_tpu_torch yet: ROADMAP.md, {where}"
    )


def _verbose(op: Operation) -> bool:
    return bool(op.attrs.get("verbose"))


class CompiledModule:
    """Executable view of a verified module."""

    def __init__(self, module: Module, backend: Optional[str] = None, device=None):
        self.module = module
        self.backend = backend or config.backend
        if self.backend not in _BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}; options: {_BACKENDS}")
        self.device = None if device is None else torch.device(device)
        self._opdef_cache: dict[str, Callable] = {}
        self._structure_cache: dict[int, Callable] = {}
        self._fn_cache: dict[str, Callable] = {}
        # (id(solve_linear op), matrix symbol) -> fused solve site or None
        self._fused_sites: dict = {}

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------

    def opdef(self, name: str, differentiable: bool = False) -> Callable:
        """Callable for a linear/nonlinear opdef: (*tensors) -> tensor(s)."""
        if differentiable:
            raise _roadmap(
                "opdef(differentiable=True), the custom-JVP wrapper", "queue 1, item 7"
            )
        if name not in self._opdef_cache:
            fn = self.module.lookup(name)
            if not fn.is_opdef:
                raise ValueError(f"@{name} is not an opdef")
            skey = fn.attrs.get("structure_key_hash")
            if skey is not None and skey in self._structure_cache:
                self._opdef_cache[name] = self._structure_cache[skey]
            else:
                cb = None
                if self.backend in ("auto", "cuda"):
                    cb = self.chain_callable(name)
                if cb is None:
                    cb = self._make_callable(fn)
                self._opdef_cache[name] = cb
                if skey is not None:
                    self._structure_cache[skey] = cb
        return self._opdef_cache[name]

    def function(self, name: str) -> Callable:
        """Callable for a plain function."""
        if name not in self._fn_cache:
            self._fn_cache[name] = self._make_callable(self.module.lookup(name))
        return self._fn_cache[name]

    def sweeps(self, name: str, k: int) -> Callable:
        """x -> opdef @name applied k times (fixed-point / smoother sweeps).

        As `neptune_tpu`'s: an operator that `sweeps.sweep_plan` takes runs
        k // depth launches of kernel C, `depth` sweeps each, then the
        leftover sweeps as single applies; any other operator runs k single
        applies. On CPU tensors kernel C's plain version runs instead.
        """
        fn = self.module.lookup(name)
        if not fn.is_opdef:
            raise ValueError(f"@{name} is not an opdef")
        n_temps = sum(1 for t in fn.ftype.inputs if isinstance(t, TempType))
        if n_temps != 1 or len(fn.ftype.results) != 1:
            raise ValueError(
                f"sweeps(@{name}): repeated application needs a unary "
                f"operator (one temp in, one temp out); got {n_temps} "
                f"inputs, {len(fn.ftype.results)} results"
            )
        one = self.opdef(name)
        n_scalars = len(fn.ftype.inputs) - 1
        plan = None
        if self.backend in ("auto", "cuda"):
            plan = sweeps.sweep_plan(self.module, name, k)
        n_full, rem = divmod(k, plan.depth) if plan is not None else (0, k)

        def run(x, *scalars):
            if len(scalars) != n_scalars:
                raise TypeError(f"sweeps(@{name}) expects {n_scalars} scalars, got {len(scalars)}")
            u = self._tensor(x, torch_backend.DTYPES[fn.ftype.inputs[0].element])
            for _ in range(n_full):
                u = sweeps.run_sweeps(plan, u, scalars)
            for _ in range(rem):
                u = one(u, *scalars)
            return u

        run.__name__ = f"neptune_sweeps_{name}"
        return run

    def chain_callable(self, name: str) -> Optional[Callable]:
        """Composite opdef @name as one launch of kernel D, or None when
        `chain.chain_plan` refuses it (the opdef then runs stage at a time)."""
        plan = chain.chain_plan(self.module, name)
        if plan is None:
            return None
        args_in = self.module.lookup(name).body.args
        n_args = plan.n_fields + plan.n_scalars

        def run(*args):
            if len(args) != n_args:
                raise TypeError(f"@{name} expects {n_args} args, got {len(args)}")
            fields = []
            for barg, a in zip(args_in[: plan.n_fields], args):
                a = self._tensor(a, torch.float32)
                if tuple(a.shape) != plan.outer.shape:
                    raise TypeError(
                        f"@{name} arg {barg.name_hint}: shape {tuple(a.shape)} != "
                        f"declared {barg.type}"
                    )
                fields.append(a)
            scalars = [
                torch_backend.scalar_tensor(a, barg.type)
                for barg, a in zip(args_in[plan.n_fields :], args[plan.n_fields :])
            ]
            return chain.run_chain(plan, fields, scalars)

        run.__name__ = f"neptune_chain_{name}"
        return run

    def low_precision_opdef(self, name: str) -> Callable:
        raise _roadmap("low_precision_opdef (passes/retype)", "queue 1, item 2")

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a), device=default_device(self.device))
        return a.to(device=a.device if self.device is None else self.device, dtype=dtype)

    def _make_callable(self, fn: Function) -> Callable:
        def run(*args):
            if len(args) != len(fn.body.args):
                raise TypeError(
                    f"@{fn.name} expects {len(fn.body.args)} args, got {len(args)}"
                )
            env: dict[int, object] = {}
            cells: dict[int, torch.Tensor] = {}
            for barg, a in zip(fn.body.args, args):
                t = barg.type
                if isinstance(t, (TensorType, TempType)):
                    a = self._tensor(a, torch_backend.DTYPES[t.element])
                    want = t.bounds.shape if isinstance(t, TempType) else t.shape
                    if tuple(a.shape) != tuple(want):
                        raise TypeError(
                            f"@{fn.name} arg {barg.name_hint}: shape {tuple(a.shape)} != "
                            f"declared {t}"
                        )
                    env[barg.uid] = a
                elif isinstance(t, FieldType):
                    a = self._tensor(a, torch_backend.DTYPES[t.element])
                    env[barg.uid] = a
                    cells[barg.uid] = a
                elif isinstance(t, ScalarType):
                    env[barg.uid] = torch_backend.scalar_tensor(a, t)
                else:
                    env[barg.uid] = a
            outs = self._run_block(fn, env, cells)
            if outs is None:
                return None
            return outs[0] if len(outs) == 1 else tuple(outs)

        run.__name__ = f"neptune_{fn.name}"
        return run

    def _run_block(self, fn: Function, env: dict, cells: dict):
        result = None
        for op in fn.body.ops:
            result = self._eval_op(op, env, cells)
        return result

    def _eval_op(self, op: Operation, env: dict, cells: dict):
        """Evaluate one field-level op; returns terminator values if any."""
        name = op.name
        get = lambda v: env[v.uid]  # noqa: E731

        if name == "neptune.wrap":
            arr = get(op.operands[0])
            env[op.results[0].uid] = arr
            cells[op.results[0].uid] = arr
        elif name in ("neptune.unwrap", "neptune.load"):
            env[op.results[0].uid] = self._cell_of(op.operands[0], env, cells)
        elif name == "neptune.store":
            temp = get(op.operands[0])
            field = op.operands[1]
            cur = self._cell_of(field, env, cells)
            bounds: Optional[Bounds] = op.attrs.get("bounds")
            if bounds is not None:
                ft: FieldType = field.type
                tt: TempType = op.operands[0].type
                cur = cur.clone()  # buffers are values: never write a caller's tensor
                cur[bounds.rel_slices(ft.bounds)] = temp[bounds.rel_slices(tt.bounds)].to(cur.dtype)
            else:
                cur = temp.to(cur.dtype)
            cells[field.uid] = cur
        elif name == "neptune.as_tensor":
            env[op.results[0].uid] = get(op.operands[0])
        elif name == "neptune.from_tensor":
            env[op.results[0].uid] = get(op.operands[0]).to(
                torch_backend.DTYPES[op.results[0].type.element]
            )
        elif name == "neptune.apply":
            out = self._execute_apply(op, [get(o) for o in op.operands])
            if len(op.results) == 1:
                env[op.results[0].uid] = out
            else:
                for r, v in zip(op.results, out):
                    env[r.uid] = v
        elif name == "neptune.reduce":
            env[op.results[0].uid] = torch_backend.execute_reduce(op, get(op.operands[0]))
        elif name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
            outs = self.opdef(op.attrs["symbol"])(*[get(o) for o in op.operands])
            if len(op.results) == 1:
                env[op.results[0].uid] = outs
            else:
                for r, o in zip(op.results, outs):
                    env[r.uid] = o
        elif name == "neptune.assemble_matrix":
            env[op.results[0].uid] = self._assemble(op)
        elif name == "neptune.solve_linear":
            env[op.results[0].uid] = self._solve_linear(op, env)
        elif name == "neptune.solve_nonlinear":
            self._solve_nonlinear(op, env)
        elif name == "neptune.time_advance":
            env[op.results[0].uid] = self._time_advance(op, env)
        elif name == "neptune.time_advance_runtime":
            env[op.results[0].uid] = self._time_advance_runtime(op, env)
        elif name in ("neptune.return", "neptune.yield"):
            # field-typed operands return their *current* buffer contents
            return [
                self._cell_of(o, env, cells) if isinstance(o.type, FieldType) else get(o)
                for o in op.operands
            ]
        elif name == "arith.constant":
            env[op.results[0].uid] = torch.tensor(
                op.attrs["value"], dtype=torch_backend.scalar_dtype(op.results[0].type)
            )
        elif name in torch_backend._BINOPS:
            env[op.results[0].uid] = torch_backend._BINOPS[name](
                get(op.operands[0]), get(op.operands[1])
            )
        elif name in torch_backend._UNARY:
            env[op.results[0].uid] = torch_backend._UNARY[name](get(op.operands[0]))
        elif name == "arith.cmp":
            env[op.results[0].uid] = torch_backend._CMPS[op.attrs["pred"]](
                get(op.operands[0]), get(op.operands[1])
            )
        elif name == "arith.select":
            c, a, bb = (get(o) for o in op.operands)
            env[op.results[0].uid] = torch.where(c, a, bb)
        elif name == "arith.cast":
            env[op.results[0].uid] = get(op.operands[0]).to(
                torch_backend.scalar_dtype(op.results[0].type)
            )
        else:
            raise NotImplementedError(f"executor: unhandled op {name}")
        return None

    # ------------------------------------------------------------------
    # op implementations
    # ------------------------------------------------------------------

    def _cell_of(self, field_value, env, cells):
        if field_value.uid in cells:
            return cells[field_value.uid]
        return env[field_value.uid]

    def _execute_apply(self, op: Operation, operand_arrays: Sequence):
        # an apply with no tensor input is placed like a NumPy input
        device = self.device if op.attrs.get("num_inputs", len(op.operands)) else (
            default_device(self.device))
        if self.backend in ("cuda", "auto"):
            result = cuda_backend.try_execute_apply(op, operand_arrays, device)
            if result is not None:
                return result
            if self.backend == "cuda":
                raise NotImplementedError(
                    f"cuda backend cannot lower apply with bounds "
                    f"{op.attrs['bounds']} (rank/dtype unsupported)"
                )
        return torch_backend.execute_apply(op, operand_arrays, device)

    def _handle_for(self, sym: str) -> MatrixHandle:
        fn = self.module.lookup(sym)
        return MatrixHandle(
            symbol=sym,
            matvec=self.opdef(sym),
            temp_type=fn.ftype.inputs[0],
            structure_key_hash=fn.attrs.get("structure_key_hash", 0),
            halo=fn.attrs.get("halo", ()),
            interior=single_apply_interior(fn),
        )

    def _assemble(self, op: Operation) -> MatrixHandle:
        return self._handle_for(op.attrs["symbol"])

    def _solve_linear(self, op: Operation, env):
        handle: MatrixHandle = env[op.operands[0].uid]
        b = env[op.operands[1].uid]
        if not isinstance(handle, MatrixHandle):
            raise TypeError("solve_linear operand 0 must be an assembled matrix handle")
        solver = op.attrs["solver"]
        tol = op.attrs["tol"]
        max_iters = op.attrs["max_iters"]
        precond = op.attrs.get("precond", "none")
        opts = merged_linear_options(op.attrs.get("options"), solver)
        pc_opts = split_precond_options(opts, precond)
        if op.attrs.get("precision", "full") == "mixed":
            raise _roadmap("solve_linear(precision='mixed')", "queue 1, item 7")
        key = (id(op), handle.symbol)
        if key not in self._fused_sites:
            self._fused_sites[key] = self._fused_site(
                handle, solver, opts, precond, tol, max_iters, b
            )
        solve_k = self._fused_sites[key]
        if solve_k is not None:
            x, iters, rn = solve_k(b)
            if _verbose(op):
                print(
                    f"[neptune] KSP(cg/fused) {handle.symbol}: iters={int(iters)} "
                    f"resnorm={float(rn):.3e}"
                )
            return x

        if precond == "mg" or pc_opts:
            raise _roadmap(
                f"precond={precond!r} with options {sorted(pc_opts)}", "queue 1, items 4 and 7"
            )
        M = None
        if precond not in (None, "none"):
            like = torch.zeros(handle.grid_shape, dtype=handle.dtype, device=b.device)
            M = make_preconditioner(precond, handle.matvec, like, handle.halo)
        if solver == "direct":
            raise _roadmap("solver='direct'", "queue 1, item 4")
        kw = linear_option_kwargs(solver, opts)
        # Dirichlet lift (CG only): nonzero copy-through ring data in b breaks
        # CG's M-symmetry under non-uniform preconditioners; see
        # MatrixHandle.ring_lift. GMRES/BiCGStab handle the ring natively.
        lift = handle.ring_lift(b) if solver == "cg" else None
        b_eff = b if lift is None else b - handle.matvec(lift)
        x, info = krylov.solve(
            handle.matvec, b_eff, solver=solver, tol=tol, maxiter=max_iters, M=M, **kw
        )
        if lift is not None:
            x = x + lift
        if _verbose(op):
            print(
                f"[neptune] KSP({solver}) {handle.symbol}: iters={info.iters} "
                f"resnorm={info.resnorm:.3e} converged={info.converged}"
            )
        return x

    def _fused_site(self, handle, solver, opts, precond, tol, max_iters, b):
        """The whole-CG kernel's solve site for one solve_linear op, or
        None: under the JAX package's own conditions (per-solve options such
        as atol/divtol/restart are honored only by the generic path).
        Decided, planned and (for Jacobi) given its inverse diagonal once;
        the site builds and allocates on each device at its first solve
        there."""
        if not (
            solver == "cg"
            and not opts
            and precond in (None, "none", "jacobi")
            and self.backend in ("auto", "cuda")
            and fused.supported(self.module, handle.symbol, handle.temp_type)
        ):
            return None
        inv_diag = None
        if precond == "jacobi":
            inv_diag = safe_inv_diag(handle.diagonal(b.device))
        return fused.fused_cg(
            self.module, handle.symbol, tol=tol, maxiter=max_iters, inv_diag=inv_diag
        )

    def _solve_nonlinear(self, op: Operation, env):
        raise _roadmap("solve_nonlinear (Newton-Krylov, Picard)", "queue 1, item 7")

    def _time_advance(self, op: Operation, env):
        """Direct interpretation of time_advance. Normally the high-level pass
        rewrites this op away first; interpreting it keeps un-lowered modules
        executable."""
        state = env[op.operands[0].uid]
        dt = env[op.operands[1].uid]
        method = TimeMethod(op.attrs["method"])
        if method == TimeMethod.EXPLICIT:
            return self._explicit_step(op, state, dt)
        if method == TimeMethod.IMPLICIT_LINEAR:
            handle = self._handle_for(op.attrs["system"])
            M = None
            precond = op.attrs.get("precond", "none")
            if precond not in (None, "none"):
                like = torch.zeros(handle.grid_shape, dtype=handle.dtype, device=state.device)
                M = make_preconditioner(precond, handle.matvec, like, handle.halo)
            kw = linear_option_kwargs(
                op.attrs["solver"],
                merged_linear_options(op.attrs.get("options"), op.attrs["solver"]),
            )
            x, info = krylov.solve(
                handle.matvec,
                state,
                solver=op.attrs["solver"],
                tol=op.attrs["tol"],
                maxiter=op.attrs["max_iters"],
                M=M,
                **kw,
            )
            return x
        if method == TimeMethod.IMPLICIT_NONLINEAR:
            raise _roadmap("time_advance(method=implicit_nonlinear)", "queue 1, item 7")
        raise NotImplementedError(
            "time_advance with method=runtime must be lowered by the "
            "high-level pass to time_advance_runtime first"
        )

    def _explicit_step(self, op: Operation, state, dt):
        rhs = self.opdef(op.attrs["rhs"])
        scheme = op.attrs.get("scheme", "euler")
        if scheme == "euler":
            return state + dt * rhs(state)
        if scheme == "rk2":
            k1 = rhs(state)
            k2 = rhs(state + dt * k1)
            return state + 0.5 * dt * (k1 + k2)
        if scheme == "rk4":
            k1 = rhs(state)
            k2 = rhs(state + 0.5 * dt * k1)
            k3 = rhs(state + 0.5 * dt * k2)
            k4 = rhs(state + dt * k3)
            return state + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        raise ValueError(f"unknown explicit scheme {scheme!r}")

    def _time_advance_runtime(self, op: Operation, env):
        """Branch on the runtime method code, the reference *runtime*
        convention: 0 = pass-through, 1 = copy, 2 = forward Euler (these
        differ from the IR TimeMethod enum)."""
        state = env[op.operands[0].uid]
        dt = env[op.operands[1].uid]
        method = min(max(int(env[op.operands[2].uid]), 0), 2)
        if method == 0:
            return state
        if method == 1:
            return state + 0.0
        rhs_sym = op.attrs.get("rhs")
        k = self.opdef(rhs_sym)(state) if rhs_sym else torch.zeros_like(state)
        return state + dt * k


def single_apply_interior(fn: Function):
    """The apply bounds of a unary single-apply opdef whose copy-through
    seed is the opdef argument — the structure MatrixHandle.ring_lift
    needs ((A z)_ring = z_ring exactly). None for anything else."""
    ap = None
    for op in fn.body.ops:
        if op.name == "neptune.apply":
            if ap is not None:
                return None
            ap = op
        elif op.name not in ("neptune.return", "arith.constant"):
            return None
    if ap is None or not fn.body.args:
        return None
    if not ap.operands or ap.operands[0].uid != fn.body.args[0].uid:
        return None
    return ap.attrs.get("bounds")
