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

Differentiation: the kernels are ctypes launches that autograd cannot see,
so on the kernel backends every opdef call that may be differentiated goes
through a `torch.autograd.Function` (`_OpdefRule`) whose forward runs the
kernel route and whose tangent and cotangent come from `torch.func.jvp` / `torch.func.vjp` of the same opdef on
an eager view of the module (`_torch_view`), the twin of the JAX package's
`custom_jvp` over its jnp lowering. Newton's J·v, `differentiable_solve`
and `differentiable_root` differentiate opdefs through it.

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
import torch._C._functorch as _functorch
from torch.autograd import forward_ad

from ..config import config, default_device
from ..ir.core import Function, Module, Operation
from ..ir.types import Bounds, FieldType, ScalarType, TempType, TensorType, TimeMethod
from ..kernels.build import LaunchCounter
from ..solvers import fused, krylov
from ..solvers.assemble import MatrixHandle, single_apply_interior
from ..solvers.newton import newton_krylov, picard
from ..solvers.precond import make_preconditioner, safe_inv_diag
from ..utils.options import (
    linear_option_kwargs,
    merged_linear_options,
    merged_nonlinear_options,
    nonlinear_option_kwargs,
    split_precond_options,
)
from ..utils.profiling import report_solve, span, verbose_default
from . import chain, cuda_backend, sweeps, torch_backend

_BACKENDS = ("auto", "torch", "cuda")

# tangents and cotangents taken through `_OpdefRule`
rule_counter = LaunchCounter("opdef_rule")


def _verbose(op: Operation) -> bool:
    """Whether a solve op prints its convergence line: its `verbose`
    attribute, or NEPTUNE_TORCH_VERBOSE=1 for every solve."""
    return bool(op.attrs.get("verbose")) or verbose_default()


class _OpdefRule(torch.autograd.Function):
    """The derivative rule of a kernel-routed opdef: `apply(rule, *args)`.

    The forward runs the kernel route (`rule.route`), which autograd cannot
    see through. The tangent (`jvp`, taken by `torch.func.jvp` and forward
    AD) and the cotangent (`backward`, taken by `torch.autograd.grad` and
    `torch.func.vjp`) are the rule's (`rule.jvp`, `rule.vjp`): those of the
    same opdef on the module's eager view, and over a mesh those of its
    evaluation on the halo-padded blocks (`parallel.sharded_apply._MeshRule`),
    with respect to the tensor arguments; scalars and other non-tensor
    arguments pass through with no tangent. Under
    `torch.func.vmap` (dense assembly) the kernel route runs once per
    slice of the batch."""

    @staticmethod
    def forward(rule, *args):
        return rule.route(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        rule, *args = inputs
        ctx.rule = rule
        ctx.is_tensor = [isinstance(a, torch.Tensor) for a in args]
        ctx.others = [None if t else a for a, t in zip(args, ctx.is_tensor)]
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        ctx.save_for_backward(*tensors)
        ctx.save_for_forward(*tensors)

    @staticmethod
    def _args(ctx) -> list:
        saved = iter(ctx.saved_tensors)
        return [next(saved) if t else o for t, o in zip(ctx.is_tensor, ctx.others)]

    @staticmethod
    def _partial(view, args, slots):
        """view as a function of the arguments at `slots` alone."""

        def f(*xs):
            full = list(args)
            for i, x in zip(slots, xs):
                full[i] = x
            return view(*full)

        return f

    @staticmethod
    def jvp(ctx, _rule_tangent, *tangents):
        rule_counter.count += 1
        return ctx.rule.jvp(_OpdefRule._args(ctx), tangents)

    @staticmethod
    def vmap(info, in_dims, rule, *args):
        # the kernels take one field at a time: one launch per slice
        outs = [
            rule.route(*(a if d is None else a.select(d, i) for a, d in zip(args, in_dims[1:])))
            for i in range(info.batch_size)
        ]
        if isinstance(outs[0], torch.Tensor):
            return torch.stack(outs), 0
        return tuple(torch.stack(o) for o in zip(*outs)), (0,) * len(outs[0])

    @staticmethod
    def backward(ctx, *grads):
        rule_counter.count += 1
        args = _OpdefRule._args(ctx)
        slots = [i for i, t in enumerate(ctx.is_tensor) if t and ctx.needs_input_grad[i + 1]]
        cots = ctx.rule.vjp(args, slots, grads[0] if len(grads) == 1 else tuple(grads))
        out = [None] * (1 + len(args))
        for i, c in zip(slots, cots):
            out[i + 1] = c
        return tuple(out)


class _Rule:
    """What `_OpdefRule` needs of one opdef: its kernel route, its eager
    view looked up at each use (the view's callables are cached), and the
    tangent and cotangent taken from that view."""

    def __init__(self, cm: "CompiledModule", name: str, route: Callable):
        self.cm, self.name, self.route = cm, name, route

    def view(self) -> Callable:
        return self.cm._torch_view().opdef(self.name)

    def jvp(self, args: list, tangents: Sequence):
        """The tangent of the outputs: `torch.func.jvp` of the eager view
        in the tensor arguments that carry a tangent."""
        slots = [
            i for i, t in enumerate(tangents)
            if t is not None and isinstance(args[i], torch.Tensor)
        ]
        f = _OpdefRule._partial(self.view(), args, slots)
        _, out_t = torch.func.jvp(
            f, tuple(args[i] for i in slots), tuple(tangents[i] for i in slots)
        )
        return out_t

    def vjp(self, args: list, slots: list, cotangent):
        """The cotangents of the arguments at `slots`: `torch.func.vjp` of
        the eager view."""
        f = _OpdefRule._partial(self.view(), args, slots)
        _, pull = torch.func.vjp(f, *(args[i] for i in slots))
        return pull(cotangent)


def rule_callable(rule, name: str) -> Callable:
    """`rule.route` as a callable that goes through `_OpdefRule` when its
    result may be differentiated (`CompiledModule._differentiating`) and
    straight to the route otherwise, without the Function's host time
    (tens of microseconds per call)."""
    symbol = getattr(rule, "name", name)

    def run(*args):
        with span("nt.run", symbol=symbol):
            if CompiledModule._differentiating(args):
                return _OpdefRule.apply(rule, *args)
            return rule.route(*args)

    run.__name__ = name
    return run


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
        # matrix symbol -> its handle, which keeps its dense matrix
        self._handles: dict[str, MatrixHandle] = {}
        # (id(solve_linear op), matrix symbol) -> fused solve site or None
        self._fused_sites: dict = {}
        # (id(solve_linear op), matrix symbol, device) -> precond="mg"'s M
        self._mg_sites: dict = {}
        self._lo_cm: Optional["CompiledModule"] = None
        self._torch_cm: Optional["CompiledModule"] = None

    # ------------------------------------------------------------------
    # public entry points
    # ------------------------------------------------------------------

    def opdef(self, name: str, differentiable: bool = False) -> Callable:
        """Callable for a linear/nonlinear opdef: (*tensors) -> tensor(s).

        On the kernel backends ("auto", "cuda") the callable carries
        `_OpdefRule`, whatever the device and whether or not its applies
        reach a kernel, as the JAX package attaches its `custom_jvp` to
        every opdef while its kernels are live: `torch.func.jvp`,
        `torch.func.vjp` and `torch.autograd.grad` through a plain `opdef()`
        call (the JFNK residual of `solvers/newton.py`) take the tangent
        from the eager view. A call that nothing can differentiate runs
        the kernel route directly. `differentiable=True` returns the eager
        view's callable outright (no kernel primal at all)."""
        if differentiable:
            return self._torch_view().opdef(name)
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
                if self.backend in ("auto", "cuda"):
                    cb = self._with_rule(name, cb)
                self._opdef_cache[name] = cb
                if skey is not None:
                    self._structure_cache[skey] = cb
        return self._opdef_cache[name]

    def colour_form(self, name: str) -> Callable:
        """A symgs colour pass (`passes.smoother.colour_pass`) in place:
        (x, b, d, c) -> x, x's cells of colour c relaxed in x itself, x a
        tensor of the pass's type that the caller owns. Kernel A's colour
        form (`cuda_backend.apply_colour`) where the backend runs kernels,
        kernel A has one and x is on the card; otherwise the plain version,
        the out-of-place pass `opdef(name)` written into x at those cells.
        Calling `opdef(name)` stays the out-of-place pass."""
        from ..passes.smoother import MARK, PARITY

        fn = self.module.lookup(name)
        (op,) = [op for op in fn.body.ops if op.name == "neptune.apply"]
        if list(op.operands) != list(fn.body.args) or op.attrs.get(MARK) != PARITY:
            raise ValueError(f"@{name} is not a colour pass (passes.smoother.colour_pass)")
        n_in = op.attrs.get("num_inputs", len(op.operands))
        kernel = self.backend in ("auto", "cuda") and cuda_backend.colour_form(op)
        whole = self.opdef(name)

        def run(x, *args):
            with span("nt.run", symbol=name):
                if kernel and x.device.type == "cuda":
                    return cuda_backend.apply_colour(op, x, args[:n_in - 1], args[n_in - 1:])
                cells = cuda_backend.colour_slices(op, args[-1])
                x[cells] = whole(x, *args)[cells]
                return x

        run.__name__ = f"neptune_colour_{name}"
        return run

    def _torch_view(self) -> "CompiledModule":
        """A backend="torch" view of this module on the same device, with
        its own caches: the eager lowering that differentiates opdefs."""
        if self.backend == "torch":
            return self
        if self._torch_cm is None:
            self._torch_cm = CompiledModule(self.module, "torch", self.device)
        return self._torch_cm

    @staticmethod
    def _differentiating(args) -> bool:
        """Whether values computed from `args` may be differentiated: a
        `torch.func` transform (vmap included) or a forward-AD level is
        active, or grad mode is on and an argument requires grad. Reads
        torch internals; test_rule_is_what_differentiates and the GPU
        test_rule_on_the_card fail if a torch release changes them."""
        if _functorch.maybe_current_level() is not None or forward_ad._current_level >= 0:
            return True
        return torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args
        )

    def _with_rule(self, name: str, cb: Callable) -> Callable:
        return rule_callable(_Rule(self, name, cb), getattr(cb, "__name__", f"neptune_{name}"))

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
            with span("nt.run", symbol=name):
                if len(scalars) != n_scalars:
                    raise TypeError(
                        f"sweeps(@{name}) expects {n_scalars} scalars, got {len(scalars)}")
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
            with span("nt.run", symbol=name):
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
        """float32 twin of an opdef (for mixed-precision refinement): a
        module of its own on the same backend and device, whose applies
        take kernel A in float32."""
        if self._lo_cm is None:
            from ..passes.retype import retype_module

            self._lo_cm = CompiledModule(
                retype_module(self.module, "float32"), self.backend, self.device
            )
        return self._lo_cm.opdef(name)

    # ------------------------------------------------------------------
    # evaluation
    # ------------------------------------------------------------------

    def _tensor(self, a, dtype: torch.dtype) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a), device=default_device(self.device))
        return a.to(device=a.device if self.device is None else self.device, dtype=dtype)

    def _arg_shape(self, shape) -> tuple:
        """The shape a grid argument of declared `shape` takes (a block of
        it in the mesh view of `parallel.sharded_function`)."""
        return tuple(shape)

    def _make_callable(self, fn: Function) -> Callable:
        def run(*args):
            with span("nt.run", symbol=fn.name):
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
                        want = self._arg_shape(
                            t.bounds.shape if isinstance(t, TempType) else t.shape)
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
        if sym not in self._handles:
            fn = self.module.lookup(sym)
            self._handles[sym] = MatrixHandle(
                symbol=sym,
                matvec=self.opdef(sym),
                temp_type=fn.ftype.inputs[0],
                structure_key_hash=fn.attrs.get("structure_key_hash", 0),
                halo=fn.attrs.get("halo", ()),
                interior=single_apply_interior(fn),
            )
        return self._handles[sym]

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
            return self.solve_mixed(
                handle, b, solver=solver, tol=tol, max_iters=max_iters, precond=precond,
                options=op.attrs.get("options"), verbose=_verbose(op),
            )
        with span("nt.solve", solver=solver, precond=precond) as s:
            key = (id(op), handle.symbol)
            if key not in self._fused_sites:
                self._fused_sites[key] = self._fused_site(
                    handle, solver, opts, precond, tol, max_iters, b
                )
            solve_k = self._fused_sites[key]
            if solve_k is not None:
                x, iters, rn = solve_k(b)
                s.set(route="fused", iters=iters, lift=int(solve_k.lift is not None))
                if _verbose(op):
                    print(
                        f"[neptune] KSP(cg/fused) {handle.symbol}: iters={int(iters)} "
                        f"resnorm={float(rn):.3e}"
                    )
                return x

            M = None
            if precond == "mg":
                M = self._mg_site(op, handle, b.device, pc_opts)
            elif precond not in (None, "none"):
                like = torch.zeros(handle.grid_shape, dtype=handle.dtype, device=b.device)
                dense = handle.dense(b.device) if precond == "ssor_dense" else None
                M = make_preconditioner(
                    precond, handle.matvec, like, handle.halo, dense_matrix=dense, **pc_opts
                )
            if solver == "direct":
                if opts:
                    raise ValueError(
                        f"solver='direct' takes no runtime options (got {sorted(opts)})")
                x, info = krylov.direct(handle.dense(b.device), b)
                s.set(route="direct")
            else:
                s.set(route="generic")
                kw = linear_option_kwargs(solver, opts)
                # Dirichlet lift (CG only): nonzero copy-through ring data in b
                # breaks CG's M-symmetry under non-uniform preconditioners; see
                # MatrixHandle.ring_lift. GMRES/BiCGStab handle the ring natively.
                lift = handle.ring_lift(b) if solver == "cg" else None
                b_eff = b if lift is None else b - handle.matvec(lift)
                x, info = krylov.solve(
                    handle.matvec, b_eff, solver=solver, tol=tol, maxiter=max_iters, M=M, **kw
                )
                if lift is not None:
                    x = x + lift
            s.set(iters=info.iters)
            if _verbose(op):
                report_solve(f"KSP({solver})", handle.symbol, info)
            return x

    def _mg_site(self, op: Operation, handle: MatrixHandle, device, pc_opts: dict, gmesh=None):
        """precond="mg"'s M for one solve site: the hierarchy (coarsened
        modules, probes, power iterations) is built once per solve site,
        device and mesh (None: the whole grid)."""
        key = (id(op), handle.symbol, device, gmesh)
        if key not in self._mg_sites:
            self._mg_sites[key] = auto_mg_preconditioner(
                self.module, handle, self.backend, device=device, gmesh=gmesh, **pc_opts
            )
        return self._mg_sites[key]

    def _reduction_group(self, states):
        """The process group that the norms of `states` (a tensor or a tuple
        of them) reduce over: none on the whole grid."""
        return None

    def _origin(self, shape):
        """The global index of cell 0 of a grid value of this shape, per dim:
        None (0) on the whole grid, a block's start in the mesh view."""
        return None

    def solve_mixed(self, handle: MatrixHandle, b, *, solver: str, tol: float,
                    max_iters: int, precond: str, options=None, verbose: bool = False):
        """precision="mixed": f32 inner Krylov solves on the operator's f32
        twin, f64 residuals (`solvers.refine`), with the JAX executor's
        refusals. The executor's and the eager DSL's solve_linear both come
        here."""
        if options:
            raise ValueError(
                "precision='mixed' does not support per-solve options; "
                "drop options= or use precision='full'"
            )
        if precond in ("ssor_dense", "mg"):
            raise ValueError(
                f"precision='mixed' does not support precond={precond!r}; "
                "use 'jacobi', 'ssor' (matrix-free) or 'none'"
            )
        if solver == "direct":
            raise ValueError(
                "precision='mixed' does not support solver='direct' "
                "(dense LU has no refinement loop); use a Krylov solver"
            )
        from ..solvers.refine import refined_solve

        lo = self.low_precision_opdef(handle.symbol)
        M_lo = None
        if precond not in (None, "none"):
            like32 = torch.zeros(b.shape, dtype=torch.float32, device=b.device)
            M_lo = make_preconditioner(
                precond, lo, like32, handle.halo, origin=self._origin(tuple(b.shape))
            )
        with span("nt.solve", solver=solver, precond=precond, route="mixed") as s:
            x, info = refined_solve(
                handle.matvec, lo, b, solver=solver, tol=tol, inner_iters=max_iters,
                M_lo=M_lo, group=self._reduction_group(b),
            )
            s.set(iters=info.inner_iters)
        if verbose:
            print(
                f"[neptune] KSP({solver}/mixed) {handle.symbol}: rounds={info.rounds} "
                f"inner={info.inner_iters} resnorm={info.resnorm:.3e} "
                f"converged={info.converged}"
            )
        return x

    def _fused_site(self, handle, solver, opts, precond, tol, max_iters, b):
        """The whole-CG kernel's solve site for one solve_linear op, or
        None: under the JAX package's own conditions (per-solve options such
        as atol/divtol/restart are honored only by the generic path).
        Decided, planned and (for Jacobi) given its inverse diagonal once;
        the site builds and allocates on each device at its first solve
        there. It lifts the copy-through ring where the generic route's
        `ring_lift` would (`fused.ring_of`), in the kernel's prologue."""
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

    def _jac_mv(self, jac_sym: Optional[str], n_state: int, captures: tuple):
        """The user's linearization `jacobian=` as newton_krylov's
        `(u, v) -> J(u) v`, or None. The builder verified its signature:
        either (v...) constant-J or (v..., u..., captures...)."""
        if jac_sym is None:
            return None
        jac_fn = self.opdef(jac_sym)
        n_jac_in = len(self.module.lookup(jac_sym).ftype.inputs)

        def jac_mv(u, v):
            args = tuple(v) if n_jac_in == n_state else tuple(v) + tuple(u) + captures
            out = jac_fn(*args)
            return out if isinstance(out, tuple) else (out,)

        return jac_mv

    def _solve_nonlinear(self, op: Operation, env):
        sym = op.attrs["residual"]
        n_state = op.attrs["num_states"]
        residual_fn = self.opdef(sym)
        states0 = tuple(env[o.uid] for o in op.operands[:n_state])
        captures = tuple(env[o.uid] for o in op.operands[n_state:])

        def residual(states):
            out = residual_fn(*states, *captures)
            return out if isinstance(out, tuple) else (out,)

        jac_mv = self._jac_mv(op.attrs.get("jacobian"), n_state, captures)
        method = op.attrs["method"]
        okw = nonlinear_option_kwargs(
            "picard" if method == "picard" else "newton",
            merged_nonlinear_options(op.attrs.get("options"), method),
        )
        group = self._reduction_group(states0)
        if method in ("newton", "newton-krylov"):
            x, info = newton_krylov(
                residual,
                states0,
                tol=op.attrs["tol"],
                max_iters=op.attrs["max_iters"],
                krylov_tol=op.attrs.get("krylov_tol", 1e-6),
                krylov_iters=op.attrs.get("krylov_iters", 200),
                jac_mv=jac_mv,
                group=group,
                **okw,
            )
        elif method == "picard":
            x, info = picard(
                residual, states0, tol=op.attrs["tol"], max_iters=op.attrs["max_iters"],
                group=group, **okw,
            )
        else:
            raise ValueError(f"unknown nonlinear method {method!r}")
        if _verbose(op):
            report_solve(f"SNES({method})", sym, info)
        for r, v in zip(op.results, x):
            env[r.uid] = v

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
            res_fn = self.opdef(op.attrs["residual"])

            def residual(states):
                return (res_fn(states[0], state),)

            # jacobian= and options= as on the lowered solve_nonlinear path:
            # the interpreter solves with the same Newton as the module after
            # the high-level pass
            okw = nonlinear_option_kwargs(
                "newton", merged_nonlinear_options(op.attrs.get("options"), "newton")
            )
            x, _ = newton_krylov(
                residual,
                (state,),
                tol=op.attrs["tol"],
                max_iters=op.attrs["max_iters"],
                jac_mv=self._jac_mv(op.attrs.get("jacobian"), 1, (state,)),
                group=self._reduction_group(state),
                **okw,
            )
            return x[0]
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


class _CoarseOp:
    """What build_levels needs of a coarse level: a scaled matvec, the halo
    for probing its diagonal, the mesh it runs over (None: the whole grid),
    and its grid where that is not half the finer one (None)."""

    def __init__(self, matvec, halo, gmesh=None, level_shape=None):
        self.matvec = matvec
        self.halo = halo
        self.gmesh = gmesh
        self.level_shape = level_shape

    def __call__(self, x):
        return self.matvec(x)


def auto_mg_preconditioner(
    module: Module,
    handle: MatrixHandle,
    backend: Optional[str] = None,
    *,
    mg_levels: Optional[int] = None,
    mg_smoother: str = "jacobi",
    mg_coarsen: str = "cell",
    mg_coarse_sweeps: int = 32,
    device=None,
    gmesh=None,
):
    """Geometric-MG preconditioner for `solve_linear(..., precond="mg")`.

    The coarse hierarchy is built by 2:1 re-instantiation of the user's
    opdef (`passes.coarsen.coarsen_opdef`), each level a `CompiledModule` of
    its own on `backend` and `device` (so on the card every level's matvec
    is a kernel-A launch), damped by 1/4 per level after the launch: the
    exact rediscretization of a second-order (1/h²-scaled or h²-absorbed)
    operator. Other operator orders pass an explicit hierarchy to
    `solvers.multigrid.mg_preconditioner` instead.

    mg_levels: total level count including the finest (default: coarsen
    while every extent stays even and the smallest stays >= 16, at most 6
    levels). mg_smoother: "jacobi", "cheb" or "symgs" (all symmetric, as
    CG requires; "symgs" builds each level's colour pass from its opdef,
    `passes.smoother.colour_pass`, run in place, `CompiledModule.
    colour_form`, and needs the operator unscaled).
    mg_coarsen: "cell" (the grid halves; mean restriction, multilinear
    interpolation, each level damped by 1/4) or "vertex" (HPCG's hierarchy:
    the interior box halves and the ring stays, the extents counted are the
    box's; injection transfers, the coarse operators unscaled).
    mg_coarse_sweeps: smoothing sweeps on the coarsest level; one sweep
    before and one after on the others. HPCG's cycle is mg_levels=4,
    "symgs", "vertex", mg_coarse_sweeps=1. `device` holds the levels'
    tensors (default `config.device`).

    gmesh: a `parallel.GridMesh` whose blocks the solve runs on (the
    handle's matvec is then the mesh's sharded opdef): each coarse level
    is `parallel.shardmap_opdef` of its coarsened module, and M takes and
    returns this process's blocks. The level count follows the global
    grid. From the first level whose block turns odd above the coarsest
    (`solvers.multigrid.first_whole_level`) every level is `opdef` of its
    module on the whole grid, replicated on every process: the restricted
    residual is gathered once on the way down, and each process takes its
    block of the correction on the way up. Where the finest block is odd
    already, M gathers r, runs a whole-grid cycle and returns its block.
    HPCG's options ("symgs", "vertex") run on the whole grid only.
    """
    from ..passes.coarsen import coarsen_opdef
    from ..passes.smoother import SUFFIX, colour_pass
    from ..solvers.multigrid import first_whole_level, mg_preconditioner

    shape = handle.grid_shape
    extents = shape
    if mg_coarsen == "vertex":
        if handle.interior is None:
            raise ValueError("mg_coarsen='vertex' needs a single-apply opdef (its ring is kept)")
        extents = handle.interior.shape
    if mg_levels is None:
        mg_levels = 1
        while (
            mg_levels < 6
            and all(s % (2**mg_levels) == 0 for s in extents)
            and min(extents) // (2**mg_levels) >= 16
        ):
            mg_levels += 1
    if mg_levels < 2:
        raise ValueError(
            f"precond='mg' needs at least 2 levels (grid {shape} with "
            f"mg_levels={mg_levels}; extents must be even and >= 32 to "
            "coarsen, or pass mg_levels explicitly)"
        )
    if gmesh is not None and (mg_smoother == "symgs" or mg_coarsen == "vertex"):
        raise ValueError("mg_smoother='symgs' and mg_coarsen='vertex' run on the whole grid "
                         "only (no mesh)")
    if mg_smoother == "symgs" and mg_coarsen != "vertex":
        raise ValueError("mg_smoother='symgs' builds its colour passes from unscaled coarse "
                         "operators: it needs mg_coarsen='vertex'")
    # levels below `sharded` run on the mesh's blocks, the rest whole
    sharded = 0
    if gmesh is not None:
        gmesh.check_divisible(shape)
        sharded = first_whole_level(shape, gmesh, mg_levels)
    ops: list = [handle]
    if gmesh is not None and sharded == 0:
        whole = CompiledModule(module, backend, device).opdef(handle.symbol)
        ops = [_CoarseOp(whole, handle.halo)]
    colour_ops = None
    if mg_smoother == "symgs":
        colour_ops = [CompiledModule(colour_pass(module, handle.symbol), backend, device)
                      .colour_form(handle.symbol + SUFFIX)]
    mod = module
    for lvl in range(1, mg_levels):
        mod = coarsen_opdef(mod, handle.symbol, mode=mg_coarsen)
        cm = CompiledModule(mod, backend, device)
        if lvl >= sharded:
            mv, mesh = cm.opdef(handle.symbol), None
        else:
            from ..parallel.sharded_apply import shardmap_opdef

            mv, mesh = shardmap_opdef(cm, handle.symbol, gmesh, cm.backend), gmesh
        if mg_coarsen == "vertex":
            grid = mod.lookup(handle.symbol).ftype.inputs[0].bounds.shape
            ops.append(_CoarseOp(mv, handle.halo, mesh, grid))
        else:
            scale = 0.25**lvl  # rediscretization damping (see the docstring)
            ops.append(_CoarseOp(lambda x, f=mv, s=scale: s * f(x), handle.halo, mesh))
        if colour_ops is not None:
            colour_ops.append(CompiledModule(colour_pass(mod, handle.symbol), backend, device)
                              .colour_form(handle.symbol + SUFFIX))
    if sharded > 0:
        shape = tuple(
            n // gmesh.shape[d] if d < len(gmesh.shape) else n for d, n in enumerate(shape)
        )
    like = torch.zeros(shape, dtype=handle.dtype, device=default_device(device))
    M = mg_preconditioner(ops, like, smoother=mg_smoother, coarse_iters=mg_coarse_sweeps,
                          transfer="injection" if mg_coarsen == "vertex" else "mean",
                          colour_ops=colour_ops)
    if gmesh is None or sharded > 0:
        return M

    def M_gathered(r):
        e = M(gmesh.gather(r))
        return e[gmesh.block_slices(tuple(e.shape))].contiguous()

    return M_gathered


def compile_module(module: Module, backend: Optional[str] = None, device=None) -> CompiledModule:
    return CompiledModule(module, backend, device)
