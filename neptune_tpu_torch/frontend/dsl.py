"""User-facing DSL: decorators and solver directives.

The port of `neptune_tpu/frontend/dsl.py`, with the same names, signatures
and errors. Every directive is dual-mode (see `frontend.core`): it emits IR
while a function is being traced, and otherwise runs at once on the port's
`CompiledModule`. Eager calls take torch tensors, which stay on their device,
or anything `np.asarray` takes, which goes to `config.device` (the card by
default; `NEPTUNE_TORCH_DEVICE=cpu` or `config.device = "cpu"` asks for the
CPU, and asking for CUDA where there is none raises).

`solve_nonlinear` and `time_advance(method="implicit_nonlinear")` run
Newton–Krylov or Picard (`solvers.newton`); `solve_linear` takes
`precision="mixed"` (`solvers.refine`), `solver="direct"` and
`"chebyshev"`, and `precond="ssor"`/`"ssor_dense"`/`"mg"` (the executor's
`auto_mg_preconditioner`, built once per operator structure, grid and MG
options in the context).
"""

from __future__ import annotations

import inspect
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..config import config, default_device
from ..ir.types import Bounds, Location, TempType, TimeMethod
from ..lowering.executor import auto_mg_preconditioner, report_solve
from ..lowering.torch_backend import DTYPES
from ..solvers import krylov
from ..solvers.assemble import MatrixHandle, single_apply_interior
from ..solvers.newton import newton_krylov, picard
from ..solvers.precond import make_preconditioner
from ..utils.profiling import span, verbose_default
from ..utils.options import (
    LINEAR_OPTION_KEYS,
    NONLINEAR_OPTION_KEYS,
    linear_option_kwargs,
    merged_linear_options,
    merged_nonlinear_options,
    nonlinear_option_kwargs,
    parse_options,
    split_precond_options,
)
from . import expr as E
from .core import get_context
from .trace import emit_apply_inline, fresh_kernel_name, trace_kernel_into_opdef

Expr = E.Expr


# ---------------------------------------------------------------------------
# operator definition handles
# ---------------------------------------------------------------------------


class OpDef:
    """Handle to a traced operator symbol. Stringifies to its symbol name
    (the reference decorator returns the bare name); calling it applies the
    operator (eagerly on tensors, as IR when tracing)."""

    def __init__(self, name: str, kind: str, captures=()):
        self.name = name
        self.kind = kind
        # lexical temp captures appended to the traced signature
        # (trace_kernel_into_opdef); calling the handle supplies them
        self.captures = tuple(captures)

    def __str__(self):
        return self.name

    def __repr__(self):
        return f"<neptune {self.kind} @{self.name}>"

    @property
    def function(self):
        return get_context().module.lookup(self.name)

    @property
    def halo(self):
        # annotations land on the verified clone inside the compiled
        # snapshot (run_pipeline clones), not on the module being traced
        cm = get_context().compiled()
        return cm.module.lookup(self.name).attrs.get("halo", ())

    def _capture_args(self, eager: bool):
        out = []
        for leaf in self.captures:
            if eager:
                if leaf.concrete is None:
                    raise TypeError(
                        f"@{self.name} captured a symbolic temp with no "
                        "concrete value; pass it as a kernel argument"
                    )
                out.append(leaf.concrete)
            else:
                if getattr(leaf, "ir_value", None) is None:
                    raise TypeError(
                        f"@{self.name} captured a temp with no traced IR "
                        "value; pass it as a kernel argument"
                    )
                out.append(leaf.ir_value)
        return out

    def __call__(self, *args):
        ctx = get_context()
        if ctx.tracing and all(
            isinstance(a, Expr) and getattr(a.node, "ir_value", None) is not None
            for a in args
        ):
            b = ctx.builder
            vals = [a.node.ir_value for a in args] + self._capture_args(eager=False)
            if self.kind == "linear_opdef":
                out = b.apply_linear(self.name, vals)
            else:
                out = b.apply_nonlinear(self.name, vals)
            if isinstance(out, tuple):
                return tuple(Expr(E.TempLeaf(o.type, ir_value=o)) for o in out)
            return Expr(E.TempLeaf(out.type, ir_value=out))
        with span("nt.call", symbol=self.name):
            arrays = [_concrete_array(a) for a in args] + self._capture_args(eager=True)
            return ctx.compiled().opdef(self.name)(*arrays)

    def matvec(self, x):
        """Eager matrix-free application (linear opdefs)."""
        return get_context().compiled().opdef(self.name)(x)


def _sym_name(op) -> str:
    if isinstance(op, OpDef):
        return op.name
    if isinstance(op, str):
        return op
    raise TypeError(f"expected an opdef or symbol name, got {type(op)}")


def _concrete_array(x):
    if isinstance(x, Expr):
        n = x.node
        if isinstance(n, E.TempLeaf) and n.concrete is not None:
            return n.concrete
        raise TypeError("expected a concrete array, got a traced expression")
    return np.asarray(x) if not hasattr(x, "dtype") else x


def _as_tensor(x) -> torch.Tensor:
    """A tensor stays where it is; anything else goes to `config.device`."""
    if isinstance(x, torch.Tensor):
        return x
    # np.require, not np.ascontiguousarray, which makes a 0-d array 1-d
    return torch.from_numpy(np.require(np.asarray(x), requirements="C")).to(default_device())


def _element(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _dtype_name(dtype) -> str:
    if dtype is None:
        return config.default_dtype
    if isinstance(dtype, torch.dtype):
        return _element(dtype)
    if isinstance(dtype, str) and dtype in DTYPES:
        return dtype
    return np.dtype(dtype).name


# ---------------------------------------------------------------------------
# temps from arrays (eager sources)
# ---------------------------------------------------------------------------


def _dedupe_opdef(ctx, fn) -> str:
    """If a structurally identical opdef already exists, drop `fn` and reuse
    the existing symbol (avoids per-call module growth and pipeline re-runs
    in eager stepping loops); bumps the context only when the module
    changed."""
    from ..ir.verify import _structure_key

    key = _structure_key(fn)
    for other in ctx.module.functions.values():
        if other is fn or not other.is_opdef:
            continue
        if other.kind == fn.kind and other.ftype == fn.ftype and _structure_key(other) == key:
            del ctx.module.functions[fn.name]
            return other.name
    ctx.bump()
    return fn.name


def temp(array, lb: Optional[Sequence[int]] = None, location: str = "cell") -> Expr:
    """Wrap a concrete array as a temp Expr usable in kernels/closures."""
    arr = _as_tensor(array)
    rank = arr.dim()
    lb = tuple(lb) if lb is not None else (0,) * rank
    ub = tuple(lo + s for lo, s in zip(lb, arr.shape))
    tt = TempType(_element(arr.dtype), Bounds.of(lb, ub), Location(location))
    return Expr(E.TempLeaf(tt, concrete=arr))


# ---------------------------------------------------------------------------
# opdef decorators
# ---------------------------------------------------------------------------


def _opdef_decorator(
    kind: str,
    bounds,
    location: str,
    name: Optional[str],
    dtype,
    interior,
    periodic: bool = False,
):
    lb, ub = bounds
    full = Bounds.of(lb, ub)
    ap_bounds = Bounds.of(*interior) if interior is not None else full
    elem = _dtype_name(dtype)
    loc = Location(location)

    def decorator(func: Callable) -> OpDef:
        ctx = get_context()
        sym = name or func.__name__
        nargs = len(inspect.signature(func).parameters)
        tt = TempType(elem, full, loc)
        fn, captures, scalar_caps = trace_kernel_into_opdef(
            ctx.builder,
            sym,
            kind,
            func,
            [tt] * nargs,
            ap_bounds,
            arg_names=list(inspect.signature(func).parameters),
            periodic=periodic,
        )
        if scalar_caps:
            del ctx.module.functions[sym]
            raise TypeError(
                f"@{kind} {sym} captured traced scalars; operator definitions "
                "must be closed over constants (scalar captures are supported "
                "in solve_nonlinear residual closures)"
            )
        if kind == "linear_opdef":
            if captures:
                del ctx.module.functions[sym]  # don't leave a broken symbol
                raise TypeError(
                    f"@linear_op_def {sym} captured temps "
                    f"{[c.name for c in captures]}; linear operators must be "
                    "closed (use nonlinear_op_def or pass them as kernel "
                    "arguments)"
                )
            # fail at decoration, not at the first compile
            from ..ir.verify import _verify_linear_body

            try:
                _verify_linear_body(fn)
            except Exception:
                del ctx.module.functions[sym]  # don't leave a broken symbol
                raise
        ctx.bump()
        return OpDef(sym, kind, captures=captures)

    return decorator


def linear_op_def(
    bounds,
    location: str = "cell",
    name: Optional[str] = None,
    dtype=None,
    interior=None,
    periodic: bool = False,
):
    """Define a linear operator symbol.

    @linear_op_def(bounds=([0],[100]), location="cell")
    def laplacian(u):
        return u[0]*2 - u[-1] - u[1]
    """
    return _opdef_decorator("linear_opdef", bounds, location, name, dtype, interior, periodic)


def nonlinear_op_def(
    bounds,
    location: str = "cell",
    name: Optional[str] = None,
    dtype=None,
    interior=None,
    periodic: bool = False,
):
    """Define a nonlinear operator symbol."""
    return _opdef_decorator("nonlinear_opdef", bounds, location, name, dtype, interior, periodic)


# ---------------------------------------------------------------------------
# apply / stencil
# ---------------------------------------------------------------------------


def apply(inputs: Sequence, bounds):
    """Immediate stencil application:

    @neptune.apply(inputs=[u, v], bounds=([1], [15]))
    def kernel(u, v):
        return u[-1] - 2*u[0] + u[1] + v[0]

    In traced mode the decorator emits an apply op and returns its result
    Expr; in eager mode it executes and returns a concrete temp Expr.
    """
    lb, ub = bounds
    ap_bounds = Bounds.of(lb, ub)
    ctx = get_context()

    def decorator(func: Callable):
        exprs = [x if isinstance(x, Expr) else temp(x) for x in inputs]
        if ctx.tracing and all(
            isinstance(x.node, E.TempLeaf) and x.node.ir_value is not None for x in exprs
        ):
            return emit_apply_inline(ctx.builder, func, exprs, ap_bounds)
        # eager: trace into a hidden opdef, execute against concrete arrays
        for x in exprs:
            if not (isinstance(x.node, E.TempLeaf) and x.node.concrete is not None):
                raise TypeError("eager @apply inputs must be arrays or concrete temps")
        sym = fresh_kernel_name("_eager_apply")
        fn, captures, scalar_caps = trace_kernel_into_opdef(
            ctx.builder,
            sym,
            "nonlinear_opdef",
            func,
            [x.node.ttype for x in exprs],
            ap_bounds,
        )
        sym = _dedupe_opdef(ctx, fn)
        args = [x.node.concrete for x in exprs]
        for c in captures:
            if c.concrete is None:
                raise TypeError(f"eager @apply captured non-concrete temp '{c.name or c.uid}'")
            args.append(c.concrete)
        for sc in scalar_caps:
            if sc.concrete is None:
                raise TypeError("eager @apply captured a non-concrete scalar")
            args.append(sc.concrete)
        out = ctx.compiled().opdef(sym)(*args)
        # every result spans input0's domain (trace_kernel_into_opdef)
        out_lb = exprs[0].node.ttype.bounds.lb
        if isinstance(out, tuple):
            return tuple(temp(o, lb=out_lb) for o in out)
        return temp(out, lb=out_lb)

    return decorator


stencil = apply  # reference alias


# ---------------------------------------------------------------------------
# matrix assembly + linear solve
# ---------------------------------------------------------------------------


class MatrixExpr:
    """Traced assembled-matrix handle (wraps the IR value)."""

    def __init__(self, ir_value):
        self.ir_value = ir_value

    def __repr__(self):
        return f"<neptune MatrixExpr {self.ir_value.type}>"


def assemble_matrix(op):
    """H = neptune.assemble_matrix(laplacian).

    Traced mode returns a MatrixExpr (IR handle); eager mode returns a live
    MatrixHandle (a lazy matrix-free operator).
    """
    sym = _sym_name(op)
    ctx = get_context()
    if ctx.tracing:
        return MatrixExpr(ctx.builder.assemble_matrix(sym))
    cm = ctx.compiled()
    fn = ctx.module.lookup(sym)
    # annotations live on the verified clone inside the compiled snapshot
    vfn = cm.module.lookup(sym)
    return MatrixHandle(
        symbol=sym,
        matvec=cm.opdef(sym),
        temp_type=fn.ftype.inputs[0],
        structure_key_hash=vfn.attrs.get("structure_key_hash", 0),
        halo=vfn.attrs.get("halo", ()),
        interior=single_apply_interior(vfn),
    )


def sweeps(op, k: int) -> Callable:
    """fn(x, *scalars) -> operator @op applied k times (relaxation sweeps,
    explicit stepping x <- A x).

    Eligible operators (one f32 rank-2 or rank-3 apply with a dim-0 halo)
    run as kernel C, `stencil_sweeps`, on a CUDA tensor: several sweeps per
    pass over device memory. Everything else, and every CPU tensor, runs k
    single applies with the same semantics.
    """
    sym = _sym_name(op)
    ctx = get_context()
    if ctx.tracing:
        raise RuntimeError(
            "sweeps() builds an executable callable; call it outside the "
            "traced method and close over the result, or loop the operator "
            "directly inside the trace"
        )
    return ctx.compiled().sweeps(sym, k)


def solve_linear(
    matrix,
    rhs,
    solver: str = "cg",
    tol: float = 1e-6,
    max_iters: int = 1000,
    precond: str = "none",
    verbose: bool = False,
    precision: str = "full",
    options=None,
):
    """Solve A x = b (defaults cg + tol 1e-6).

    options: per-solve runtime options dict or PETSc-style string, e.g.
    {"restart": 50, "atol": 1e-12, "divtol": 1e5}."""
    ctx = get_context()
    if ctx.tracing:
        b = ctx.builder
        if isinstance(matrix, MatrixHandle):
            # eager handle used inside a traced method (the @jit_class
            # init-state pattern): re-emit the assembly, it is lazy anyway
            matrix = MatrixExpr(b.assemble_matrix(matrix.symbol))
        if not isinstance(matrix, MatrixExpr):
            raise TypeError("solve_linear: matrix must come from assemble_matrix")
        if not (
            isinstance(rhs, Expr)
            and isinstance(rhs.node, E.TempLeaf)
            and rhs.node.ir_value is not None
        ):
            raise TypeError("solve_linear: rhs must be a traced temp Expr")
        out = b.solve_linear(
            matrix.ir_value,
            rhs.node.ir_value,
            solver=solver,
            tol=tol,
            max_iters=max_iters,
            precond=precond,
            verbose=verbose,
            precision=precision,
            options=options,
        )
        return Expr(E.TempLeaf(out.type, ir_value=out))

    # eager
    if isinstance(matrix, (OpDef, str)):
        matrix = assemble_matrix(matrix)
    if not isinstance(matrix, MatrixHandle):
        raise TypeError("solve_linear: matrix must be a MatrixHandle (eager mode)")
    b_arr = _as_tensor(_concrete_array(rhs)).to(matrix.dtype)
    opts = merged_linear_options(
        parse_options(options, LINEAR_OPTION_KEYS, where="solve_linear"), solver
    )
    pc_opts = split_precond_options(opts, precond)
    if precision == "mixed":
        return get_context().compiled().solve_mixed(
            matrix, b_arr, solver=solver, tol=tol, max_iters=max_iters, precond=precond,
            options=options, verbose=verbose or verbose_default(),
        )
    M = None
    if precond == "mg":
        ctx = get_context()
        cm = ctx.compiled()
        key = (
            matrix.structure_key_hash, matrix.grid_shape, matrix.dtype,
            tuple(sorted(pc_opts.items())), cm.backend, b_arr.device,
        )
        if key not in ctx.mg_sites:
            ctx.mg_sites[key] = auto_mg_preconditioner(
                cm.module, matrix, cm.backend, device=b_arr.device, **pc_opts
            )
        M = ctx.mg_sites[key]
    elif precond not in (None, "none"):
        like = torch.zeros(matrix.grid_shape, dtype=matrix.dtype, device=b_arr.device)
        dense = matrix.dense(b_arr.device) if precond == "ssor_dense" else None
        M = make_preconditioner(
            precond, matrix.matvec, like, matrix.halo, dense_matrix=dense, **pc_opts
        )
    if solver == "direct":
        if opts:
            raise ValueError(f"solver='direct' takes no runtime options (got {sorted(opts)})")
        x, info = krylov.direct(matrix.dense(b_arr.device), b_arr)
    else:
        # Dirichlet lift, CG only (see MatrixHandle.ring_lift): keeps
        # preconditioned CG in the symmetric interior subspace when b
        # carries boundary data
        lift = matrix.ring_lift(b_arr) if solver == "cg" else None
        b_eff = b_arr if lift is None else b_arr - matrix.matvec(lift)
        x, info = krylov.solve(
            matrix.matvec, b_eff, solver=solver, tol=tol, maxiter=max_iters,
            M=M, **linear_option_kwargs(solver, opts),
        )
        if lift is not None:
            x = x + lift
    if verbose or verbose_default():
        report_solve(f"KSP({solver})", matrix.symbol, info)
    return x


# ---------------------------------------------------------------------------
# nonlinear solve
# ---------------------------------------------------------------------------


def _newton_kwargs(method: str, options, where: str) -> dict:
    kind = "picard" if method == "picard" else "newton"
    return nonlinear_option_kwargs(
        kind,
        merged_nonlinear_options(parse_options(options, NONLINEAR_OPTION_KEYS, where=where), kind),
    )


def solve_nonlinear(
    residual: Callable,
    initial_guess,
    method: str = "newton-krylov",
    tol: float = 1e-8,
    max_iters: int = 50,
    krylov_tol: float = 1e-6,
    krylov_iters: int = 200,
    verbose: bool = False,
    options=None,
):
    """Solve F(U) = 0 for a (possibly multi-field) state.

    `residual` is a scalar stencil kernel over the state temps; closures over
    other temps (e.g. the previous time level) are lifted to captures
    automatically.

        h_next, q_next = ntt.solve_nonlinear(
            swe_residual, initial_guess=(h, q), method="newton-krylov")
    """
    single = not isinstance(initial_guess, (tuple, list))
    states = [initial_guess] if single else list(initial_guess)
    states = [x if isinstance(x, Expr) else temp(x) for x in states]
    for x in states:
        if not isinstance(x.node, E.TempLeaf):
            raise TypeError("solve_nonlinear initial_guess must be temps/arrays")

    ctx = get_context()
    sym = fresh_kernel_name("_residual")
    fn, captures, scalar_caps = trace_kernel_into_opdef(
        ctx.builder,
        sym,
        "nonlinear_opdef",
        residual,
        [x.node.ttype for x in states],
        states[0].node.ttype.bounds,
    )
    if len(fn.ftype.results) != len(states):
        del ctx.module.functions[sym]
        raise TypeError(
            f"residual returns {len(fn.ftype.results)} fields for {len(states)} states"
        )
    sym = _dedupe_opdef(ctx, fn)

    nkw = dict(tol=tol, max_iters=max_iters, krylov_tol=krylov_tol, krylov_iters=krylov_iters)
    if method not in ("newton", "newton-krylov", "picard"):
        raise ValueError(f"unknown nonlinear method {method!r}")

    if ctx.tracing and all(s.node.ir_value is not None for s in states):
        b = ctx.builder
        cap_vals = []
        for c in captures:
            if c.ir_value is None:
                raise TypeError(
                    f"residual captured non-traced temp '{c.name or c.uid}' "
                    "inside a traced function"
                )
            cap_vals.append(c.ir_value)
        for sc in scalar_caps:
            if sc.ir_value is None:
                raise TypeError(
                    "residual captured a non-traced scalar inside a traced function"
                )
            cap_vals.append(sc.ir_value)
        out = b.solve_nonlinear(
            sym,
            [s.node.ir_value for s in states],
            captures=cap_vals,
            method="newton" if method.startswith("newton") else method,
            verbose=verbose,
            options=options,
            **nkw,
        )
        outs = out if isinstance(out, tuple) else (out,)
        exprs = tuple(Expr(E.TempLeaf(o.type, ir_value=o)) for o in outs)
        return exprs[0] if single else exprs

    # eager
    res_fn = ctx.compiled().opdef(sym)
    state_arrays = tuple(_as_tensor(_concrete_array(s)) for s in states)
    cap_arrays = []
    for c in captures:
        if c.concrete is None:
            raise TypeError(
                f"residual captured non-concrete temp '{c.name or c.uid}' in eager mode"
            )
        cap_arrays.append(c.concrete)
    for sc in scalar_caps:
        if sc.concrete is None:
            raise TypeError("residual captured a non-concrete scalar")
        cap_arrays.append(sc.concrete)

    def F(ss):
        out = res_fn(*ss, *cap_arrays)
        return out if isinstance(out, tuple) else (out,)

    okw = _newton_kwargs(method, options, "solve_nonlinear")
    if method == "picard":
        x, info = picard(F, state_arrays, tol=tol, max_iters=max_iters, **okw)
    else:
        x, info = newton_krylov(F, state_arrays, **nkw, **okw)
    if verbose or verbose_default():
        report_solve(f"SNES({method})", sym, info)
    return x[0] if single else tuple(x)


# ---------------------------------------------------------------------------
# reductions and time advance
# ---------------------------------------------------------------------------


def reduce(x, kind: str = "sum", bounds=None):
    """Grid reduction: sum | max | min | l1 | l2."""
    ctx = get_context()
    src_lb = None
    if isinstance(x, Expr) and isinstance(x.node, E.TempLeaf):
        if x.node.ir_value is not None and ctx.tracing:
            bnds = Bounds.of(*bounds) if bounds is not None else None
            v = ctx.builder.reduce(x.node.ir_value, kind, bnds)
            return Expr(E.ScalarRef(ir_value=v, stype=v.type))
        src_lb = x.node.ttype.bounds.lb
        x = x.node.concrete
    arr = _as_tensor(x)
    if bounds is not None:
        lb, ub = bounds
        base = src_lb or (0,) * arr.dim()
        # bounds are logical; slice at physical = logical - lb
        arr = arr[tuple(slice(lo - b, u - b) for lo, u, b in zip(lb, ub, base))]
    return {
        "sum": torch.sum,
        "max": torch.max,
        "min": torch.min,
        "l1": lambda a: torch.sum(torch.abs(a)),
        "l2": lambda a: torch.sqrt(torch.sum(a * a)),
    }[kind](arr)


def time_advance(
    state,
    dt: float,
    method,
    system=None,
    rhs=None,
    residual=None,
    jacobian=None,
    solver: str = "gmres",
    tol: float = 1e-8,
    max_iters: int = 200,
    precond: str = "none",
    scheme: str = "euler",
    options=None,
):
    """One time step.

    method: TimeMethod or int (0 explicit, 1 implicit_nonlinear,
    2 implicit_linear, 3 runtime) or the strings "explicit" /
    "implicit_nonlinear" / "implicit_linear".
    """
    if isinstance(method, str):
        method = {
            "explicit": TimeMethod.EXPLICIT,
            "implicit_nonlinear": TimeMethod.IMPLICIT_NONLINEAR,
            "implicit_linear": TimeMethod.IMPLICIT_LINEAR,
            "runtime": TimeMethod.RUNTIME,
        }[method]
    method = TimeMethod(int(method))
    ctx = get_context()

    if ctx.tracing and isinstance(state, Expr) and state.node.ir_value is not None:
        if isinstance(dt, Expr):
            if getattr(dt.node, "ir_value", None) is None:
                raise TypeError("time_advance dt Expr must be a traced scalar")
            dt = dt.node.ir_value
        out = ctx.builder.time_advance(
            state.node.ir_value,
            dt,
            int(method),
            system=_sym_name(system) if system else None,
            rhs=_sym_name(rhs) if rhs else None,
            residual=_sym_name(residual) if residual else None,
            jacobian=_sym_name(jacobian) if jacobian else None,
            solver=solver,
            tol=tol,
            max_iters=max_iters,
            precond=precond,
            scheme=scheme,
            options=options,
        )
        return Expr(E.TempLeaf(out.type, ir_value=out))

    # eager
    u = _as_tensor(_concrete_array(state))
    if method == TimeMethod.EXPLICIT:
        f = ctx.compiled().opdef(_sym_name(rhs))
        if scheme == "euler":
            return u + dt * f(u)
        if scheme == "rk2":
            k1 = f(u)
            k2 = f(u + dt * k1)
            return u + 0.5 * dt * (k1 + k2)
        if scheme == "rk4":
            k1 = f(u)
            k2 = f(u + 0.5 * dt * k1)
            k3 = f(u + 0.5 * dt * k2)
            k4 = f(u + dt * k3)
            return u + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
        raise ValueError(f"unknown scheme {scheme!r}")
    if method == TimeMethod.IMPLICIT_LINEAR:
        return solve_linear(
            assemble_matrix(system), u, solver=solver, tol=tol,
            max_iters=max_iters, precond=precond, options=options,
        )
    if method == TimeMethod.IMPLICIT_NONLINEAR:
        res = ctx.compiled().opdef(_sym_name(residual))

        def F(ss):
            return (res(ss[0], u),)

        okw = _newton_kwargs("newton", options, "time_advance")
        x, _ = newton_krylov(F, (u,), tol=tol, max_iters=max_iters, **okw)
        return x[0]
    raise ValueError("eager time_advance does not support method=runtime")
