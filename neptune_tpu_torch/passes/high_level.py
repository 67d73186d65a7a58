"""High-level conversion pass: rewrite `time_advance` into solver/apply ops.

Rebuild of the reference's `neptune-ir-high-level-convertion` pass
(`lib/Passes/HighLevelConvertion.cpp:57-173`, def `NeptuneIRPasses.td:15-22`):

  * EXPLICIT            -> `apply_linear`/`apply_nonlinear @rhs` producing k,
                           then a combination apply `u + dt*k` over the full
                           state domain (the reference hard-codes a 1-D f64
                           body with dt captured from the enclosing region,
                           `HighLevelConvertion.cpp:96-117`; here the body is
                           rank-generic and dt is a proper scalar param).
                           `scheme` extends this with RK2/RK4 chains.
  * IMPLICIT_LINEAR     -> `assemble_matrix @system` + `solve_linear`
                           (`HighLevelConvertion.cpp:121-143`).
  * IMPLICIT_NONLINEAR  -> `solve_nonlinear @residual` with the state passed
                           as both initial guess and capture
                           (`HighLevelConvertion.cpp:144-161`).
  * RUNTIME             -> `time_advance_runtime` (`:162-168`).
"""

from __future__ import annotations

from ..ir.core import Block, Function, Module, Operation, Value
from ..ir.ops import NeptuneBuilder
from ..ir.types import I32, ScalarType, TempType, TimeMethod


def _replace_uses(fn: Function, old: Value, new: Value):
    for op in fn.walk():
        for i, o in enumerate(op.operands):
            if o.uid == old.uid:
                op.operands[i] = new


def _emit_combination(
    b: NeptuneBuilder, state: Value, terms: list[tuple[float, Value]], dt: Value
) -> Value:
    """Emit apply computing state + dt * sum(c_i * k_i) over the full domain."""
    tt: TempType = state.type
    inputs = [state] + [k for _, k in terms]
    op, body = b.start_apply(
        inputs, tt.bounds, result_type=tt, scalar_params=[dt]
    )
    rank = tt.bounds.rank
    b.push_block(body)
    s0 = b.access(body.args[rank], [0] * rank)
    acc = None
    elem = tt.element_scalar
    for idx, (coeff, _) in enumerate(terms):
        k0 = b.access(body.args[rank + 1 + idx], [0] * rank)
        if coeff != 1.0:
            k0 = b.mul(b.constant(coeff, elem), k0)
        acc = k0 if acc is None else b.add(acc, k0)
    dt_arg = body.args[rank + len(inputs)]
    out = b.add(s0, b.mul(dt_arg, acc))
    b.yield_(out)
    b.pop_block()
    return b.finish_apply(op)


def _apply_rhs(b: NeptuneBuilder, module: Module, rhs: str, arg: Value) -> Value:
    fn = module.lookup(rhs)
    if fn.kind == "linear_opdef":
        return b.apply_linear(rhs, [arg])
    if fn.kind == "nonlinear_opdef":
        return b.apply_nonlinear(rhs, [arg])
    raise ValueError(f"time_advance rhs @{rhs} must be an opdef, is {fn.kind}")


def _euler_like(
    b: NeptuneBuilder, module: Module, op: Operation, state: Value, dt: Value
) -> Value:
    """Explicit integrators. euler matches the reference exactly; rk2/rk4 are
    multi-stage extensions (each stage is an rhs application + combination
    apply, so the whole chain stays in IR and fuses under XLA)."""
    rhs = op.attrs["rhs"]
    scheme = op.attrs.get("scheme", "euler")
    if scheme == "euler":
        k = _apply_rhs(b, module, rhs, state)
        return _emit_combination(b, state, [(1.0, k)], dt)
    if scheme == "rk2":
        k1 = _apply_rhs(b, module, rhs, state)
        u1 = _emit_combination(b, state, [(1.0, k1)], dt)
        k2 = _apply_rhs(b, module, rhs, u1)
        return _emit_combination(b, state, [(0.5, k1), (0.5, k2)], dt)
    if scheme == "rk4":
        half = b.mul(b.constant(0.5, dt.type), dt)
        k1 = _apply_rhs(b, module, rhs, state)
        u1 = _emit_combination(b, state, [(1.0, k1)], half)
        k2 = _apply_rhs(b, module, rhs, u1)
        u2 = _emit_combination(b, state, [(1.0, k2)], half)
        k3 = _apply_rhs(b, module, rhs, u2)
        u3 = _emit_combination(b, state, [(1.0, k3)], dt)
        k4 = _apply_rhs(b, module, rhs, u3)
        return _emit_combination(
            b,
            state,
            [(1 / 6, k1), (1 / 3, k2), (1 / 3, k3), (1 / 6, k4)],
            dt,
        )
    raise ValueError(f"unknown explicit scheme {scheme!r}")


def convert_time_advance(module: Module) -> Module:
    """Rewrite every `time_advance` op in place. Mutates and returns module."""
    b = NeptuneBuilder(module)
    for fn in module.functions.values():
        changed = True
        while changed:
            changed = False
            for idx, op in enumerate(fn.body.ops):
                if op.name != "neptune.time_advance":
                    continue
                state, dt = op.operands[0], op.operands[1]
                method = TimeMethod(op.attrs["method"])
                staging = Block()
                b.push_block(staging)
                if method == TimeMethod.EXPLICIT:
                    new = _euler_like(b, module, op, state, dt)
                elif method == TimeMethod.IMPLICIT_LINEAR:
                    A = b.assemble_matrix(op.attrs["system"])
                    new = b.solve_linear(
                        A,
                        state,
                        solver=op.attrs.get("solver", "gmres"),
                        tol=op.attrs.get("tol", 1e-8),
                        max_iters=op.attrs.get("max_iters", 200),
                        precond=op.attrs.get("precond", "none"),
                        options=op.attrs.get("options"),
                    )
                elif method == TimeMethod.IMPLICIT_NONLINEAR:
                    new = b.solve_nonlinear(
                        op.attrs["residual"],
                        [state],
                        captures=[state],
                        jacobian=op.attrs.get("jacobian"),
                        method="newton",
                        tol=op.attrs.get("tol", 1e-8),
                        max_iters=op.attrs.get("max_iters", 50),
                        options=op.attrs.get("options"),
                    )
                    if isinstance(new, tuple):
                        new = new[0]
                else:
                    # RUNTIME: the runtime op's method operand uses the
                    # reference *runtime* codes (0 pass-through / 1 copy /
                    # 2 forward Euler, NeptunePETScRuntime.cpp:637-717),
                    # which differ from the IR TimeMethod enum (SURVEY §2.3).
                    # A statically-RUNTIME time_advance means "step forward",
                    # i.e. code 2; programs wanting true runtime dispatch
                    # build time_advance_runtime directly with a traced i32.
                    mval = b.constant(2, I32)
                    new = b.time_advance_runtime(
                        state, dt, mval, op.attrs.get("rhs")
                    )
                b.pop_block()
                fn.body.ops[idx : idx + 1] = staging.ops
                for s in staging.ops:
                    s.parent = fn.body
                _replace_uses(fn, op.results[0], new)
                changed = True
                break
    return module
