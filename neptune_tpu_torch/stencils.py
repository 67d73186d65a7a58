"""The stencil operators of the JAX package's benchmark rows, as IR.

Each builder returns a verified module holding one opdef, built with the
port's `NeptuneBuilder` in the operation order the JAX package's DSL traces
(`bench.py::make_jacobi_2d`, `make_heat_3d`, `make_advection_2d`, and the
512^2 Poisson operator of the CG row). `print_module` of the result parses
in either package, so the same program can run through both.
"""

from __future__ import annotations

from typing import Callable

from .ir import BF16, F32, F64, Bounds, NeptuneBuilder, TempType
from .ir.core import Module, Operation
from .ir.verify import verify_and_annotate

_SCALAR = {"float32": F32, "float64": F64, "bfloat16": BF16}


def _one_apply_opdef(
    name: str,
    shape: tuple,
    halo: int,
    dtype: str,
    body: Callable,
    *,
    kind: str = "linear_opdef",
    periodic: bool = False,
    n_inputs: int = 1,
    scalar: bool = False,
    n_results: int = 1,
) -> Module:
    """Module with opdef @name: one apply over the interior `halo` cells in
    from the edge (the whole domain when periodic). body(b, S, u, s) builds
    the scalar body -- one value per result -- from the input block args `u`
    and the scalar arg `s`."""
    S = _SCALAR[dtype]
    rank = len(shape)
    b = NeptuneBuilder()
    outer = Bounds.of([0] * rank, list(shape))
    tt = TempType(dtype, outer)
    inputs = [tt] * n_inputs + ([S] if scalar else [])
    fn = b.make_opdef(name, kind, inputs, [tt] * n_results)
    b.push_block(fn.body)
    bounds = outer if periodic else Bounds.of([halo] * rank, [n - halo for n in shape])
    temps = list(fn.body.args[:n_inputs])
    scalars = list(fn.body.args[n_inputs:])
    op, blk = b.start_apply(
        temps, bounds, scalar_params=scalars, periodic=periodic,
        result_types=[tt] * n_results,
    )
    b.push_block(blk)
    u = blk.args[rank : rank + n_inputs]
    s = blk.args[rank + n_inputs] if scalar else None
    b.yield_(body(b, S, u, s))
    b.pop_block()
    out = b.finish_apply(op)
    b.return_(list(out) if n_results > 1 else [out])
    b.pop_block()
    return verify_and_annotate(b.module)


def jacobi5(shape, dtype="float32") -> Module:
    """@jacobi: 0.25 * (u[-1,0] + u[1,0] + u[0,-1] + u[0,1]) on the interior."""

    def body(b, S, u, s):
        acc = None
        for o in ([-1, 0], [1, 0], [0, -1], [0, 1]):
            v = b.access(u[0], o)
            acc = v if acc is None else b.add(acc, v)
        return b.mul(b.constant(0.25, S), acc)

    return _one_apply_opdef("jacobi", tuple(shape), 1, dtype, body)


def poisson5(n: int, dtype="float32") -> Module:
    """@poisson: 4 u - u[-1,0] - u[1,0] - u[0,-1] - u[0,1] on the interior."""

    def body(b, S, u, s):
        acc = b.mul(b.constant(4.0, S), b.access(u[0], [0, 0]))
        for o in ([-1, 0], [1, 0], [0, -1], [0, 1]):
            acc = b.sub(acc, b.access(u[0], o))
        return acc

    return _one_apply_opdef("poisson", (n, n), 1, dtype, body)


def heat7(shape, dtype="float32", periodic=False) -> Module:
    """@heat: u + 0.1 * (sum of the 6 neighbours - 6 u) on the interior, or
    on the whole torus."""

    def body(b, S, u, s):
        c = b.access(u[0], [0, 0, 0])
        acc = None
        for o in ([-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]):
            v = b.access(u[0], o)
            acc = v if acc is None else b.add(acc, v)
        lap = b.sub(acc, b.mul(b.constant(6.0, S), c))
        return b.add(c, b.mul(b.constant(0.1, S), lap))

    return _one_apply_opdef("heat", tuple(shape), 1, dtype, body, periodic=periodic)


def advection4(shape, dtype="float32", periodic=False) -> Module:
    """@adv4: u - 0.1 (0.7 du/dx + 0.3 du/dy), 4th-order centred differences
    (a dim-0 halo of 2); interior 2 cells in, or the whole torus."""

    def body(b, S, u, s):
        def d(axis):
            def at(k):
                o = [0, 0]
                o[axis] = k
                return b.access(u[0], o)

            t = b.add(b.neg(at(2)), b.mul(b.constant(8.0, S), at(1)))
            t = b.sub(t, b.mul(b.constant(8.0, S), at(-1)))
            t = b.add(t, at(-2))
            return b.div(t, b.constant(12.0, S))

        mix = b.add(b.mul(b.constant(0.7, S), d(0)), b.mul(b.constant(0.3, S), d(1)))
        return b.sub(b.access(u[0], [0, 0]), b.mul(b.constant(0.1, S), mix))

    return _one_apply_opdef(
        "adv4", tuple(shape), 2, dtype, body, kind="nonlinear_opdef", periodic=periodic
    )


def combination(shape, dtype="float32") -> Module:
    """@combine(u, k, dt) = u + dt * k over the whole domain: the apply the
    high-level pass emits for an explicit Euler step (`_emit_combination`)."""

    def body(b, S, u, s):
        z = [0] * len(shape)
        return b.add(b.access(u[0], z), b.mul(s, b.access(u[1], z)))

    return _one_apply_opdef(
        "combine", tuple(shape), 0, dtype, body,
        kind="nonlinear_opdef", n_inputs=2, scalar=True,
    )


def gradients(shape, dtype="float32") -> Module:
    """@grad(u) = (u[1,0] - u[0,0], u[0,1] - u[0,0]) on the interior: a
    two-result apply (result 1 has no input to copy through: zeros)."""

    def body(b, S, u, s):
        c = b.access(u[0], [0, 0])
        return [b.sub(b.access(u[0], [1, 0]), c), b.sub(b.access(u[0], [0, 1]), c)]

    return _one_apply_opdef(
        "grad", tuple(shape), 1, dtype, body, kind="nonlinear_opdef", n_results=2
    )


def the_apply(module: Module) -> Operation:
    """The single apply op of a module built here."""
    (op,) = [op for op in module.walk() if op.name == "neptune.apply"]
    return op
