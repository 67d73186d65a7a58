"""The stencil operators of the JAX package's benchmark rows, as IR.

Each builder returns a verified module holding one opdef, built with the
port's `NeptuneBuilder` in the operation order the JAX package's DSL traces
(`bench.py::make_jacobi_2d`, `make_heat_3d`, `make_advection_2d`,
`make_composite_2d`, and the 512^2 Poisson operator of the CG row), and
the composite operators that hold kernel D to its plain version.
`print_module` of the result parses in either package, so the same program
can run through both.
"""

from __future__ import annotations

import itertools
from typing import Callable

from .ir import BF16, F32, F64, Bounds, FieldType, NeptuneBuilder, TempType, TensorType
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


def _cross_sum(b: NeptuneBuilder, u):
    """u[-1,0] + u[1,0] + u[0,-1] + u[0,1], summed in bench.py's order."""
    acc = None
    for o in ([-1, 0], [1, 0], [0, -1], [0, 1]):
        v = b.access(u, o)
        acc = v if acc is None else b.add(acc, v)
    return acc


def jacobi5(shape, dtype="float32") -> Module:
    """@jacobi: 0.25 * (u[-1,0] + u[1,0] + u[0,-1] + u[0,1]) on the interior."""

    def body(b, S, u, s):
        acc = _cross_sum(b, u[0])
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


def poisson7(n: int, dtype="float32") -> Module:
    """@poisson: 6 u - (the 6 neighbours) on the interior of an n^3 grid."""

    def body(b, S, u, s):
        acc = b.mul(b.constant(6.0, S), b.access(u[0], [0, 0, 0]))
        for o in ([-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]):
            acc = b.sub(acc, b.access(u[0], o))
        return acc

    return _one_apply_opdef("poisson", (n, n, n), 1, dtype, body)


def hpcg27(shape, dtype="float64") -> Module:
    """@hpcg27: HPCG's operator, (3^rank - 1) u - (the 3^rank - 1 neighbours)
    on the interior: the 27-point stencil on a rank-3 grid (9-point on a
    rank-2 one), the ring standing for absent neighbours."""
    rank = len(shape)

    def body(b, S, u, s):
        acc = b.mul(b.constant(float(3**rank - 1), S), b.access(u[0], [0] * rank))
        for o in itertools.product((-1, 0, 1), repeat=rank):
            if any(o):
                acc = b.sub(acc, b.access(u[0], list(o)))
        return acc

    return _one_apply_opdef("hpcg27", tuple(shape), 1, dtype, body)


def with_solve(module: Module, name: str, **solve) -> Module:
    """`module` with the function @solve(b) = solve_linear(assemble_matrix(
    @name), b, **solve) added: tests/test_multigrid.py's executor program
    (`solve` takes solve_linear's keywords: solver, tol, max_iters, precond,
    options, ...)."""
    b = NeptuneBuilder(module)
    tt = module.lookup(name).ftype.inputs[0]
    tensor = TensorType(tt.element, tt.bounds.shape)
    fn = b.make_function("solve", "func", [tensor], [tensor])
    b.push_block(fn.body)
    rhs = b.load(b.wrap(fn.body.args[0], FieldType(tt.element, tt.bounds)))
    b.return_([b.solve_linear(b.assemble_matrix(name), rhs, **solve)])
    b.pop_block()
    return verify_and_annotate(b.module)


def with_entry(module: Module, name: str) -> Module:
    """`module` with the function @entry(x) = apply_linear @name(x) added:
    one application of the opdef through the executor, as the CLI's --run
    drives it."""
    b = NeptuneBuilder(module)
    tt = module.lookup(name).ftype.inputs[0]
    tensor = TensorType(tt.element, tt.bounds.shape)
    fn = b.make_function("entry", "func", [tensor], [tensor])
    b.push_block(fn.body)
    x = b.load(b.wrap(fn.body.args[0], FieldType(tt.element, tt.bounds)))
    b.return_([b.apply_linear(name, [x])])
    b.pop_block()
    return verify_and_annotate(b.module)


def shifted_laplacian(shape, periodic=False, reach=1) -> Module:
    """@shifted: u + 0.1 * (4 u - u[-h,0] - u[h,0] - u[0,-h] - u[0,h]) with
    h = reach, an SPD rank-2 f32 system, on the interior of any rectangle (a
    copy-through ring h cells deep) or on the whole torus: what the fused CG
    kernel solves on uneven, narrow, periodic and wide-halo grids."""

    def body(b, S, u, s):
        c = b.access(u[0], [0, 0])
        acc = b.mul(b.constant(4.0, S), c)
        for o in ([-reach, 0], [reach, 0], [0, -reach], [0, reach]):
            acc = b.sub(acc, b.access(u[0], o))
        return b.add(c, b.mul(b.constant(0.1, S), acc))

    return _one_apply_opdef("shifted", tuple(shape), reach, "float32", body, periodic=periodic)


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


def damped_jacobi(shape) -> Module:
    """@relax(u, w) = u + w (0.25 (u[-1,0] + u[1,0] + u[0,-1] + u[0,1]) - u) on
    the interior: a rank-2 f32 smoother with a scalar parameter."""

    def body(b, S, u, s):
        acc = _cross_sum(b, u[0])
        c = b.access(u[0], [0, 0])
        return b.add(c, b.mul(s, b.sub(b.mul(b.constant(0.25, S), acc), c)))

    return _one_apply_opdef(
        "relax", tuple(shape), 1, "float32", body, kind="nonlinear_opdef", scalar=True
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


def _inner(outer: Bounds) -> Bounds:
    """outer less one cell at every edge."""
    return Bounds.of([lo + 1 for lo in outer.lb], [hi - 1 for hi in outer.ub])


def _lap_opdef(b: NeptuneBuilder, name: str, tt: TempType, periodic: bool = False) -> None:
    """@name(u) = 2 rank u - (the 2 rank neighbours), on the interior one
    cell in from the edge, or on the whole torus. The operation order of
    bench.py's traced `lap2d`."""
    S = _SCALAR[tt.element]
    rank = tt.bounds.rank
    fn = b.make_opdef(name, "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    bounds = tt.bounds if periodic else _inner(tt.bounds)
    op, blk = b.start_apply([fn.body.args[0]], bounds, periodic=periodic)
    b.push_block(blk)
    u = blk.args[rank]
    acc = b.mul(b.constant(2.0 * rank, S), b.access(u, [0] * rank))
    for d in range(rank):
        for k in (-1, 1):
            o = [0] * rank
            o[d] = k
            acc = b.sub(acc, b.access(u, o))
    b.yield_(acc)
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()


def _finish_wrapped(b: NeptuneBuilder, x, lap, bounds: Bounds) -> Module:
    """Close the open opdef @wrapped with x + 0.01 lap over bounds (the
    combination apply of bench.py's `make_composite_2d`) and verify."""
    rank = bounds.rank
    op, blk = b.start_apply([x, lap], bounds)
    b.push_block(blk)
    z = [0] * rank
    x0 = b.access(blk.args[rank], z)
    l0 = b.access(blk.args[rank + 1], z)
    b.yield_(b.add(x0, b.mul(b.constant(0.01, F32), l0)))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return verify_and_annotate(b.module)


def composite(shape, mixed: bool = False, periodic: bool = False) -> Module:
    """@wrapped(u) = u + 0.01 lap(lap(u)): bench.py's `make_composite_2d`
    (the composite_chain rows), rank 2 or 3, three stages with a composed
    reach of 2. mixed: the outer lap periodic over the whole torus and the
    combination on the interior, so periodic and bounded stages mix.
    periodic: every stage over the whole torus (an SPD system on any grid,
    one cell wide too)."""
    rank = len(shape)
    b = NeptuneBuilder()
    outer = Bounds.of([0] * rank, list(shape))
    tt = TempType("float32", outer)
    _lap_opdef(b, "lap", tt, periodic=periodic)
    if mixed:
        _lap_opdef(b, "lap_p", tt, periodic=True)
    fn = b.make_opdef("wrapped", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    x = fn.body.args[0]
    lap2 = b.apply_linear("lap_p" if mixed else "lap", [b.apply_linear("lap", [x])])
    return _finish_wrapped(b, x, lap2, _inner(outer) if mixed else outer)


def coupled(shape) -> Module:
    """@couple(u, v, a, c) = lap(a u + v[1,0] - v[-1,0]) + c u[0,1] + 0.5 u
    on the interior: a rank-2 chain of two fields, two scalar args and a
    constant scalar operand."""
    b = NeptuneBuilder()
    outer = Bounds.of([0, 0], list(shape))
    inner = _inner(outer)
    tt = TempType("float32", outer)
    _lap_opdef(b, "lap", tt)
    fn = b.make_opdef("couple", "nonlinear_opdef", [tt, tt, F32, F32], [tt])
    b.push_block(fn.body)
    u, v, a, c = fn.body.args
    half = b.constant(0.5, F32)
    op, blk = b.start_apply([u, v], inner, scalar_params=[a])
    b.push_block(blk)
    bu, bv, ba = blk.args[2:5]
    dv = b.sub(b.access(bv, [1, 0]), b.access(bv, [-1, 0]))
    b.yield_(b.add(b.mul(ba, b.access(bu, [0, 0])), dv))
    b.pop_block()
    lap = b.apply_linear("lap", [b.finish_apply(op)])
    op, blk = b.start_apply([lap, u], inner, scalar_params=[c, half])
    b.push_block(blk)
    bl, bu, bc, bh = blk.args[2:6]
    t = b.add(b.access(bl, [0, 0]), b.mul(bc, b.access(bu, [0, 1])))
    b.yield_(b.add(t, b.mul(bh, b.access(bu, [0, 0]))))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return verify_and_annotate(b.module)


def _graded_opdef(b: NeptuneBuilder, name: str, tt: TempType, periodic: bool) -> None:
    """@name(u) = 0.25 (u[-1,0] + u[1,0] + u[0,-1] + u[0,1]) + 0.001 (i0 - i1)
    with (i0, i1) the cell's logical index, on the interior or the torus."""
    fn = b.make_opdef(name, "nonlinear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, blk = b.start_apply(
        [fn.body.args[0]], tt.bounds if periodic else _inner(tt.bounds), periodic=periodic
    )
    b.push_block(blk)
    i0, i1, u = blk.args[:3]
    acc = _cross_sum(b, u)
    grade = b.mul(b.constant(0.001, F32), b.cast(b.sub(i0, i1), F32))
    b.yield_(b.add(b.mul(b.constant(0.25, F32), acc), grade))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()


def graded(shape, lb=(0, 0), periodic: bool = False) -> Module:
    """@graded: an index() body (see _graded_opdef) on a rank-2 f32 grid whose
    logical origin is lb."""
    b = NeptuneBuilder()
    tt = TempType("float32", Bounds.of(list(lb), [lo + n for lo, n in zip(lb, shape)]))
    _graded_opdef(b, "graded", tt, periodic)
    return verify_and_annotate(b.module)


def graded_chain(shape, lb=(0, 0)) -> Module:
    """@wrapped(u) = u + 0.01 lap(graded(u)) on the interior, graded periodic
    and lap bounded: a mixed chain with an index() body on a grid whose
    logical origin is lb."""
    b = NeptuneBuilder()
    outer = Bounds.of(list(lb), [lo + n for lo, n in zip(lb, shape)])
    tt = TempType("float32", outer)
    _graded_opdef(b, "graded", tt, periodic=True)
    _lap_opdef(b, "lap", tt)
    fn = b.make_opdef("wrapped", "nonlinear_opdef", [tt], [tt])
    b.push_block(fn.body)
    x = fn.body.args[0]
    lap = b.apply_linear("lap", [b.apply_nonlinear("graded", [x])])
    return _finish_wrapped(b, x, lap, _inner(outer))


# ---- the f64 programs of bench.py's native-oracle rows ------------------------


def _time_step_entry(b: NeptuneBuilder, n, dt, method, **kw) -> None:
    """@entry(out, in) = unwrap(store(time_advance(load(in)), out)), the
    entry of the reference's smoke programs."""
    shape = n if isinstance(n, tuple) else (n,)
    bounds = Bounds.of([0] * len(shape), list(shape))
    ft = FieldType("float64", bounds)
    entry = b.make_function(
        "entry", "func", [TensorType("float64", shape)] * 2, [TensorType("float64", shape)]
    )
    b.push_block(entry.body)
    fout = b.wrap(entry.body.args[0], ft)
    fin = b.wrap(entry.body.args[1], ft)
    b.store(b.time_advance(b.load(fin), dt, method, **kw), fout)
    b.return_([b.unwrap(fout)])
    b.pop_block()


def heat_gmres_f64(n: int = 48) -> Module:
    """bench.py's f64_accuracy_vs_native program: one implicit heat step
    on an n^2 f64 grid, @heatA64 = I - 0.1 lap on the interior, by GMRES to
    1e-12."""
    b = NeptuneBuilder()
    bounds = Bounds.of([0, 0], [n, n])
    tt = TempType("float64", bounds)
    fn = b.make_opdef("heatA64", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0]], Bounds.of([1, 1], [n - 1, n - 1]))
    b.push_block(body)
    u = body.args[2]
    c = b.access(u, [0, 0])
    s = b.access(u, [-1, 0])
    for o in ([1, 0], [0, -1], [0, 1]):
        s = b.add(s, b.access(u, o))
    lap = b.sub(s, b.mul(b.constant(4.0, F64), c))
    b.yield_(b.sub(c, b.mul(b.constant(0.1, F64), lap)))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    _time_step_entry(b, (n, n), 0.1, 2, system="heatA64", solver="gmres", tol=1e-12,
                     max_iters=500)
    return b.module


def black_scholes(n: int = 32) -> Module:
    """bench.py's f64_bs_vs_native program (the reference's
    smoke_time_advance_bs.mlir): one implicit Black-Scholes step, A(v) = v -
    dt (a v_xx + b v_x + c v), by GMRES to 1e-10."""
    b = NeptuneBuilder()
    tt = TempType("float64", Bounds.of([0], [n]))
    fn = b.make_opdef("bs_A", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0]], Bounds.of([1], [n - 1]))
    b.push_block(body)
    vm1 = b.access(body.args[1], [-1])
    v0 = b.access(body.args[1], [0])
    vp1 = b.access(body.args[1], [1])
    vxx = b.mul(b.constant(100.0, F64), b.add(b.sub(vm1, b.mul(b.constant(2.0, F64), v0)), vp1))
    vx = b.mul(b.constant(5.0, F64), b.sub(vp1, vm1))
    L = b.add(
        b.add(b.mul(b.constant(2.0e-2, F64), vxx), b.mul(b.constant(3.0e-2, F64), vx)),
        b.mul(b.constant(-5.0e-2, F64), v0),
    )
    b.yield_(b.sub(v0, b.mul(b.constant(1e-2, F64), L)))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    _time_step_entry(b, n, 1e-2, 2, system="bs_A", solver="gmres", tol=1e-10, max_iters=500)
    return b.module


def allen_cahn_jfnk(n: int = 16) -> Module:
    """bench.py's f64_jfnk_vs_native program (the reference's
    smoke_time_advance_nonlinear.mlir): one fully implicit Allen-Cahn step
    by Newton on F(u_next; u_prev), boundary rows u_next - u_prev."""
    b = NeptuneBuilder()
    bounds = Bounds.of([0], [n])
    tt = TempType("float64", bounds)
    fn = b.make_opdef("ac_residual", "nonlinear_opdef", [tt, tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0], fn.body.args[1]], bounds)
    b.push_block(body)
    i = body.args[0]
    un, up = body.args[1], body.args[2]
    is_left = b.cmp("eq", i, b.constant(0, i.type))
    is_right = b.cmp("eq", i, b.constant(n - 1, i.type))
    is_boundary = b.logical_or(is_left, is_right)
    un0 = b.access(un, [0])
    up0 = b.access(up, [0])
    f_boundary = b.sub(un0, up0)
    um1 = b.access(un, [-1])
    up1 = b.access(un, [1])
    lap = b.mul(b.constant(100.0, F64), b.add(b.sub(um1, b.mul(b.constant(2.0, F64), un0)), up1))
    react = b.sub(un0, b.mul(b.mul(un0, un0), un0))
    rhs = b.add(b.mul(b.constant(1e-2, F64), lap), react)
    f_interior = b.sub(b.sub(un0, up0), b.mul(b.constant(1e-2, F64), rhs))
    b.yield_(b.select(is_boundary, f_boundary, f_interior))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    _time_step_entry(b, n, 1e-2, 1, residual="ac_residual", solver="newton", tol=1e-10,
                     max_iters=20)
    return b.module


def the_apply(module: Module) -> Operation:
    """The single apply op of a module built here."""
    (op,) = [op for op in module.walk() if op.name == "neptune.apply"]
    return op
