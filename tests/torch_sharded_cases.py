"""Programs, inputs and cases of the port's multi-process sharded tests.

Imported by `test_torch_sharded.py` (the parent, which computes the JAX
package's references) and by `torch_sharded_worker.py` (one spawned
process per mesh position). It imports the port only: the same printed IR
is parsed by the JAX package in the parent.
"""

from __future__ import annotations

import numpy as np

from neptune_tpu_torch import stencils
from neptune_tpu_torch.ir import BF16, F32, F64, Bounds, NeptuneBuilder, TempType
from neptune_tpu_torch.ir import verify_and_annotate

_S = {"float32": F32, "float64": F64, "bfloat16": BF16}

MESHES = [(4, 1), (2, 2), (1, 4)]
AXES = ("x", "y")


def _lap(b: NeptuneBuilder, tt: TempType) -> None:
    """@lap(u) = 4 u - (the 4 neighbours) on the interior."""
    S = _S[tt.element]
    n0, n1 = tt.bounds.shape
    fn = b.make_opdef("lap", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, blk = b.start_apply([fn.body.args[0]], Bounds.of([1, 1], [n0 - 1, n1 - 1]))
    b.push_block(blk)
    u = blk.args[2]
    acc = b.mul(b.constant(4.0, S), b.access(u, [0, 0]))
    for o in ([-1, 0], [1, 0], [0, -1], [0, 1]):
        acc = b.sub(acc, b.access(u, o))
    b.yield_(acc)
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()


def composite(shape, dtype="float64"):
    """@wrapped(u) = u + 0.01 lap(lap(u)) over the whole grid."""
    b = NeptuneBuilder()
    tt = TempType(dtype, Bounds.of([0, 0], list(shape)))
    _lap(b, tt)
    fn = b.make_opdef("wrapped", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    x = fn.body.args[0]
    lap2 = b.apply_linear("lap", [b.apply_linear("lap", [x])])
    op, blk = b.start_apply([x, lap2], tt.bounds)
    b.push_block(blk)
    x0 = b.access(blk.args[2], [0, 0])
    l0 = b.access(blk.args[3], [0, 0])
    b.yield_(b.add(x0, b.mul(b.constant(0.01, _S[dtype]), l0)))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return verify_and_annotate(b.module)


def two_fields(shape, dtype="float64"):
    """@mix(u, v, a) = a u[1,0] - u[-1,0] + v[0,1] - 0.5 v[0,-1] on the
    interior: a single apply of two fields and a trailing scalar arg."""
    S = _S[dtype]
    b = NeptuneBuilder()
    n0, n1 = shape
    tt = TempType(dtype, Bounds.of([0, 0], [n0, n1]))
    fn = b.make_opdef("mix", "nonlinear_opdef", [tt, tt, S], [tt])
    b.push_block(fn.body)
    u, v, a = fn.body.args
    op, blk = b.start_apply([u, v], Bounds.of([1, 1], [n0 - 1, n1 - 1]), scalar_params=[a])
    b.push_block(blk)
    bu, bv, ba = blk.args[2:5]
    t = b.sub(b.mul(ba, b.access(bu, [1, 0])), b.access(bu, [-1, 0]))
    t = b.add(t, b.access(bv, [0, 1]))
    b.yield_(b.sub(t, b.mul(b.constant(0.5, S), b.access(bv, [0, -1]))))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return verify_and_annotate(b.module)


def edge_reader(shape, dtype="float64"):
    """@edge(u) = u[1,0] - u[-1,0] + 2 u[0,1] - u[0,-2] over the whole grid,
    bounded: its edge cells read the zero-filled ghosts beyond the domain."""
    S = _S[dtype]
    b = NeptuneBuilder()
    tt = TempType(dtype, Bounds.of([0, 0], list(shape)))
    fn = b.make_opdef("edge", "nonlinear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, blk = b.start_apply([fn.body.args[0]], tt.bounds)
    b.push_block(blk)
    u = blk.args[2]
    t = b.sub(b.access(u, [1, 0]), b.access(u, [-1, 0]))
    t = b.add(t, b.mul(b.constant(2.0, S), b.access(u, [0, 1])))
    b.yield_(b.sub(t, b.access(u, [0, -2])))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return verify_and_annotate(b.module)


# name -> (module builder, opdef, field count, trailing scalars, backend)
OPDEFS = {
    "jacobi5_f64": (lambda: stencils.jacobi5((32, 32), "float64"), "jacobi", 1, (), "auto"),
    "jacobi5_f32": (lambda: stencils.jacobi5((32, 32)), "jacobi", 1, (), "auto"),
    "heat7_f64": (lambda: stencils.heat7((16, 16, 8), "float64"), "heat", 1, (), "auto"),
    "edge_reader_f64": (lambda: edge_reader((32, 32)), "edge", 1, (), "auto"),
    "edge_reader_f32": (lambda: edge_reader((32, 32), "float32"), "edge", 1, (), "auto"),
    "adv4_torus_f64": (
        lambda: stencils.advection4((32, 32), "float64", periodic=True), "adv4", 1, (), "auto"
    ),
    "two_fields_scalar_f64": (lambda: two_fields((32, 32)), "mix", 2, (0.7,), "auto"),
    "composite_f64": (lambda: composite((32, 32)), "wrapped", 1, (), "auto"),
    "composite_f32": (lambda: stencils.composite((32, 32)), "wrapped", 1, (), "auto"),
    # "cuda" keeps torus ops off the fused route (the JAX package's
    # "pallas"): the extended-block route, with kernel A's window form
    "adv4_torus_ext_f32": (
        lambda: stencils.advection4((32, 32), periodic=True), "adv4", 1, (), "cuda"
    ),
}

# name -> (module builder, opdef, k)
SWEEPS = {
    "edge_reader_k2_f64": (lambda: edge_reader((32, 32)), "edge", 2),
    "jacobi5_k1_f64": (lambda: stencils.jacobi5((32, 32), "float64"), "jacobi", 1),
    "jacobi5_k2_f64": (lambda: stencils.jacobi5((32, 32), "float64"), "jacobi", 2),
    "jacobi5_k4_f64": (lambda: stencils.jacobi5((32, 32), "float64"), "jacobi", 4),
    "jacobi5_k4_f32": (lambda: stencils.jacobi5((32, 32)), "jacobi", 4),
}


def inputs(module, name, seed: int = 0):
    """Seeded global arrays for the opdef's field args."""
    fn = module.lookup(name)
    rng = np.random.default_rng(seed)
    out = []
    for t in fn.ftype.inputs:
        if isinstance(t, TempType):
            out.append(rng.standard_normal(t.bounds.shape).astype(t.element))
    return out


def solver_system():
    """@heat_A = I - 0.1 lap on a 32^2 f64 grid (copy-through ring), and
    its seeded right-hand side."""
    from neptune_tpu_torch import entry

    cm = entry.build_step(32, "float64", device="cpu")
    b = np.random.default_rng(5).standard_normal((32, 32))
    return cm.module, "heat_A", b


SOLVERS = {"cg": 1e-10, "gmres": 1e-10}
