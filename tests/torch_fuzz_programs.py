"""Random stencil programs for differential fuzzing, in either package's IR.

The generators of `tests/test_fuzz.py`, ported, and two more sized for the
port's kernels. Each takes the IR namespace to build in (`neptune_tpu.ir`
or `neptune_tpu_torch.ir`, whose builders share one API) and a NumPy
Generator, and draws from it in the same order in either package, so one
seed builds the same program in both. This module imports neither
package: the GPU tests, which import no JAX, use it too.

  * `random_opdef`: rank 1-3 f64 opdefs of random offsets, bounds, lower
    bounds, inputs and scalar DAGs (test_fuzz.py's);
  * `periodic_opdef`, `multisweep_opdef`, `two_level_opdef`: its periodic,
    K-sweep and two-level-window programs;
  * `kernel_opdef`: an f32 rank-2/3 apply for kernels A and C, bounded or
    periodic, with a dim-0 reach h0, one or two inputs, and bodies of add,
    sub, mul, div, min, max, select, constants and index casts (tanh only
    when asked), bounded so that K sweeps stay finite;
  * `chain_opdef`: a two-stage f32 chain for kernel D;
  * `with_main`: an exported @main calling one opdef (what the native
    runtime compiles);
  * `same_bits`: the bitwise comparison the kernels are held to.
"""

from __future__ import annotations

import numpy as np


def with_main(ir, module, name: str, main: str = "main"):
    """Add @main(args) = apply_nonlinear(@name, args) to `module`."""
    b = ir.NeptuneBuilder(module)
    fn = module.lookup(name)
    entry = b.make_function(main, "func", list(fn.ftype.inputs), list(fn.ftype.results))
    b.push_block(entry.body)
    b.return_([b.apply_nonlinear(name, list(entry.body.args))])
    b.pop_block()
    return module


def random_opdef(ir, rng: np.random.Generator, case: int, module=None):
    """test_fuzz.py's random nonlinear f64 opdef @fuzz_{case}; returns
    (module, name, shape, n_in). module: build into this one (several
    programs in one native library)."""
    rank = int(rng.integers(1, 4))
    shape = tuple(int(rng.integers(8, 20)) for _ in range(rank))
    lb = tuple(int(rng.integers(0, 3)) for _ in range(rank))
    bounds = ir.Bounds.of(lb, tuple(lo + s for lo, s in zip(lb, shape)))
    n_in = int(rng.integers(1, 3))
    tt = ir.TempType("float64", bounds)

    # random offsets with |o| <= 2, plus the center
    n_off = int(rng.integers(1, 5))
    offsets = [tuple(int(rng.integers(-2, 3)) for _ in range(rank)) for _ in range(n_off)]
    offsets.append((0,) * rank)
    halo = [max(abs(o[d]) for o in offsets) for d in range(rank)]
    interior = ir.Bounds.of(
        tuple(lo + h for lo, h in zip(bounds.lb, halo)),
        tuple(u - h for u, h in zip(bounds.ub, halo)),
    )

    b = ir.NeptuneBuilder(module)
    name = f"fuzz_{case}"
    fn = b.make_opdef(name, "nonlinear_opdef", [tt] * n_in, [tt])
    b.push_block(fn.body)
    op, body = b.start_apply(list(fn.body.args), interior)
    b.push_block(body)

    # leaf pool: accesses + constants + index casts
    pool = []
    for off in offsets:
        k = int(rng.integers(0, n_in))
        pool.append(b.access(body.args[rank + k], off))
    for _ in range(2):
        pool.append(b.constant(float(rng.uniform(-2, 2)), ir.F64))
    pool.append(b.cast(body.args[int(rng.integers(0, rank))], ir.F64))

    # random DAG of whitelisted scalar ops
    for _ in range(int(rng.integers(2, 8))):
        kind = rng.choice(["add", "sub", "mul", "div", "min", "max", "sel", "tanh"])
        a = pool[int(rng.integers(0, len(pool)))]
        c = pool[int(rng.integers(0, len(pool)))]
        if kind == "add":
            v = b.add(a, c)
        elif kind == "sub":
            v = b.sub(a, c)
        elif kind == "mul":
            v = b.mul(b.unary_math("tanh", a), b.unary_math("tanh", c))
        elif kind == "div":
            v = b.div(a, b.constant(float(rng.uniform(1.0, 3.0)), ir.F64))
        elif kind == "min":
            v = b.minimum(a, c)
        elif kind == "max":
            v = b.maximum(a, c)
        elif kind == "sel":
            iv = body.args[int(rng.integers(0, rank))]
            cond = b.cmp("lt", iv, b.constant(int(rng.integers(1, 12)), iv.type))
            v = b.select(cond, a, c)
        else:
            v = b.unary_math("tanh", a)
        pool.append(v)

    b.yield_(pool[-1])
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return b.module, name, shape, n_in


def periodic_opdef(ir, rng: np.random.Generator, name: str = "p", module=None):
    """test_fuzz.py's periodic program: @name(u), a sum of three random
    offsets times constants over the whole torus, rank 1 or 2, f64;
    returns (module, shape)."""
    rank = int(rng.integers(1, 3))
    shape = tuple(int(rng.integers(8, 16)) for _ in range(rank))
    bounds = ir.Bounds.of((0,) * rank, shape)
    tt = ir.TempType("float64", bounds)
    offsets = [tuple(int(rng.integers(-2, 3)) for _ in range(rank)) for _ in range(3)]

    b = ir.NeptuneBuilder(module)
    fn = b.make_opdef(name, "nonlinear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0]], bounds, periodic=True)
    b.push_block(body)
    acc = None
    for off in offsets:
        t = b.mul(b.access(body.args[rank], off), b.constant(float(rng.uniform(-1, 1)), ir.F64))
        acc = t if acc is None else b.add(acc, t)
    b.yield_(acc)
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return b.module, shape


def _tanh_sum(ir, b, u, offsets, rng, lo=-0.3, hi=0.3):
    acc = None
    for off in offsets:
        t = b.mul(b.unary_math("tanh", b.access(u, off)),
                  b.constant(float(rng.uniform(lo, hi)), ir.F32))
        acc = t if acc is None else b.add(acc, t)
    return acc


def _one_input_opdef(ir, name, tt, interior, body_of):
    b = ir.NeptuneBuilder()
    fn = b.make_opdef(name, "nonlinear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0]], interior)
    b.push_block(body)
    b.yield_(body_of(b, body.args[tt.bounds.rank]))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return b.module


def multisweep_opdef(ir, rng: np.random.Generator):
    """test_fuzz.py's K-sweep program: @ms(u) = sum of tanh(u[o]) c_o over
    2-4 random offsets and the centre, f32, rank 2, a dim-0 reach of at
    least 1; returns (module, shape, k, halo)."""
    n0 = int(rng.choice([64, 96, 128]))
    n1 = int(rng.choice([128, 256]))
    k = int(rng.integers(2, 9))
    bounds = ir.Bounds.of((0, 0), (n0, n1))
    tt = ir.TempType("float32", bounds)
    n_off = int(rng.integers(2, 5))
    offsets = [
        (int(rng.integers(-2, 3)), int(rng.integers(-2, 3))) for _ in range(n_off)
    ] + [(0, 0)]
    h = [max(abs(o[d]) for o in offsets) for d in (0, 1)]
    if h[0] == 0:
        offsets.append((1, 0))
        h[0] = 1
    interior = ir.Bounds.of((h[0], h[1]), (n0 - h[0], n1 - h[1]))
    module = _one_input_opdef(ir, "ms", tt, interior,
                              lambda b, u: _tanh_sum(ir, b, u, offsets, rng))
    return module, (n0, n1), k, h


def two_level_opdef(ir, rng: np.random.Generator):
    """test_fuzz.py's two-level-window program: @tl(u), as `multisweep_opdef`
    on 128-256 x 1024-2048 grids with 4-9 sweeps; returns (module, shape,
    k, halo, VMEM budget in bytes). The JAX package shrinks its window
    budget to that many bytes to force the two-level window; the port's
    kernel C has no such budget and takes the program as it is."""
    n0 = int(rng.choice([128, 256]))
    n1 = int(rng.choice([1024, 1536, 2048]))
    k = int(rng.integers(4, 10))
    bounds = ir.Bounds.of((0, 0), (n0, n1))
    tt = ir.TempType("float32", bounds)
    n_off = int(rng.integers(2, 5))
    offsets = [
        (int(rng.integers(-2, 3)), int(rng.integers(-2, 3))) for _ in range(n_off)
    ] + [(0, 0), (1, 0)]
    h = [max(abs(o[d]) for o in offsets) for d in (0, 1)]
    interior = ir.Bounds.of((h[0], h[1]), (n0 - h[0], n1 - h[1]))
    module = _one_input_opdef(ir, "tl", tt, interior,
                              lambda b, u: _tanh_sum(ir, b, u, offsets, rng))
    budget = int(rng.choice([900, 1400, 1900])) * 1024
    return module, (n0, n1), k, h, budget


# the scalar operations of a kernel program's body
KERNEL_OPS = ("add", "sub", "mul", "div", "min", "max", "sel")


def _offsets(rng, rank: int, h0: int, n: int) -> list:
    """n random offsets, dim 0 within h0 and the others within 2, the
    centre, and (h0 > 0) one offset that reaches h0 down dim 0."""
    offs = [
        tuple([int(rng.integers(-h0, h0 + 1))] + [int(rng.integers(-2, 3)) for _ in range(rank - 1)])
        for _ in range(n)
    ]
    offs.append((0,) * rank)
    if h0 and not any(abs(o[0]) == h0 for o in offs):
        offs.append(tuple([h0 if rng.integers(0, 2) else -h0] + [0] * (rank - 1)))
    return offs


def _kernel_body(ir, b, rng, rank, ins, iv, offsets, n_ops: int, tanh: bool, bounded: bool):
    """A random scalar DAG over accesses of `ins` at `offsets`, two
    constants and an index cast. bounded: every product has a factor in
    [-1, 1] and the result is clamped to [-4, 4], so that K sweeps stay
    finite."""
    pool = []
    for off in offsets:
        pool.append(b.access(ins[int(rng.integers(0, len(ins)))], off))
    for _ in range(2):
        pool.append(b.constant(float(rng.uniform(-2, 2)), ir.F32))
    d = int(rng.integers(0, rank))
    cast = b.cast(iv[d], ir.F32)
    pool.append(b.mul(cast, b.constant(1.0 / 64, ir.F32)) if bounded else cast)
    kinds = KERNEL_OPS + (("tanh",) if tanh else ())
    for _ in range(n_ops):
        kind = kinds[int(rng.integers(0, len(kinds)))]
        a = pool[int(rng.integers(0, len(pool)))]
        c = pool[int(rng.integers(0, len(pool)))]
        if kind == "add":
            v = b.add(a, c)
        elif kind == "sub":
            v = b.sub(a, c)
        elif kind == "mul":
            if bounded:
                c = b.constant(float(rng.uniform(-1, 1)), ir.F32)
            v = b.mul(a, c)
        elif kind == "div":
            v = b.div(a, b.constant(float(rng.uniform(1.0, 3.0)), ir.F32))
        elif kind == "min":
            v = b.minimum(a, c)
        elif kind == "max":
            v = b.maximum(a, c)
        elif kind == "sel":
            dd = int(rng.integers(0, rank))
            cond = b.cmp("lt", iv[dd], b.constant(int(rng.integers(1, 40)), iv[dd].type))
            v = b.select(cond, a, c)
        else:
            v = b.unary_math("tanh", a)
        pool.append(v)
    out = pool[-1]
    if bounded:
        out = b.minimum(b.maximum(out, b.constant(-4.0, ir.F32)), b.constant(4.0, ir.F32))
    return out


def kernel_opdef(ir, rng: np.random.Generator, shape, *, periodic=False, h0=1, n_in=1,
                 tanh=False, bounded=False, name="kf"):
    """An f32 program for kernels A and C: @name(u[, v]) of one apply of a
    random body (`_kernel_body`) over the interior, or the whole torus when
    periodic, with a dim-0 reach of h0 and up to 2 in the other dims.
    bounded: a body K sweeps keep finite (kernel C). Returns the module."""
    rank = len(shape)
    outer = ir.Bounds.of((0,) * rank, tuple(shape))
    tt = ir.TempType("float32", outer)
    offsets = _offsets(rng, rank, h0, int(rng.integers(2, 6)))
    if periodic:
        bounds = outer
    else:
        halo = [max(abs(o[d]) for o in offsets) for d in range(rank)]
        bounds = ir.Bounds.of(tuple(halo), tuple(n - h for n, h in zip(shape, halo)))
    n_ops = int(rng.integers(3, 9))
    b = ir.NeptuneBuilder()
    fn = b.make_opdef(name, "nonlinear_opdef", [tt] * n_in, [tt])
    b.push_block(fn.body)
    op, body = b.start_apply(list(fn.body.args), bounds, periodic=periodic)
    b.push_block(body)
    ins = [body.args[rank + k] for k in range(n_in)]
    b.yield_(_kernel_body(ir, b, rng, rank, ins, body.args[:rank], offsets, n_ops, tanh, bounded))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return b.module


def chain_opdef(ir, rng: np.random.Generator, shape, *, n_in=1, tanh=False, name="kd"):
    """A two-stage f32 chain for kernel D: @name(u[, v]) = s2(s1(u[, v]), u),
    each stage one apply of a random body over the interior its reach
    leaves, the second reading the first's result and u. Returns the
    module."""
    rank = len(shape)
    outer = ir.Bounds.of((0,) * rank, tuple(shape))
    tt = ir.TempType("float32", outer)
    b = ir.NeptuneBuilder()
    fn = b.make_opdef(name, "nonlinear_opdef", [tt] * n_in, [tt])
    b.push_block(fn.body)
    args = list(fn.body.args)
    prev = None
    for stage in range(2):
        srcs = args if stage == 0 else [prev, args[0]]
        offsets = _offsets(rng, rank, int(rng.integers(0, 3)), int(rng.integers(2, 5)))
        halo = [max(abs(o[d]) for o in offsets) for d in range(rank)]
        bounds = ir.Bounds.of(tuple(halo), tuple(n - h for n, h in zip(shape, halo)))
        op, body = b.start_apply(srcs, bounds)
        b.push_block(body)
        ins = [body.args[rank + k] for k in range(len(srcs))]
        n_ops = int(rng.integers(3, 8))
        b.yield_(_kernel_body(ir, b, rng, rank, ins, body.args[:rank], offsets, n_ops, tanh,
                              False))
        b.pop_block()
        prev = b.finish_apply(op)
    b.return_([prev])
    b.pop_block()
    return b.module


def same_bits(got, ref) -> bool:
    """Two f32 tensors bit for bit, NaN where the other is NaN."""
    import torch

    nan = torch.isnan(ref)
    return torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), ref[~nan].view(torch.int32))
