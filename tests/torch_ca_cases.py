"""Operators, inputs and cases of the port's multi-process CA-solver and
`sharded_function` tests.

Imported by `test_torch_ca.py` / `test_torch_sharded_function.py` (the
parents, which compute the JAX package's references) and by
`torch_ca_worker.py` (one spawned process per mesh position). It imports
the port only: the parent parses the same printed IR with the JAX package.
"""

from __future__ import annotations

import numpy as np

from neptune_tpu_torch import stencils
from neptune_tpu_torch.ir import (
    F32,
    F64,
    Bounds,
    FieldType,
    NeptuneBuilder,
    TempType,
    TensorType,
    verify_and_annotate,
)

AXES = ("x", "y", "z")


def stencil_op(name, shape, center, terms, dtype="float64", ring=1):
    """@name(u) = center u - sum c_o u[o] over terms (o, c_o), on the
    interior `ring` cells in from every edge (a copy-through ring)."""
    S = F64 if dtype == "float64" else F32
    rank = len(shape)
    b = NeptuneBuilder()
    tt = TempType(dtype, Bounds.of([0] * rank, list(shape)))
    fn = b.make_opdef(name, "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, blk = b.start_apply([fn.body.args[0]], Bounds.of([ring] * rank, [n - ring for n in shape]))
    b.push_block(blk)
    u = blk.args[rank]
    acc = b.mul(b.constant(center, S), b.access(u, [0] * rank))
    for o, c in terms:
        v = b.access(u, list(o))
        acc = b.sub(acc, v if c == 1.0 else b.mul(b.constant(c, S), v))
    b.yield_(acc)
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return verify_and_annotate(b.module)


def lap1(n, dtype="float64"):
    """@lap: 2 u - u[-1] - u[1] on the interior of an n grid."""
    return stencil_op("lap", (n,), 2.0, [((-1,), 1.0), ((1,), 1.0)], dtype)


def advdiff(n, c=0.3, dtype="float64"):
    """@lap: the nonsymmetric 5-pt Laplacian + upwind advection in dim 0
    of the JAX package's CA-BiCGStab tests."""
    terms = [((-1, 0), 1.0 + c), ((1, 0), 1.0), ((0, -1), 1.0), ((0, 1), 1.0)]
    return stencil_op("lap", (n, n), 4.0 + c, terms, dtype)


# operator name -> (module builder, opdef, its diagonal inside the ring)
OPERATORS = {
    "poisson64": (lambda: stencils.poisson5(64, "float64"), "poisson", 4.0),
    "poisson32": (lambda: stencils.poisson5(32, "float64"), "poisson", 4.0),
    "advdiff64": (lambda: advdiff(64), "lap", 4.3),
    "lap1_128": (lambda: lap1(128), "lap", 2.0),
    "poisson7_16": (lambda: stencils.poisson7(16, "float64"), "poisson", 6.0),
}


def rhs(module, opdef, seed):
    """A seeded rhs, zero on the copy-through ring."""
    shape = module.lookup(opdef).ftype.inputs[0].bounds.shape
    b = np.zeros(shape)
    inner = tuple(slice(1, n - 1) for n in shape)
    b[inner] = np.random.default_rng(seed).standard_normal(tuple(n - 2 for n in shape))
    return b


def jacobi_inv_diag(module, opdef, centre):
    """1/diag: 1/centre inside the ring, 1 on it."""
    shape = module.lookup(opdef).ftype.inputs[0].bounds.shape
    d = np.ones(shape)
    d[tuple(slice(1, n - 1) for n in shape)] = 1.0 / centre
    return d


def lam_min(n, rank=2):
    """The smallest eigenvalue of the Dirichlet Laplacian on an n grid."""
    return rank * (2.0 - 2.0 * np.cos(np.pi / (n + 1)))


LAM = dict(lam_min=0.01, lam_max=8.0)

# fixed-iteration cases (tol=0, f64): name -> (operator, mesh, solver,
# keyword arguments, jacobi, rhs seed)
FIXED = {
    "cg_mono_22": ("poisson64", (2, 2), "cg", dict(s=4, maxiter=40), False, 0),
    "cg_mono_41": ("poisson64", (4, 1), "cg", dict(s=4, maxiter=40), False, 0),
    "cg_cheb_22": ("poisson64", (2, 2), "cg", dict(s=6, maxiter=30, basis="chebyshev", **LAM), False, 3),
    "cg_cheb_41": ("poisson64", (4, 1), "cg", dict(s=6, maxiter=30, basis="chebyshev", **LAM), False, 3),
    "cg_jacobi_22": ("poisson64", (2, 2), "cg", dict(s=4, maxiter=32), True, 2),
    "cg_jacobi_41": ("poisson64", (4, 1), "cg", dict(s=4, maxiter=32), True, 2),
    # monomial GMRES at s=4: at s=6 the JAX package's own x differs by
    # 1.7e-10 relative between the (2,2) and (1,4) meshes (kappa(V)^2
    # amplifies the Gram's summation order), above this file's 1e-10
    "gmres_mono_22": ("poisson64", (2, 2), "gmres", dict(s=4, maxiter=36), False, 1),
    "gmres_mono_41": ("poisson64", (4, 1), "gmres", dict(s=4, maxiter=36), False, 1),
    "gmres_cheb_22": ("poisson64", (2, 2), "gmres", dict(s=6, maxiter=36, basis="chebyshev", **LAM), False, 4),
    "gmres_cheb_41": ("poisson64", (4, 1), "gmres", dict(s=6, maxiter=36, basis="chebyshev", **LAM), False, 4),
    "gmres_jacobi_22": ("poisson64", (2, 2), "gmres", dict(s=6, maxiter=36), True, 5),
    "gmres_jacobi_41": ("poisson64", (4, 1), "gmres", dict(s=6, maxiter=36), True, 5),
    # BiCGStab at 10 iterations: at 20 the JAX package's own x differs by
    # 4.7e-9 relative between the (2,2) and (1,4) meshes
    "bicgstab_s2_22": ("advdiff64", (2, 2), "bicgstab", dict(s=2, maxiter=10), False, 6),
    "bicgstab_s2_41": ("advdiff64", (4, 1), "bicgstab", dict(s=2, maxiter=10), False, 6),
    "cheb_k4_22": ("poisson64", (2, 2), "chebyshev", dict(k_fuse=4, maxiter=33, lam_min=lam_min(64), lam_max=8.0), False, 7),
    "cheb_k8_41": ("poisson64", (4, 1), "chebyshev", dict(k_fuse=8, maxiter=33, lam_min=lam_min(64), lam_max=8.0), False, 7),
    "cheb_k8_check_22": (
        "poisson64", (2, 2), "chebyshev",
        dict(k_fuse=8, maxiter=49, check_every=2, lam_min=lam_min(64), lam_max=8.0), False, 7,
    ),
    "cheb_k4_jacobi_22": (
        "poisson64", (2, 2), "chebyshev", dict(k_fuse=4, maxiter=25, lam_min=lam_min(64) / 4, lam_max=2.0), True, 8,
    ),
    "cg_rank1_4": ("lap1_128", (4,), "cg", dict(s=3, maxiter=36), False, 4),
    "cg_rank1_22": ("lap1_128", (2, 2), "cg", dict(s=3, maxiter=36), False, 4),
    "cheb_rank1_22": ("lap1_128", (2, 2), "chebyshev", dict(k_fuse=4, maxiter=25, lam_min=lam_min(128, 1), lam_max=4.0), False, 4),
    "cg_rank3_221": ("poisson7_16", (2, 2, 1), "cg", dict(s=4, maxiter=24), False, 5),
}

# converged cases: name -> (operator, mesh, solver, keyword arguments, rhs seed)
CONVERGED = {
    "cg_22": ("poisson64", (2, 2), "cg", dict(s=5, maxiter=4000, tol=1e-9), 1),
    "gmres_cheb_41": ("poisson32", (4, 1), "gmres", dict(s=3, maxiter=4000, tol=1e-9, basis="chebyshev", **LAM), 2),
    # BiCGStab to 1e-5: to 1e-9 the JAX package itself takes 141, 114 and
    # 131 iterations on the (2,2), (4,1) and (1,4) meshes (its breakdown
    # restarts amplify roundoff); to 1e-5 it takes 80, 80 and 81
    "bicgstab_22": ("advdiff64", (2, 2), "bicgstab", dict(s=2, maxiter=400, tol=1e-5), 2),
    "cheb_check_22": (
        "poisson32", (2, 2), "chebyshev",
        dict(k_fuse=8, maxiter=2000, tol=1e-8, check_every=2, lam_min=lam_min(32), lam_max=8.0), 3,
    ),
}

# per-iteration oracle inside the port: CA-CG at fixed iterations against
# krylov.cg over shardmap_opdef with the mesh's group
ORACLE = {"cg_mono_22": "poisson64", "cg_mono_41": "poisson64"}

# the communication counts: CA-CG s=8 against per-iteration CG, 96
# iterations of the 64^2 operator on (2,2)
COMM = dict(operator="poisson64", mesh=(2, 2), s=8, iters=96)


# ---- sharded_function -------------------------------------------------------


def reach2_jacobi(n=32):
    """@wide: 2 u - 0.2 (the 4 neighbours at 1) - 0.05 (the 4 at 2), ring 2
    deep, with @solve: six iterations of GMRES + Jacobi (not converged, so
    x depends on the preconditioner). The probe period is 3, which a block
    start of 16 is no multiple of: the diagonal is only right when the
    probes follow the global lattice."""
    terms = [((-1, 0), 0.2), ((1, 0), 0.2), ((0, -1), 0.2), ((0, 1), 0.2)]
    terms += [((-2, 0), 0.05), ((2, 0), 0.05), ((0, -2), 0.05), ((0, 2), 0.05)]
    module = stencil_op("wide", (n, n), 2.0, terms, ring=2)
    return stencils.with_solve(
        module, "wide", solver="gmres", tol=1e-14, max_iters=6, precond="jacobi"
    )


def stats_program(n=32):
    """@stats(u): a 5-pt average stored into the field on a sub-box, and the
    five reductions of it over that box: bounded stores and reduces on
    blocks, in global coordinates."""
    b = NeptuneBuilder()
    bounds = Bounds.of([0, 0], [n, n])
    box = Bounds.of([3, 5], [n - 2, n - 7])
    fn = b.make_function("stats", "func", [TensorType("float64", (n, n))],
                         [TensorType("float64", (n, n))] + [F64] * 5)
    b.push_block(fn.body)
    f = b.wrap(fn.body.args[0], FieldType("float64", bounds))
    op, blk = b.start_apply([b.load(f)], Bounds.of([1, 1], [n - 1, n - 1]))
    b.push_block(blk)
    u = blk.args[2]
    acc = b.access(u, [0, 0])
    for o in ([-1, 0], [1, 0], [0, -1], [0, 1]):
        acc = b.add(acc, b.access(u, o))
    b.yield_(b.mul(b.constant(0.2, F64), acc))
    b.pop_block()
    v = b.finish_apply(op)
    b.store(v, f, bounds=box)
    outs = [b.unwrap(f)] + [b.reduce(v, k, bounds=box) for k in ("sum", "l1", "l2", "max", "min")]
    b.return_(outs)
    b.pop_block()
    return verify_and_annotate(b.module)


def function_module(kind):
    """(pipeline-compiled port module, function name, its grid arguments'
    seeded global arrays) for each `sharded_function` program but the
    Allen-Cahn one, which the parent prints from the JAX package's
    builder."""
    from neptune_tpu_torch import entry
    from neptune_tpu_torch.passes import run_pipeline

    rng = np.random.default_rng(11)
    if kind == "step32":
        return entry.build_step(32, "float64", device="cpu").module, "step", [
            rng.standard_normal((32, 32))]
    if kind == "step3d16":
        return entry.build_step_3d(16, "float64", device="cpu").module, "step3d", [
            rng.standard_normal((16, 16, 16))]
    if kind == "wide32":
        return run_pipeline(reach2_jacobi()).module, "solve", [rhs_ring(32, rng)]
    if kind == "stats32":
        return run_pipeline(stats_program()).module, "stats", [rng.standard_normal((32, 32))]
    if kind in MG_PROGRAMS or kind in SOLVE_PROGRAMS:
        solve = dict(MG_PROGRAMS.get(kind) or SOLVE_PROGRAMS[kind])
        n = solve.pop("n", 32)
        module = stencils.with_solve(stencils.poisson5(n, "float64"), "poisson", **solve)
        return run_pipeline(module).module, "solve", [rhs_ring(n, rng)]
    if kind in SHAPE_PROGRAMS:
        build, fname, shape = SHAPE_PROGRAMS[kind]
        return run_pipeline(build()).module, fname, [rng.standard_normal(shape)]
    if kind.startswith("ac2d_"):
        # a smooth state: 0.8 sin(pi x) sin(pi y) plus seeded noise
        x = np.linspace(0.0, 1.0, 32)
        u0 = 0.8 * np.outer(np.sin(np.pi * x), np.sin(np.pi * x))
        u0 = u0 + 0.05 * rng.standard_normal((32, 32))
        fname = kind[len("ac2d_"):]
        module = allen_cahn_2d()
        # solve_nonlinear runs as written; "step"'s time_advance is
        # interpreted by the executor, not lowered by the pipeline
        return module, fname, [u0]
    raise KeyError(kind)


# the solve_linear programs of the mesh-aware V-cycle and Chebyshev: kind ->
# solve_linear keywords (32^2 f64 Poisson, rhs with ring values)
MG_PROGRAMS = {
    "mg32": dict(solver="cg", tol=1e-10, max_iters=50, precond="mg"),
    "mg32_cheb": dict(solver="cg", tol=1e-10, max_iters=50, precond="mg",
                      options={"mg_smoother": "cheb"}),
    "cheb32_jacobi": dict(solver="chebyshev", tol=1e-9, max_iters=600, precond="jacobi",
                          options={"check_every": 10}),
    "cheb32_bounds": dict(solver="chebyshev", tol=1e-12, max_iters=97,
                          options={"lam_min": float(lam_min(32)), "lam_max": 8.0}),
}


# the solves that the mesh view runs on the whole grid's dense matrix, on
# red-black blocks, or by f64 refinement of f32 solves: kind -> solve_linear
# keywords (f64 Poisson, 32^2 unless "n" says otherwise; verbose, so that
# both packages print their KSP lines)
SOLVE_PROGRAMS = {
    # 34^2 on (2,2) and 36^2 on (4,1): blocks of 17 and 9 rows start at odd
    # global indices, where block-local colours and probes would be wrong
    "ssor34": dict(n=34, solver="cg", tol=1e-10, max_iters=200, precond="ssor", verbose=True),
    "ssor36": dict(n=36, solver="cg", tol=1e-10, max_iters=200, precond="ssor", verbose=True),
    "ssor_dense32": dict(solver="cg", tol=1e-10, max_iters=200, precond="ssor_dense",
                         verbose=True),
    "direct32": dict(solver="direct", verbose=True),
    # refined to 1e-13: the two packages' f32 inner solves round apart, so
    # their x agree only to about cond(A) tol (2.3e-10 apart at tol 1e-10)
    "mixed32": dict(solver="cg", tol=1e-13, max_iters=200, precision="mixed", verbose=True),
    "mixed_ssor36": dict(n=36, solver="cg", tol=1e-13, max_iters=200, precision="mixed",
                         precond="ssor", verbose=True),
    # three levels of a 36^2 grid: level 1 is 18^2, in blocks of 9 on (2,2),
    # so levels 1-2 run on the whole grid; on (4,1) level 0's blocks are 9
    # rows already, so the whole cycle does
    "mg_odd36": dict(n=36, solver="cg", tol=1e-10, max_iters=50, precond="mg",
                     options={"mg_levels": 3}, verbose=True),
}


def rhs_ring(n, rng):
    """A seeded rhs with nonzero ring values (what CG's Dirichlet lift
    handles)."""
    return rng.standard_normal((n, n))


def allen_cahn_2d(n=32, dt=0.05, k=5.0):
    """Fully implicit Allen-Cahn on an n^2 f64 grid: @ac_res(u, up) = u - up
    - dt (k lap(u) + u - u^3), u - up on the boundary rows; @ac_jac(v, u,
    up), its Jacobian in the full form; @solve(u0) and @solve_jac(u0):
    solve_nonlinear from u0 with up = u0, without and with jacobian=,
    verbose (their SNES line gives Newton's iterations); @step(u0):
    time_advance(method=implicit_nonlinear). dt k = 0.25 keeps the Jacobian
    I + O(1). Verified, not lowered."""
    b = NeptuneBuilder()
    bounds = Bounds.of([0, 0], [n, n])
    tt = TempType("float64", bounds)
    ft = FieldType("float64", bounds)

    def body_of(name, n_in, interior_of, boundary_of):
        fn = b.make_opdef(name, "nonlinear_opdef", [tt] * n_in, [tt])
        b.push_block(fn.body)
        op, blk = b.start_apply(list(fn.body.args), bounds)
        b.push_block(blk)
        i, j, *fields = blk.args
        edge = None
        for iv in (i, j):
            for e in (0, n - 1):
                c = b.cmp("eq", iv, b.constant(e, iv.type))
                edge = c if edge is None else b.logical_or(edge, c)
        b.yield_(b.select(edge, boundary_of(*fields), interior_of(*fields)))
        b.pop_block()
        b.return_([b.finish_apply(op)])
        b.pop_block()

    def c(v):
        return b.constant(v, F64)

    def lap(u):
        acc = b.mul(c(-4.0), b.access(u, [0, 0]))
        for o in ([-1, 0], [1, 0], [0, -1], [0, 1]):
            acc = b.add(acc, b.access(u, o))
        return acc

    def res_interior(u, up):
        u0 = b.access(u, [0, 0])
        react = b.sub(u0, b.mul(b.mul(u0, u0), u0))
        rhs = b.add(b.mul(c(k), lap(u)), react)
        return b.sub(b.sub(u0, b.access(up, [0, 0])), b.mul(c(dt), rhs))

    def jac_interior(v, u, up):
        v0, u0 = b.access(v, [0, 0]), b.access(u, [0, 0])
        react = b.sub(v0, b.mul(b.mul(c(3.0), b.mul(u0, u0)), v0))
        rhs = b.add(b.mul(c(k), lap(v)), react)
        return b.sub(v0, b.mul(c(dt), rhs))

    body_of("ac_res", 2, res_interior,
            lambda u, up: b.sub(b.access(u, [0, 0]), b.access(up, [0, 0])))
    body_of("ac_jac", 3, jac_interior,
            lambda v, u, up: b.add(b.access(v, [0, 0]), b.mul(c(0.0), b.access(up, [0, 0]))))

    for fname in ("solve", "solve_jac", "step"):
        fn = b.make_function(fname, "func", [TensorType("float64", (n, n))],
                             [TensorType("float64", (n, n))])
        b.push_block(fn.body)
        u0 = b.load(b.wrap(fn.body.args[0], ft))
        if fname == "step":
            out = b.time_advance(u0, dt, 1, residual="ac_res", tol=1e-10, max_iters=20)
        else:
            out = b.solve_nonlinear(
                "ac_res", [u0], captures=[u0], tol=1e-10, max_iters=20, verbose=True,
                jacobian="ac_jac" if fname == "solve_jac" else None,
            )
        b.return_([out])
        b.pop_block()
    return verify_and_annotate(b.module)


# name -> (program, mesh)
FUNCTIONS = {
    "allen_cahn_4": ("allen_cahn", (4,)),
    "step_22": ("step32", (2, 2)),
    "step_41": ("step32", (4, 1)),
    "step3d_22": ("step3d16", (2, 2)),
    "step3d_41": ("step3d16", (4, 1)),
    "wide_22": ("wide32", (2, 2)),
    "wide_41": ("wide32", (4, 1)),
    "stats_22": ("stats32", (2, 2)),
    "stats_14": ("stats32", (1, 4)),
    "mg_22": ("mg32", (2, 2)),
    "mg_41": ("mg32", (4, 1)),
    "mg_cheb_41": ("mg32_cheb", (4, 1)),
    "cheb_jacobi_22": ("cheb32_jacobi", (2, 2)),
    "cheb_bounds_14": ("cheb32_bounds", (1, 4)),
    "newton_22": ("ac2d_solve", (2, 2)),
    "newton_jac_41": ("ac2d_solve_jac", (4, 1)),
    "step_nonlinear_22": ("ac2d_step", (2, 2)),
    "ssor_22": ("ssor34", (2, 2)),
    "ssor_41": ("ssor36", (4, 1)),
    "ssor_dense_22": ("ssor_dense32", (2, 2)),
    "direct_22": ("direct32", (2, 2)),
    "mixed_22": ("mixed32", (2, 2)),
    "mixed_ssor_41": ("mixed_ssor36", (4, 1)),
    "noin_22": ("noin32", (2, 2)),
    "noin_41": ("noin32", (4, 1)),
    "far_22": ("far32", (2, 2)),
    "far_41": ("far32", (4, 1)),
    "far_periodic_41": ("far32_periodic", (4, 1)),
    "stores_22": ("stores32", (2, 2)),
    "stores_14": ("stores32", (1, 4)),
    "mg_odd_22": ("mg_odd36", (2, 2)),
    "mg_odd_41": ("mg_odd36", (4, 1)),
}

# programs that raise on the mesh, as the JAX package's GSPMD
# sharded_function does: name -> (program, mesh, the exception's type, a
# pattern of its message). A 30^2 grid does not split over 4 rows and an
# apply cannot read inputs of another shape.
RAISING = {
    "reshape_22": ("reshape36", (2, 2), "ValueError", "differ from the result"),
    "far30_41": ("far30", (4, 1), "ValueError", "not divisible"),
}


# ---- multigrid over a mesh (test_torch_ca_multigrid.py) ---------------------

MG_SIZES = (128, 64, 32, 16)
MG_NAMES = tuple(f"poisson{n}" for n in MG_SIZES)
MG_MESHES = ((2, 2), (4, 1))


def poisson_hierarchy(nt, sizes=MG_SIZES):
    """The rediscretized 1/h^2-scaled 5-pt f64 Poisson opdefs @poisson{n},
    finest first, as tests/test_multigrid.py builds them, in a fresh context
    of `nt`'s DSL (either package's): their assembled handles."""
    nt.reset_context()

    def make(n):
        inv_h2 = float((n - 1) * (n - 1))

        @nt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
                          dtype="float64", name=f"poisson{n}")
        def op(u):
            return (4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]) * inv_h2

        return op

    return [nt.assemble_matrix(make(n)) for n in sizes]


def wide5(n=64):
    """@wide5: 6 u - the four cells at distance 2, on a ring 2 deep (the JAX
    package's wide-stencil diagonal-probe case)."""
    terms = [((-2, 0), 1.0), ((2, 0), 1.0), ((0, -2), 1.0), ((0, 2), 1.0)]
    return stencil_op("wide5", (n, n), 6.0, terms, ring=2)


# a hierarchy whose blocks on (4,1) turn odd above the coarsest level (18,
# then 9 rows): build_ca_levels smooths level 0 on blocks and runs levels
# 1-3 on the whole grid, replicated on every process
MG_ODD_SIZES = (72, 36, 18, 9)

# the meshes each solve runs on: every solve costs seconds of gloo round
# trips (~1 ms per ring shift or reduction among four CPU processes), so
# each runs where it tests most: red-black multigrid_solve on (2,2); the CA
# cycle against per-matvec smoothing, and Newton, on (4,1), whose coarsest
# level is CA-ineligible
MG_SOLVES = {"rb": ((2, 2),), "pcg": ((2, 2), (4, 1)), "ca": ((4, 1),), "newton": ((4, 1),)}

# the prolongation cases: (rank, coarse shape); a block corner lies inside
# each grid on (2,2), and every block touches the domain edge
PROLONG = {"2d": (2, (32, 32)), "3d": (3, (16, 16, 8))}


# ---- pinned arithmetic over a mesh (test_torch_pinned.py) ------------------
# tests/test_scale_stability.py's systems: the 256^2 f64 5-pt Poisson
# operator, CG to 1e-8 from its rhs, and the f32 4th-order advection
# operator applied 50 times, under pinned arithmetic on each mesh

PINNED_N, PINNED_TOL, PINNED_STEPS = 256, 1e-8, 50
PINNED_MESHES = ((1, 1), (2, 2), (4, 1))


def pinned_rhs(n=PINNED_N):
    """test_scale_stability._rhs: standard normal, zero on the ring."""
    b = np.random.default_rng(7).standard_normal((n, n))
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = 0.0
    return b


def pinned_modules(n=PINNED_N):
    """(the f64 Poisson module, @poisson; the f32 adv4 module, @adv4)."""
    return stencils.poisson5(n, "float64"), stencils.advection4((n, n))


def run_pinned(gm, results, infos):
    """On mesh `gm`, under pinned arithmetic: CG over `sharded_opdef` with
    the mesh's layout (`GridMesh.mesh_group`) and its gathers, and
    PINNED_STEPS applies of adv4, gathered into results["cg/TAG"] and
    results["adv4/TAG"] (TAG: the mesh shape as "2x2")."""
    from neptune_tpu_torch.lowering.executor import CompiledModule
    from neptune_tpu_torch.parallel import sharded_opdef
    from neptune_tpu_torch.solvers import krylov

    poisson, adv4 = (CompiledModule(m, device="cpu") for m in pinned_modules())
    b = pinned_rhs()
    tag = "x".join(map(str, gm.shape))
    gm.gathers = 0
    x, info = krylov.cg(sharded_opdef(poisson, "poisson", gm), gm.shard(b), tol=PINNED_TOL,
                        maxiter=3000, group=gm.mesh_group(2))
    infos[f"cg/{tag}"] = {"iters": int(info.iters), "converged": bool(info.converged),
                          "gathers": gm.gathers}
    results[f"cg/{tag}"] = gm.gather(x).numpy()
    mv, u = sharded_opdef(adv4, "adv4", gm), gm.shard(b.astype(np.float32))
    for _ in range(PINNED_STEPS):
        u = mv(u)
    results[f"adv4/{tag}"] = gm.gather(u).numpy()


def snes_iters(text: str) -> list:
    """Newton's iteration counts from the verbose SNES lines in `text`, as
    either package prints them."""
    import re

    return [int(m) for m in re.findall(r"SNES\([^)]*\) \S+: iters=(\d+)", text)]


class Spawn:
    """`torch_ca_worker.py MODE` on `world` gloo processes on localhost,
    started at construction; `results()` waits for them and returns rank
    0's (results, info). The parent works meanwhile."""

    def __init__(self, mode: str, out_dir, world: int = 4):
        import os
        import socket
        import subprocess
        import sys
        from pathlib import Path

        here = Path(__file__).resolve().parent
        self.out_dir = Path(out_dir)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = str(s.getsockname()[1])
        env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
        env["PYTHONPATH"] = os.pathsep.join([str(here.parent), env.get("PYTHONPATH", "")])
        self.procs = [
            subprocess.Popen(
                [sys.executable, str(here / "torch_ca_worker.py"), mode, str(r), str(world),
                 port, str(out_dir)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for r in range(world)
        ]

    def results(self, timeout: float = 240) -> tuple:
        import json

        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in self.procs]
        if any(codes):
            raise RuntimeError(f"worker exit codes {codes}:\n" + "\n".join(logs))
        with np.load(self.out_dir / "results.npz") as z:
            results = {k: z[k] for k in z.files}
        return results, json.loads((self.out_dir / "info.json").read_text())



# ---- the remaining apply and store shapes of sharded_function ---------------


def _temp_function(name, in_bounds, out_bounds, body, dtype="float64"):
    """@name(u: temp on in_bounds) -> temp on out_bounds, built by
    body(b, u) -> the result value; verified."""
    b = NeptuneBuilder()
    fn = b.make_function(name, "func", [TempType(dtype, in_bounds)],
                         [TempType(dtype, out_bounds)])
    b.push_block(fn.body)
    b.return_([body(b, fn.body.args[0])])
    b.pop_block()
    return verify_and_annotate(b.module)


def _one_apply(b, inputs, bounds, result_type, value_of, periodic=False):
    """One apply of value_of(index values, input block args)."""
    op, blk = b.start_apply(inputs, bounds, result_type=result_type, periodic=periodic)
    b.push_block(blk)
    rank = bounds.rank
    b.yield_(value_of(blk.args[:rank], blk.args[rank:]))
    b.pop_block()
    return b.finish_apply(op)


def no_input_program(n=32, dtype="float64"):
    """@noin(u) = u + g u[1, 0] on rows [0, n - 1), where g is an apply with
    no field input: 0.25 i - 0.125 j + 1 on the interior, 0 on the ring."""
    full = Bounds.of([0, 0], [n, n])
    S = F64 if dtype == "float64" else F32

    def body(b, u):
        def g_of(ivs, _):
            i, j = (b.cast(v, S) for v in ivs)
            ramp = b.sub(b.mul(b.constant(0.25, S), i), b.mul(b.constant(0.125, S), j))
            return b.add(ramp, b.constant(1.0, S))

        def out_of(_, f):
            return b.add(b.access(f[0], [0, 0]),
                         b.mul(b.access(f[1], [0, 0]), b.access(f[0], [1, 0])))

        g = _one_apply(b, [], Bounds.of([1, 1], [n - 1, n - 1]), TempType(dtype, full), g_of)
        return _one_apply(b, [u, g], Bounds.of([0, 0], [n - 1, n]), None, out_of)

    return _temp_function("noin", full, full, body, dtype)


def far_program(n=32, reach=12, periodic=False, dtype="float64"):
    """@far(u) = u + u[-r, 0] + u[r, 0] + 0.5 u[0, -r] + 0.25 u[0, r], r =
    reach, on [r, n - r)^2 (every read inside the domain) or on the whole
    torus. At n=32 and r=12 the reach is more than a block of the (4,1) mesh
    holds (8 rows): the ghosts come from two neighbours along the ring."""
    full = Bounds.of([0, 0], [n, n])
    bounds = full if periodic else Bounds.of([reach, reach], [n - reach, n - reach])
    r = reach
    S = F64 if dtype == "float64" else F32

    def body(b, u):
        def value_of(_, f):
            acc = b.add(b.access(f[0], [0, 0]), b.access(f[0], [-r, 0]))
            acc = b.add(acc, b.access(f[0], [r, 0]))
            acc = b.add(acc, b.mul(b.constant(0.5, S), b.access(f[0], [0, -r])))
            return b.add(acc, b.mul(b.constant(0.25, S), b.access(f[0], [0, r])))

        return _one_apply(b, [u], bounds, None, value_of, periodic=periodic)

    return _temp_function("far", full, full, body, dtype)


def reshape_program(n=32, pad=2):
    """@reshape(u on [0, n + 2 pad)^2) -> v on [pad, n + pad)^2: v = 2 u -
    u[-2, 0] - u[0, 1] + 0.5 u[2, 2], on all of v's domain. Its input and
    result differ in shape, so their blocks do not line up."""
    inb = Bounds.of([0, 0], [n + 2 * pad] * 2)
    outb = Bounds.of([pad, pad], [n + pad] * 2)

    def body(b, u):
        def value_of(_, f):
            acc = b.sub(b.mul(b.constant(2.0, F64), b.access(f[0], [0, 0])),
                        b.access(f[0], [-2, 0]))
            acc = b.sub(acc, b.access(f[0], [0, 1]))
            return b.add(acc, b.mul(b.constant(0.5, F64), b.access(f[0], [2, 2])))

        return _one_apply(b, [u], outb, TempType("float64", outb), value_of)

    return _temp_function("reshape", inb, outb, body)


def store_program(n=32, shift=4):
    """@stores(u: n x n) -> (u', sum): a 5-pt average v on [shift, n +
    shift)^2, the input's domain shifted by `shift` (same shape, other
    bounds), stored into u's field on [6, n - 2)^2, and the sum of v over
    that box: a bounded store between different bounds."""
    b = NeptuneBuilder()
    full = Bounds.of([0, 0], [n, n])
    moved = Bounds.of([shift, shift], [n + shift] * 2)
    box = Bounds.of([6, 6], [n - 2, n - 2])
    fn = b.make_function("stores", "func", [TensorType("float64", (n, n))],
                         [TensorType("float64", (n, n)), F64])
    b.push_block(fn.body)
    f = b.wrap(fn.body.args[0], FieldType("float64", full))

    def value_of(_, fs):
        acc = b.access(fs[0], [0, 0])
        for o in ([-1, 0], [1, 0], [0, -1], [0, 1]):
            acc = b.add(acc, b.access(fs[0], o))
        return b.mul(b.constant(0.2, F64), acc)

    v = _one_apply(b, [b.load(f)], Bounds.of([shift + 1] * 2, [n + shift - 1] * 2),
                   TempType("float64", moved), value_of)
    b.store(v, f, bounds=box)
    b.return_([b.unwrap(f), b.reduce(v, "sum", bounds=box)])
    b.pop_block()
    return verify_and_annotate(b.module)


# kind -> (module builder, function, its argument's shape)
SHAPE_PROGRAMS = {
    "noin32": (no_input_program, "noin", (32, 32)),
    "far32": (far_program, "far", (32, 32)),
    "far32_periodic": (lambda: far_program(periodic=True), "far", (32, 32)),
    "far30": (lambda: far_program(n=30), "far", (30, 30)),
    "reshape36": (reshape_program, "reshape", (36, 36)),
    "stores32": (store_program, "stores", (32, 32)),
}


def ksp_counts(text: str) -> list:
    """(solver, iterations or refinement rounds) of every KSP line in
    `text`, as either package prints them."""
    import re

    return [(k, int(n)) for k, n in
            re.findall(r"KSP\(([^)]*)\) \S+: (?:iters|rounds)=(\d+)", text)]


# ---- reverse mode over a mesh (test_torch_mesh_grad.py) ---------------------


def grad_module(n=32):
    """The opdefs whose derivatives the mesh-gradient tests take, f64 on an
    n^2 grid: @cubic(u, up) = u - up - 0.05 (lap u + u - u^3) on the
    interior (a copy-through ring); @adv(u) = u + 0.1 (u[1,0] u[0,1] -
    u[-1,0] u[0,-1]) on the torus; @deep(u) and @pdeep(u), the same with
    rows 9 away in place of 1, on rows [9, n - 9) and on the torus (a reach
    deeper than a block of (4,1)); @lap(u) = u + 0.1 (4 u - the four
    neighbours) on the interior, and @plap(u), the same on the torus (both
    SPD)."""
    b = NeptuneBuilder()
    full = Bounds.of([0, 0], [n, n])
    tt = TempType("float64", full)
    nbrs = ([-1, 0], [1, 0], [0, -1], [0, 1])

    def c(v):
        return b.constant(v, F64)

    def opdef(name, kind, n_in, value_of, periodic, reach=1):
        fn = b.make_opdef(name, kind, [tt] * n_in, [tt])
        b.push_block(fn.body)
        bounds = full if periodic else Bounds.of([reach, 1], [n - reach, n - 1])
        b.return_([_one_apply(b, list(fn.body.args), bounds, None, value_of, periodic)])
        b.pop_block()

    def lap(u):
        acc = b.mul(c(4.0), b.access(u, [0, 0]))
        for o in nbrs:
            acc = b.sub(acc, b.access(u, o))
        return acc

    def cubic(_, f):
        u0 = b.access(f[0], [0, 0])
        react = b.sub(u0, b.mul(b.mul(u0, u0), u0))
        rhs = b.add(b.mul(c(-1.0), lap(f[0])), react)
        return b.sub(b.sub(u0, b.access(f[1], [0, 0])), b.mul(c(0.05), rhs))

    def adv_by(r):
        def adv(_, f):
            u = f[0]
            fwd = b.mul(b.access(u, [r, 0]), b.access(u, [0, 1]))
            bwd = b.mul(b.access(u, [-r, 0]), b.access(u, [0, -1]))
            return b.add(b.access(u, [0, 0]), b.mul(c(0.1), b.sub(fwd, bwd)))

        return adv

    def shifted(_, f):
        return b.add(b.access(f[0], [0, 0]), b.mul(c(0.1), lap(f[0])))

    opdef("cubic", "nonlinear_opdef", 2, cubic, False)
    opdef("adv", "nonlinear_opdef", 1, adv_by(1), True)
    opdef("deep", "nonlinear_opdef", 1, adv_by(9), False, reach=9)
    opdef("pdeep", "nonlinear_opdef", 1, adv_by(9), True)
    opdef("lap", "linear_opdef", 1, shifted, False)
    opdef("plap", "linear_opdef", 1, shifted, True)
    return verify_and_annotate(b.module)


def grad_data(n=32):
    """The seeded global inputs of the gradient cases: x, up, w, b (n x n)
    and theta (a scalar)."""
    rng = np.random.default_rng(21)
    x, up, w, b = rng.standard_normal((4, n, n))
    return {"x": x, "up": up, "w": w, "b": b, "theta": np.float64(0.7)}


# the gradient cases: kind -> (what is differentiated, opdef); each runs on
# every mesh of GRAD_MESHES. "opdef": loss = sum(w f(x, ...)), gradients in
# x (and up); "solve": x* = A^-1 b with A v = op(v) + theta v by GMRES
# (symmetric=False: the transposed solve goes through the reverse rule),
# loss = sum(w x*), gradients in b and theta; "root": F(u) = op(u) + 0.1 u^3
# - theta b = 0, loss = sum(w u*), gradients in b and theta
GRADS = {
    "opdef_bounded": ("opdef", "cubic"),
    "opdef_periodic": ("opdef", "adv"),
    "opdef_deep_bounded": ("opdef", "deep"),
    "opdef_deep_periodic": ("opdef", "pdeep"),
    "solve_bounded": ("solve", "lap"),
    "solve_periodic": ("solve", "plap"),
    "root_bounded": ("root", "lap"),
    "root_periodic": ("root", "plap"),
}
GRAD_MESHES = ((2, 2), (4, 1))
GRAD_SOLVE = dict(tol=1e-13, maxiter=400)
GRAD_ROOT = dict(tol=1e-13, krylov_tol=1e-13, krylov_iters=400)
