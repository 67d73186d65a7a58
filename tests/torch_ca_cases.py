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
    if kind in MG_PROGRAMS:
        solve = MG_PROGRAMS[kind]
        module = stencils.with_solve(stencils.poisson5(32, "float64"), "poisson", **solve)
        return run_pipeline(module).module, "solve", [rhs_ring(32, rng)]
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


# the meshes each solve runs on: every solve costs seconds of gloo round
# trips (~1 ms per ring shift or reduction among four CPU processes), so
# each runs where it tests most: red-black multigrid_solve on (2,2); the CA
# cycle against per-matvec smoothing, and Newton, on (4,1), whose coarsest
# level is CA-ineligible
MG_SOLVES = {"rb": ((2, 2),), "pcg": ((2, 2), (4, 1)), "ca": ((4, 1),), "newton": ((4, 1),)}

# the prolongation cases: (rank, coarse shape); a block corner lies inside
# each grid on (2,2), and every block touches the domain edge
PROLONG = {"2d": (2, (32, 32)), "3d": (3, (16, 16, 8))}


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
