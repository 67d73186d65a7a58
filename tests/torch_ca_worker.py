"""One mesh position of the port's multi-process CA-solver and
`sharded_function` tests.

    python tests/torch_ca_worker.py MODE RANK WORLD PORT OUT_DIR

MODE "ca" runs every case of `torch_ca_cases` for the communication-
avoiding solvers (FIXED, CONVERGED, ORACLE, COMM); MODE "function" runs
its FUNCTIONS through `sharded_function` (the Allen-Cahn program's IR text
comes from OUT_DIR/allen_cahn.mlir, printed by the parent); MODE "mg" runs
the mesh-aware multigrid, the CA smoothers and Newton over a sharded
residual (`run_mg`); MODE "grad" the reverse-mode cases (`run_grad`);
MODE "pinned" CG and an apply chain under pinned arithmetic on the meshes
of four positions in PINNED_MESHES (`run_pinned`); MODE "examples" the
port's mesh examples on (2,2) (`run_examples`).
Each process joins a gloo group on localhost, runs on its own blocks on the CPU, gathers
the results, and rank 0 writes OUT_DIR/results.npz (arrays) and
OUT_DIR/info.json (iterations, residual norms, call counts). Imports the
port only, never JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(0, str(HERE))

import torch_ca_cases as cases  # noqa: E402
from neptune_tpu_torch.ir.parser import parse_module  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from neptune_tpu_torch.parallel import (  # noqa: E402
    GridMesh,
    bicgstab_sharded,
    cg_sharded,
    chebyshev_sharded,
    gmres_sharded,
    initialize_multihost,
    sharded_function,
    shardmap_opdef,
)
from neptune_tpu_torch.passes import compile_ir  # noqa: E402
from neptune_tpu_torch.solvers import krylov  # noqa: E402
from neptune_tpu_torch.utils import tree  # noqa: E402

SOLVERS = {
    "cg": cg_sharded,
    "gmres": gmres_sharded,
    "bicgstab": bicgstab_sharded,
    "chebyshev": chebyshev_sharded,
}


class Meshes(dict):
    """One GridMesh per mesh shape: building one builds its reduction
    groups, collectively."""

    def __missing__(self, shape):
        gm = self[shape] = GridMesh(shape, cases.AXES[: len(shape)], device="cpu")
        return gm


def _info(info) -> dict:
    return {"iters": int(info.iters), "resnorm": float(info.resnorm),
            "converged": bool(info.converged)}


def run_ca(meshes, results, infos):
    for table, fixed in ((cases.FIXED, True), (cases.CONVERGED, False)):
        for name, case in table.items():
            if fixed:
                op_name, mesh, solver, kw, jacobi, seed = case
                kw = dict(kw, tol=0.0)
            else:
                op_name, mesh, solver, kw, seed = case
                jacobi = False
            build, opdef, centre = cases.OPERATORS[op_name]
            module = build()
            gm = meshes[mesh]
            if jacobi:
                kw = dict(kw, inv_diag=gm.shard(cases.jacobi_inv_diag(module, opdef, centre)))
            solve = SOLVERS[solver](CompiledModule(module), opdef, gm, **kw)
            x, info = solve(gm.shard(cases.rhs(module, opdef, seed)))
            tag = "fixed" if fixed else "converged"
            results[f"{tag}/{name}"] = gm.gather(x).numpy()
            infos[f"{tag}/{name}"] = _info(info)

    for name, op_name in cases.ORACLE.items():
        _, mesh, _, kw, _, seed = cases.FIXED[name]
        build, opdef, _ = cases.OPERATORS[op_name]
        module = build()
        gm = meshes[mesh]
        mv = shardmap_opdef(CompiledModule(module), opdef, gm)
        x, _ = krylov.cg(mv, gm.shard(cases.rhs(module, opdef, seed)), tol=0.0,
                         maxiter=kw["maxiter"], group=gm.group)
        results[f"oracle/{name}"] = gm.gather(x).numpy()

    # communication: ring shifts and reductions per solve
    c = cases.COMM
    build, opdef, _ = cases.OPERATORS[c["operator"]]
    module = build()
    gm = meshes[c["mesh"]]
    bl = gm.shard(cases.rhs(module, opdef, 0))
    cm = CompiledModule(module)
    solve = cg_sharded(cm, opdef, gm, s=c["s"], maxiter=c["iters"], tol=0.0)
    gm.shifts = gm.reductions = 0
    _, info = solve(bl)
    comm = {"ca_shifts": gm.shifts, "ca_reductions": gm.reductions, "ca_iters": info.iters}
    # per-iteration CG reduces through utils.tree.allreduce: count those calls
    calls = [0]
    plain_allreduce = tree.allreduce

    def counted(t, group=None):
        calls[0] += 1
        return plain_allreduce(t, group)

    tree.allreduce = counted
    try:
        gm.shifts = gm.reductions = 0
        mv = shardmap_opdef(cm, opdef, gm)
        _, info = krylov.cg(mv, bl, tol=0.0, maxiter=c["iters"], group=gm.group)
    finally:
        tree.allreduce = plain_allreduce
    comm.update(pi_shifts=gm.shifts, pi_reductions=calls[0], pi_iters=info.iters)
    infos["comm"] = comm


def run_functions(meshes, results, infos, out_dir: Path):
    for name, (kind, mesh) in cases.FUNCTIONS.items():
        gm = meshes[mesh]
        if kind == "allen_cahn":
            cm = compile_ir(parse_module((out_dir / "allen_cahn.mlir").read_text()), device="cpu")
            fname = "entry"
            uin = np.sin(np.linspace(0, np.pi, 16))
            args = [np.zeros(16), uin]
        else:
            module, fname, args = cases.function_module(kind)
            cm = CompiledModule(module, device="cpu")
        gm.shifts = gm.reductions = gm.gathers = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            out = sharded_function(cm, fname, gm)(*[gm.shard(a) for a in args])
        outs = out if isinstance(out, tuple) else (out,)
        counts = {"shifts": gm.shifts, "reductions": gm.reductions, "gathers": gm.gathers}
        for i, o in enumerate(outs):
            if o.dim():
                results[f"fn/{name}/{i}"] = gm.gather(o).numpy()
            else:
                results[f"fn/{name}/{i}"] = o.numpy()
        infos[name] = dict(counts, snes_iters=cases.snes_iters(log.getvalue()),
                           ksp=cases.ksp_counts(log.getvalue()))

    # what raises on the mesh: every process raises at the same op
    for name, (kind, mesh, *_) in cases.RAISING.items():
        gm = meshes[mesh]
        module, fname, args = cases.function_module(kind)
        try:
            sharded_function(CompiledModule(module, device="cpu"), fname, gm)(
                *[gm.shard(a) for a in args])
            infos[name] = {"error": None}
        except Exception as e:  # noqa: BLE001 -- the test names the expected type
            infos[name] = {"error": type(e).__name__, "message": str(e)}


def run_mg(meshes, results, infos):
    """The mesh-aware V-cycle, the CA smoothers and Newton over a sharded
    residual, on each mesh of `cases.MG_MESHES` (see
    test_torch_ca_multigrid.py for what is compared)."""
    import neptune_tpu_torch as ntt
    from neptune_tpu_torch import stencils
    from neptune_tpu_torch.parallel import build_ca_levels, ca_smoother
    from neptune_tpu_torch.solvers import multigrid, newton_krylov
    from neptune_tpu_torch.solvers.chebyshev import chebyshev

    cases.poisson_hierarchy(ntt)
    cm = ntt.get_context().compiled()
    names = cases.MG_NAMES
    b = cases.rhs(cm.module, names[0], 0)
    built = {}
    for mesh in cases.MG_MESHES:
        gm = meshes[mesh]
        tag = "x".join(map(str, mesh))
        group = gm.sum_group(2)
        bs = gm.shard(b)
        mvs = [shardmap_opdef(cm, nm, gm) for nm in names]
        lv = built[mesh] = build_ca_levels(cm, names, gm, torch.zeros_like(bs), k=3)
        plain = [lvl._replace(ca_smooth=None, ca_smooth_zero=None, ca_k=0) for lvl in lv]
        infos[f"levels/{tag}"] = {
            "eligible": [lvl.ca_smooth is not None for lvl in lv],
            "lmax": [lvl.cheb_lmax for lvl in lv],
        }
        results[f"inv_diag/{tag}"] = gm.gather(lv[0].inv_diag).numpy()
        runs = {name for name, on in cases.MG_SOLVES.items() if mesh in on}

        if "rb" in runs:
            # multigrid_solve with red-black smoothing over the shardmap matvecs
            x, info = multigrid.multigrid_solve(mvs, bs, tol=1e-9, maxiter=60)
            results[f"rb/{tag}"], infos[f"rb/{tag}"] = gm.gather(x).numpy(), _info(info)

        if "pcg" in runs:
            # MG-PCG with the Chebyshev-smoothed cycle
            M = multigrid.mg_preconditioner(mvs, bs, smoother="cheb", levels=plain)
            x, info = krylov.cg(mvs[0], bs, M=M, tol=1e-8, maxiter=200, group=group)
            results[f"pcg/{tag}"], infos[f"pcg/{tag}"] = gm.gather(x).numpy(), _info(info)

        if "ca" in runs:
            # CA-smoothed multigrid_solve against per-matvec "cheb" smoothing
            for route, levels in (("ca", lv), ("per_matvec", plain)):
                gm.shifts = 0
                x, info = multigrid.multigrid_solve(
                    [None] * 4, bs, tol=1e-9, maxiter=60, levels=levels, smoother="cheb",
                    pre=3, post=3,
                )
                results[f"{route}/{tag}"] = gm.gather(x).numpy()
                infos[f"{route}/{tag}"] = dict(_info(info), shifts=gm.shifts)

        if "newton" in runs:
            # Newton-Krylov over a sharded residual: F = A u + 0.1 u^3 - b
            module = stencils.poisson5(64, "float64")
            mv = shardmap_opdef(CompiledModule(module), "poisson", gm)
            b64 = gm.shard(cases.rhs(module, "poisson", 2))

            def F(u, mv=mv, b64=b64):
                return mv(u) + 0.1 * u * u * u - b64

            x, info = newton_krylov(F, torch.zeros_like(b64), group=group)
            results[f"newton/{tag}"] = gm.gather(x).numpy()
            infos[f"newton/{tag}"] = {
                "iters": info.iters, "krylov_iters": info.krylov_iters,
                "converged": bool(info.converged), "fnorm": float(tree.tnorm(F(x), group)),
            }

        # prolongation at block corners and domain edges
        for pname, (rank, shape) in cases.PROLONG.items():
            e = gm.shard(np.random.default_rng(rank).standard_normal(shape))
            fine = tuple(2 * n for n in e.shape)
            results[f"prolong/{pname}/{tag}"] = gm.gather(multigrid.prolong(e, fine, gm)).numpy()

    gm = meshes[(2, 2)]
    group = gm.sum_group(2)
    bs = gm.shard(b)
    L = built[(2, 2)][0]
    mv = L.matvec
    lmax = L.cheb_lmax

    # the smoother against chebyshev(maxiter=k) over the same matvec
    sm, sm0 = ca_smoother(cm, names[0], gm, k=3, lam_min=lmax / 4, lam_max=lmax,
                          inv_diag=L.inv_diag)
    x1 = gm.shard(np.random.default_rng(1).standard_normal(b.shape))
    for start, (xs, rs), x0 in (
        ("zero", sm0(bs), torch.zeros_like(bs)), ("live", sm(bs, x1), x1),
    ):
        xo, _ = chebyshev(mv, bs, x0=x0, M=lambda v: L.inv_diag * v, lam_min=lmax / 4,
                          lam_max=lmax, maxiter=3, residual_replacement=False, group=group)
        results[f"smoother/{start}"] = gm.gather(xs).numpy()
        results[f"smoother_oracle/{start}"] = gm.gather(xo).numpy()
        results[f"smoother_r/{start}"] = gm.gather(rs).numpy()
        results[f"smoother_true_r/{start}"] = gm.gather(bs - mv(xs)).numpy()

    # exchange rounds per smoothing pass, against k per-matvec applications
    rounds = {}
    for k in (2, 6):
        s_k, s0_k = ca_smoother(cm, names[0], gm, k=k, lam_min=lmax / 4, lam_max=lmax,
                                inv_diag=L.inv_diag)
        gm.shifts = 0
        s0_k(bs)
        rounds[f"zero_{k}"] = gm.shifts
        gm.shifts = 0
        s_k(bs, x1)
        rounds[f"live_{k}"] = gm.shifts
        gm.shifts = 0
        v = bs
        for _ in range(k):
            v = mv(v)
        rounds[f"naive_{k}"] = gm.shifts
    infos["rounds"] = rounds

    # CA-MG preconditioning CG (k=2)
    lv2 = build_ca_levels(cm, names, gm, torch.zeros_like(bs), k=2)
    M = multigrid.mg_preconditioner([None], bs, smoother="cheb", levels=lv2)
    x, info = krylov.cg(mv, bs, M=M, tol=1e-8, maxiter=200, group=group)
    results["ca_pcg"], infos["ca_pcg"] = gm.gather(x).numpy(), _info(info)

    # the wide stencil's diagonal, probed through build_ca_levels
    module = cases.wide5()
    lw = build_ca_levels(CompiledModule(module), ["wide5"], gm, torch.zeros(32, 32,
                         dtype=torch.float64), k=2)
    results["wide5_inv_diag"] = gm.gather(lw[0].inv_diag).numpy()

    # CA smoothing above the whole-grid levels of an odd hierarchy on (4,1)
    gm = meshes[(4, 1)]
    cases.poisson_hierarchy(ntt, cases.MG_ODD_SIZES)
    cm = ntt.get_context().compiled()
    names = [f"poisson{n}" for n in cases.MG_ODD_SIZES]
    bs = gm.shard(cases.rhs(cm.module, names[0], 3))
    lv = build_ca_levels(cm, names, gm, torch.zeros_like(bs), k=2)
    gm.gathers = 0
    x, info = multigrid.multigrid_solve([None] * 4, bs, tol=1e-9, maxiter=60, levels=lv,
                                        smoother="cheb")
    results["ca_odd"] = gm.gather(x).numpy()
    infos["ca_odd"] = dict(_info(info), gathers=gm.gathers,
                           eligible=[lvl.ca_smooth is not None for lvl in lv],
                           whole=[lvl.mesh is None for lvl in lv])


def run_grad(meshes, results, infos):
    """Reverse mode over a mesh: every case of `cases.GRADS` on every mesh of
    `cases.GRAD_MESHES` (see test_torch_mesh_grad.py)."""
    from neptune_tpu_torch.lowering.executor import rule_counter
    from neptune_tpu_torch.solvers.diff import differentiable_root, differentiable_solve

    cm = CompiledModule(cases.grad_module(), device="cpu")
    data = cases.grad_data()
    for mesh in cases.GRAD_MESHES:
        gm = meshes[mesh]
        group = gm.sum_group(2)
        tag = "x".join(map(str, mesh))
        for name, (kind, opdef) in cases.GRADS.items():
            op = shardmap_opdef(cm, opdef, gm)
            blk = {k: gm.shard(v) for k, v in data.items() if np.ndim(v)}
            theta = torch.tensor(data["theta"], dtype=torch.float64, requires_grad=True)
            before = rule_counter.count
            if kind == "opdef":
                leaves = {"x": blk["x"].clone().requires_grad_(True)}
                if opdef == "cubic":
                    leaves["up"] = blk["up"].clone().requires_grad_(True)
                y = op(*leaves.values())
            else:
                leaves = {"b": blk["b"].clone().requires_grad_(True), "theta": theta}
                if kind == "solve":
                    y = differentiable_solve(
                        lambda v: op(v) + theta * v, leaves["b"], solver="gmres", group=group,
                        **cases.GRAD_SOLVE)
                else:
                    y = differentiable_root(
                        lambda u: op(u) + 0.1 * u * u * u - theta * leaves["b"],
                        torch.zeros_like(blk["b"]), group=group, **cases.GRAD_ROOT)
            # each process's part of the loss; their sum is the loss
            (blk["w"] * y).sum().backward()
            for k, leaf in leaves.items():
                g = leaf.grad
                # a scalar's gradient is the sum of every process's part
                g = gm.allreduce(g, 2) if g.dim() == 0 else gm.gather(g)
                results[f"{name}/{tag}/{k}"] = g.numpy()
            infos[f"{name}/{tag}"] = {"rule": rule_counter.count - before}


def run_pinned(meshes, results, infos):
    """test_scale_stability's pinned systems on each mesh of four positions
    in `cases.PINNED_MESHES` (`cases.run_pinned`; the parent runs the mesh
    of one position meanwhile)."""
    from neptune_tpu_torch.config import config

    config.pinned_arithmetic = True
    for mesh in cases.PINNED_MESHES:
        if mesh != (1, 1):
            cases.run_pinned(meshes[mesh], results, infos)


# the port's programs of examples/ that run over a mesh
MESH_EXAMPLES = ("multichip_poisson", "comm_avoiding_jacobi", "ca_krylov_poisson")
# ca_krylov_poisson's CA-BiCGStab(2) beyond the example's run: (dtype, seed
# of the right-hand side); f64, where the two packages agree, and f32 on two
# more right-hand sides (its f32 stall on (2,2), ROADMAP queue 3)
BICGSTAB_RUNS = (("float64", 0), ("float32", 1), ("float32", 2))


def bicgstab_rhs(n: int, dtype: str, seed: int) -> np.ndarray:
    """ca_krylov_poisson's right-hand side, drawn with `seed`, in dtype."""
    b = np.zeros((n, n), dtype)
    b[1:-1, 1:-1] = np.random.default_rng(seed).standard_normal((n - 2, n - 2)).astype(dtype)
    return b


def run_bicgstab(gm, results, infos):
    """BICGSTAB_RUNS on gm, each under "bicgstab_DTYPE_SEED/KEY": x, the
    iterations, the convergence flag, the reported and true residuals and
    ||b||."""
    import neptune_tpu_torch as ntt

    ntt.reset_context()  # the import defines the example's opdef
    from neptune_tpu_torch.examples.ca_krylov_poisson import N, TOL

    for dtype, seed in BICGSTAB_RUNS:
        ntt.reset_context()

        @ntt.linear_op_def(bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]),
                           dtype=dtype)
        def poisson(u):
            return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

        cm = ntt.get_context().compiled()
        b = bicgstab_rhs(N, dtype, seed)
        bs = gm.shard(b)
        x, info = bicgstab_sharded(cm, "poisson", gm, s=2, maxiter=4000, tol=TOL)(bs)
        true = float(tree.tnorm(bs - shardmap_opdef(cm, "poisson", gm)(x), gm.mesh_group(2)))
        key = f"bicgstab_{dtype}_{seed}"
        results[f"{key}/x"] = gm.gather(x).numpy()
        infos |= {f"{key}/iters": int(info.iters), f"{key}/converged": bool(info.converged),
                  f"{key}/resnorm": float(info.resnorm), f"{key}/true": true,
                  f"{key}/bnorm": float(np.linalg.norm(b))}


def run_examples(meshes, results, infos):
    """Each mesh example on (2,2), run afresh in a fresh DSL context: its
    arrays (gathered whole) into results, its numbers into
    infos, both under "NAME/KEY"."""
    import runpy

    import neptune_tpu_torch as ntt
    from neptune_tpu_torch.config import config

    config.device = "cpu"
    gm = meshes[(2, 2)]
    for name in MESH_EXAMPLES:
        ntt.reset_context()
        with contextlib.redirect_stdout(io.StringIO()):
            ns = runpy.run_module(f"neptune_tpu_torch.examples.{name}")
            # ca_krylov_poisson: its solves without main()'s asserts, which
            # its f32 CA-BiCGStab(2) does not pass on (2,2); the test holds
            # what it can (test_ca_krylov_poisson_meshes)
            out = ns["flat"](ns["solve_all"](gm)) if "solve_all" in ns else ns["main"](gm)
        for key, v in out.items():
            if isinstance(v, np.ndarray):
                results[f"{name}/{key}"] = v
            else:
                infos[f"{name}/{key}"] = v
    run_bicgstab(gm, results, infos)


def main() -> int:
    mode, rank, world, port, out_dir = sys.argv[1:6]
    rank, world, out_dir = int(rank), int(world), Path(out_dir)
    torch.set_num_threads(1)
    n = initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    assert n == world
    results, infos = {}, {}
    meshes = Meshes()
    if mode == "ca":
        run_ca(meshes, results, infos)
    elif mode == "mg":
        run_mg(meshes, results, infos)
    elif mode == "grad":
        run_grad(meshes, results, infos)
    elif mode == "pinned":
        run_pinned(meshes, results, infos)
    elif mode == "examples":
        run_examples(meshes, results, infos)
    else:
        run_functions(meshes, results, infos, out_dir)
    if rank == 0:
        np.savez(out_dir / "results.npz", **results)
        (out_dir / "info.json").write_text(json.dumps(infos))
    # every rank done with every group before any tears one down
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    sys.exit(main())
