"""One mesh position of the port's multi-process CA-solver and
`sharded_function` tests.

    python tests/torch_ca_worker.py MODE RANK WORLD PORT OUT_DIR

MODE "ca" runs every case of `torch_ca_cases` for the communication-
avoiding solvers (FIXED, CONVERGED, ORACLE, COMM); MODE "function" runs
its FUNCTIONS through `sharded_function` (the Allen-Cahn program's IR text
comes from OUT_DIR/allen_cahn.mlir, printed by the parent). Each process
joins a gloo group on localhost, runs on its own blocks on the CPU, gathers
the results, and rank 0 writes OUT_DIR/results.npz (arrays) and
OUT_DIR/info.json (iterations, residual norms, call counts). Imports the
port only, never JAX.
"""

from __future__ import annotations

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
        gm.shifts = gm.reductions = 0
        out = sharded_function(cm, fname, gm)(*[gm.shard(a) for a in args])
        outs = out if isinstance(out, tuple) else (out,)
        for i, o in enumerate(outs):
            if o.dim():
                results[f"fn/{name}/{i}"] = gm.gather(o).numpy()
            else:
                results[f"fn/{name}/{i}"] = o.numpy()
        infos[name] = {"shifts": gm.shifts, "reductions": gm.reductions}


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
