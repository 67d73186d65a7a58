"""One mesh position of the port's multi-process sharded tests.

    python tests/torch_sharded_worker.py RANK WORLD PORT OUT_DIR

Joins a gloo process group on localhost, runs every case of
`torch_sharded_cases` on each of its meshes with this process's blocks on
the CPU, gathers the results, and on rank 0 writes them to
OUT_DIR/results.npz (arrays) and OUT_DIR/solvers.json (iteration counts).
Imports the port only, never JAX.
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

import torch_sharded_cases as cases  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from neptune_tpu_torch.parallel import (  # noqa: E402
    GridMesh,
    halo_pad_local,
    initialize_multihost,
    sharded_stencil,
    shardmap_opdef,
    shardmap_sweeps,
)
from neptune_tpu_torch.solvers import krylov  # noqa: E402


def main() -> int:
    rank, world, port, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], Path(sys.argv[4])
    torch.set_num_threads(1)
    n = initialize_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo")
    assert n == world
    results, solvers = {}, {}

    for mesh in cases.MESHES:
        gm = GridMesh(mesh, cases.AXES, device="cpu")
        tag = "x".join(map(str, mesh))
        for name, (build, opdef, n_fields, scalars, backend) in cases.OPDEFS.items():
            module = build()
            cm = CompiledModule(module)
            xs = [gm.shard(x) for x in cases.inputs(module, opdef)]
            out = shardmap_opdef(cm, opdef, gm, backend=backend)(*xs, *scalars)
            results[f"opdef/{name}/{tag}"] = gm.gather(out).numpy()
        for name, (build, opdef, k) in cases.SWEEPS.items():
            module = build()
            (x,) = cases.inputs(module, opdef)
            out = shardmap_sweeps(CompiledModule(module), opdef, gm, k)(gm.shard(x))
            results[f"sweeps/{name}/{tag}"] = gm.gather(out).numpy()

        # halo_pad_local: the padded block, recentred, is the block again;
        # its ghosts are the neighbours' rows (zeros at the domain edge)
        g = np.arange(32 * 32, dtype=np.float64).reshape(32, 32)
        halo = ((1, 1), (2, 0))
        ext = halo_pad_local(gm.shard(g), halo, list(cases.AXES), gm)
        results[f"halo_pad/{tag}"] = gm.gather(ext[1:-1, 2:].contiguous()).numpy()
        sl = gm.block_slices(g.shape)
        padded = np.pad(g, halo)
        want = padded[sl[0].start : sl[0].stop + 2, sl[1].start : sl[1].stop + 2]
        ok = torch.tensor([[float(np.array_equal(ext.numpy(), want))]])
        results[f"halo_ghosts_ok/{tag}"] = gm.gather(ok).numpy()
        # sharded_stencil: a 5-pt Laplacian sweep on the torus
        x = np.random.default_rng(3).standard_normal((32, 32))

        def sweep(e, info):
            c = e[1:-1, 1:-1]
            return 4 * c - e[:-2, 1:-1] - e[2:, 1:-1] - e[1:-1, :-2] - e[1:-1, 2:]

        f = sharded_stencil(sweep, gm, ((1, 1), (1, 1)), 2, periodic=True)
        results[f"stencil_torus/{tag}"] = gm.gather(f(gm.shard(x))).numpy()

        module, opdef, b = cases.solver_system()
        mv = shardmap_opdef(CompiledModule(module), opdef, gm)
        bl = gm.shard(b)
        for solver, tol in cases.SOLVERS.items():
            x, info = krylov.solve(mv, bl, solver=solver, tol=tol, maxiter=500, group=gm.group)
            results[f"solve/{solver}/{tag}"] = gm.gather(x).numpy()
            solvers[f"{solver}/{tag}"] = int(info.iters)

    if rank == 0:
        np.savez(out_dir / "results.npz", **results)
        (out_dir / "solvers.json").write_text(json.dumps(solvers))
    # every rank done with every group before any tears one down
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    sys.exit(main())
