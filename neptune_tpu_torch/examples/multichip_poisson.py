"""Multi-process Poisson solve: a 2-D field split over a mesh of processes,
each holding its block, solved by matrix-free CG whose dot products reduce
over the mesh; then the explicit-communication matvec checked against the
operator on the whole grid. The port of `examples/multichip_poisson.py`,
whose mesh is one of devices in one process (GSPMD).

Run: python -m neptune_tpu_torch.examples.multichip_poisson [--cpu] [--procs N]
"""

import numpy as np

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli
from neptune_tpu_torch.parallel import sharded_opdef, shardmap_opdef
from neptune_tpu_torch.solvers import cg

N = 256


@ntt.linear_op_def(bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]))
def poisson(u):
    return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]


def rhs() -> np.ndarray:
    """b, in the opdef's dtype (it names none)."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((N, N)).astype(ntt.config.default_dtype)


def residual(x: np.ndarray, b: np.ndarray) -> np.ndarray:
    """b - A x by NumPy, whole grid (the replicated oracle)."""
    r = b.astype(np.float64)
    r[1:-1, 1:-1] -= (
        4 * x[1:-1, 1:-1] - x[:-2, 1:-1] - x[2:, 1:-1] - x[1:-1, :-2] - x[1:-1, 2:]
    )
    r[0, :] -= x[0, :]
    r[-1, :] -= x[-1, :]
    r[1:-1, 0] -= x[1:-1, 0]
    r[1:-1, -1] -= x[1:-1, -1]
    return r


def main(gm=None) -> dict:
    """On this process's mesh `gm`; without one, the command line's
    (`_cli.spmd`)."""
    if gm is None:
        return _cli.spmd("neptune_tpu_torch.examples.multichip_poisson", main)
    print(f"devices: {gm.n_devices}, mesh {gm.shape}")

    cm = ntt.get_context().compiled()
    matvec = sharded_opdef(cm, "poisson", gm)

    b = rhs()
    b_sharded = gm.shard(b)

    x, info = cg(matvec, b_sharded, tol=1e-10, maxiter=3000, group=gm.mesh_group(2))
    x = gm.gather(x)
    print(f"CG iters={int(info.iters)} resnorm={float(info.resnorm):.3e} "
          f"converged={bool(info.converged)}")

    # the explicit-communication mode: per-block execution with ring-shift
    # ghost exchange at the operator's verified stencil reach, against the
    # operator on the whole grid
    mv_explicit = shardmap_opdef(cm, "poisson", gm)
    y1 = gm.gather(mv_explicit(gm.shard(x))).cpu().numpy()
    y2 = cm.opdef("poisson")(x).cpu().numpy()
    dev = float(np.abs(y1 - y2).max())
    print(f"explicit shard_map matvec max dev: {dev:.2e}")

    # residual check against the (replicated) numpy oracle
    x = x.cpu().numpy()
    r = residual(x, b)
    print(f"max |A x - b| = {np.abs(r).max():.3e}")
    return {"iters": int(info.iters), "resnorm": float(info.resnorm),
            "converged": bool(info.converged), "matvec_dev": dev,
            "max_residual": float(np.abs(r).max()), "x": x}


if __name__ == "__main__":
    main()
