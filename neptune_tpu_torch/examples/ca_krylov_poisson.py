"""s-step (communication-avoiding) Krylov solves on a Poisson problem split
over a mesh of processes, each beside per-iteration CG, which pays one halo
exchange and two reductions per iteration:

  cg_sharded        one K-deep strip exchange and ONE Gram reduction per s
                    iterations (matrix-powers basis, coefficient-space CG)
  gmres_sharded     one exchange and one reduction per restart cycle
  bicgstab_sharded  one exchange and one reduction per s iterations

Each reports an honest final residual, which is checked against the true
||b - A x||. The port of `examples/ca_krylov_poisson.py`, whose mesh is one
of devices in one process.

Run: python -m neptune_tpu_torch.examples.ca_krylov_poisson [--cpu] [--procs N]
"""

import numpy as np

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli
from neptune_tpu_torch.parallel import (
    bicgstab_sharded,
    cg_sharded,
    gmres_sharded,
    shardmap_opdef,
)
from neptune_tpu_torch.solvers import cg
from neptune_tpu_torch.utils.tree import tnorm

N = 128
DTYPE = "float32"  # the CA paths are f32-first; honest reporting keeps
# the claimed residual truthful at this precision
TOL = 1e-4  # the f32 recurrence floor for this conditioning
SOLVES = ("cg", "ca_cg", "ca_gmres", "ca_bicgstab")


@ntt.linear_op_def(
    bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]), dtype=DTYPE
)
def poisson(u):
    return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]


def rhs() -> np.ndarray:
    rng = np.random.default_rng(0)
    b = np.zeros((N, N), np.float32)
    b[1:-1, 1:-1] = rng.standard_normal((N - 2, N - 2)).astype(np.float32)
    return b


def solve_all(gm) -> dict:
    """The four solves on this process's mesh `gm`, each printed: {name:
    (x gathered whole, its SolveInfo, its true residual ||b - A x||)}, and
    "bnorm"."""
    print(f"devices: {gm.n_devices}, mesh {gm.shape}")

    cm = ntt.get_context().compiled()
    b = rhs()
    bs = gm.shard(b)
    bn = float(np.linalg.norm(b))
    tol = TOL
    group = gm.mesh_group(2)

    # baseline: per-iteration CG over the explicit sharded matvec
    mv = shardmap_opdef(cm, "poisson", gm)
    x0, info0 = cg(mv, bs, tol=tol, maxiter=4000, group=group)
    print(
        f"per-iteration CG: iters={int(info0.iters)} "
        f"rel_res={float(info0.resnorm) / bn:.2e} "
        f"(1 exchange + 2 reductions per iteration)"
    )

    # s-step CA-CG: chebyshev basis keeps the Gram matrix well-conditioned
    # at s > ~4 (a monomial basis degrades as kappa^s)
    lam_min = 2.0 * (2.0 - 2.0 * np.cos(np.pi / (N + 1)))
    solve_cacg = cg_sharded(
        cm, "poisson", gm, s=8, maxiter=4000, tol=tol,
        basis="chebyshev", lam_min=lam_min, lam_max=8.0,
    )
    x1, info1 = solve_cacg(bs)
    print(
        f"CA-CG (s=8):      iters={int(info1.iters)} "
        f"rel_res={float(info1.resnorm) / bn:.2e} "
        f"(1 exchange + 1 reduction per 8 iterations)"
    )

    # CA-GMRES(s): the nonsymmetric-capable default, one reduction per cycle
    solve_cagm = gmres_sharded(
        cm, "poisson", gm, s=8, maxiter=6000, tol=tol,
        basis="chebyshev", lam_min=lam_min, lam_max=8.0,
    )
    x2, info2 = solve_cagm(bs)
    print(
        f"CA-GMRES(8):      iters={int(info2.iters)} "
        f"rel_res={float(info2.resnorm) / bn:.2e} "
        f"(1 exchange + 1 reduction per cycle)"
    )

    # CA-BiCGStab: the trio's nonsymmetric workhorse (chains run 2s+1 deep,
    # so s stays small -- one exchange + one reduction per 2 iterations here)
    solve_cabi = bicgstab_sharded(cm, "poisson", gm, s=2, maxiter=4000, tol=tol)
    x3, info3 = solve_cabi(bs)
    print(
        f"CA-BiCGStab(s=2): iters={int(info3.iters)} "
        f"rel_res={float(info3.resnorm) / bn:.2e} "
        f"(1 exchange + 1 reduction per 2 iterations)"
    )

    out = {"bnorm": bn}
    for name, x, info in (
        ("cg", x0, info0), ("ca_cg", x1, info1), ("ca_gmres", x2, info2),
        ("ca_bicgstab", x3, info3),
    ):
        out[name] = (gm.gather(x).cpu().numpy(), info, float(tnorm(bs - mv(x), group)))
    return out


def flat(solves: dict) -> dict:
    """`solve_all`'s result as numbers and arrays under NAME_KEY."""
    out = {"bnorm": solves["bnorm"]}
    for name in SOLVES:
        x, info, true = solves[name]
        out.update({name: x, f"{name}_iters": int(info.iters),
                    f"{name}_resnorm": float(info.resnorm),
                    f"{name}_converged": bool(info.converged), f"{name}_true": true})
    return out


def main(gm=None) -> dict:
    """On this process's mesh `gm`; without one, the command line's
    (`_cli.spmd`)."""
    if gm is None:
        return _cli.spmd("neptune_tpu_torch.examples.ca_krylov_poisson", main)
    solves = solve_all(gm)
    tol, bn = TOL, solves["bnorm"]

    # every reported residual must be the TRUE residual of the returned x
    for name in SOLVES:
        _, info, true = solves[name]
        assert bool(info.converged), name
        rep = float(info.resnorm)
        assert true <= tol * bn * 1.6, (name, true / bn)
        assert abs(rep - true) <= 0.3 * true + 1e-6 * bn, (name, rep, true)
    print("all four solves converged; reported residuals are true residuals")
    return flat(solves)


if __name__ == "__main__":
    main()
