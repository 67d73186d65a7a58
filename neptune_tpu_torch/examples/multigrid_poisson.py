"""Geometric multigrid Poisson solve: V-cycle iteration against plain
Krylov. The operator is rediscretized on each 2:1-coarsened grid;
`multigrid_solve` runs red-black smoothing and full-weighting transfers. The
port of `examples/multigrid_poisson.py`: f64 under --cpu, f32 on the card.

Run: python -m neptune_tpu_torch.examples.multigrid_poisson [--cpu]
"""

import time

import numpy as np
import torch

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli
from neptune_tpu_torch.solvers import cg, mg_preconditioner, multigrid_solve

N = 512
SIZES = [512, 256, 128, 64, 32, 16]


def poisson(n, dtype):
    inv_h2 = float((n - 1) * (n - 1))

    @ntt.linear_op_def(
        bounds=([0, 0], [n, n]),
        interior=([1, 1], [n - 1, n - 1]),
        dtype=dtype,
        name=f"poisson{n}",
    )
    def op(u):
        return (
            4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]
        ) * inv_h2

    return op


def manufactured(n: int = N) -> np.ndarray:
    """u*: smooth, zero on the boundary ring."""
    xs = np.linspace(0, 1, n)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    u_star = np.sin(np.pi * X) * np.sin(2 * np.pi * Y) * (X * (1 - X))
    u_star[0, :] = u_star[-1, :] = u_star[:, 0] = u_star[:, -1] = 0.0
    return u_star


def main(sizes=SIZES) -> dict:
    dev = _cli.device()
    x64 = _cli.cpu_requested()
    dtype = "float64" if x64 else "float32"
    tol = 1e-9 if x64 else 1e-4  # f32 can't reach 1e-9 on a scaled operator
    ops = [ntt.assemble_matrix(poisson(n, dtype)) for n in sizes]

    # manufactured solution: u* smooth, zero on the boundary ring
    u_star = manufactured(sizes[0])
    b = ops[0].matvec(torch.from_numpy(u_star).to(dev, getattr(torch, dtype)))

    t0 = time.perf_counter()
    x, info = multigrid_solve(ops, b, tol=tol, maxiter=60)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t_mg = time.perf_counter() - t0
    err = float(np.abs(x.cpu().double().numpy() - u_star).max())
    print(
        f"multigrid: {int(info.iters)} V-cycles, resnorm "
        f"{float(info.resnorm):.2e}, max error vs u* = {err:.2e} "
        f"({t_mg:.2f}s incl. compile)"
    )

    _, plain = cg(ops[0].matvec, b, tol=tol, maxiter=20000)
    print(
        f"plain CG:  {int(plain.iters)} iterations "
        f"(converged={bool(plain.converged)})"
    )

    M = mg_preconditioner(ops, b)
    _, pre = cg(ops[0].matvec, b, tol=tol, maxiter=200, M=M)
    print(
        f"MG-preconditioned CG: {int(pre.iters)} iterations "
        f"(converged={bool(pre.converged)})"
    )
    return {"cycles": int(info.iters), "resnorm": float(info.resnorm), "err": err,
            "cg": int(plain.iters), "pcg": int(pre.iters),
            "converged": np.array([info.converged, plain.converged, pre.converged]),
            "x": x.cpu().numpy(), "bnorm": float(torch.linalg.norm(b))}


if __name__ == "__main__":
    main()
