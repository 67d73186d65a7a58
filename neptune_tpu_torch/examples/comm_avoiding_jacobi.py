"""Communication-avoiding relaxation over a mesh of processes: K Jacobi
sweeps per halo exchange through `shardmap_sweeps` (1/K the messages of the
exchange-every-sweep loop, the same result), then the same trapezoid
carrying a whole solver, CA-Chebyshev. The port of
`examples/comm_avoiding_jacobi.py`, whose mesh is one of devices in one
process.

Run: python -m neptune_tpu_torch.examples.comm_avoiding_jacobi [--cpu] [--procs N]
"""

import numpy as np

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli
from neptune_tpu_torch.parallel import chebyshev_sharded, shardmap_opdef, shardmap_sweeps

N = 128
K = 8  # sweeps per halo exchange
ROUNDS = 12  # exchanges (K * ROUNDS total sweeps)


# damped-Jacobi relaxation step for the Dirichlet Poisson problem
# u <- u + (omega/4) * (b - A u), written as a unary operator on u with the
# right-hand side folded in as zero (homogeneous problem: decay of a mode)
@ntt.linear_op_def(bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]))
def jacobi_sweep(u):
    return 0.25 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1])


def fundamental_mode() -> np.ndarray:
    """The (1,1) Dirichlet eigenmode, zero on the ring."""
    ii = np.arange(N)
    mode = np.sin(np.pi * ii[:, None] / (N - 1)) * np.sin(
        np.pi * ii[None, :] / (N - 1)
    )
    mode[0, :] = mode[-1, :] = mode[:, 0] = mode[:, -1] = 0.0
    return mode


def relax(cm, gm, u0):
    """(naive, ca): K * ROUNDS sweeps exchanging every sweep, and ROUNDS
    calls of K sweeps per exchange, each gathered whole."""
    mv = shardmap_opdef(cm, "jacobi_sweep", gm)
    fk = shardmap_sweeps(cm, "jacobi_sweep", gm, K)
    u = v = u0
    for _ in range(K * ROUNDS):
        u = mv(u)
    for _ in range(ROUNDS):
        v = fk(v)
    return gm.gather(u).cpu().numpy(), gm.gather(v).cpu().numpy()


def chebyshev_rhs() -> np.ndarray:
    b = np.zeros((N, N))
    b[1:-1, 1:-1] = np.random.default_rng(3).standard_normal((N - 2, N - 2))
    return b


def true_relative_residual(xs: np.ndarray, b: np.ndarray) -> float:
    r = b.copy()
    r[1:-1, 1:-1] -= (
        4 * xs[1:-1, 1:-1] - xs[:-2, 1:-1] - xs[2:, 1:-1]
        - xs[1:-1, :-2] - xs[1:-1, 2:]
    )
    r[0, :] -= xs[0, :]
    r[-1, :] -= xs[-1, :]
    r[1:-1, 0] -= xs[1:-1, 0]
    r[1:-1, -1] -= xs[1:-1, -1]
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def main(gm=None) -> dict:
    """On this process's mesh `gm`; without one, the command line's
    (`_cli.spmd`)."""
    if gm is None:
        return _cli.spmd("neptune_tpu_torch.examples.comm_avoiding_jacobi", main)
    print(f"devices: {gm.n_devices}, mesh {gm.shape}")

    cm = ntt.get_context().compiled()
    dtype = ntt.config.default_dtype  # the opdef's: it names none

    # initial state: the (1,1) Dirichlet eigenmode, which plain Jacobi damps
    # by exactly lam = cos(pi/ (N-1))... per sweep on the interior
    mode = fundamental_mode()
    u0 = gm.shard(mode.astype(dtype))

    naive, ca = relax(cm, gm, u0)
    dev = float(np.abs(naive - ca).max())
    print(f"max |naive - comm-avoiding| after {K * ROUNDS} sweeps: {dev:.3e}")
    assert dev < 1e-10 if naive.dtype == np.float64 else dev < 1e-4

    # analytic decay of the fundamental mode under plain Jacobi
    lam = 0.5 * (np.cos(np.pi / (N - 1)) + np.cos(np.pi / (N - 1)))
    predicted = lam ** (K * ROUNDS)
    measured = float(np.abs(ca[1:-1, 1:-1]).max() / np.abs(mode[1:-1, 1:-1]).max())
    print(f"mode decay: measured {measured:.6f}, analytic {predicted:.6f}")
    assert abs(measured - predicted) < 5e-3

    # ---- the same trapezoid carrying a whole SOLVER: CA-Chebyshev ----
    # K full (x, r, d) Chebyshev iterations per exchange, one reduction at the end
    @ntt.linear_op_def(
        bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]),
        name="poisson_ca",
    )
    def poisson_ca(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    cm2 = ntt.get_context().compiled()
    lmin = 2.0 * (2.0 - 2.0 * np.cos(np.pi / (N + 1)))
    b = chebyshev_rhs()
    solve = chebyshev_sharded(
        cm2, "poisson_ca", gm, lam_min=lmin, lam_max=8.0,
        k_fuse=K, maxiter=4000, tol=1e-8,
    )
    xs, info = solve(gm.shard(b.astype(dtype)))
    xs = gm.gather(xs).cpu().numpy()
    f64 = xs.dtype == np.float64
    rel = true_relative_residual(xs, b)
    print(
        f"CA-Chebyshev solve: converged={bool(info.converged)} "
        f"({int(info.iters)} iterations, {K} per exchange), "
        f"true relative residual {rel:.2e}"
    )
    # f32 (the card's kernels' dtype) stalls at ~eps*kappa for this conditioning
    assert rel < (1e-6 if f64 else 1e-2)
    print("ok")
    return {"dev": dev, "measured": measured, "predicted": predicted, "naive": naive, "ca": ca,
            "cheb_iters": int(info.iters), "cheb_converged": bool(info.converged),
            "cheb_rel": rel, "xs": xs}


if __name__ == "__main__":
    main()
