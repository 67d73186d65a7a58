"""`examples/allen_cahn.py`, `examples/swe_implicit.py`,
`examples/multigrid_poisson.py` (at 128^2) and the multigrid row of
`examples/preconditioned_poisson.py` written with the port (`import
neptune_tpu_torch as ntt`): the same programs, line for line, as the
examples build with the JAX package. This module imports the port
only; `test_torch_examples.py` holds its runs against the examples' own."""

import numpy as np
import torch

import neptune_tpu_torch as ntt

# examples/allen_cahn.py
N = 128
DT = 1e-2
EPS2 = 1e-2
DXINV2 = (N / 1.0) ** 2 / 100.0


def allen_cahn_opdefs():
    """The example's three opdefs, defined in the current context."""

    @ntt.linear_op_def(bounds=([0], [N]), interior=([1], [N - 1]), name="ac_A")
    def ac_A(x):
        lap = DXINV2 * (x[-1] - 2.0 * x[0] + x[1])
        return x[0] - (DT * EPS2) * lap

    @ntt.nonlinear_op_def(bounds=([0], [N]), name="ac_rhs")
    def ac_rhs(u):
        lap = DXINV2 * (u[-1] - 2.0 * u[0] + u[1])
        react = u[0] - u[0] * u[0] * u[0]
        i = ntt.index(0)
        interior = EPS2 * lap + react
        return ntt.where((i == 0) | (i == N - 1), 0.0 * u[0], interior)

    return ac_A, ac_rhs


def imex_step(ac_A, u):
    ustar = ntt.apply(inputs=[u], bounds=([1], [N - 1]))(
        lambda t: t[0] + DT * (t[0] - t[0] * t[0] * t[0])
    )
    return ntt.solve_linear(
        ntt.assemble_matrix(ac_A), ustar.node.concrete, solver="gmres", tol=1e-8, max_iters=200
    )


def newton_step(u_prev_arr):
    u_prev = ntt.temp(u_prev_arr)

    def residual(u):
        i = ntt.index(0)
        boundary = (i == 0) | (i == N - 1)
        lap = DXINV2 * (u[-1] - 2.0 * u[0] + u[1])
        react = u[0] - u[0] * u[0] * u[0]
        rhs = EPS2 * lap + react
        interior = u[0] - u_prev[0] - DT * rhs
        return ntt.where(boundary, u[0] - u_prev[0], interior)

    return ntt.solve_nonlinear(residual, u_prev_arr, tol=1e-10, max_iters=20)


def allen_cahn_energies(u0: np.ndarray, steps: int = 20) -> list:
    """The example's main(): the energy after `steps` steps of each of its
    three integrators, and the final states."""
    ac_A, ac_rhs = allen_cahn_opdefs()
    out = []
    for step in (
        lambda u: imex_step(ac_A, u),
        newton_step,
        lambda u: ntt.time_advance(u, DT, "explicit", rhs=ac_rhs, scheme="rk4"),
    ):
        u = u0.copy()
        for _ in range(steps):
            u = step(u).cpu().numpy()
        out.append((float(np.sum(u**2)), u))
    return out


# examples/swe_implicit.py
g = 9.81


@ntt.jit_class
class ImplicitSWESolver:
    def __init__(self, dt, dx, nx):
        self.dt = dt
        self.dx = dx
        self.nx = nx

    def step(self, h_curr, q_curr):
        dt, dx, nx = self.dt, self.dx, self.nx

        def swe_residual(h, q):
            fh = q
            fq = (q * q) / h + 0.5 * g * (h * h)
            div_fh = (fh[1] - fh[-1]) / (2.0 * dx)
            div_fq = (fq[1] - fq[-1]) / (2.0 * dx)
            dt_h = (h[0] - h_curr[0]) / dt
            dt_q = (q[0] - q_curr[0]) / dt
            i = ntt.index(0)
            boundary = (i == 0) | (i == nx - 1)
            res_h = ntt.where(boundary, h[0] - h_curr[0], dt_h + div_fh)
            res_q = ntt.where(boundary, q[0] - q_curr[0], dt_q + div_fq)
            return res_h, res_q

        return ntt.solve_nonlinear(
            swe_residual, initial_guess=(h_curr, q_curr), method="newton-krylov", tol=1e-10
        )


def swe_run(steps: int = 10):
    """The example's main(): (average height, max |q|) after each step, and
    the final (h, q)."""
    nx, dx, dt = 100, 1.0, 0.1
    h = np.ones(nx)
    h[: nx // 2] = 2.0
    q = np.zeros(nx)
    solver = ImplicitSWESolver(dt=dt, dx=dx, nx=nx)
    rows = []
    for _ in range(steps):
        h, q = solver.step(h, q)
        h, q = h.cpu().numpy(), q.cpu().numpy()
        rows.append((h.mean(), np.abs(q).max()))
    return rows, (h, q)


# examples/multigrid_poisson.py, at MG_N^2 in f64
MG_N = 128
MG_SIZES = [128, 64, 32, 16]
MG_TOL = 1e-9


def mg_poisson(n, dtype="float64"):
    """The example's rediscretized Poisson opdef at n^2."""
    inv_h2 = float((n - 1) * (n - 1))

    @ntt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]), dtype=dtype,
                       name=f"poisson{n}")
    def op(u):
        return (4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]) * inv_h2

    return op


def mg_manufactured(n=MG_N) -> np.ndarray:
    """The example's u*: smooth, zero on the boundary ring."""
    xs = np.linspace(0, 1, n)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    u_star = np.sin(np.pi * X) * np.sin(2 * np.pi * Y) * (X * (1 - X))
    u_star[0, :] = u_star[-1, :] = u_star[:, 0] = u_star[:, -1] = 0.0
    return u_star


def multigrid_poisson_run() -> dict:
    """The example's main(): V-cycles and the error against u*, plain CG's
    iterations and MG-preconditioned CG's."""
    from neptune_tpu_torch.solvers import cg, mg_preconditioner, multigrid_solve

    ops = [ntt.assemble_matrix(mg_poisson(n)) for n in MG_SIZES]
    u_star = mg_manufactured()
    b = ops[0].matvec(torch.from_numpy(u_star))
    x, info = multigrid_solve(ops, b, tol=MG_TOL, maxiter=60)
    _, plain = cg(ops[0].matvec, b, tol=MG_TOL, maxiter=20000)
    M = mg_preconditioner(ops, b)
    _, pre = cg(ops[0].matvec, b, tol=MG_TOL, maxiter=200, M=M)
    return {"cycles": info.iters, "resnorm": info.resnorm,
            "err": float(np.abs(x.numpy() - u_star).max()), "cg": plain.iters,
            "pcg": pre.iters, "converged": (info.converged, plain.converged, pre.converged)}


# examples/preconditioned_poisson.py's precond="mg" row
PC_N = 256
PC_TOL = 1e-10


def preconditioned_poisson_mg():
    """(x, relative residual) of the example's ("mg", {"mg_levels": 4}) row:
    CG on the 256^2 Poisson system with boundary data, verbose."""

    @ntt.linear_op_def(bounds=([0, 0], [PC_N, PC_N]), interior=([1, 1], [PC_N - 1, PC_N - 1]),
                       name="poisson")
    def poisson(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    H = ntt.assemble_matrix(poisson)
    b = np.random.default_rng(0).standard_normal((PC_N, PC_N))
    x = ntt.solve_linear(H, b, solver="cg", tol=PC_TOL, max_iters=20000, precond="mg",
                         options={"mg_levels": 4}, verbose=True)
    r = b - H.matvec(x).numpy()
    return x.numpy(), float(np.linalg.norm(r) / np.linalg.norm(b))
