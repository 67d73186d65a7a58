"""Allen–Cahn equation, three time integrators: IMEX (explicit reaction,
implicit-linear diffusion by GMRES), fully implicit Newton–Krylov, and
explicit RK4. The port of `examples/allen_cahn.py`.

Run: python -m neptune_tpu_torch.examples.allen_cahn [--cpu]
"""

import numpy as np

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli

N = 128
DT = 1e-2
EPS2 = 1e-2
DXINV2 = (N / 1.0) ** 2 / 100.0  # scaled for stability of the demo


@ntt.linear_op_def(bounds=([0], [N]), interior=([1], [N - 1]), name="ac_lap")
def ac_lap(u):
    return DXINV2 * (u[-1] - 2.0 * u[0] + u[1])


@ntt.linear_op_def(bounds=([0], [N]), interior=([1], [N - 1]), name="ac_A")
def ac_A(x):
    # A(x) = x - dt*eps2 * Lap(x)
    lap = DXINV2 * (x[-1] - 2.0 * x[0] + x[1])
    return x[0] - (DT * EPS2) * lap


@ntt.nonlinear_op_def(bounds=([0], [N]), name="ac_rhs")
def ac_rhs(u):
    lap = DXINV2 * (u[-1] - 2.0 * u[0] + u[1])
    react = u[0] - u[0] * u[0] * u[0]
    i = ntt.index(0)
    interior = EPS2 * lap + react
    return ntt.where((i == 0) | (i == N - 1), 0.0 * u[0], interior)


def imex_step(u):
    """u* = u + dt*(u - u^3); then (I - dt eps2 Lap) u1 = u* (GMRES tol 1e-8)."""
    ustar = ntt.apply(inputs=[u], bounds=([1], [N - 1]))(
        lambda t: t[0] + DT * (t[0] - t[0] * t[0] * t[0])
    )
    return ntt.solve_linear(
        ntt.assemble_matrix(ac_A), ustar.node.concrete, solver="gmres",
        tol=1e-8, max_iters=200,
    )


def newton_step(u_prev_arr):
    """Fully implicit Euler residual solved by Newton–Krylov (tol 1e-10, max 20)."""
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


def rk4_step(u):
    return ntt.time_advance(u, DT, "explicit", rhs=ac_rhs, scheme="rk4")


def initial_state() -> np.ndarray:
    x = np.linspace(-1, 1, N)
    return (0.9 * np.sign(np.sin(4 * np.pi * x)) + 0.05 * np.cos(2 * np.pi * x)).astype(float)


def integrate(step, u0: np.ndarray, steps: int = 20) -> np.ndarray:
    """`steps` steps of one integrator from u0, each read back to the host."""
    u = u0.copy()
    for _ in range(steps):
        u = step(u).cpu().numpy()
    return u


def main(steps: int = 20) -> dict:
    _cli.device()
    u0 = initial_state()
    out = {}
    for key, label, step in (
        ("imex", "IMEX (implicit-linear, GMRES):  ", imex_step),
        ("newton", "Fully implicit (Newton/JFNK):   ", newton_step),
        ("rk4", "Explicit RK4:                   ", rk4_step),
    ):
        u = integrate(step, u0, steps)
        out[f"{key}_energy"], out[key] = float(np.sum(u**2)), u
        print(f"{label}energy={out[f'{key}_energy']:.6f}")
    return out


if __name__ == "__main__":
    main()
