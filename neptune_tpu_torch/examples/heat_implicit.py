"""Implicit heat equation through `@jit_class`: backward-Euler steps, each
a CG solve of A(u) = u - dt lap(u), then the traced IR. The port of
`examples/heat_implicit.py`.

Run: python -m neptune_tpu_torch.examples.heat_implicit [--cpu]
"""

import numpy as np

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli

N = 256
DT = 0.1


# Physics: A(u) = u - dt * lap(u)  (backward Euler system operator)
@ntt.linear_op_def(bounds=([0], [N]), interior=([1], [N - 1]))
def heat_system(u):
    lap = u[-1] - 2.0 * u[0] + u[1]
    return u[0] - DT * lap


@ntt.jit_class
class HeatSolver:
    def __init__(self, dt):
        self.dt = dt
        self.H = ntt.assemble_matrix(heat_system)

    def step(self, u):
        return ntt.solve_linear(self.H, u, solver="cg", tol=1e-10, max_iters=2000)


def initial_state() -> np.ndarray:
    """A Gaussian, in the opdef's dtype (it names none)."""
    x = np.linspace(-3, 3, N)
    return np.exp(-(x**2)).astype(ntt.config.default_dtype)


def main(steps: int = 10) -> dict:
    _cli.device()
    solver = HeatSolver(dt=DT)
    u = initial_state()

    out = {"max0": float(u.max()), "sum0": float(u.sum())}
    print(f"initial: max={u.max():.6f} sum={u.sum():.6f}")
    for n in range(steps):
        u = solver.step(u).cpu().numpy()
    print(f"after {steps} implicit steps: max={u.max():.6f} sum={u.sum():.6f}")

    dump = ntt.get_compiler().dump()
    print("\n[traced IR]")
    print(dump[:800])
    out.update({"max": float(u.max()), "sum": float(u.sum()), "u": u, "ir": dump})
    return out


if __name__ == "__main__":
    main()
