"""3-D heat diffusion, explicit stepping: forward Euler on the 7-point
Laplacian (a rank-3 apply, kernel A on the card), checked against the exact
discrete decay of the separable mode sin(pi x) sin(pi y) sin(pi z). The
port of `examples/heat3d_explicit.py`: f64 under --cpu, f32 on the card.

Run: python -m neptune_tpu_torch.examples.heat3d_explicit [--cpu]
"""

import numpy as np
import torch

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli
from neptune_tpu_torch.solvers import simulate

N = 64
KAPPA = 1.0
H = 1.0 / (N - 1)
DT = 0.15 * H * H / KAPPA  # forward-Euler stability needs dt <= h^2/6
STEPS = 400
DTYPE = "float64" if _cli.cpu_requested() else "float32"


@ntt.linear_op_def(
    bounds=([0, 0, 0], [N, N, N]),
    interior=([1, 1, 1], [N - 1, N - 1, N - 1]),
    dtype=DTYPE,
    name="lap3",
)
def lap3(u):
    return (
        u[-1, 0, 0] + u[1, 0, 0] + u[0, -1, 0]
        + u[0, 1, 0] + u[0, 0, -1] + u[0, 0, 1]
        - 6.0 * u[0, 0, 0]
    ) / (H * H)


def initial_mode() -> np.ndarray:
    xs = np.linspace(0.0, 1.0, N)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    return np.sin(np.pi * X) * np.sin(np.pi * Y) * np.sin(np.pi * Z)


def make_step(dev):
    ring = np.zeros((N, N, N), bool)
    for d in range(3):
        sl = [slice(None)] * 3
        sl[d] = 0
        ring[tuple(sl)] = True
        sl[d] = -1
        ring[tuple(sl)] = True
    interior = torch.from_numpy(~ring).to(dev)

    def step(u):
        # lap3 is copy-through on the boundary ring; masking the update
        # keeps the homogeneous Dirichlet condition exact
        return torch.where(interior, u + DT * KAPPA * lap3(u), 0.0)

    return step


def main(steps: int = STEPS) -> dict:
    dev = _cli.device()
    mode = initial_mode()
    u0 = mode.astype(DTYPE)

    u = simulate(make_step(dev), torch.from_numpy(u0).to(dev), steps)
    u = u.cpu().double().numpy()

    # exact discrete decay: one step multiplies the mode by (1 - dt*k*lam_h)
    lam_h = (6.0 - 6.0 * np.cos(np.pi * H)) / (H * H)
    decay = (1.0 - DT * KAPPA * lam_h) ** steps
    u_exact = mode * decay
    err = float(np.abs(u - u_exact).max())
    tol = 1e-10 if DTYPE == "float64" else 1e-4
    print(f"N={N}^3 dt={DT:.2e} steps={steps} discrete decay={decay:.6f}")
    print(f"max |u - exact discrete mode| = {err:.3e}")
    assert err < tol, "diverged from the discrete eigenmode decay"
    print("OK: matches the 7-pt eigenmode decay exactly")
    return {"err": err, "decay": decay, "u": u}


if __name__ == "__main__":
    main()
