"""2-D wave equation, explicit leapfrog, on a two-field state (u, v = u_t
staggered by dt/2):

    v += dt * c^2 * Lap(u)       (kick)
    u += dt * v                  (drift)

The Laplacian is a linear opdef, the trajectory one `simulate` loop,
checked against the analytic standing mode sin(pi x) sin(pi y)
cos(sqrt(2) pi c t). The port of `examples/wave_leapfrog.py`: f64 under
--cpu, f32 on the card.

Run: python -m neptune_tpu_torch.examples.wave_leapfrog [--cpu]
"""

import numpy as np
import torch

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli
from neptune_tpu_torch.solvers import simulate

N = 256
C = 1.0
H = 1.0 / (N - 1)
DT = 0.4 * H / C  # CFL 0.4 (leapfrog stable below 1/sqrt(2))
STEPS = 1200
DTYPE = "float32" if not _cli.cpu_requested() else "float64"


@ntt.linear_op_def(
    bounds=([0, 0], [N, N]),
    interior=([1, 1], [N - 1, N - 1]),
    dtype=DTYPE,
    name="lap",
)
def lap(u):
    return (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1] - 4.0 * u[0, 0]) / (H * H)


def initial_state():
    """(u0, v0, omega) in f64: the mode and its staggered velocity."""
    xs = np.linspace(0.0, 1.0, N)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    u0 = np.sin(np.pi * X) * np.sin(np.pi * Y)
    omega = np.sqrt(2.0) * np.pi * C
    # leapfrog staggering: v = du/dt at t = -dt/2, and du/dt = -w sin(wt) u0
    v0 = u0 * omega * np.sin(omega * (0.5 * DT))
    return u0, v0, omega


def make_step(dev):
    ring = np.zeros((N, N), bool)
    ring[0, :] = ring[-1, :] = ring[:, 0] = ring[:, -1] = True
    interior = torch.from_numpy(~ring).to(dev)

    def step(state):
        u, v = state
        # lap(u) is copy-through at the ring (returns u there); masking the
        # kick keeps the homogeneous Dirichlet boundary exact
        v = torch.where(interior, v + DT * (C * C) * lap(u), 0.0)
        u = u + DT * v
        return (u, v)

    return step


def main(steps: int = STEPS) -> dict:
    dev = _cli.device()
    u0, v0, omega = initial_state()
    dtype = getattr(torch, DTYPE)

    state = (torch.from_numpy(u0).to(dev, dtype), torch.from_numpy(v0).to(dev, dtype))
    (u, v) = simulate(make_step(dev), state, steps)
    u = u.cpu().double().numpy()

    t = steps * DT
    u_exact = u0 * np.cos(omega * t)
    err = float(np.abs(u - u_exact).max())
    print(f"N={N} dt={DT:.5f} steps={steps} t={t:.3f}")
    print(f"max |u - exact| = {err:.3e} (amplitude {np.abs(u_exact).max():.3f})")
    # leapfrog dispersion error ~ (w dt)^2/24 per period-fraction; this setup
    # lands well under 1% of amplitude
    assert err < 2e-2, "wave solution diverged from the analytic mode"
    print("OK: matches the analytic standing mode")
    return {"err": err, "u": u, "v": v.cpu().double().numpy()}


if __name__ == "__main__":
    main()
