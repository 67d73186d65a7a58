"""2-D lid-driven cavity (incompressible Navier–Stokes) in the
vorticity–streamfunction form: an explicit advection-diffusion step of the
vorticity and a streamfunction CG solve every step, run in chunks with
checkpoints and a resume by `SimulationDriver`.

    w_t + u w_x + v w_y = nu lap(w)     (explicit update)
    lap(psi) = -w,  u = psi_y, v = -psi_x  (CG solve + central gradients)
    wall vorticity from Thom's formula (the lid drives the flow)

The port of `examples/navier_stokes.py`. Its checkpoint goes to the
temporary directory under its own name, so it and the JAX example never
share a file.

Run: python -m neptune_tpu_torch.examples.navier_stokes [--cpu]
"""

import os
import tempfile

import numpy as np
import torch

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli
from neptune_tpu_torch.solvers import cg
from neptune_tpu_torch.utils.driver import SimulationDriver

N = 64  # grid (unit square)
DX = 1.0 / (N - 1)
RE = 100.0
NU = 1.0 / RE
DT = 0.2 * DX * DX / NU  # diffusive stability limit
LID = 1.0


# -lap with Dirichlet (identity) boundary rows: the streamfunction operator
@ntt.linear_op_def(
    bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]), dtype="float64",
    name="psi_poisson",
)
def psi_poisson(p):
    return (4.0 * p[0, 0] - p[-1, 0] - p[1, 0] - p[0, -1] - p[0, 1]) / (DX * DX)


def make_step():
    mv = ntt.get_context().compiled().opdef("psi_poisson")

    def step(state):
        w = state["w"].clone()

        # streamfunction: -lap psi = w  (psi = 0 on walls via identity rows)
        rhs = torch.zeros_like(w)
        rhs[1:-1, 1:-1] = w[1:-1, 1:-1]
        psi, _ = cg(mv, rhs, tol=1e-10, maxiter=4000)

        # velocities from psi (central differences; axis 0 = y, axis 1 = x)
        u = torch.zeros_like(w)
        u[1:-1, 1:-1] = (psi[2:, 1:-1] - psi[:-2, 1:-1]) / (2 * DX)
        v = torch.zeros_like(w)
        v[1:-1, 1:-1] = -(psi[1:-1, 2:] - psi[1:-1, :-2]) / (2 * DX)
        u[-1, :] = LID

        # wall vorticity (Thom): w_wall = -2 psi_adj / dx^2 (± lid term)
        w[0, :] = -2.0 * psi[1, :] / (DX * DX)
        w[-1, :] = -2.0 * psi[-2, :] / (DX * DX) - 2.0 * LID / DX
        w[:, 0] = -2.0 * psi[:, 1] / (DX * DX)
        w[:, -1] = -2.0 * psi[:, -2] / (DX * DX)

        # explicit advection-diffusion of vorticity on the interior
        wx = (w[1:-1, 2:] - w[1:-1, :-2]) / (2 * DX)
        wy = (w[2:, 1:-1] - w[:-2, 1:-1]) / (2 * DX)
        lapw = (
            w[2:, 1:-1] + w[:-2, 1:-1] + w[1:-1, 2:] + w[1:-1, :-2]
            - 4 * w[1:-1, 1:-1]
        ) / (DX * DX)
        wi = w[1:-1, 1:-1] + DT * (
            -u[1:-1, 1:-1] * wx - v[1:-1, 1:-1] * wy + NU * lapw
        )
        w[1:-1, 1:-1] = wi
        return {"w": w}

    return step


def velocities(w):
    """Diagnostic u, v from the converged streamfunction of state w."""
    mv = ntt.get_context().compiled().opdef("psi_poisson")
    rhs = torch.zeros_like(w)
    rhs[1:-1, 1:-1] = w[1:-1, 1:-1]
    psi, _ = cg(mv, rhs, tol=1e-10, maxiter=4000)
    p = psi.cpu().numpy()
    u = np.zeros_like(p)
    v = np.zeros_like(u)
    u[1:-1, 1:-1] = (p[2:, 1:-1] - p[:-2, 1:-1]) / (2 * DX)
    v[1:-1, 1:-1] = -(p[1:-1, 2:] - p[1:-1, :-2]) / (2 * DX)
    u[-1, :] = LID
    return u, v, p


def main(tmp_checkpoint=None, steps: int = 1000, resume_to: int = 1200) -> dict:
    dev = _cli.device()
    if tmp_checkpoint is None:
        tmp_checkpoint = os.path.join(tempfile.gettempdir(), "ns_cavity_torch.npz")
    if os.path.exists(tmp_checkpoint):
        os.remove(tmp_checkpoint)

    step = make_step()
    driver = SimulationDriver(step, tmp_checkpoint, checkpoint_every=200, dt=DT)
    init = {"w": torch.zeros((N, N), dtype=torch.float64, device=dev)}

    state, n = driver.run(init, steps)
    u, v, psi = velocities(state["w"])
    print(f"after {n} steps (Re={RE}, t={n*DT:.3f}):")
    print(f"  max |u| = {np.abs(u).max():.3f} (lid = {LID})")
    print(f"  center u = {u[N//2, N//2]:+.4f}  (negative: return flow)")
    print(f"  min psi = {psi.min():+.5f}  (primary vortex strength)")

    # resume demo: the driver picks up from the checkpoint
    state2, n2 = driver.run(init, resume_to)
    print(f"resumed from step {n} -> advanced to {n2}")
    return {"n": n, "n2": n2, "max_u": float(np.abs(u).max()), "center_u": float(u[N // 2, N // 2]),
            "min_psi": float(psi.min()), "w": state["w"].cpu().numpy(),
            "w2": state2["w"].cpu().numpy()}


if __name__ == "__main__":
    main()
