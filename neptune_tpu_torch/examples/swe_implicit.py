"""Fully implicit 1-D shallow-water equations (dam break) by JFNK: closure
residuals over a two-field state, `solve_nonlinear(..., initial_guess=(h,
q), method="newton-krylov")`. The port of `examples/swe_implicit.py`.

Run: python -m neptune_tpu_torch.examples.swe_implicit [--cpu]
"""

import time

import numpy as np

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli

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
            # flux F(U): (q, q^2/h + g h^2/2) -- pointwise temp algebra
            fh = q
            fq = (q * q) / h + 0.5 * g * (h * h)
            # central-difference flux divergence (stencil access on fluxes)
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
            swe_residual,
            initial_guess=(h_curr, q_curr),
            method="newton-krylov",
            tol=1e-10,
        )


def main(steps: int = 10) -> dict:
    _cli.device()
    nx, dx, dt = 100, 1.0, 0.1

    h = np.ones(nx)
    h[: nx // 2] = 2.0  # dam break: high water on the left
    q = np.zeros(nx)

    print(f"SWE dam break: nx={nx} dt={dt} (implicit — large steps allowed)")
    solver = ImplicitSWESolver(dt=dt, dx=dx, nx=nx)

    rows = []
    t0 = time.time()
    for n in range(steps):
        h, q = solver.step(h, q)
        h, q = h.cpu().numpy(), q.cpu().numpy()
        rows.append((h.mean(), np.abs(q).max()))
        print(f"  step {n}: avg height = {h.mean():.4f}  max |q| = {np.abs(q).max():.4f}")
    print(f"finished in {time.time() - t0:.3f}s")
    print("front sample:", np.round(h[45:55], 4))
    return {"rows": np.array(rows), "h": h, "q": q}


if __name__ == "__main__":
    main()
