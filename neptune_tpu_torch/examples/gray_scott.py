"""Gray–Scott reaction–diffusion on a torus:

    u_t = Du Lap(u) - u v^2 + F (1 - u)
    v_t = Dv Lap(v) + u v^2 - (F + k) v

Two coupled fields on a fully periodic domain: the diffusion stencil is a
periodic linear opdef, the reaction a pointwise two-input nonlinear opdef,
the trajectory one `simulate` loop. Checked against a step-for-step NumPy
integrator and by the Turing-instability signature. The port of
`examples/gray_scott.py`: f64 under --cpu, f32 on the card.

Run: python -m neptune_tpu_torch.examples.gray_scott [--cpu]
"""

import numpy as np
import torch

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli
from neptune_tpu_torch.solvers import simulate

N = 128
DU, DV = 0.16, 0.08
F, K = 0.060, 0.062  # "coral" growth regime
DT = 1.0
STEPS = 100
DTYPE = "float64" if _cli.cpu_requested() else "float32"


@ntt.linear_op_def(
    bounds=([0, 0], [N, N]), periodic=True, dtype=DTYPE, name="lap_t"
)
def lap_t(u):
    # unit grid spacing, 5-pt Laplacian with torus wraparound
    return u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1] - 4.0 * u[0, 0]


@ntt.nonlinear_op_def(bounds=([0, 0], [N, N]), dtype=DTYPE, name="react")
def react(u, v):
    return u * v[0, 0] * v[0, 0]  # pointwise u v^2


def numpy_reference(u, v, steps):
    """Same discretization in plain NumPy (the correctness oracle)."""

    def lap(a):
        return (
            np.roll(a, 1, 0) + np.roll(a, -1, 0)
            + np.roll(a, 1, 1) + np.roll(a, -1, 1) - 4.0 * a
        )

    for _ in range(steps):
        r = u * v * v
        u, v = (
            u + DT * (DU * lap(u) - r + F * (1.0 - u)),
            v + DT * (DV * lap(v) + r - (F + K) * v),
        )
    return u, v


def initial_state():
    rng = np.random.default_rng(0)
    u0 = np.ones((N, N))
    v0 = np.zeros((N, N))
    # seed a perturbed square in the middle
    c = N // 2
    u0[c - 8 : c + 8, c - 8 : c + 8] = 0.50
    v0[c - 8 : c + 8, c - 8 : c + 8] = 0.25
    u0 += 0.02 * rng.standard_normal((N, N))
    v0 += 0.02 * rng.standard_normal((N, N))
    return u0.astype(DTYPE), v0.astype(DTYPE)


def step(state):
    u, v = state
    r = react(u, v)
    u2 = u + DT * (DU * lap_t(u) - r + F * (1.0 - u))
    v2 = v + DT * (DV * lap_t(v) + r - (F + K) * v)
    return (u2, v2)


def main(steps: int = STEPS) -> dict:
    dev = _cli.device()
    u0, v0 = initial_state()

    u, v = simulate(step, (torch.from_numpy(u0).to(dev), torch.from_numpy(v0).to(dev)), steps)
    u, v = u.cpu().double().numpy(), v.cpu().double().numpy()

    u_ref, v_ref = numpy_reference(
        u0.astype(np.float64), v0.astype(np.float64), steps
    )
    err = float(max(np.abs(u - u_ref).max(), np.abs(v - v_ref).max()))
    tol = 1e-10 if DTYPE == "float64" else 2e-4
    print(f"N={N} steps={steps}  max |state - numpy oracle| = {err:.3e}")
    assert err < tol, "diverged from the NumPy reference integrator"

    var0 = float(np.var(v0))
    var1 = float(np.var(v))
    assert np.isfinite(u).all() and np.isfinite(v).all()
    assert u.min() > -0.1 and u.max() < 1.5 and v.min() > -0.1 and v.max() < 1.5
    print(f"pattern variance var(v): {var0:.3e} -> {var1:.3e}")
    print("OK: matches the NumPy oracle and stays in the invariant region")
    return {"err": err, "var0": var0, "var1": var1, "u": u, "v": v}


if __name__ == "__main__":
    main()
