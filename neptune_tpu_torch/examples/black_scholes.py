"""Black–Scholes implicit pricing: backward induction from the call payoff,
each step A(v) = v - dt(a v_xx + b v_x + c v) with coefficients that depend
on the grid index, solved by Newton (tol 1e-10), then held against the
closed form. The port of `examples/black_scholes.py`.

Run: python -m neptune_tpu_torch.examples.black_scholes [--cpu]
"""

from math import erf, exp, log, sqrt

import numpy as np

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli

N = 128
SIGMA, R = 0.2, 0.05
S_MAX, K = 300.0, 100.0
T, STEPS = 1.0, 100
DT = T / STEPS
DS = S_MAX / (N - 1)


@ntt.nonlinear_op_def(bounds=([0], [N]), interior=([1], [N - 1]), name="bs_A")
def bs_A(v):
    # nonlinear_op_def because coefficients depend on the grid index
    # (a(S) = sigma^2 S^2 / 2) -- allowed there, whitelisted out of linear_op_def
    i = ntt.index(0)
    # cast index to the value dtype via arithmetic with floats
    S = (i * 1.0) * DS
    a = 0.5 * SIGMA * SIGMA * S * S
    b = R * S
    vxx = (v[-1] - 2.0 * v[0] + v[1]) / (DS * DS)
    vx = (v[1] - v[-1]) / (2.0 * DS)
    L = a * vxx + b * vx - R * v[0]
    return v[0] - DT * L


def residual_factory(v_prev_arr):
    v_prev = ntt.temp(v_prev_arr)

    def residual(v):
        i = ntt.index(0)
        boundary = (i == 0) | (i == N - 1)
        Sg = (i * 1.0) * DS
        a = 0.5 * SIGMA * SIGMA * Sg * Sg
        b = R * Sg
        vxx = (v[-1] - 2.0 * v[0] + v[1]) / (DS * DS)
        vx = (v[1] - v[-1]) / (2.0 * DS)
        L = a * vxx + b * vx - R * v[0]
        interior = v[0] - DT * L - v_prev[0]
        return ntt.where(boundary, v[0] - v_prev[0], interior)

    return residual


def bs_call(S0):
    """The Black–Scholes closed form at t=0."""
    if S0 <= 0:
        return 0.0
    d1 = (log(S0 / K) + (R + 0.5 * SIGMA**2) * T) / (SIGMA * sqrt(T))
    d2 = d1 - SIGMA * sqrt(T)

    def Phi(x):
        return 0.5 * (1 + erf(x / sqrt(2)))

    return S0 * Phi(d1) - K * exp(-R * T) * Phi(d2)


def main(steps: int = STEPS) -> dict:
    _cli.device()
    S = np.linspace(0, S_MAX, N)
    v = np.maximum(S - K, 0.0)  # call payoff at expiry

    for n in range(steps):
        v = ntt.solve_nonlinear(residual_factory(v), v, tol=1e-10, max_iters=20).cpu().numpy()

    idx = np.searchsorted(S, 100.0)
    print(f"PDE price at S=100:        {v[idx]:.4f}")
    print(f"closed-form price at S=100: {bs_call(S[idx]):.4f}")
    err = abs(v[idx] - bs_call(S[idx]))
    print(f"abs error: {err:.4f} (O(dt + dS^2) discretization)")
    return {"price": float(v[idx]), "closed_form": bs_call(S[idx]), "err": float(err), "v": v}


if __name__ == "__main__":
    main()
