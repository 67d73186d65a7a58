"""The preconditioner surface of `solve_linear`: one 256^2 Poisson system
with Dirichlet boundary data, solved by CG four ways (precond="none",
"jacobi", "ssor", "mg"). The right-hand side carries nonzero boundary
values, which the solve paths lift out before the Krylov loop. The port of
`examples/preconditioned_poisson.py`.

Run: python -m neptune_tpu_torch.examples.preconditioned_poisson [--cpu]
"""

import time

import numpy as np
import torch

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli

N = 256
TOL = 1e-10
ROWS = (
    ("none", None),
    ("jacobi", None),
    ("ssor", {"omega": 1.2}),
    ("mg", {"mg_levels": 4}),
)


@ntt.linear_op_def(
    bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]), name="poisson"
)
def poisson(u):
    return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]


H = ntt.assemble_matrix(poisson)


def rhs() -> np.ndarray:
    """b, in the opdef's dtype (it names none): nonzero ring values are the
    boundary data."""
    rng = np.random.default_rng(0)
    return rng.standard_normal((N, N)).astype(ntt.config.default_dtype)


def solve(b: np.ndarray, pc: str, opts) -> tuple:
    """One row: (x, relative residual, wall seconds) of CG to TOL."""
    t0 = time.perf_counter()
    x = ntt.solve_linear(
        H, b, solver="cg", tol=TOL, max_iters=20000, precond=pc,
        options=opts, verbose=True,
    )
    if x.is_cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    r = b - H.matvec(x).cpu().numpy()
    return x.cpu().numpy(), float(np.linalg.norm(r) / np.linalg.norm(b)), dt


def main() -> dict:
    _cli.device()
    b = rhs()
    x_ref = None
    results = {}
    for pc, opts in ROWS:
        x, rel, dt = solve(b, pc, opts)
        results[f"{pc}_rel"], results[pc] = rel, x
        if x_ref is None:
            x_ref = x
        else:
            agree = np.abs(x - x_ref).max()
            assert agree < 1e-6, f"{pc} disagrees with none by {agree:.2e}"
        print(f"precond={pc:7s} rel resnorm {rel:.2e}  wall {dt:.2f}s")
        assert rel <= TOL * 1.01, f"{pc} did not converge: {rel:.2e}"

    print("all four preconditioners reached", TOL, "on the same system; OK")
    return results


if __name__ == "__main__":
    main()
