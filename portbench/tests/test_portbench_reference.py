"""The plain references against hand-worked answers: a 5-point step, the
Poisson operator, a residual, and a small CG solve against a dense one."""

import numpy as np
import torch

from portbench.reference import jacobi2d_5pt, poisson2d_5pt


def test_jacobi_step_by_hand():
    u = torch.arange(16, dtype=torch.float32).reshape(4, 4)
    out = jacobi2d_5pt.step(u, ((1, 1), (3, 3)))
    want = u.clone()
    # cell (1,1): 0.25 * (u[0,1] + u[2,1] + u[1,0] + u[1,2]) = 0.25 * (1 + 9 + 4 + 6)
    want[1, 1] = 5.0
    want[1, 2] = 0.25 * (2 + 10 + 5 + 7)
    want[2, 1] = 0.25 * (5 + 13 + 8 + 10)
    want[2, 2] = 0.25 * (6 + 14 + 9 + 11)
    assert torch.equal(out, want)
    twice = jacobi2d_5pt.steps(u, ((1, 1), (3, 3)), 2)
    assert torch.equal(twice, jacobi2d_5pt.step(out, ((1, 1), (3, 3))))


def test_lower_precision_stepper_rounds():
    u = torch.rand(32, 32, generator=torch.Generator().manual_seed(0))
    exact = jacobi2d_5pt.step(u, ((1, 1), (31, 31)))
    low = jacobi2d_5pt.lower_precision_stepper(((1, 1), (31, 31)), 1)(u)
    assert low.dtype == torch.float32 and 0 < (low - exact).abs().max() < 1e-2


def test_poisson_matvec_and_residual_by_hand():
    x = torch.zeros(1, 3, 3, dtype=torch.float64)
    x[0, 1, 1] = 1.0
    ax = poisson2d_5pt.matvec(x, ((1, 1), (2, 2)))
    assert ax[0, 1, 1] == 4.0 and ax.sum() == 4.0  # the ring is copied through (zeros)
    b = torch.full((1, 3, 3), 0.0, dtype=torch.float64)
    b[0, 1, 1] = 8.0
    # b - A x = 8 - 4 = 4 at the centre: 4 / 8
    assert poisson2d_5pt.rel_residuals(x, b, ((1, 1), (2, 2))).item() == 0.5


def dense_poisson(n):
    """The 5-point operator on an n x n grid as a dense matrix (ring rows identity)."""
    idx = np.arange(n * n).reshape(n, n)
    a = np.eye(n * n)
    for i in range(1, n - 1):
        for j in range(1, n - 1):
            r = idx[i, j]
            a[r, r] = 4.0
            for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                a[r, idx[i + di, j + dj]] = -1.0
    return a


def test_cg_against_a_dense_solve():
    n = 10
    interior = ((1, 1), (n - 1, n - 1))
    b = torch.zeros(n, n, dtype=torch.float64)
    b[1:-1, 1:-1] = torch.randn(n - 2, n - 2, generator=torch.Generator().manual_seed(1),
                                dtype=torch.float64)
    x, iters = poisson2d_5pt.cg(b, interior, 1e-12, 500)
    want = np.linalg.solve(dense_poisson(n), b.numpy().ravel()).reshape(n, n)
    assert np.abs(x.numpy() - want).max() < 1e-10
    assert 0 < iters <= (n - 2) ** 2
    assert poisson2d_5pt.rel_residuals(x[None], b[None], interior).item() < 1e-11
    # the control stops far from the answer
    low = poisson2d_5pt.lower_precision_solver(interior, 1e-4, 500)(b.float())
    assert poisson2d_5pt.rel_residuals(low[None], b[None], interior).item() > 1e-3
