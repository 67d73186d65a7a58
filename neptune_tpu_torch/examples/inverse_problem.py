"""Inverse problem through differentiable solves: recover a source term
from a noisy observation of the PDE solution. We observe u_obs ~ A^-1
f_true for a shifted Poisson operator A and minimize ||A^-1 f - u_obs||^2
by plain gradient descent; each gradient costs one forward and one adjoint
solve (`ntt.differentiable_solve`, reverse mode through `torch.autograd`).
The port of `examples/inverse_problem.py`; its noise comes from a
`torch.Generator` seeded 0.

Run: python -m neptune_tpu_torch.examples.inverse_problem [--cpu]
"""

import numpy as np
import torch

import neptune_tpu_torch as ntt
from neptune_tpu_torch.examples import _cli

N = 48
ITERS = 200
LR = 10.0


@ntt.linear_op_def(bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]))
def A(u):
    # shifted Poisson (well-conditioned): 0.1 u + lap(u)
    return 0.1 * u[0, 0] + 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]


def source() -> np.ndarray:
    """The ground truth: two Gaussian sources."""
    xx, yy = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    return np.exp(-((xx - 15) ** 2 + (yy - 15) ** 2) / 20.0) - 0.7 * np.exp(
        -((xx - 32) ** 2 + (yy - 30) ** 2) / 30.0
    )


def noise(shape) -> torch.Tensor:
    """The observation noise, 1e-4 N(0, 1), from a generator seeded 0 (f64, CPU)."""
    gen = torch.Generator().manual_seed(0)
    return 1e-4 * torch.randn(shape, generator=gen, dtype=torch.float64)


def forward(mv, f):
    return ntt.differentiable_solve(mv, f, solver="cg", symmetric=True, tol=1e-12, maxiter=3000)


def observe(mv, f_true, eps=None):
    """u_obs = A^-1 f_true + noise (eps, or `noise`'s draw)."""
    u_obs = forward(mv, f_true)
    return u_obs + (noise(u_obs.shape) if eps is None else torch.as_tensor(eps)).to(u_obs)


def loss(mv, f, u_obs):
    return torch.mean((forward(mv, f) - u_obs) ** 2)


def grad(mv, f, u_obs):
    """d loss / d f: one forward solve, one adjoint solve."""
    f = f.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(mv, f, u_obs), f)
    return g


def main(iters: int = ITERS, eps=None) -> dict:
    dev = _cli.device()
    mv = ntt.get_context().compiled().opdef("A")
    dtype = getattr(torch, ntt.config.default_dtype)  # the opdef's: it names none

    f_true = torch.as_tensor(source(), dtype=dtype, device=dev)
    u_obs = observe(mv, f_true, eps)

    f = torch.zeros((N, N), dtype=dtype, device=dev)
    losses = []
    print("recovering the source term by gradient descent through the solver:")
    for it in range(iters):
        f = f - LR * grad(mv, f, u_obs)
        if it % 40 == 0:
            err = float((f - f_true).abs().max())
            with torch.no_grad():
                losses.append(float(loss(mv, f, u_obs)))
            print(f"  iter {it:3d}: loss={losses[-1]:.3e}  max|f-f_true|={err:.3f}")

    err = float((f - f_true).abs().max())
    rel = err / float(f_true.abs().max())
    print(f"final max error {err:.4f} ({rel:.1%} of peak source)")
    return {"err": err, "rel": rel, "losses": np.array(losses), "f": f.cpu().numpy()}


if __name__ == "__main__":
    main()
