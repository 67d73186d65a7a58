"""The 2-D 5-point Poisson solve as a user of the port writes it: a
`linear_op_def`, its assembled matrix held by a `@ntt.jit_class`, and a
traced method calling `ntt.solve_linear`, which reaches the executor's
solve site (kernel B for CG with no or Jacobi preconditioning; the
multigrid hierarchy for precond="mg")."""

from __future__ import annotations


def solver(cfg: dict, precond: str):
    """b -> x, CG to the configuration's tolerance, through the port's DSL."""
    import neptune_tpu_torch as ntt

    ntt.reset_context()
    (lo, hi), (ilo, ihi) = cfg["bounds"], cfg["interior"]

    @ntt.linear_op_def(bounds=(lo, hi), interior=(ilo, ihi), dtype=cfg["dtype"], name="poisson")
    def poisson(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    @ntt.jit_class
    class PoissonSolver:
        def __init__(self):
            self.H = ntt.assemble_matrix(poisson)

        def solve(self, b):
            return ntt.solve_linear(
                self.H, b, solver=cfg["solver"], tol=cfg["tol"], max_iters=cfg["max_iters"],
                precond=precond,
            )

    return PoissonSolver().solve
