"""HPCG's problem as a user of the port writes it: the 27-point operator
(diagonal 26, each of the 26 neighbours -1) as a `linear_op_def` over the
unknowns inside a one-cell ring of zeros (HPCG's absent neighbours), held
by a `@ntt.jit_class` whose traced method calls `ntt.solve_linear` with
HPCG's cycle: CG, tolerance 0, 50 iterations, `precond="mg"` with four
levels of vertex coarsening, injection, unscaled coarse operators and one
symmetric multicolour Gauss-Seidel sweep before and after, and one on the
coarsest level. A grid of rank 2 gives the 9-point operator."""

from __future__ import annotations

import itertools


def solver(cfg: dict, options: dict):
    """b -> x, HPCG's preconditioned CG through the port's DSL."""
    import neptune_tpu_torch as ntt

    ntt.reset_context()
    (lo, hi), (ilo, ihi) = cfg["bounds"], cfg["interior"]
    rank = len(lo)
    neighbours = [o for o in itertools.product((-1, 0, 1), repeat=rank) if any(o)]
    centre = (0,) * rank

    @ntt.linear_op_def(bounds=(lo, hi), interior=(ilo, ihi), dtype=cfg["dtype"], name="hpcg27")
    def hpcg27(u):
        acc = float(3**rank - 1) * u[centre]
        for o in neighbours:
            acc = acc - u[o]
        return acc

    @ntt.jit_class
    class HPCG:
        def __init__(self):
            self.A = ntt.assemble_matrix(hpcg27)

        def solve(self, b):
            return ntt.solve_linear(
                self.A, b, solver=cfg["solver"], tol=cfg["tol"], max_iters=cfg["max_iters"],
                precond="mg", options=options,
            )

    return HPCG().solve
