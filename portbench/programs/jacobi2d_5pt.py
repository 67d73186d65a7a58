"""The 2-D 5-point Jacobi step as a user of the port writes it: a
`linear_op_def` over the configuration's bounds and interior, called as
`u = jacobi(u)`, or `ntt.sweeps(jacobi, k)` for k steps per call."""

from __future__ import annotations


def stepper(cfg: dict, sweeps: int):
    """u -> the state after `sweeps` steps, through the port's DSL."""
    import neptune_tpu_torch as ntt

    ntt.reset_context()
    (lo, hi), (ilo, ihi) = cfg["bounds"], cfg["interior"]

    @ntt.linear_op_def(bounds=(lo, hi), interior=(ilo, ihi), dtype=cfg["dtype"])
    def jacobi(u):
        return 0.25 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1])

    return jacobi if sweeps == 1 else ntt.sweeps(jacobi, sweeps)
