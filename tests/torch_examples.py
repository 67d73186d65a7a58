"""The port's runs of `examples/allen_cahn.py`, `examples/swe_implicit.py`,
`examples/multigrid_poisson.py` (at 128^2) and the multigrid row of
`examples/preconditioned_poisson.py`, through the port's own programs
(`neptune_tpu_torch/examples/`), as `test_torch_examples.py` calls them.

Each call runs the example's module afresh (`runpy.run_module`), so its
opdefs land in the current DSL context; the examples read `--cpu` from the
command line, which the test file sets (f64 on the CPU). This module
imports the port only."""

import runpy

import numpy as np


def port_example(name: str) -> dict:
    """The namespace of a fresh run of `neptune_tpu_torch.examples.<name>`."""
    return runpy.run_module(f"neptune_tpu_torch.examples.{name}")


def allen_cahn_energies(u0: np.ndarray, steps: int = 20) -> list:
    """The example's main(): the energy after `steps` steps of each of its
    three integrators, and the final states."""
    ex = port_example("allen_cahn")
    out = []
    for step in (ex["imex_step"], ex["newton_step"], ex["rk4_step"]):
        u = ex["integrate"](step, u0, steps)
        out.append((float(np.sum(u**2)), u))
    return out


def swe_run(steps: int = 10):
    """The example's main(): (average height, max |q|) after each step, and
    the final (h, q)."""
    r = port_example("swe_implicit")["main"](steps)
    return [tuple(row) for row in r["rows"]], (r["h"], r["q"])


# examples/multigrid_poisson.py, at MG_N^2 in f64
MG_N = 128
MG_SIZES = [128, 64, 32, 16]
MG_TOL = 1e-9


def mg_manufactured(n=MG_N) -> np.ndarray:
    """The example's u*: smooth, zero on the boundary ring."""
    return port_example("multigrid_poisson")["manufactured"](n)


def multigrid_poisson_run() -> dict:
    """The example's main() at MG_N^2: V-cycles and the error against u*,
    plain CG's iterations and MG-preconditioned CG's."""
    return port_example("multigrid_poisson")["main"](MG_SIZES)


# examples/preconditioned_poisson.py's precond="mg" row
PC_N = 256
PC_TOL = 1e-10


def preconditioned_poisson_mg():
    """(x, relative residual) of the example's ("mg", {"mg_levels": 4}) row:
    CG on the 256^2 Poisson system with boundary data, verbose."""
    ex = port_example("preconditioned_poisson")
    x, rel, _ = ex["solve"](ex["rhs"](), "mg", {"mg_levels": 4})
    return x, rel
