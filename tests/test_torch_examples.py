"""The shipped examples run through the port on the CPU, against the JAX
package's run of the same examples: `examples/allen_cahn.py`'s three
integrators (20 steps each), `examples/swe_implicit.py`'s 10 steps,
`examples/multigrid_poisson.py` at 128^2 and the precond="mg" row of
`examples/preconditioned_poisson.py`.

The examples import the JAX package and are not edited, so the port's
programs are written out in `torch_examples.py` (which imports the port
only); the examples' own functions give the reference, in f64. Energies,
heights and states agree to 1e-10.
"""

import re
import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import neptune_tpu as ntp  # noqa: E402
import neptune_tpu_torch as ntt  # noqa: E402
import torch_examples  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"
TOL = 1e-10


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(torch_config, "device", "cpu")


@pytest.fixture(autouse=True)
def fresh_contexts():
    ntp.reset_context()
    ntt.reset_context()
    yield
    ntp.reset_context()
    ntt.reset_context()


def _rel(got, ref):
    return np.abs(np.asarray(got) - np.asarray(ref)).max() / max(np.abs(ref).max(), 1.0)


def test_allen_cahn_three_integrators():
    ex = runpy.run_path(str(EXAMPLES / "allen_cahn.py"))  # defines its opdefs
    x = np.linspace(-1, 1, ex["N"])
    u0 = 0.9 * np.sign(np.sin(4 * np.pi * x)) + 0.05 * np.cos(2 * np.pi * x)
    ref = []
    for step in (
        ex["imex_step"],
        ex["newton_step"],
        lambda u: ntp.time_advance(u, ex["DT"], "explicit", rhs=ex["ac_rhs"], scheme="rk4"),
    ):
        u = u0.copy()
        for _ in range(20):
            u = np.asarray(step(u))
        ref.append((float(np.sum(u**2)), u))
    got = torch_examples.allen_cahn_energies(u0, 20)
    for (e_ref, u_ref), (e, u) in zip(ref, got):
        assert abs(e - e_ref) <= TOL * abs(e_ref)
        assert _rel(u, u_ref) <= TOL


def test_swe_implicit_ten_steps():
    ex = runpy.run_path(str(EXAMPLES / "swe_implicit.py"))
    solver = ex["ImplicitSWESolver"](dt=0.1, dx=1.0, nx=100)
    h = np.ones(100)
    h[:50] = 2.0
    q = np.zeros(100)
    ref_rows = []
    for _ in range(10):
        h, q = (np.asarray(a) for a in solver.step(h, q))
        ref_rows.append((h.mean(), np.abs(q).max()))
    rows, (h_got, q_got) = torch_examples.swe_run(10)
    for (hm_ref, qm_ref), (hm, qm) in zip(ref_rows, rows):
        assert abs(hm - hm_ref) <= TOL and abs(qm - qm_ref) <= TOL * max(qm_ref, 1.0)
    assert _rel(h_got, h) <= TOL and _rel(q_got, q) <= TOL


def test_multigrid_poisson_128():
    """examples/multigrid_poisson.py's main() at 128^2 in f64: V-cycles, plain
    CG and MG-preconditioned CG iterations within 1 of the JAX package's,
    the error against u* within 1e-8 of its."""
    ex = runpy.run_path(str(EXAMPLES / "multigrid_poisson.py"))
    tol = torch_examples.MG_TOL
    ops = [ntp.assemble_matrix(ex["poisson"](n, "float64")) for n in torch_examples.MG_SIZES]
    u_star = torch_examples.mg_manufactured()
    b = ops[0].matvec(jnp.asarray(u_star))
    x, info = ex["multigrid_solve"](ops, b, tol=tol, maxiter=60)
    _, plain = ex["cg"](ops[0].matvec, b, tol=tol, maxiter=20000)
    _, pre = ex["cg"](ops[0].matvec, b, tol=tol, maxiter=200, M=ex["mg_preconditioner"](ops, b))
    err_ref = float(np.abs(np.asarray(x) - u_star).max())
    got = torch_examples.multigrid_poisson_run()
    assert all(got["converged"])
    for key, ref in (("cycles", info.iters), ("cg", plain.iters), ("pcg", pre.iters)):
        assert abs(got[key] - int(ref)) <= 1, (key, got[key], int(ref))
    assert got["resnorm"] <= tol * float(np.linalg.norm(np.asarray(b)))
    assert abs(got["err"] - err_ref) <= 1e-8, (got["err"], err_ref)


def test_preconditioned_poisson_mg_row(capsys):
    """examples/preconditioned_poisson.py's ("mg", {"mg_levels": 4}) row: CG
    iterations (each package's verbose KSP line) within 1, the relative
    residual under 1e-10, the solution within 1e-8 of the example's."""
    capsys.readouterr()
    ex = runpy.run_path(str(EXAMPLES / "preconditioned_poisson.py"))
    ref_it = int(re.findall(r"KSP\(cg\) poisson: iters=(\d+)", capsys.readouterr().out)[-1])
    x_ref = ex["x"]  # the last row's solution
    x, rel = torch_examples.preconditioned_poisson_mg()
    (it,) = re.findall(r"KSP\(cg\) poisson: iters=(\d+)", capsys.readouterr().out)
    assert abs(int(it) - ref_it) <= 1, (it, ref_it)
    assert rel <= torch_examples.PC_TOL and ex["results"]["mg"][1] <= ex["TOL"] * 1.01
    assert np.abs(x - np.asarray(x_ref)).max() <= 1e-8 * np.abs(np.asarray(x_ref)).max()
