"""The shipped examples run through the port on the CPU, against the JAX
package's run of the same examples: `examples/allen_cahn.py`'s three
integrators (20 steps each) and `examples/swe_implicit.py`'s 10 steps.

The examples import the JAX package and are not edited, so the port's
programs are written out in `torch_examples.py` (which imports the port
only); the examples' own functions give the reference, in f64. Energies,
heights and states agree to 1e-10.
"""

import runpy
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
