"""The port's Chebyshev iteration (`solvers/chebyshev.py`) against the JAX
package's, on the CPU in f64: `power_method`, `estimate_spectrum`, both
loop forms (`check_every=0` and `check_every=k`), residual replacement and
`replace_every`, the host reads of each loop form, and `solver="chebyshev"`
through the DSL and the IR executor with option validation, as
tests/test_chebyshev.py runs them. Solutions and spectrum bounds agree
within 1e-12 relative, iteration counts exactly (their tests are read on
the host at the same points).
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import neptune_tpu as ntp  # noqa: E402
import neptune_tpu_torch as ntt  # noqa: E402
import neptune_tpu_torch.ir as tir  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.passes import compile_ir as jax_compile_ir  # noqa: E402
from neptune_tpu.solvers import chebyshev as jax_chebyshev  # noqa: E402
from neptune_tpu.solvers import estimate_spectrum as jax_estimate  # noqa: E402
from neptune_tpu.solvers import power_method as jax_power  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.passes import compile_ir  # noqa: E402
from neptune_tpu_torch.solvers import chebyshev, estimate_spectrum, power_method  # noqa: E402
from neptune_tpu_torch.solvers import krylov  # noqa: E402
from neptune_tpu_torch.utils.options import linear_option_kwargs  # noqa: E402

TOL = 1e-12  # f64, relative to the largest |value|

# the module itself: the package attribute `solvers.chebyshev` is the function
cheb_mod = __import__("sys").modules["neptune_tpu_torch.solvers.chebyshev"]


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


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _rel(got, ref) -> float:
    ref = _np(ref)
    return float(np.abs(_np(got) - ref).max() / max(np.abs(ref).max(), 1e-300))


def jax_poisson_1d(x):
    xm = jnp.pad(x, 1)
    return 2.0 * x - xm[:-2] - xm[2:]


def torch_poisson_1d(x):
    xm = torch.nn.functional.pad(x, (1, 1))
    return 2.0 * x - xm[:-2] - xm[2:]


def bounds_1d(n):
    """The exact spectrum ends of tridiag(-1, 2, -1)."""
    return 2.0 - 2.0 * np.cos(np.pi / (n + 1)), 2.0 - 2.0 * np.cos(n * np.pi / (n + 1))


def _both(n, seed, **kw):
    """chebyshev on the 1-D Poisson system in both packages: (x_ref, info_ref,
    x, info)."""
    b = np.random.default_rng(seed).standard_normal(n)
    x_ref, i_ref = jax_chebyshev(jax_poisson_1d, jnp.asarray(b), **kw)
    x, info = chebyshev(torch_poisson_1d, torch.from_numpy(b), **kw)
    return x_ref, i_ref, x, info


def test_power_method_and_estimate_spectrum():
    n = 64
    b = np.random.default_rng(2).standard_normal(n)
    inv = np.linspace(0.4, 0.6, n)
    for M_j, M_t in ((None, None), (lambda v: jnp.asarray(inv) * v,
                                    lambda v: torch.from_numpy(inv) * v)):
        ref = jax_power(jax_poisson_1d, jnp.asarray(b), 40, M_j)
        got = power_method(torch_poisson_1d, torch.from_numpy(b), 40, M_t)
        assert got.ndim == 0 and _rel(got, ref) <= TOL
    est_ref = jax_estimate(jax_poisson_1d, jnp.asarray(b), iters=200)
    est = estimate_spectrum(torch_poisson_1d, torch.from_numpy(b), iters=200)
    lmin, lmax = bounds_1d(n)
    assert float(est.lam_max) >= lmax and float(est.lam_max) <= 1.2 * lmax
    for got, ref in zip(est, est_ref):
        assert _rel(got, ref) <= TOL


@pytest.mark.parametrize(
    "kw",
    [
        dict(maxiter=800, tol=1e-10),  # check_every=0: a fixed count
        dict(maxiter=5000, tol=1e-8, check_every=25),  # stops early
        dict(maxiter=700, tol=1e-12, residual_replacement=False),
        dict(maxiter=1000, tol=1e-8, check_every=0, replace_every=100),
        dict(maxiter=3000, tol=1e-8, check_every=40, residual_replacement=False),
    ],
    ids=["fixed", "check25", "no_replacement", "replace_every", "check40_no_replacement"],
)
def test_loop_forms(kw):
    lmin, lmax = bounds_1d(64)
    x_ref, i_ref, x, info = _both(64, 0, lam_min=lmin, lam_max=lmax, **kw)
    assert info.iters == int(i_ref.iters) and info.converged == bool(i_ref.converged)
    assert info.converged and info.iters < kw["maxiter"] or not kw.get("check_every")
    bnorm = np.linalg.norm(np.random.default_rng(0).standard_normal(64))
    assert abs(info.resnorm - float(i_ref.resnorm)) <= TOL * bnorm  # near the f64 floor
    assert _rel(x, x_ref) <= TOL


def test_estimated_bounds_solve():
    x_ref, i_ref, x, info = _both(64, 2, maxiter=2500, tol=1e-8, spectrum_iters=200)
    assert info.converged and bool(i_ref.converged)
    assert _rel(x, x_ref) <= 1e-10  # the bounds' rounding grows over 2500 iterations
    b = np.random.default_rng(2).standard_normal(64)
    r = b - _np(torch_poisson_1d(x))
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b)


@pytest.fixture
def host_reads(monkeypatch):
    """Counts the early-stopping loop's host reads and every norm taken."""
    calls = {"reads": 0, "norms": 0}
    real_test, real_norm = cheb_mod._unconverged, cheb_mod.tnorm

    def counting_test(*a):
        calls["reads"] += 1
        return real_test(*a)

    def counting_norm(a):
        calls["norms"] += 1
        return real_norm(a)

    monkeypatch.setattr(cheb_mod, "_unconverged", counting_test)
    monkeypatch.setattr(cheb_mod, "tnorm", counting_norm)
    monkeypatch.setattr(krylov, "tnorm", lambda a, group=None: counting_norm(a))
    return calls


def test_fixed_loop_reads_nothing_until_the_end(host_reads):
    lmin, lmax = bounds_1d(64)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(64))
    chebyshev(torch_poisson_1d, b, lam_min=lmin, lam_max=lmax, maxiter=200, replace_every=50)
    # ||b|| for the target and the final ||r||: no reduction in the loop
    assert host_reads == {"reads": 0, "norms": 2}


def test_check_every_reads_once_per_check(host_reads):
    lmin, lmax = bounds_1d(64)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(64))
    _, info = chebyshev(torch_poisson_1d, b, lam_min=lmin, lam_max=lmax, maxiter=5000,
                        tol=1e-8, check_every=25)
    checks = (info.iters - 1) // 25
    assert info.converged and host_reads["reads"] == checks + 1  # and once before the loop
    assert host_reads["norms"] == checks + 2  # ||b||, then ||r1|| and one per check


def test_smooth_is_chebyshev_without_its_residual():
    lmin, lmax = bounds_1d(32)
    rng = np.random.default_rng(6)
    b, x0 = (torch.from_numpy(a) for a in rng.standard_normal((2, 32)))
    inv = torch.full((32,), 0.5, dtype=torch.float64)
    for n in (1, 2, 5):
        kw = dict(M=lambda v: inv * v, lam_min=lmax / 4.0, lam_max=lmax, maxiter=n)
        assert torch.equal(cheb_mod.smooth(torch_poisson_1d, b, x0, **kw),
                           chebyshev(torch_poisson_1d, b, x0=x0, **kw)[0])


def _ksp_iters(text: str) -> list:
    return [int(m) for m in re.findall(r"KSP\([^)]*\) \S+: iters=(\d+)", text)]


def _dsl_case(nt, n=32):
    @nt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
                      name="poisson_ch")
    def poisson_ch(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    H = nt.assemble_matrix(poisson_ch)
    b = np.random.default_rng(5).standard_normal((n, n))
    x = nt.solve_linear(H, b, solver="chebyshev", tol=1e-8, max_iters=4000, verbose=True,
                        options={"lam_max": 8.0, "lam_min": 5e-3, "check_every": 50})
    return H, b, x


def test_dsl_dispatch(capsys):
    """solver="chebyshev" through the eager DSL (it raised 'unknown linear
    solver' before the port registered it)."""
    its = []
    for nt in (ntp, ntt):
        capsys.readouterr()
        H, b, x = _dsl_case(nt)
        its.append(_ksp_iters(capsys.readouterr().out))
        xs = _np(x)
        r = b - _np(H.matvec(jnp.asarray(xs) if nt is ntp else torch.from_numpy(xs)))
        assert np.linalg.norm(r) <= 1e-6 * np.linalg.norm(b)
        if nt is ntp:
            ref = xs
    assert its[0] == its[1] and len(its[0]) == 1, its
    assert _rel(x, ref) <= TOL


def _ir_program(n):
    """solve_linear(solver="chebyshev") on an absorbed-h² 5-pt Laplacian,
    Jacobi-preconditioned: the port's module and the JAX package's parse of
    its text."""
    module = stencils.with_solve(
        stencils.poisson5(n, "float64"), "poisson", solver="chebyshev", tol=1e-8,
        max_iters=2000, precond="jacobi", verbose=True,
        options={"lam_min": 1.2e-3, "lam_max": 2.0, "check_every": 10})
    return module, jax_parse(tir.print_module(module))


def test_ir_executor_dispatch(capsys):
    n = 32
    bb = np.random.default_rng(7).standard_normal((n, n))
    module, jax_module = _ir_program(n)
    capsys.readouterr()
    ref = np.asarray(jax_compile_ir(jax_module).function("solve")(bb))
    ref_it = _ksp_iters(capsys.readouterr().out)
    got = compile_ir(module).function("solve")(bb)
    it = _ksp_iters(capsys.readouterr().out)
    assert it == ref_it and len(it) == 1
    assert _rel(got, ref) <= TOL


def test_option_validation():
    with pytest.raises(ValueError, match="only applies to solver='chebyshev'"):
        linear_option_kwargs("cg", {"lam_max": 4.0})
    with pytest.raises(ValueError, match="does not apply"):
        linear_option_kwargs("chebyshev", {"divtol": 1e5})
    kw = linear_option_kwargs("chebyshev", {"lam_min": 0.1, "lam_max": 4.0, "check_every": 10})
    assert kw == {"lam_min": 0.1, "lam_max": 4.0, "check_every": 10}
    assert krylov.SOLVERS["chebyshev"] is chebyshev
