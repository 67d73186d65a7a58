"""The port's implicit derivatives (`differentiable_solve`,
`differentiable_root`) and `simulate`, against the JAX package's
(`tests/test_diff.py`'s six cases) and against central differences taken
on the port, on the CPU in f64.

Gradients agree with `jax.grad` to GRAD_TOL relative (both solves run to
1e-13) and with differences to the tolerances of `tests/test_diff.py`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neptune_tpu as ntp  # noqa: E402
import neptune_tpu_torch as ntt  # noqa: E402
from neptune_tpu.solvers.diff import differentiable_root as jax_root  # noqa: E402
from neptune_tpu.solvers.diff import differentiable_solve as jax_solve  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.solvers.diff import differentiable_root, differentiable_solve  # noqa: E402

GRAD_TOL = 1e-8


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


def jlap(x):
    return 2 * x - jnp.roll(x, 1).at[0].set(0) - jnp.roll(x, -1).at[-1].set(0)


def tlap(x):
    zero = x.new_zeros(1)
    return 2 * x - torch.cat([zero, x[:-1]]) - torch.cat([x[1:], zero])


def _grad(loss, x: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(x.copy()).requires_grad_(True)
    (g,) = torch.autograd.grad(loss(t), t)
    return g.numpy()


def _fd(loss, x: np.ndarray, eps=1e-6, sample=6):
    """Central differences of the port's loss at a few sampled indices."""
    rng = np.random.default_rng(42)
    idx = rng.choice(x.size, size=min(sample, x.size), replace=False)
    vals = []
    with torch.no_grad():
        for i in idx:
            d = np.zeros_like(x)
            d.flat[i] = eps
            hi = float(loss(torch.from_numpy(x + d)))
            lo = float(loss(torch.from_numpy(x - d)))
            vals.append((hi - lo) / (2 * eps))
    return idx, np.asarray(vals)


def _check(got, ref, fd=None, rtol=1e-4, atol=1e-6):
    ref = np.asarray(ref)
    assert np.abs(got - ref).max() <= GRAD_TOL * np.abs(ref).max()
    if fd is not None:
        idx, vals = fd
        np.testing.assert_allclose(got.flat[idx], vals, rtol=rtol, atol=atol)


def test_grad_wrt_rhs():
    b = np.random.default_rng(0).standard_normal(24)

    def loss(bb):
        return torch.sum(differentiable_solve(tlap, bb, solver="cg", symmetric=True, tol=1e-13) ** 2)

    ref = jax.grad(lambda bb: jnp.sum(jax_solve(jlap, bb, solver="cg", symmetric=True,
                                                tol=1e-13) ** 2))(jnp.asarray(b))
    _check(_grad(loss, b), ref, _fd(loss, b))


def test_grad_wrt_operator_parameter():
    b = np.random.default_rng(1).standard_normal(16)

    def loss(theta):
        x = differentiable_solve(lambda x: theta * x + tlap(x), torch.from_numpy(b),
                                 solver="cg", symmetric=True, tol=1e-13)
        return torch.sum(x)

    ref = jax.grad(lambda th: jnp.sum(jax_solve(lambda x: th * x + jlap(x), jnp.asarray(b),
                                                solver="cg", symmetric=True, tol=1e-13)))(1.5)
    theta = np.asarray(1.5)
    g = _grad(loss, theta)
    _check(g, ref)
    eps = 1e-6
    with torch.no_grad():
        fd = (float(loss(torch.tensor(1.5 + eps, dtype=torch.float64)))
              - float(loss(torch.tensor(1.5 - eps, dtype=torch.float64)))) / (2 * eps)
    assert abs(float(g) - fd) < 1e-5 * max(1.0, abs(fd))


def test_grad_through_opdef_solve():
    # a stencil opdef's solve, nonsymmetric solver: the adjoint takes Aᵀ
    # through torch.func.vjp of the opdef (its derivative rule)
    def matvec(nt):
        @nt.linear_op_def(bounds=([0], [32]), interior=([1], [31]))
        def lap(u):
            return 2.0 * u[0] - u[-1] - u[1]

        return nt.get_context().compiled().opdef("lap")

    b = np.random.default_rng(2).standard_normal(32)
    jmv = matvec(ntp)
    ref = jax.grad(lambda bb: jnp.sum(jnp.sin(jax_solve(
        jmv, bb, solver="bicgstab", tol=1e-13, maxiter=2000))))(jnp.asarray(b))
    mv = matvec(ntt)

    def loss(bb):
        return torch.sum(torch.sin(differentiable_solve(mv, bb, solver="bicgstab", tol=1e-13,
                                                        maxiter=2000)))

    _check(_grad(loss, b), ref, _fd(loss, b), rtol=1e-3)


def test_jvp_through_solve():
    # forward mode: the tangent of x = A⁻¹ b is A⁻¹ db
    rng = np.random.default_rng(5)
    b, db = (torch.from_numpy(rng.standard_normal(24)) for _ in range(2))
    _, tan = torch.func.jvp(
        lambda bb: differentiable_solve(tlap, bb, solver="cg", symmetric=True, tol=1e-13),
        (b,), (db,))
    A = np.diag(2 * np.ones(24)) - np.diag(np.ones(23), 1) - np.diag(np.ones(23), -1)
    want = np.linalg.solve(A, db.numpy())
    assert np.abs(tan.numpy() - want).max() <= GRAD_TOL * np.abs(want).max()


def test_grad_through_newton():
    b = np.asarray([0.5, 1.0, 2.0, 3.0])

    def loss(bb):
        return torch.sum(differentiable_root(lambda x: x**3 + x - bb, torch.zeros_like(bb),
                                             tol=1e-13))

    ref = jax.grad(lambda bb: jnp.sum(jax_root(lambda x: x**3 + x - bb, jnp.zeros_like(bb),
                                               tol=1e-13)))(jnp.asarray(b))
    g = _grad(loss, b)
    _check(g, ref)
    x = b / 2
    for _ in range(100):
        x = x - (x**3 + x - b) / (3 * x**2 + 1)
    np.testing.assert_allclose(g, 1.0 / (3 * x**2 + 1), rtol=1e-8)


def test_grad_through_implicit_step():
    dt = 0.5
    u0 = np.random.default_rng(3).standard_normal(16)

    def loss(u_prev):
        u = differentiable_root(lambda u: u + dt * tlap(u) - u_prev, u_prev, tol=1e-13)
        return torch.sum(u**2)

    ref = jax.grad(lambda up: jnp.sum(jax_root(lambda u: u + dt * jlap(u) - up, up,
                                               tol=1e-13) ** 2))(jnp.asarray(u0))
    _check(_grad(loss, u0), ref, _fd(loss, u0), atol=1e-7)


def test_grad_through_implicit_opdef_step():
    # the Allen–Cahn implicit step of an opdef (its derivative rule in the
    # residual), the gradient with respect to u_prev
    n = 32

    def residual_of(nt):
        @nt.nonlinear_op_def(bounds=([0], [n]), name="ac_res")
        def ac_res(u, u_prev):
            i = nt.index(0)
            lap = 100.0 * (u[-1] - 2.0 * u[0] + u[1])
            interior = u[0] - u_prev[0] - 0.01 * (0.01 * lap + u[0] - u[0] * u[0] * u[0])
            return nt.where((i == 0) | (i == n - 1), u[0] - u_prev[0], interior)

        return nt.get_context().compiled().opdef("ac_res")

    u0 = 0.9 * np.sin(np.linspace(0, 2 * np.pi, n))
    jres = residual_of(ntp)
    ref = jax.grad(lambda up: jnp.sum(jax_root(lambda u: jres(u, up), up, tol=1e-13) ** 2))(
        jnp.asarray(u0))
    res = residual_of(ntt)

    def loss(up):
        return torch.sum(differentiable_root(lambda u: res(u, up), up, tol=1e-13) ** 2)

    _check(_grad(loss, u0), ref, _fd(loss, u0), atol=1e-7)


def test_grad_through_simulate():
    u0 = np.random.default_rng(0).standard_normal(12)

    def loss(u):
        return torch.sum(ntt.simulate(lambda s: s - 0.1 * tlap(s), u, 20, differentiable=True,
                                      jit=False) ** 2)

    ref = jax.grad(lambda u: jnp.sum(ntp.simulate(lambda s: s - 0.1 * jlap(s), u, 20,
                                                  differentiable=True, jit=False) ** 2))(
        jnp.asarray(u0))
    _check(_grad(loss, u0), ref, _fd(loss, u0), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("record_every", [None, 3, 7])
def test_simulate_matches_jax(record_every):
    rng = np.random.default_rng(4)
    u0, v0 = rng.standard_normal(12), rng.standard_normal(12)

    def step_of(lap):
        return lambda s: (s[0] - 0.1 * lap(s[0]) + 0.01 * s[1], s[1] - 0.05 * lap(s[1]))

    ref = ntp.simulate(step_of(jlap), (jnp.asarray(u0), jnp.asarray(v0)), 20,
                       record_every=record_every)
    got = ntt.simulate(step_of(tlap), (torch.from_numpy(u0), torch.from_numpy(v0)), 20,
                       record_every=record_every)
    if record_every is not None:
        (ref, ref_traj), (got, got_traj) = ref, got
        for r, g in zip(ref_traj, got_traj):
            assert g.shape == r.shape == (20 // record_every, 12)
            assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-12
    for r, g in zip(ref, got):
        assert not g.requires_grad
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-12
