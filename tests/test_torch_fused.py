"""Kernel B's plain version against the JAX package's fused-CG Pallas
kernel (interpret mode) at 64^2: unpreconditioned, Jacobi, and a composite
operator whose inner `apply_linear` the kernel inlines. Then the ring lift
of the executor's solve site against the JAX executor's generic CG, which
lifts the same ring."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.lowering.executor import CompiledModule as JaxCompiledModule  # noqa: E402
from neptune_tpu.solvers import fused as jax_fused  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.ir import F32, Bounds, NeptuneBuilder, TempType  # noqa: E402
from neptune_tpu_torch.ir import print_module, verify_and_annotate  # noqa: E402
from neptune_tpu_torch.kernels import codegen  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from neptune_tpu_torch.solvers import fused  # noqa: E402
from neptune_tpu_torch.solvers.precond import extract_diagonal, safe_inv_diag  # noqa: E402

N = 64
TOL = 1e-4


def composite(n=N):
    """@shifted(x) = x + 0.1 * lap_in(x), lap_in the 5-pt Poisson operator
    (the composite of tests/test_fused.py)."""
    lap = stencils.poisson5(n)
    b = NeptuneBuilder(lap)
    tt = TempType("float32", Bounds.of([0, 0], [n, n]))
    fn = b.make_opdef("shifted", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    lapx = b.apply_linear("poisson", [fn.body.args[0]])
    op, body = b.start_apply([fn.body.args[0], lapx], tt.bounds)
    b.push_block(body)
    x0 = b.access(body.args[2], [0, 0])
    l0 = b.access(body.args[3], [0, 0])
    b.yield_(b.add(x0, b.mul(b.constant(0.1, F32), l0)))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return verify_and_annotate(b.module), "shifted"


def poisson(n=N):
    return stencils.poisson5(n), "poisson"


@pytest.mark.parametrize(
    "make, jacobi",
    [(poisson, False), (poisson, True), (composite, False)],
    ids=["poisson", "poisson_jacobi", "composite"],
)
def test_plain_matches_pallas_fused_cg(make, jacobi):
    module, name = make()
    jax_module = jax_verify(jax_parse(print_module(module)))
    b = np.random.default_rng(3).standard_normal((N, N)).astype(np.float32)
    if jacobi:
        # fused_cg_plain without `lift` does not lift the Dirichlet ring, as
        # the JAX kernel does not (a solve site, fused_cg, lifts it), and
        # Jacobi's ring diagonal of 1 breaks CG's M-symmetry when b carries
        # ring data; a zero ring keeps the true residual at tol
        b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = 0.0
    stages = fused.matvec_plan(module, name)
    matvec = fused.plain_matvec(stages)
    inv_diag = None
    if jacobi:
        like = torch.zeros((N, N), dtype=torch.float32)
        inv_diag = safe_inv_diag(extract_diagonal(matvec, like, ((1, 1), (1, 1))))

    x_ref, it_ref, _ = jax_fused.fused_cg(
        jax_module, name, tol=TOL, maxiter=2000, interpret=True,
        inv_diag=None if inv_diag is None else jnp.asarray(inv_diag.numpy()),
    )(jnp.asarray(b))
    x, it, rn = fused.fused_cg_plain(matvec, torch.from_numpy(b), tol=TOL, maxiter=2000,
                                     inv_diag=inv_diag)
    assert abs(int(it) - int(it_ref)) <= 1
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), atol=1e-4)
    bt = torch.from_numpy(b)
    assert float(rn) <= TOL * float(torch.linalg.norm(bt))
    true_res = float(torch.linalg.norm(bt - matvec(x)))
    assert true_res <= TOL * float(torch.linalg.norm(bt))


def test_composite_plan_inlines_apply_linear():
    module, name = composite()
    stages = fused.matvec_plan(module, name)
    assert [st.inputs for st in stages] == [["x"], ["x", 0]]
    plan = fused.cg_plan(module, name)
    assert plan.n_buffers == 1 and plan.reach == (1, 1)
    src = codegen.fused_cg_source(plan)
    # both stages run from shared memory with no grid barrier between them:
    # the two barriers of an iteration are the fixed kernel's, whatever the
    # stages
    assert "kBuffers = 1" in src and "barrier" not in src and "grid.sync" not in src
    assert src.count("nt_cg_stage<") == 1 and src.count("nt_cg_apply<") == 1
    assert "NT_DEFINE_FUSED_CG(NtCgPlan)" in src


def test_supported_gates():
    module, name = poisson()
    tt = module.lookup(name).ftype.inputs[0]
    assert fused.supported(module, name, tt)
    m64 = stencils.poisson5(16, "float64")
    assert not fused.supported(m64, "poisson", m64.lookup("poisson").ftype.inputs[0])
    big = stencils.poisson5(1024)  # 7 vectors of 4 MB > the 12 MiB cap
    assert not fused.supported(big, "poisson", big.lookup("poisson").ftype.inputs[0])
    m3 = stencils.heat7((8, 8, 8))
    assert not fused.supported(m3, "heat", m3.lookup("heat").ftype.inputs[0])


RING = ((1, N - 1), (1, N - 1))  # poisson5's interior: the ring is the outermost cells


def _ring_rhs(seed=4):
    """A right-hand side with data on the ring, as the Dirichlet values are."""
    return np.random.default_rng(seed).standard_normal((N, N)).astype(np.float32)


def _poisson_inv_diag(matvec):
    like = torch.zeros((N, N), dtype=torch.float32)
    return safe_inv_diag(extract_diagonal(matvec, like, ((1, 1), (1, 1))))


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_lifted_plain_matches_jax_generic_cg(precond):
    """The lifted recurrence solves what the JAX executor's generic CG
    solves on the CPU (CG on b - A lift, plus the lift)."""
    module, name = poisson()
    solve_mod = stencils.with_solve(module, name, solver="cg", tol=TOL, max_iters=2000,
                                    precond=precond)
    jm = jax_verify(jax_parse(print_module(solve_mod)))
    b = _ring_rhs()
    x_ref = np.asarray(JaxCompiledModule(jm, "auto").function("solve")(b))
    matvec = fused.plain_matvec(fused.matvec_plan(module, name))
    inv = _poisson_inv_diag(matvec) if precond == "jacobi" else None
    bt = torch.from_numpy(b)
    solve = fused.fused_cg(module, name, tol=TOL, maxiter=2000, inv_diag=inv)
    assert solve.lift == RING  # the site lifts the ring it finds
    x, it, rn = solve(bt)
    np.testing.assert_allclose(x.numpy(), x_ref, atol=1e-4)
    assert torch.equal(x[0], bt[0]) and torch.equal(x[:, -1], bt[:, -1])  # x = b on the ring
    bnorm = float(torch.linalg.norm(bt.double()))
    assert float(rn) <= TOL * bnorm
    true_res = float(torch.linalg.norm(bt.double() - matvec(x).double()))
    assert true_res <= 1.05 * TOL * bnorm


def test_lift_takes_fewer_iterations_under_jacobi():
    module, name = poisson()
    matvec = fused.plain_matvec(fused.matvec_plan(module, name))
    inv = _poisson_inv_diag(matvec)
    bt = torch.from_numpy(_ring_rhs())
    _, it_plain, _ = fused.fused_cg_plain(matvec, bt, tol=TOL, maxiter=2000, inv_diag=inv)
    _, it_lift, _ = fused.fused_cg_plain(matvec, bt, tol=TOL, maxiter=2000, inv_diag=inv,
                                         lift=RING)
    assert int(it_lift) < int(it_plain)


@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_zero_ring_lift_is_bitwise_unlifted(precond):
    """With b 0 on the ring the lift is 0 and r0 = b - A 0 = b exactly: the
    lifted recurrence is the unlifted one, bit for bit."""
    module, name = poisson()
    matvec = fused.plain_matvec(fused.matvec_plan(module, name))
    inv = _poisson_inv_diag(matvec) if precond == "jacobi" else None
    b = _ring_rhs()
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = 0.0
    bt = torch.from_numpy(b)
    x0, it0, rn0 = fused.fused_cg_plain(matvec, bt, tol=TOL, maxiter=2000, inv_diag=inv)
    x1, it1, rn1 = fused.fused_cg_plain(matvec, bt, tol=TOL, maxiter=2000, inv_diag=inv,
                                        lift=RING)
    assert int(it1) == int(it0) > 5
    assert torch.equal(rn1, rn0) and torch.equal(x1, x0)


@pytest.mark.parametrize(
    "make, lift",
    [(poisson, RING), (composite, None),
     (lambda: (stencils.shifted_laplacian((N, N), periodic=True), "shifted"), None)],
    ids=["copy_through_ring", "composite", "periodic"],
)
@pytest.mark.parametrize("precond", ["none", "jacobi"])
def test_solve_site_lifts_only_a_copy_through_ring(make, lift, precond, monkeypatch):
    """The executor's fused site lifts where the generic route's `ring_lift`
    gives a lift: a single apply with a copy-through ring. A composite
    operator (no known interior) and a periodic one (interior = the whole
    grid) get none, and their plan's interior box is the whole grid."""
    monkeypatch.setattr(torch_config, "device", "cpu")
    sites = []
    site = fused.fused_cg

    def spy(*a, **k):
        sites.append(site(*a, **k))
        return sites[-1]

    monkeypatch.setattr(fused, "fused_cg", spy)
    module, name = make()
    solve_mod = stencils.with_solve(module, name, solver="cg", tol=TOL, max_iters=2000,
                                    precond=precond)
    x = CompiledModule(solve_mod).function("solve")(_ring_rhs())
    assert [s.lift for s in sites] == [lift] and bool(torch.isfinite(x).all())
    assert fused.cg_plan(module, name).interior == (lift or ((0, N), (0, N)))
