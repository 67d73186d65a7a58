"""The rest of the port's linear-solve surface against the JAX package's, on
the CPU: module retyping and the f32 twin (`passes.retype`,
`low_precision_opdef`), mixed-precision refinement (`solvers.refine`,
`precision="mixed"`), matrix-free and dense SSOR, dense assembly and the
direct solve, and `compile_module`.

Tolerances: f64 solutions 1e-10 relative; f64 preconditioner and matrix
entries 1e-12; the f32 twin `TOL["float32"]` relative; refinement rounds
equal and inner iterations within 1 per round.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import neptune_tpu as ntp  # noqa: E402
import neptune_tpu_torch as ntt  # noqa: E402
from neptune_tpu.passes.retype import retype_module as jax_retype  # noqa: E402
from neptune_tpu.solvers import precond as jax_precond  # noqa: E402
from neptune_tpu.solvers.krylov import cg as jax_cg  # noqa: E402
from neptune_tpu.solvers.refine import refined_solve as jax_refined  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.lowering import compile_module  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from neptune_tpu_torch.passes.retype import retype_module  # noqa: E402
from neptune_tpu_torch.solvers import precond  # noqa: E402
from neptune_tpu_torch.solvers.krylov import cg  # noqa: E402
from neptune_tpu_torch.solvers.refine import refined_solve  # noqa: E402
from test_torch_apply import TOL  # noqa: E402


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
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def poisson(nt, n=32, dtype="float64"):
    @nt.linear_op_def(
        bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]), dtype=dtype, name="poisson"
    )
    def poisson(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    return poisson


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()


# ---------------------------------------------------------------------------
# retype and the f32 twin
# ---------------------------------------------------------------------------


def test_retype_matches_jax():
    poisson(ntt)
    m = ntt.get_context().module
    m32 = retype_module(m, "float32")
    assert m.lookup("poisson").ftype.inputs[0].element == "float64"  # original untouched
    fn = m32.lookup("poisson")
    for op in fn.walk():
        for r in op.results:
            assert getattr(r.type, "element", getattr(r.type, "name", None)) != "float64"
    from neptune_tpu.ir import print_module as jax_print
    from neptune_tpu.ir.parser import parse_module as jax_parse

    assert print_module(m32) == jax_print(jax_retype(jax_parse(print_module(m)), "float32"))


def test_twin_matches_jax():
    x = np.random.default_rng(0).standard_normal((32, 32))
    outs = []
    for nt in (ntp, ntt):
        poisson(nt)
        cm = nt.get_context().compiled()
        outs.append((_np(cm.opdef("poisson")(x)), _np(cm.low_precision_opdef("poisson")(
            x.astype(np.float32)))))
    (hi_ref, lo_ref), (hi, lo) = outs
    assert lo.dtype == np.float32 and hi.dtype == np.float64
    assert _rel(hi, hi_ref) <= 1e-14
    assert _rel(lo, lo_ref) <= TOL["float32"]
    # the twin is a module of its own on the same backend: its applies take
    # kernel A's route in f32
    cm = ntt.get_context().compiled()
    assert cm._lo_cm.backend == cm.backend and cm._lo_cm.device == cm.device


# ---------------------------------------------------------------------------
# refinement
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pc", [None, "jacobi", "ssor"])
def test_refined_solve_matches_jax(pc):
    b = np.random.default_rng(1).standard_normal((32, 32))
    res = []
    for nt, xp in ((ntp, jnp), (ntt, torch)):
        poisson(nt)
        cm = nt.get_context().compiled()
        H = nt.assemble_matrix("poisson")
        lo = cm.low_precision_opdef("poisson")
        like32 = xp.zeros((32, 32), dtype=xp.float32)
        mod = jax_precond if nt is ntp else precond
        M = None if pc is None else mod.make_preconditioner(pc, lo, like32, H.halo)
        bb = jnp.asarray(b) if nt is ntp else torch.from_numpy(b)
        x, info = (jax_refined if nt is ntp else refined_solve)(
            H.matvec, lo, bb, solver="cg", tol=1e-12, inner_tol=1e-5, inner_iters=3000, M_lo=M)
        res.append((_np(x), int(info.rounds), int(info.inner_iters), bool(info.converged)))
    (ref, r_ref, i_ref, c_ref), (got, r_got, i_got, c_got) = res
    assert c_ref and c_got and got.dtype == np.float64
    assert r_got == r_ref and abs(i_got - i_ref) <= r_ref, (r_ref, i_ref, r_got, i_got)
    assert _rel(got, ref) <= 1e-10


def _true_residual(x, b):
    n = b.shape[0]
    A = np.zeros_like(b)
    A[1:-1, 1:-1] = (4 * x[1:-1, 1:-1] - x[:-2, 1:-1] - x[2:, 1:-1] - x[1:-1, :-2]
                     - x[1:-1, 2:])
    ring = np.ones((n, n), bool)
    ring[1:-1, 1:-1] = False
    A[ring] = x[ring]
    return np.linalg.norm(b - A) / np.linalg.norm(b)


@pytest.mark.parametrize("pc", ["none", "jacobi", "ssor"])
def test_dsl_precision_mixed(pc, capsys):
    b = np.random.default_rng(2).standard_normal((32, 32))
    outs = []
    for nt in (ntp, ntt):
        H = nt.assemble_matrix(poisson(nt))
        outs.append(_np(nt.solve_linear(H, b, solver="cg", tol=1e-12, max_iters=3000,
                                        precond=pc, precision="mixed", verbose=True)))
    ref, got = outs
    out = capsys.readouterr().out
    assert out.count("KSP(cg/mixed) poisson") == 2
    assert got.dtype == np.float64 and _rel(got, ref) <= 1e-10
    assert _true_residual(got, b) <= 1e-12 * 1.01


def test_traced_precision_mixed():
    b = np.random.default_rng(3).standard_normal((32, 32))
    outs = []
    for nt in (ntp, ntt):
        p = poisson(nt)

        @nt.jit_class
        class S:
            def __init__(self):
                self.H = nt.assemble_matrix(p)

            def solve(self, b):
                return nt.solve_linear(self.H, b, solver="cg", tol=1e-12, max_iters=3000,
                                       precond="jacobi", precision="mixed")

        outs.append(_np(S().solve(b)))
    ref, got = outs
    assert _rel(got, ref) <= 1e-10 and _true_residual(got, b) <= 1e-12 * 1.01


@pytest.mark.parametrize("pc, solver, options, match", [
    ("ssor_dense", "cg", None, "ssor_dense"),
    ("mg", "cg", None, "mg"),
    ("none", "cg", {"atol": 1e-14}, "per-solve options"),
    ("none", "direct", None, "direct"),
])
def test_mixed_refusals(pc, solver, options, match):
    # the JAX executor's refusals, in the DSL and in the executor
    H = ntt.assemble_matrix(poisson(ntt, 16))
    with pytest.raises(ValueError, match=match):
        ntt.solve_linear(H, np.ones((16, 16)), solver=solver, precond=pc, precision="mixed",
                         options=options)
    ntt.reset_context()
    p = poisson(ntt, 16)

    @ntt.jit_class
    class S:
        def __init__(self):
            self.H = ntt.assemble_matrix(p)

        def solve(self, b):
            return ntt.solve_linear(self.H, b, solver=solver, precond=pc, precision="mixed",
                                    options=options)

    with pytest.raises(ValueError, match=match):
        S().solve(np.ones((16, 16)))


# ---------------------------------------------------------------------------
# SSOR
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("omega", [1.0, 1.5])
def test_ssor_stencil_matches_jax(omega):
    n = 16
    r = np.random.default_rng(3).standard_normal((n, n))
    outs = []
    for nt, mod, xp in ((ntp, jax_precond, jnp), (ntt, precond, torch)):
        H = nt.assemble_matrix(poisson(nt, n))
        M = mod.ssor_stencil(H.matvec, xp.zeros((n, n), dtype=xp.float64), H.halo, omega=omega)
        rr = jnp.asarray(r) if nt is ntp else torch.from_numpy(r)
        Md = mod.ssor_dense(H.dense(), omega=omega)
        outs.append((_np(M(rr)), _np(Md(rr)), _np(H.dense())))
    (ref, ref_d, A_ref), (got, got_d, A) = outs
    np.testing.assert_array_equal(
        precond.red_mask((n, n), "cpu").numpy(), jax_precond._red_mask_np((n, n))
    )
    assert np.abs(A - A_ref).max() == 0
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    assert np.abs(got_d - ref_d).max() <= 1e-12 * np.abs(ref_d).max()


@pytest.mark.parametrize("pc", ["ssor", "ssor_dense", "jacobi"])
def test_solve_linear_ssor_iterations_match_jax(pc, capsys):
    n = 24
    b = np.random.default_rng(4).standard_normal((n, n))
    outs = []
    for nt in (ntp, ntt):
        H = nt.assemble_matrix(poisson(nt, n))
        capsys.readouterr()
        x = nt.solve_linear(H, b, solver="cg", tol=1e-10, max_iters=500, precond=pc,
                            options={"omega": 1.2} if pc != "jacobi" else None, verbose=True)
        line = capsys.readouterr().out
        outs.append((_np(x), int(line.split("iters=")[1].split()[0])))
    (ref, i_ref), (got, i_got) = outs
    assert abs(i_got - i_ref) <= 1 and _rel(got, ref) <= 1e-10


def test_ssor_cuts_cg_iterations():
    # tests/test_solvers.py's SSOR-against-none case, at 128^2
    n = 128
    b = torch.from_numpy(np.random.default_rng(0).standard_normal((n, n)))
    H = ntt.assemble_matrix(poisson(ntt, n))
    M = precond.make_preconditioner("ssor", H.matvec, torch.zeros((n, n), dtype=torch.float64),
                                    H.halo)
    _, plain = cg(H.matvec, b, tol=1e-8, maxiter=3000)
    x, info = cg(H.matvec, b, tol=1e-8, maxiter=3000, M=M)
    assert info.converged and info.iters < plain.iters / 2, (info.iters, plain.iters)
    jb = jnp.asarray(b.numpy())
    jH = ntp.assemble_matrix(poisson(ntp, n))
    jx, jinfo = jax_cg(jH.matvec, jb, tol=1e-8, maxiter=3000, M=jax_precond.ssor_stencil(
        jH.matvec, jnp.zeros((n, n)), jH.halo))
    assert abs(info.iters - int(jinfo.iters)) <= 1 and _rel(_np(x), jx) <= 1e-10


def test_make_preconditioner_routes():
    H = ntt.assemble_matrix(poisson(ntt, 16))
    like = torch.zeros((16, 16), dtype=torch.float64)
    assert precond.make_preconditioner("ssor", H.matvec, like, H.halo) is not None
    with pytest.raises(ValueError, match="requires an assembled"):
        precond.make_preconditioner("ssor_dense", H.matvec, like, H.halo)


# ---------------------------------------------------------------------------
# dense assembly and the direct solve
# ---------------------------------------------------------------------------


def test_direct_matches_jax():
    b = np.random.default_rng(5).standard_normal((16, 16))
    outs = []
    for nt in (ntp, ntt):
        H = nt.assemble_matrix(poisson(nt, 16))
        outs.append(_np(nt.solve_linear(H, b, solver="direct")))
    ref, got = outs
    assert _rel(got, ref) <= 1e-10 and _true_residual(got, b) <= 1e-13
    with pytest.raises(ValueError, match="no runtime options"):
        ntt.solve_linear(ntt.assemble_matrix("poisson"), b, solver="direct",
                         options={"atol": 1e-12})


def test_direct_in_a_compiled_function():
    b = np.random.default_rng(6).standard_normal((16, 16))
    outs = []
    for nt in (ntp, ntt):
        p = poisson(nt, 16)

        @nt.jit_class
        class S:
            def __init__(self):
                self.H = nt.assemble_matrix(p)

            def solve(self, b):
                return nt.solve_linear(self.H, b, solver="direct")

        outs.append(_np(S().solve(b)))
    ref, got = outs
    assert _rel(got, ref) <= 1e-10


def test_direct_solves_assemble_once(monkeypatch):
    """A compiled function's direct solves assemble the dense matrix at the
    first solve only: the executor keeps one handle per matrix symbol, and
    the handle keeps its matrix."""
    b = np.random.default_rng(6).standard_normal((16, 16))
    p = poisson(ntt, 16)

    @ntt.jit_class
    class S:
        def __init__(self):
            self.H = ntt.assemble_matrix(p)

        def solve(self, b):
            return ntt.solve_linear(self.H, b, solver="direct")

    calls = []
    real = torch.func.vmap
    monkeypatch.setattr(torch.func, "vmap", lambda *a, **k: calls.append(1) or real(*a, **k))
    s = S()
    x1, x2 = s.solve(b), s.solve(b)
    assert len(calls) == 1 and torch.equal(torch.as_tensor(x1), torch.as_tensor(x2))


def test_dense_f32_is_full_precision():
    # f32 LU at full precision (TF32 off): the residual is at f32 rounding
    H = ntt.assemble_matrix(poisson(ntt, 16, "float32"))
    b = np.random.default_rng(7).standard_normal((16, 16)).astype(np.float32)
    x = _np(ntt.solve_linear(H, b, solver="direct"))
    assert x.dtype == np.float32 and _true_residual(x.astype(np.float64), b) <= 1e-5


def test_dense_on_the_default_device(monkeypatch):
    """dense() with no device assembles on `config.device`, once per device
    however it is named; with the card as default and no card, it raises."""
    H = ntt.assemble_matrix(poisson(ntt, 8, "float32"))
    A = H.dense()
    assert A.device == torch.device("cpu") and H.dense("cpu") is A and H.dense() is A
    monkeypatch.setattr(torch_config, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H.dense()


def test_dense_takes_the_kernel_route_per_column(monkeypatch):
    """A kernel-routed operator assembles through its kernel route, one
    apply per column, and gives the eager view's matrix."""
    from neptune_tpu_torch.lowering import cuda_backend

    calls = []
    real = cuda_backend.try_execute_apply
    monkeypatch.setattr(cuda_backend, "try_execute_apply",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    H = ntt.assemble_matrix(poisson(ntt, 8, "float32"))
    A = H.dense()
    assert len(calls) == 64
    view = ntt.get_context().compiled().opdef("poisson", differentiable=True)
    ref = torch.func.vmap(lambda e: view(e.reshape(8, 8)).reshape(-1))(torch.eye(64)).T
    assert torch.equal(A, ref)


def test_compile_module():
    poisson(ntt)
    cm = compile_module(ntt.get_context().compiled().module, "torch", "cpu")
    assert isinstance(cm, CompiledModule) and cm.backend == "torch"
    assert cm.device == torch.device("cpu")
