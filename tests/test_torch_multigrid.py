"""The port's geometric multigrid (`passes/coarsen.py`,
`solvers/multigrid.py`, `precond="mg"`) against the JAX package's, on the
CPU in f64.

The same inputs, made from a seed with NumPy, go through both packages:
  * the coarsened module prints the same text;
  * `restrict` and `prolong` agree within 1e-15 (ranks 1-3);
  * `build_levels` gives bitwise-equal `inv_diag` and `interior` and
    `cheb_lmax` within 1e-12 relative;
  * one `v_cycle` (each smoother and coarse solver, and a stand-in CA
    smoother pair) and one `mg_preconditioner` application agree within
    1e-12 relative;
  * whole solves (`multigrid_solve`, from a zero start and from `fmg_start`,
    and `precond="mg"` through the IR executor and the DSL) take cycles or
    iterations within 1 of the JAX package's (read from each package's
    verbose KSP line) and reach their tolerance in the true residual.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import neptune_tpu as ntp  # noqa: E402
import neptune_tpu.ir as jir  # noqa: E402
import neptune_tpu_torch as ntt  # noqa: E402
import neptune_tpu_torch.ir as tir  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.passes import compile_ir as jax_compile_ir  # noqa: E402
from neptune_tpu.passes.coarsen import coarsen_opdef as jax_coarsen  # noqa: E402
from neptune_tpu.solvers import multigrid as jmg  # noqa: E402
from neptune_tpu.solvers.precond import make_preconditioner as jax_make_pc  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from neptune_tpu_torch.passes import compile_ir  # noqa: E402
from neptune_tpu_torch.passes.coarsen import coarsen_opdef  # noqa: E402
from neptune_tpu_torch.solvers import multigrid as tmg  # noqa: E402
from neptune_tpu_torch.solvers.precond import make_preconditioner  # noqa: E402

CYCLE_TOL = 1e-12  # one f64 cycle, relative to the largest |value|
TRANSFER_TOL = 1e-15  # f64 transfers of O(1) values, absolute


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port puts NumPy inputs on `config.device`, the card by default:
    these CPU tests ask for the CPU."""
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


def _arr(nt, a):
    """A NumPy array as the package's array type."""
    return jnp.asarray(a) if nt is ntp else torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, ref) -> float:
    ref = _np(ref)
    return float(np.abs(_np(got) - ref).max() / np.abs(ref).max())


def poisson_ops(nt, sizes, rank=2, dtype="float64"):
    """Rediscretized 1/h²-scaled Poisson handles (5-pt, or 7-pt in 3-D),
    finest first, as tests/test_multigrid.py builds them."""
    nt.reset_context()

    def make(n):
        inv_h2 = float((n - 1) * (n - 1))

        @nt.linear_op_def(
            bounds=([0] * rank, [n] * rank), interior=([1] * rank, [n - 1] * rank),
            dtype=dtype, name=f"poisson{rank}d{n}",
        )
        def op(u):
            z = (0,) * rank
            s = 2.0 * rank * u[z]
            for d in range(rank):
                for o in (-1, 1):
                    s = s - u[tuple(o if e == d else 0 for e in range(rank))]
            return s * inv_h2

        return op

    return [nt.assemble_matrix(make(n)) for n in sizes]


@pytest.fixture(scope="module")
def hier():
    """(JAX ops, port ops, JAX levels, port levels) of the 64/32/16 f64
    Poisson hierarchy, and the rng's b and x."""
    rng = np.random.default_rng(11)
    b, x = rng.standard_normal((2, 64, 64))
    ops_j = poisson_ops(ntp, [64, 32, 16])
    ops_t = poisson_ops(ntt, [64, 32, 16])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch_config, "device", "cpu")
        lv_t = tmg.build_levels(ops_t, b)
    lv_j = jmg.build_levels(ops_j, b)
    return ops_j, ops_t, lv_j, lv_t, b, x


# ---------------------------------------------------------------------------
# passes/coarsen.py
# ---------------------------------------------------------------------------


def _poisson_prog(nt, n=64):
    @nt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
                      dtype="float64", name="fine")
    def fine(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    return "fine"


def _wide_prog(nt):
    @nt.nonlinear_op_def(bounds=([0, 0], [64, 128]), interior=([2, 3], [62, 125]),
                         dtype="float64", name="wide")
    def wide(u):
        return u[0, 0] - 0.1 * (u[-2, 0] + u[2, 0] + u[0, -3] + u[0, 3])

    return "wide"


def _heat3d_prog(nt):
    @nt.linear_op_def(bounds=([0, 0, 0], [32, 16, 32]), interior=([1, 1, 1], [31, 15, 31]),
                      dtype="float32", name="heat3")
    def heat3(u):
        return u[0, 0, 0] + 0.1 * (u[-1, 0, 0] + u[1, 0, 0] + u[0, -1, 0] + u[0, 1, 0]
                                   + u[0, 0, -1] + u[0, 0, 1] - 6.0 * u[0, 0, 0])

    return "heat3"


def _composite_prog(nt):
    """An opdef that applies another: coarsening takes both."""
    n = 32

    @nt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]),
                      dtype="float64", name="lap")
    def lap(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    ir = jir if nt is ntp else tir
    ctx = nt.get_context()
    b = ctx.builder
    tt = ir.TempType("float64", ir.Bounds.of([0, 0], [n, n]))
    fn = b.make_opdef("twice", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    b.return_([b.apply_linear("lap", [b.apply_linear("lap", [fn.body.args[0]])])])
    b.pop_block()
    ctx.bump()
    return "twice"


COARSEN = {"poisson": _poisson_prog, "margins": _wide_prog, "rank3": _heat3d_prog,
           "composite": _composite_prog}


@pytest.mark.parametrize("name", COARSEN)
def test_coarsened_module_prints_the_same(name):
    texts = []
    for nt, coarsen, ir in ((ntp, jax_coarsen, jir), (ntt, coarsen_opdef, tir)):
        sym = COARSEN[name](nt)
        mod = nt.get_context().compiled().module
        c1 = coarsen(mod, sym)
        texts.append((ir.print_module(c1), ir.print_module(coarsen(c1, sym))))
    assert texts[1] == texts[0]
    if name == "margins":
        ap = [o for o in coarsen_opdef(
            ntt.get_context().compiled().module, "wide").lookup("wide").walk()
            if o.name == "neptune.apply"][0]
        assert ap.attrs["bounds"].lb == (2, 3) and ap.attrs["bounds"].ub == (30, 61)


def test_coarse_matvec_matches_hand_built():
    _poisson_prog(ntt, 64)
    coarse = coarsen_opdef(ntt.get_context().compiled().module, "fine")
    mv_c = CompiledModule(coarse, "auto", "cpu").opdef("fine")
    ntt.reset_context()
    hand = ntt.assemble_matrix(
        ntt.linear_op_def(bounds=([0, 0], [32, 32]), interior=([1, 1], [31, 31]),
                          dtype="float64", name="hand")(
            lambda u: 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((32, 32)))
    assert torch.equal(mv_c(x), hand.matvec(x))


@pytest.mark.parametrize("nt,coarsen,ir", [(ntp, jax_coarsen, jir), (ntt, coarsen_opdef, tir)],
                         ids=["jax", "torch"])
def test_coarsen_refusals(nt, coarsen, ir):
    nt.linear_op_def(bounds=([0, 0], [34, 34]), interior=([1, 1], [33, 33]), dtype="float64",
                     name="odd17")(lambda u: 4.0 * u[0, 0] - u[-1, 0] - u[1, 0])
    c1 = coarsen(nt.get_context().compiled().module, "odd17")  # 34 -> 17
    with pytest.raises(ValueError, match="coarsenable"):
        coarsen(c1, "odd17")
    b = ir.NeptuneBuilder()
    fn = b.make_function("entry", "func", [ir.TensorType("float64", (8, 8))],
                         [ir.TensorType("float64", (8, 8))])
    b.push_block(fn.body)
    b.return_([fn.body.args[0]])
    b.pop_block()
    with pytest.raises(NotImplementedError, match="not an opdef"):
        coarsen(b.module, "entry")


# ---------------------------------------------------------------------------
# transfers and levels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_transfers(rank):
    rng = np.random.default_rng(rank)
    fine = rng.standard_normal((16, 8, 12)[:rank] if rank < 3 else (8, 12, 16))
    coarse = rng.standard_normal(tuple(s // 2 for s in fine.shape))
    r_ref = _np(jmg.restrict(jnp.asarray(fine)))
    p_ref = _np(jmg.prolong(jnp.asarray(coarse), fine.shape))
    r = tmg.restrict(torch.from_numpy(fine))
    p = tmg.prolong(torch.from_numpy(coarse), fine.shape)
    assert r.shape == r_ref.shape and p.shape == p_ref.shape
    assert np.abs(_np(r) - r_ref).max() <= TRANSFER_TOL
    assert np.abs(_np(p) - p_ref).max() <= TRANSFER_TOL


@pytest.mark.parametrize("rank", [2, 3])
def test_build_levels(rank, hier):
    if rank == 2:
        _, _, lv_j, lv_t, _, _ = hier
    else:
        sizes = [16, 8]
        like = np.zeros((16,) * 3)
        lv_j = jmg.build_levels(poisson_ops(ntp, sizes, 3), like)
        lv_t = tmg.build_levels(poisson_ops(ntt, sizes, 3), like)
    assert len(lv_t) == len(lv_j)
    for a, b in zip(lv_t, lv_j):
        assert a.inv_diag.dtype == torch.float64 and a.interior.dtype == torch.bool
        assert np.array_equal(_np(a.inv_diag), _np(b.inv_diag))
        assert np.array_equal(_np(a.interior), _np(b.interior))
        assert isinstance(a.cheb_lmax, float)
        assert abs(a.cheb_lmax - float(b.cheb_lmax)) <= 1e-12 * float(b.cheb_lmax)


def test_odd_hierarchy_rejected():
    h = poisson_ops(ntt, [33])[0]
    with pytest.raises(ValueError, match="coarsenable"):
        tmg.multigrid_solve([h, h], np.zeros((33, 33)))


# ---------------------------------------------------------------------------
# one cycle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("coarse", ["cg", "jacobi"])
@pytest.mark.parametrize("smoother", ["rb", "jacobi", "cheb"])
def test_one_v_cycle(smoother, coarse, hier):
    _, _, lv_j, lv_t, b, x = hier
    kw = dict(smoother=smoother, coarse_solver=coarse)
    ref = jmg.v_cycle(lv_j, jnp.asarray(b), jnp.asarray(x), **kw)
    got = tmg.v_cycle(lv_t, torch.from_numpy(b), torch.from_numpy(x), **kw)
    assert _rel(got, ref) <= CYCLE_TOL


@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
def test_mg_preconditioner_application(smoother, hier):
    ops_j, ops_t, lv_j, lv_t, b, _ = hier
    ref = jmg.mg_preconditioner(ops_j, b, smoother=smoother, levels=lv_j)(jnp.asarray(b))
    got = tmg.mg_preconditioner(ops_t, b, smoother=smoother, levels=lv_t)(torch.from_numpy(b))
    assert _rel(got, ref) <= CYCLE_TOL
    with pytest.raises(ValueError, match="not symmetric"):
        tmg.mg_preconditioner(ops_t, b, smoother="rb", levels=lv_t)


def _with_ca(levels, k=2):
    """Each level with a stand-in CA smoother pair: k damped Jacobi sweeps,
    returning the residual, written once for either package's arrays."""

    def pair(L):
        def ca_smooth(b, x):
            for _ in range(k):
                x = x + 0.8 * L.inv_diag * (b - L.matvec(x))
            return x, b - L.matvec(x)

        return dict(ca_smooth=ca_smooth, ca_smooth_zero=lambda b: ca_smooth(b, 0.0 * b), ca_k=k)

    return [L._replace(**pair(L)) for L in levels]


def test_ca_smooth_hooks(hier):
    ops_j, ops_t, lv_j, lv_t, b, x = hier
    ca_j, ca_t = _with_ca(lv_j), _with_ca(lv_t)
    for coarse in ("cg", "jacobi"):
        ref = jmg.v_cycle(ca_j, jnp.asarray(b), jnp.asarray(x), coarse_solver=coarse)
        got = tmg.v_cycle(ca_t, torch.from_numpy(b), torch.from_numpy(x), coarse_solver=coarse)
        assert _rel(got, ref) <= CYCLE_TOL
    ref = jmg.mg_preconditioner(ops_j, b, levels=ca_j)(jnp.asarray(b))
    got = tmg.mg_preconditioner(ops_t, b, levels=ca_t)(torch.from_numpy(b))
    assert _rel(got, ref) <= CYCLE_TOL
    # the hooks replace the sweeps: the same cycle without them differs
    plain = tmg.mg_preconditioner(ops_t, b, levels=lv_t)(torch.from_numpy(b))
    assert not torch.equal(plain, got)


def test_unknown_smoother_rejected(hier):
    _, ops_t, _, _, _, _ = hier
    with pytest.raises(ValueError, match="unknown smoother"):
        tmg.multigrid_solve(ops_t, np.zeros((64, 64)), maxiter=1, smoother="sor")


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------


def _true_rel(ops, x, b) -> float:
    r = b - _np(ops[0].matvec(x))
    return float(np.linalg.norm(r) / np.linalg.norm(b))


@pytest.mark.parametrize("rank,sizes,tol", [(2, [64, 32, 16], 1e-9), (3, [32, 16, 8], 1e-8)])
def test_multigrid_solve(rank, sizes, tol):
    b = np.random.default_rng(5).standard_normal((sizes[0],) * rank)
    _, ref = jmg.multigrid_solve(poisson_ops(ntp, sizes, rank), b, tol=tol, maxiter=60)
    ops = poisson_ops(ntt, sizes, rank)
    x, info = tmg.multigrid_solve(ops, b, tol=tol, maxiter=60)
    assert info.converged and abs(info.iters - int(ref.iters)) <= 1, (info, ref)
    assert _true_rel(ops, x, b) <= tol * 1.01


def test_fmg_start(hier):
    ops_j, ops_t, lv_j, lv_t, b, _ = hier
    x_ref = jmg.fmg_start(lv_j, jnp.asarray(b))
    x0 = tmg.fmg_start(lv_t, torch.from_numpy(b))
    assert _rel(x0, x_ref) <= CYCLE_TOL
    _, ref = jmg.multigrid_solve(ops_j, b, x0=x_ref, tol=1e-9, maxiter=60, levels=lv_j)
    _, zero = tmg.multigrid_solve(ops_t, b, tol=1e-9, maxiter=60, levels=lv_t)
    x, info = tmg.multigrid_solve(ops_t, b, x0=x0, tol=1e-9, maxiter=60, levels=lv_t)
    assert info.converged and abs(info.iters - int(ref.iters)) <= 1, (info, ref)
    assert info.iters < zero.iters
    assert _true_rel(ops_t, x, b) <= 1e-9 * 1.01


def _ksp_iters(text: str) -> list:
    return [int(m) for m in re.findall(r"KSP\([^)]*\) \S+: iters=(\d+)", text)]


def _mg_program(n, options):
    """tests/test_multigrid.py's IR program, CG + precond="mg" on an
    (absorbed-h²) 5-pt Laplacian with the given options: the port's module
    and the JAX package's parse of its text."""
    module = stencils.with_solve(stencils.poisson5(n, "float64"), "poisson", solver="cg",
                                 tol=1e-10, max_iters=80, precond="mg", options=options,
                                 verbose=True)
    return module, jax_parse(tir.print_module(module))


def _lap_matvec(x):
    y = x.copy()
    y[1:-1, 1:-1] = (4 * x[1:-1, 1:-1] - x[:-2, 1:-1] - x[2:, 1:-1] - x[1:-1, :-2]
                     - x[1:-1, 2:])
    return y


@pytest.mark.parametrize("options", [{"mg_levels": 2, "mg_smoother": "jacobi"},
                                     {"mg_smoother": "cheb"}], ids=["levels2", "cheb"])
def test_ir_path_precond_mg(options, capsys):
    n = 64
    bb = np.random.default_rng(2).standard_normal((n, n))
    module, jax_module = _mg_program(n, options)
    capsys.readouterr()
    ref = np.asarray(jax_compile_ir(jax_module).function("solve")(bb))
    ref_it = _ksp_iters(capsys.readouterr().out)
    x = _np(compile_ir(module).function("solve")(bb))
    it = _ksp_iters(capsys.readouterr().out)
    assert len(it) == len(ref_it) == 1 and abs(it[0] - ref_it[0]) <= 1, (it, ref_it)
    for sol in (ref, x):
        r = bb - _lap_matvec(sol)
        assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(bb) * 1.01


def _dsl_mg(nt, n, b, name="pmg", **kw):
    H = nt.assemble_matrix(nt.linear_op_def(
        bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]), dtype="float64",
        name=name)(lambda u: 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]))
    return H, nt.solve_linear(H, b, solver="cg", tol=1e-10, max_iters=60, precond="mg",
                              verbose=True, **kw)


@pytest.mark.parametrize("smoother", ["jacobi", "cheb"])
def test_dsl_precond_mg(smoother, capsys):
    n = 64
    b = np.random.default_rng(0).standard_normal((n, n))
    its = []
    for nt in (ntp, ntt):
        capsys.readouterr()
        H, x = _dsl_mg(nt, n, b, options={"mg_smoother": smoother})
        its.append(_ksp_iters(capsys.readouterr().out))
        r = b - _np(H.matvec(_arr(nt, _np(x))))
        assert np.linalg.norm(r) <= 1e-10 * np.linalg.norm(b) * 1.01
    (ref_it,), (it,) = its
    assert abs(it - ref_it) <= 1 and it < 40, its


# ---------------------------------------------------------------------------
# refusals and the hierarchy cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nt", [ntp, ntt], ids=["jax", "torch"])
def test_refusals(nt):
    with pytest.raises(ValueError, match="precond='mg' needs at least 2 levels"):
        _dsl_mg(nt, 24, np.ones((24, 24)))  # 24 -> 12: min extent < 16
    with pytest.raises(ValueError, match="precision='mixed' does not support precond='mg'"):
        _dsl_mg(nt, 32, np.ones((32, 32)), "p32", precision="mixed")
    make = jax_make_pc if nt is ntp else make_preconditioner
    with pytest.raises(ValueError, match="unknown preconditioner 'mg'"):
        make("mg", lambda v: v, _arr(nt, np.zeros((8, 8))), ((1, 1), (1, 1)))


@pytest.fixture
def probes(monkeypatch):
    """Counts the diagonal probes of every hierarchy built."""
    calls = []
    real = tmg.extract_diagonal

    def counting(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    monkeypatch.setattr(tmg, "extract_diagonal", counting)
    return calls


def test_dsl_hierarchy_is_cached(probes):
    b = np.random.default_rng(3).standard_normal((64, 64))
    _, x1 = _dsl_mg(ntt, 64, b)
    assert sorted(probes) == [(16, 16), (32, 32), (64, 64)]
    probes.clear()
    _, x2 = _dsl_mg(ntt, 64, b, "pmg_again")  # a new opdef of the same structure
    assert probes == [] and torch.equal(x1, x2)
    _dsl_mg(ntt, 64, b, "pmg_2", options={"mg_levels": 2})  # other options: a new hierarchy
    assert sorted(probes) == [(32, 32), (64, 64)]


def test_executor_hierarchy_is_cached(probes):
    bb = np.random.default_rng(4).standard_normal((64, 64))
    f = compile_ir(_mg_program(64, None)[0]).function("solve")
    x1 = f(bb)
    assert len(probes) == 3
    probes.clear()
    x2 = f(bb)
    assert probes == [] and torch.equal(x1, x2)
