"""The port's nonlinear path (Newton–Krylov, Picard, `jacobian=`, the
implicit-nonlinear time step) against the JAX package's, on the CPU in f64.

The same programs go through both packages: the DSL cases are one Python
function taking the package, the IR cases one builder function taking the
package's `ir`. Solutions agree to 1e-10 and Newton iterations (read from
each package's `verbose` SNES line) within 1. Also the derivative rule of
kernel-routed opdefs (`lowering.executor._OpdefRule`): the tangent and
cotangent of a kernel-A and a kernel-D opdef equal `jax.jvp`/`jax.vjp` of
the JAX package's, and come from the rule, not from autograd through the
plain version.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import neptune_tpu as ntp  # noqa: E402
import neptune_tpu.ir as jir  # noqa: E402
import neptune_tpu_torch as ntt  # noqa: E402
import neptune_tpu_torch.ir as tir  # noqa: E402
from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.lowering.executor import CompiledModule as JaxCompiledModule  # noqa: E402
from neptune_tpu.passes import compile_ir as jax_compile_ir  # noqa: E402
from neptune_tpu.solvers import newton as jax_newton  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.ir.ops import IRError  # noqa: E402
from neptune_tpu_torch.lowering import executor  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from neptune_tpu_torch.passes import compile_ir  # noqa: E402
from neptune_tpu_torch.solvers import newton  # noqa: E402
from test_torch_apply import TOL  # noqa: E402

F64_TOL = 1e-10  # f64 solutions, both packages to tol 1e-12


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


def _iters(text: str) -> list:
    return [int(m) for m in re.findall(r"SNES\([^)]*\) \S+: iters=(\d+)", text)]


def _both(capsys, run):
    """run(package) for the JAX package then the port: (results, Newton
    iterations of each from its verbose line)."""
    out = []
    for nt in (ntp, ntt):
        capsys.readouterr()
        x = run(nt)
        out.append((x, _iters(capsys.readouterr().out)))
    (ref, ref_it), (got, got_it) = out
    assert ref_it and len(ref_it) == len(got_it)
    assert all(abs(a - b) <= 1 for a, b in zip(ref_it, got_it)), (ref_it, got_it)
    return ref, got


# ---------------------------------------------------------------------------
# the (rank, captures) matrix of tests/test_nonlinear_abi.py
# ---------------------------------------------------------------------------

WANT = {0: np.sqrt(3.0), 1: np.sqrt(3.0), 2: np.sqrt(2.5)}


def _dsl_case(nt, rank, caps):
    nt.reset_context()
    shape = (6,) * rank
    a = nt.temp(np.full(shape, 3.0))
    c = nt.temp(np.full(shape, 0.5))
    u0 = nt.temp(np.ones(shape))
    off = (0,) * rank if rank != 1 else 0

    def index(t):
        return t[()] if rank == 0 else t[off]

    if caps == 0:

        def residual(u):
            return index(u) * index(u) - 3.0

    elif caps == 1:

        def residual(u):
            return index(u) * index(u) - index(a)

    else:

        def residual(u):
            return index(u) * index(u) - index(a) + index(c)

    return _np(nt.solve_nonlinear(residual, u0, tol=1e-12, max_iters=60, verbose=True))


@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("caps", [0, 1, 2])
def test_dsl_rank_caps_matrix(rank, caps, capsys):
    ref, got = _both(capsys, lambda nt: _dsl_case(nt, rank, caps))
    assert np.abs(got - ref).max() <= F64_TOL
    assert np.allclose(got, WANT[caps], atol=F64_TOL)


def _ir_module(ir, rank, caps, n=4):
    b = ir.NeptuneBuilder()
    bounds = ir.Bounds.of([0] * rank, [n] * rank)
    tt = ir.TempType("float64", bounds)
    ins = [tt] * (1 + caps)
    fn = b.make_opdef("res", "nonlinear_opdef", ins, [tt])
    b.push_block(fn.body)
    op, body = b.start_apply(list(fn.body.args), bounds)
    b.push_block(body)
    args = body.args[rank:]
    zero = [0] * rank
    u = b.access(args[0], zero)
    expr = b.sub(b.mul(u, u), b.constant(3.0, ir.F64))
    if caps >= 1:
        expr = b.add(expr, b.sub(b.constant(3.0, ir.F64), b.access(args[1], zero)))
    if caps >= 2:
        expr = b.add(expr, b.access(args[2], zero))
    b.yield_(expr)
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()

    f = b.make_function("run", "func", ins, [tt])
    b.push_block(f.body)
    outs = b.solve_nonlinear(
        "res", [f.body.args[0]], captures=list(f.body.args[1:]), method="newton",
        tol=1e-12, max_iters=60, verbose=True,
    )
    b.return_([outs if not isinstance(outs, tuple) else outs[0]])
    b.pop_block()
    return b.module


@pytest.mark.parametrize("rank", [0, 1, 2])
@pytest.mark.parametrize("caps", [0, 1, 2])
def test_ir_rank_caps_matrix(rank, caps, capsys):
    shape = (4,) * rank
    arrays = [np.ones(shape)] + [np.full(shape, 3.0), np.full(shape, 0.5)][:caps]

    def run(nt):
        ir, comp = (jir, jax_compile_ir) if nt is ntp else (tir, compile_ir)
        return _np(comp(_ir_module(ir, rank, caps)).function("run")(*arrays))

    ref, got = _both(capsys, run)
    assert np.abs(got - ref).max() <= F64_TOL
    assert np.allclose(got, WANT[caps], atol=F64_TOL)


def test_rank0_picard(capsys):
    def run(nt):
        u0 = nt.temp(np.asarray(0.5))
        x = nt.solve_nonlinear(
            lambda u: u[()] - nt.cos(u[()]), u0, method="picard", tol=1e-12, max_iters=200,
            verbose=True,
        )
        return float(_np(x))

    ref, got = _both(capsys, run)
    assert abs(got - ref) <= F64_TOL and abs(got - np.cos(got)) < 1e-10


# ---------------------------------------------------------------------------
# jacobian= (tests/test_nonlinear_abi.py): used, in both of its forms
# ---------------------------------------------------------------------------


def _sqrt3_module(ir, jac_kind, n=6):
    """F(u) = u^2 - 3; jacobian None, "exact" ((v,u) -> 2uv), "damped"
    ((v,u) -> 4uv, half steps) or "constant" ((v) -> 2 sqrt(3) v)."""
    b = ir.NeptuneBuilder()
    bounds = ir.Bounds.of([0], [n])
    tt = ir.TempType("float64", bounds)

    def opdef(name, arity, body_fn):
        fn = b.make_opdef(name, "nonlinear_opdef", [tt] * arity, [tt])
        b.push_block(fn.body)
        op, body = b.start_apply(list(fn.body.args), bounds)
        b.push_block(body)
        b.yield_(body_fn(*(b.access(a, [0]) for a in body.args[1:])))
        b.pop_block()
        b.return_([b.finish_apply(op)])
        b.pop_block()

    opdef("res", 1, lambda u: b.sub(b.mul(u, u), b.constant(3.0, ir.F64)))
    if jac_kind == "constant":
        opdef("jac", 1, lambda v: b.mul(b.constant(2.0 * np.sqrt(3.0), ir.F64), v))
    elif jac_kind is not None:
        scale = {"exact": 2.0, "damped": 4.0}[jac_kind]
        opdef("jac", 2, lambda v, u: b.mul(b.constant(scale, ir.F64), b.mul(u, v)))
    f = b.make_function("run", "func", [tt], [tt])
    b.push_block(f.body)
    out = b.solve_nonlinear(
        "res", [f.body.args[0]], jacobian=None if jac_kind is None else "jac",
        method="newton", tol=1e-12, max_iters=12, options={"line_search": False},
        verbose=True,
    )
    b.return_([out])
    b.pop_block()
    return b.module


@pytest.mark.parametrize("jac_kind", [None, "exact", "damped", "constant"])
def test_jacobian_forms(jac_kind, capsys):
    def run(nt):
        ir, comp = (jir, jax_compile_ir) if nt is ntp else (tir, compile_ir)
        return _np(comp(_sqrt3_module(ir, jac_kind)).function("run")(np.ones(6)))

    ref, got = _both(capsys, run)
    assert np.abs(got - ref).max() <= F64_TOL
    err = np.abs(got - np.sqrt(3.0)).max()
    if jac_kind == "damped":  # half steps: observably the user's jacobian
        assert 1e-6 < err < 1e-2, err
    else:
        assert err <= F64_TOL


def test_jacobian_bad_arity_rejected():
    b = tir.NeptuneBuilder()
    bounds = tir.Bounds.of([0], [6])
    tt = tir.TempType("float64", bounds)
    for name, arity in (("res", 1), ("jac", 3)):
        fn = b.make_opdef(name, "nonlinear_opdef", [tt] * arity, [tt])
        b.push_block(fn.body)
        op, body = b.start_apply(list(fn.body.args), bounds)
        b.push_block(body)
        b.yield_(b.access(body.args[1], [0]))
        b.pop_block()
        b.return_([b.finish_apply(op)])
        b.pop_block()
    f = b.make_function("run", "func", [tt], [tt])
    b.push_block(f.body)
    with pytest.raises(IRError, match="jacobian"):
        b.solve_nonlinear("res", [f.body.args[0]], jacobian="jac")
    with pytest.raises(IRError, match="jacobian"):
        b.solve_nonlinear("res", [f.body.args[0]], jacobian="nope")


# ---------------------------------------------------------------------------
# solvers.newton directly (tests/test_solvers.py::TestNewton)
# ---------------------------------------------------------------------------


def _lap1d(x, xp):
    """The SPD 1-D Laplacian with zero ends, in jnp or torch."""
    if xp is jnp:
        return 2 * x - jnp.roll(x, 1).at[0].set(0) - jnp.roll(x, -1).at[-1].set(0)
    y = 2 * x
    y[1:] = y[1:] - x[:-1]
    y[:-1] = y[:-1] - x[1:]
    return y


def _newton_pair(F_of, x0, **kw):
    """newton_krylov in both packages on the same residual: solutions and
    infos (x0 a NumPy array or a tuple of them)."""
    if isinstance(x0, tuple):
        jx0, tx0 = tuple(map(jnp.asarray, x0)), tuple(map(torch.from_numpy, x0))
    else:
        jx0, tx0 = jnp.asarray(x0), torch.from_numpy(x0)
    jx, jinfo = jax_newton.newton_krylov(F_of(jnp), jx0, **kw)
    tx, tinfo = newton.newton_krylov(F_of(torch), tx0, **kw)
    assert tinfo.converged and bool(jinfo.converged)
    assert abs(tinfo.iters - int(jinfo.iters)) <= 1
    assert abs(tinfo.krylov_iters - int(jinfo.krylov_iters)) <= 1
    return jx, tx


def test_scalar_field_newton():
    b = np.random.default_rng(0).standard_normal(64)

    def F_of(xp):
        bb = xp.asarray(b) if xp is jnp else torch.from_numpy(b)
        return lambda u: _lap1d(u, xp) + u**3 - bb

    jx, tx = _newton_pair(F_of, np.zeros(64), tol=1e-12, krylov_tol=1e-10, krylov_iters=300)
    assert np.abs(_np(tx) - np.asarray(jx)).max() <= F64_TOL


def test_tuple_state_newton():
    def F_of(_xp):
        def F(state):
            h, q = state
            return (h + 0.1 * q**2 - 1.0, q + 0.05 * h * q - 0.5)

        return F

    jx, tx = _newton_pair(F_of, (np.ones(8), np.zeros(8)), tol=1e-13)
    for j, t in zip(jx, tx):
        assert np.abs(_np(t) - np.asarray(j)).max() <= F64_TOL


@pytest.mark.parametrize("max_step", [None, 0.25])
def test_line_search_and_max_step(max_step):
    # a stiff cubic: full steps overshoot, the Armijo search backtracks
    def F_of(_xp):
        return lambda u: u**3 + u - 2.0 + 10.0 * (u - 1.0) ** 3

    jx, tx = _newton_pair(F_of, np.full(4, 5.0), tol=1e-13, max_step=max_step)
    assert np.abs(_np(tx) - np.asarray(jx)).max() <= F64_TOL


def test_picard():
    jx, jinfo = jax_newton.picard(lambda x: x - jnp.cos(x), jnp.zeros(4), tol=1e-12, max_iters=200)
    tx, tinfo = newton.picard(lambda x: x - torch.cos(x), torch.zeros(4, dtype=torch.float64),
                              tol=1e-12, max_iters=200)
    assert tinfo.converged and tinfo.iters == int(jinfo.iters)
    np.testing.assert_allclose(_np(tx), 0.7390851332151607, atol=F64_TOL)


# ---------------------------------------------------------------------------
# the implicit-nonlinear time step
# ---------------------------------------------------------------------------


def test_time_advance_implicit_nonlinear_eager():
    n = 32

    def run(nt):
        @nt.nonlinear_op_def(bounds=([0], [n]), name="ac_res")
        def ac_res(u, u_prev):
            i = nt.index(0)
            lap = 100.0 * (u[-1] - 2.0 * u[0] + u[1])
            interior = u[0] - u_prev[0] - 0.01 * (0.01 * lap + u[0] - u[0] * u[0] * u[0])
            return nt.where((i == 0) | (i == n - 1), u[0] - u_prev[0], interior)

        u = 0.9 * np.sin(np.linspace(0, 2 * np.pi, n))
        for _ in range(3):
            u = _np(nt.time_advance(u, 0.01, "implicit_nonlinear", residual=ac_res, tol=1e-12))
        return u

    ref, got = run(ntp), run(ntt)
    assert np.abs(got - ref).max() <= F64_TOL


def test_time_advance_interpreted(tmp_path):
    # the executor's own _time_advance, on a module the high-level pass has
    # not rewritten
    import programs
    from neptune_tpu_torch.interop import arrays_from_numpy, module_from_reference

    text = print_module(module_from_reference(
        jir.print_module(programs.build_allen_cahn_nonlinear())))
    uin = 0.9 * np.sin(np.linspace(0, 2 * np.pi, 16))
    ref = np.asarray(JaxCompiledModule(jax_verify(jax_parse(text))).function("entry")(
        np.zeros(16), uin))
    got = _np(CompiledModule(tir.verify_and_annotate(module_from_reference(text)))
              .function("entry")(*arrays_from_numpy([np.zeros(16), uin], "cpu")))
    assert np.abs(got - ref).max() <= F64_TOL
    assert np.abs(programs.ac_residual_np(got, uin)).max() < 1e-10


# ---------------------------------------------------------------------------
# the derivative rule of kernel-routed opdefs
# ---------------------------------------------------------------------------

RULE_CASES = {
    # kernel A: one f32 rank-2 apply
    "apply_2d": (lambda: stencils.advection4((32, 64)), "adv4", 1, ()),
    # kernel D: a composite of two stages, and two fields with scalars
    "composite": (lambda: stencils.composite((32, 64)), "wrapped", 1, ()),
    "two_fields_scalars": (lambda: stencils.coupled((32, 64)), "couple", 2, (0.7, -1.3)),
}


@pytest.mark.parametrize("case", RULE_CASES)
def test_rule_tangent_and_cotangent_match_jax(case):
    build, name, n_fields, scalars = RULE_CASES[case]
    module = build()
    jm = jax_verify(jax_parse(print_module(module)))
    cm = CompiledModule(module)
    rng = np.random.default_rng(3)
    shape = module.lookup(name).ftype.inputs[0].bounds.shape
    xs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n_fields)]
    vs = [rng.standard_normal(shape).astype(np.float32) for _ in range(n_fields)]
    jf = JaxCompiledModule(jm, "jnp").opdef(name)
    jsc = tuple(np.float32(s) for s in scalars)
    j_out, j_tan = jax.jvp(lambda *f: jf(*f, *jsc), tuple(map(jnp.asarray, xs)),
                           tuple(map(jnp.asarray, vs)))
    _, pull = jax.vjp(lambda *f: jf(*f, *jsc), *map(jnp.asarray, xs))
    j_cot = pull(jnp.asarray(vs[0]))

    f = cm.opdef(name)
    if case != "apply_2d":
        assert cm.chain_callable(name) is not None  # kernel D's route
    count = executor.rule_counter
    count.reset()
    txs = tuple(torch.from_numpy(x) for x in xs)
    t_out, t_tan = torch.func.jvp(lambda *fs: f(*fs, *scalars), txs,
                                  tuple(torch.from_numpy(v) for v in vs))
    assert count.count == 1  # the tangent came through the rule
    leaves = [x.clone().requires_grad_(True) for x in txs]
    t_cot = torch.autograd.grad(f(*leaves, *scalars), leaves, torch.from_numpy(vs[0]))
    assert count.count == 2  # and so did the cotangent
    tol = 4 * TOL["float32"]
    for ref, got in [(j_out, t_out), (j_tan, t_tan), *zip(j_cot, t_cot)]:
        ref = np.asarray(ref, np.float64)
        assert np.abs(_np(got) - ref).max() <= tol * np.abs(ref).max()


def test_rule_is_what_differentiates(monkeypatch):
    """With the rule's tangent replaced by zeros, the kernel route gives a
    zero J·v: the plain version's own autograd plays no part."""
    cm = CompiledModule(stencils.advection4((32, 64)))
    f = cm.opdef("adv4")
    x = torch.randn(32, 64)
    _, tan = torch.func.jvp(f, (x,), (torch.ones_like(x),))
    assert tan.abs().max() > 0
    monkeypatch.setattr(executor._OpdefRule, "jvp", staticmethod(
        lambda ctx, _r, *t: torch.zeros(32, 64)))
    _, tan = torch.func.jvp(f, (x,), (torch.ones_like(x),))
    assert tan.abs().max() == 0
    with torch.no_grad():  # forward mode does not look at grad mode
        _, tan = torch.func.jvp(f, (x,), (torch.ones_like(x),))
    assert tan.abs().max() == 0
    fwad = torch.autograd.forward_ad
    with fwad.dual_level():
        tan = fwad.unpack_dual(f(fwad.make_dual(x, torch.ones_like(x)))).tangent
    assert tan.abs().max() == 0
    # a call that nothing differentiates takes the kernel route alone
    monkeypatch.setattr(executor._OpdefRule, "apply", None)
    assert torch.equal(f(x), cm._make_callable(cm.module.lookup("adv4"))(x))
    # the eager backend and differentiable=True take no rule
    assert CompiledModule(cm.module, "torch").opdef("adv4").__name__ == "neptune_adv4"
    assert cm.opdef("adv4", differentiable=True) is cm._torch_view().opdef("adv4")
