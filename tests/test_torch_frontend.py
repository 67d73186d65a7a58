"""The port's DSL frontend (`import neptune_tpu_torch as ntt`) against the
JAX package's (`import neptune_tpu as ntp`).

Each program is one Python function that takes the package as its
argument, so the very same decorated code is traced by both: the printed
modules must be identical, the verifier's structure keys equal, and the
eager calls agree within `test_torch_apply.TOL`.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import neptune_tpu as ntp  # noqa: E402
import neptune_tpu_torch as ntt  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from test_torch_apply import TOL  # noqa: E402


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port puts NumPy inputs on `config.device`, the card by default:
    these CPU tests ask for the CPU."""
    monkeypatch.setattr(torch_config, "device", "cpu")


# the JAX package's top-level names the port has no use for: PyTorch needs
# no switch for f64
NOT_PORTED = ("enable_x64",)


@pytest.fixture(autouse=True)
def fresh_kernel_names(monkeypatch):
    """Traced residuals are named from a process-wide counter in each
    package; start both at 0 so the printed modules can be compared
    whatever ran before in the process."""
    import itertools

    import neptune_tpu.frontend.trace as jax_trace
    import neptune_tpu_torch.frontend.trace as torch_trace

    for trace in (jax_trace, torch_trace):
        monkeypatch.setattr(trace, "_kernel_counter", itertools.count())


@pytest.fixture(autouse=True)
def fresh_contexts():
    ntp.reset_context()
    ntt.reset_context()
    yield
    ntp.reset_context()
    ntt.reset_context()


def jacobi5(nt, n=32):
    @nt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]), dtype="float32")
    def jacobi(u):
        return 0.25 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1])

    return jacobi, [(n, n)], "float32"


def adv4(nt, n=32):
    @nt.nonlinear_op_def(
        bounds=([0, 0], [n, n]), interior=([2, 2], [n - 2, n - 2]), dtype="float32"
    )
    def adv4(u):
        dudx = (-u[2, 0] + 8.0 * u[1, 0] - 8.0 * u[-1, 0] + u[-2, 0]) / 12.0
        dudy = (-u[0, 2] + 8.0 * u[0, 1] - 8.0 * u[0, -1] + u[0, -2]) / 12.0
        return u[0, 0] - 0.1 * (0.7 * dudx + 0.3 * dudy)

    return adv4, [(n, n)], "float32"


def heat7(nt, m=10):
    @nt.linear_op_def(
        bounds=([0, 0, 0], [m, m, m]), interior=([1, 1, 1], [m - 1, m - 1, m - 1]),
        dtype="float32",
    )
    def heat(u):
        return u[0, 0, 0] + 0.1 * (
            u[-1, 0, 0] + u[1, 0, 0] + u[0, -1, 0]
            + u[0, 1, 0] + u[0, 0, -1] + u[0, 0, 1]
            - 6.0 * u[0, 0, 0]
        )

    return heat, [(m, m, m)], "float32"


def composite(nt, n=32):
    """bench.py's make_composite_2d: u + 0.01 lap(lap(u)), the lap traced by
    the DSL and the composite built on the context's builder."""
    ir = sys.modules[nt.__name__ + ".ir"]

    @nt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]), dtype="float32")
    def lap2d(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    ctx = nt.get_context()
    b = ctx.builder
    tt = ir.TempType("float32", ir.Bounds.of([0, 0], [n, n]))
    fn = b.make_opdef("wrapped", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    lap2x = b.apply_linear("lap2d", [b.apply_linear("lap2d", [fn.body.args[0]])])
    op, body = b.start_apply([fn.body.args[0], lap2x], tt.bounds)
    b.push_block(body)
    x0 = b.access(body.args[2], [0, 0])
    l0 = b.access(body.args[3], [0, 0])
    b.yield_(b.add(x0, b.mul(b.constant(0.01, ir.ScalarType("float32")), l0)))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    ctx.bump()
    return nt.OpDef("wrapped", "linear_opdef"), [(n, n)], "float32"


def heat_stepper(nt, n=16):
    """A @jit_class whose traced method takes an implicit and an explicit
    time_advance step (f64, the default dtype)."""

    @nt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]))
    def heat_A(u):
        return u[0, 0] - 0.1 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1] - 4.0 * u[0, 0])

    @nt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]))
    def lap(u):
        return u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1] - 4.0 * u[0, 0]

    @nt.jit_class
    class Heat:
        def __init__(self):
            self.A = nt.assemble_matrix(heat_A)

        def step(self, u):
            v = nt.time_advance(u, 0.1, "implicit_linear", system=heat_A, solver="cg", tol=1e-10)
            return nt.time_advance(v, 0.01, "explicit", rhs=lap)

    return Heat().step, [(n, n)], "float64"


def nonlinear_stepper(nt, n=16):
    """A @jit_class whose traced method takes an implicit-nonlinear
    Allen–Cahn step, then solves a residual closed over its result with
    Newton (f64)."""

    @nt.nonlinear_op_def(bounds=([0], [n]), name="ac_res")
    def ac_res(u, u_prev):
        i = nt.index(0)
        lap = 100.0 * (u[-1] - 2.0 * u[0] + u[1])
        interior = u[0] - u_prev[0] - 0.01 * (0.01 * lap + u[0] - u[0] * u[0] * u[0])
        return nt.where((i == 0) | (i == n - 1), u[0] - u_prev[0], interior)

    @nt.jit_class
    class AC:
        def __init__(self):
            self.n = n

        def step(self, u):
            v = nt.time_advance(u, 0.01, "implicit_nonlinear", residual=ac_res, tol=1e-12)

            def residual(w):
                return w[0] * w[0] * w[0] + w[0] - v[0]

            return nt.solve_nonlinear(residual, v, tol=1e-12, max_iters=30)

    return AC().step, [(n,)], "float64"


def mixed_solver(nt, n=16):
    """A @jit_class whose traced method solves Poisson to 1e-12 with f32
    inner CG rounds preconditioned by matrix-free SSOR."""

    @nt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]))
    def poisson(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    @nt.jit_class
    class P:
        def __init__(self):
            self.H = nt.assemble_matrix(poisson)

        def solve(self, b):
            return nt.solve_linear(self.H, b, tol=1e-12, max_iters=500, precond="ssor",
                                   precision="mixed")

    return P().solve, [(n, n)], "float64"


def mg_solver(nt, n=32):
    """A @jit_class whose traced method solves Poisson with CG and the
    automatic geometric-multigrid preconditioner (Chebyshev smoothing)."""

    @nt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]))
    def poisson(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    @nt.jit_class
    class P:
        def __init__(self):
            self.H = nt.assemble_matrix(poisson)

        def solve(self, b):
            return nt.solve_linear(self.H, b, tol=1e-12, max_iters=100, precond="mg",
                                   options={"mg_smoother": "cheb"})

    return P().solve, [(n, n)], "float64"


PROGRAMS = {
    "jacobi5": jacobi5,
    "adv4_interior": adv4,
    "heat7": heat7,
    "composite": composite,
    "time_advance": heat_stepper,
    "nonlinear": nonlinear_stepper,
    "mixed": mixed_solver,
    "mg": mg_solver,
}
# programs that solve: results within the solves' tolerance
SOLVES = ("time_advance", "nonlinear", "mixed", "mg")


def _trace(nt, program, args):
    """(printed module, structure keys by opdef, eager result as f64)."""
    fn, _, _ = program(nt)
    out = fn(*args)
    keys = {
        f.name: f.attrs.get("structure_key_hash")
        for f in nt.get_context().compiled().module.opdefs()
    }
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    return nt.get_context().dump(), keys, out.astype(np.float64)


@pytest.mark.parametrize("name", PROGRAMS)
def test_same_code_traces_the_same_program(name):
    program = PROGRAMS[name]
    _, shapes, dtype = program(ntp)
    ntp.reset_context()
    rng = np.random.default_rng(0)
    args = [rng.standard_normal(s).astype(dtype) for s in shapes]
    jax_text, jax_keys, ref = _trace(ntp, program, args)
    text, keys, got = _trace(ntt, program, args)
    assert text == jax_text
    assert keys == jax_keys and all(k is not None for k in keys.values())
    tol = TOL[dtype] if name not in SOLVES else 1e-10  # solves to 1e-10 or tighter
    assert np.abs(got - ref).max() <= tol * np.abs(ref).max()


def test_package_imports_no_jax():
    code = (
        "import sys, neptune_tpu_torch, neptune_tpu_torch.frontend; "
        "assert 'jax' not in sys.modules"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


def test_top_level_names():
    for name in ntp.__all__:
        if name in NOT_PORTED:
            assert not hasattr(ntt, name), name
        else:
            assert name in ntt.__all__ and hasattr(ntt, name), name


def test_eager_apply_reduce_and_temp():
    u = np.random.default_rng(1).standard_normal(32)
    outs = []
    for nt in (ntp, ntt):
        r = nt.apply(inputs=[u], bounds=([1], [31]))(
            lambda t: nt.where(nt.index(0) == 1, t[0] * 10.0, t[-1] - 2.0 * t[0] + t[1])
        )
        arr = np.asarray(r.node.concrete, np.float64)
        outs.append((arr, float(nt.reduce(r, "l2")), float(nt.reduce(u, "sum", bounds=([2], [9])))))
    (ref, l2_ref, s_ref), (got, l2, s) = outs
    np.testing.assert_allclose(got, ref, rtol=1e-14)
    assert abs(l2 - l2_ref) <= 1e-12 * l2_ref and abs(s - s_ref) <= 1e-12
    t = ntt.temp(torch.zeros(4, 6, dtype=torch.float32), lb=(1, 2))
    assert t.node.ttype.element == "float32" and t.node.ttype.bounds.lb == (1, 2)


def test_jit_compile_library():
    step, shapes, _ = heat_stepper(ntt)
    u = np.random.default_rng(2).standard_normal(shapes[0])
    first = step(u)
    lib = ntt.jit_compile()
    assert "Heat_step" in lib.function_names()
    assert torch.equal(lib.Heat_step(u), first)


def test_unported_paths_name_their_roadmap_item():
    # Newton, Picard, mixed precision and multigrid are ported
    # (test_torch_nonlinear.py, test_torch_refine.py, test_torch_multigrid.py,
    # the "nonlinear", "mixed" and "mg" programs above), and a whole function
    # runs over a mesh (test_torch_sharded_function.py): the traced "mg"
    # program on a one-process mesh is the whole-grid function
    from neptune_tpu_torch.parallel import GridMesh, sharded_function

    solve, shapes, _ = mg_solver(ntt)
    b = np.random.default_rng(3).standard_normal(shapes[0])
    want = solve(b)
    cm = ntt.get_context().compiled()
    (name,) = [f.name for f in cm.module.functions.values() if not f.is_opdef]
    f = sharded_function(cm, name, GridMesh((1,), ("x",), device="cpu"))
    assert torch.equal(f(b), want)