"""The port's native C++ runtime (`neptune_tpu_torch.runtime`) against the
JAX package's (`neptune_tpu.runtime`).

The cases of tests/test_native.py, each program printed by the JAX
package's builder or DSL and parsed by the port (`module_from_reference`),
as test_torch_ir.py does: for every program `generate_cpp` of the port
equals the JAX package's, character for character, and the port's native
output equals the JAX package's native output bitwise, beside each case's
own oracle. Both caches live in one per-session temporary directory.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import programs  # noqa: E402
from neptune_tpu.ir import print_module as jax_print  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.passes import run_pipeline as jax_run_pipeline  # noqa: E402
from neptune_tpu.runtime import compile_native as jax_compile_native  # noqa: E402
from neptune_tpu.runtime import generate_cpp as jax_generate_cpp  # noqa: E402

import neptune_tpu_torch as ntt  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.interop import module_from_reference  # noqa: E402
from neptune_tpu_torch.ir import F64, INDEX, Bounds, FieldType, NeptuneBuilder  # noqa: E402
from neptune_tpu_torch.ir import TempType, TensorType  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.passes import compile_ir, run_pipeline  # noqa: E402
from neptune_tpu_torch.runtime import CodegenError, compile_native, generate_cpp  # noqa: E402

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="needs a C++ compiler")

PROGRAMS = {
    "allen_cahn_implicit_linear": programs.build_allen_cahn_implicit_linear,
    "allen_cahn_nonlinear": programs.build_allen_cahn_nonlinear,
    "bs": programs.build_bs_program,
}


@pytest.fixture(scope="session", autouse=True)
def native_caches(tmp_path_factory):
    """Both packages' native caches in this session's own directory."""
    root = tmp_path_factory.mktemp("native_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEPTUNE_TORCH_CACHE_DIR", str(root / "torch"))
        mp.setattr(torch_config, "cache_dir", str(root / "torch"))
        mp.setenv("NEPTUNE_TPU_CACHE_DIR", str(root / "jax"))
        yield root


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(torch_config, "device", "cpu")
    ntt.reset_context()
    yield
    ntt.reset_context()


def _inputs(name):
    if name == "allen_cahn_implicit_linear":
        return [np.zeros(16), np.sin(np.linspace(0, np.pi, 16))]
    if name == "allen_cahn_nonlinear":
        return [np.zeros(16), 0.9 * np.sin(np.linspace(0, 2 * np.pi, 16))]
    return [np.zeros(32), np.maximum(np.linspace(0, 3.1, 32) - 1.0, 0.0)]


def _port(ref_module):
    return module_from_reference(jax_print(ref_module))


def _same_cpp(port_module, jax_module):
    """generate_cpp of both packages' pipelines on one IR text."""
    src = generate_cpp(run_pipeline(port_module).module)
    assert src == jax_generate_cpp(jax_run_pipeline(jax_module).module)
    return src


@pytest.mark.parametrize("name", PROGRAMS)
def test_generate_cpp_and_output_equal_the_jax_package(name):
    ref = PROGRAMS[name]()
    port = _port(ref)
    _same_cpp(port, ref)
    args = _inputs(name)
    out = compile_native(port).function("entry")(*args)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert out.dtype == torch.float64
    want = jax_compile_native(ref).function("entry")(*args)
    np.testing.assert_array_equal(out.numpy(), want)


def test_allen_cahn_implicit_linear():
    nm = compile_native(_port(programs.build_allen_cahn_implicit_linear()))
    uin = np.sin(np.linspace(0, np.pi, 16))
    out = nm.function("entry")(np.zeros(16), uin)
    np.testing.assert_allclose(out.numpy(), programs.allen_cahn_implicit_linear_oracle(uin),
                               atol=1e-10)


def test_allen_cahn_newton():
    nm = compile_native(_port(programs.build_allen_cahn_nonlinear()))
    uin = 0.9 * np.sin(np.linspace(0, 2 * np.pi, 16))
    out = nm.function("entry")(np.zeros(16), uin)
    assert np.abs(programs.ac_residual_np(out.numpy(), uin)).max() < 1e-10


def test_black_scholes():
    nm = compile_native(_port(programs.build_bs_program()))
    vin = np.maximum(np.linspace(0, 3.1, 32) - 1.0, 0.0)
    out = nm.function("entry")(np.zeros(32), vin)
    A = programs.dense_from_op(programs.bs_A_np, 32)
    np.testing.assert_allclose(out.numpy(), np.linalg.solve(A, vin), atol=5e-9)


def test_native_matches_the_torch_executor():
    """Three-way agreement: the port's native C++ against its eager
    executor (both checked against NumPy separately)."""
    m = _port(programs.build_allen_cahn_implicit_linear())
    uin = np.cos(np.linspace(0, 3, 16))
    a = compile_native(m).function("entry")(np.zeros(16), uin)
    b = compile_ir(m, device="cpu").function("entry")(np.zeros(16), uin)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-9)


def test_caller_arrays_and_tensors_not_mutated():
    nm = compile_native(_port(programs.build_allen_cahn_implicit_linear()))
    uin = np.sin(np.linspace(0, np.pi, 16))
    keep = uin.copy()
    out_buf = torch.zeros(16, dtype=torch.float32)
    out = nm.function("entry")(out_buf, torch.from_numpy(uin))
    np.testing.assert_array_equal(uin, keep)
    assert torch.equal(out_buf, torch.zeros(16, dtype=torch.float32))
    # tensors of any dtype are copied to host f64: the same result as arrays
    np.testing.assert_array_equal(out.numpy(), nm.function("entry")(np.zeros(16), uin).numpy())


def test_source_loops_match_reference_structure():
    src = generate_cpp(run_pipeline(_port(programs.build_allen_cahn_implicit_linear())).module)
    assert "for (long i0 = 1L; i0 < 15L; ++i0)" in src
    assert "neptune_rt_gmres" in src
    assert 'extern "C" void nt_entry' in src


def test_f32_module_rejected():
    @ntt.linear_op_def(bounds=([0], [8]), dtype="float32")
    def op32(u):
        return u[0] * 2.0

    with pytest.raises(CodegenError, match="float64"):
        generate_cpp(ntt.get_context().module)


def test_cache_hit():
    m = _port(programs.build_allen_cahn_implicit_linear())
    nm1, nm2 = compile_native(m), compile_native(m)
    uin = np.sin(np.linspace(0, np.pi, 16))
    a = nm1.function("entry")(np.zeros(16), uin)
    b = nm2.function("entry")(np.zeros(16), uin)
    assert torch.equal(a, b)


def _jacobi_module(n=64):
    """tests/test_native.py's Jacobi-CG program, traced by the port's DSL."""

    @ntt.linear_op_def(bounds=([0], [n]), interior=([1], [n - 1]), name="scaled_lap")
    def scaled_lap(u):
        i = ntt.index(0)
        c = 2.0 + (i * 1.0) * 0.05
        return c * u[0] + (2.0 * u[0] - u[-1] - u[1])

    b = ntt.get_context().builder
    tt = TempType("float64", Bounds.of([0], [n]))
    entry = b.make_function("entry", "func", [tt], [tt])
    b.push_block(entry.body)
    A = b.assemble_matrix("scaled_lap")
    x = b.solve_linear(A, entry.body.args[0], solver="cg", tol=1e-12, max_iters=5000,
                       precond="jacobi")
    b.return_([x])
    b.pop_block()
    ntt.get_context().bump()
    return ntt.get_context().module


def test_jacobi_cg_native():
    n = 64
    module = _jacobi_module(n)
    _same_cpp(module, jax_parse(print_module(module)))
    nm = compile_native(module, keep_source=True)
    assert "jp_inv" in nm.source
    rhs = np.random.default_rng(0).standard_normal(n)
    out = nm.function("entry")(rhs)
    mv = ntt.get_context().compiled().opdef("scaled_lap")
    assert (mv(out) - torch.from_numpy(rhs)).abs().max().item() < 1e-8


def test_unsupported_precond_rejected():
    @ntt.linear_op_def(bounds=([0], [16]), interior=([1], [15]), name="l2")
    def l2(u):
        return 2.0 * u[0] - u[-1] - u[1]

    b = ntt.get_context().builder
    tt = TempType("float64", Bounds.of([0], [16]))
    entry = b.make_function("entry", "func", [tt], [tt])
    b.push_block(entry.body)
    A = b.assemble_matrix("l2")
    b.return_([b.solve_linear(A, entry.body.args[0], solver="gmres", precond="jacobi")])
    b.pop_block()
    with pytest.raises(CodegenError, match="jacobi.*cg|cg.*jacobi"):
        generate_cpp(run_pipeline(ntt.get_context().module).module)


def _entry_module(build_body, n=16):
    """entry(t: temp) -> temp whose apply body is build_body(b, block)."""
    b = NeptuneBuilder()
    bounds = Bounds.of([0], [n])
    tt = TempType("float64", bounds)
    entry = b.make_function("entry", "func", [tt], [tt])
    b.push_block(entry.body)
    op, body = b.start_apply([entry.body.args[0]], bounds)
    b.push_block(body)
    b.yield_(build_body(b, body))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return b.module


def test_index_division_truncates_on_both_backends():
    def body(b, blk):
        i = blk.args[0]
        two = b.constant(2, INDEX)
        even = b.cmp("eq", b.mul(b.div(i, two), two), i)
        return b.select(even, b.access(blk.args[1], [0]), b.constant(0.0, F64))

    m = _entry_module(body)
    _same_cpp(m, jax_parse(print_module(m)))
    x = np.arange(1.0, 17.0)
    y_torch = compile_ir(m, backend="auto", device="cpu").function("entry")(x)
    y_nat = compile_native(m).function("entry")(x)
    expect = np.where(np.arange(16) % 2 == 0, x, 0.0)
    np.testing.assert_allclose(y_torch.numpy(), expect, atol=1e-12)
    np.testing.assert_allclose(y_nat.numpy(), expect, atol=1e-12)


def test_where_promotes_across_branches():
    n = 12

    @ntt.nonlinear_op_def(bounds=([0], [n]), interior=([0], [n]), name="mixed")
    def mixed(u):
        i = ntt.index(0)
        return ntt.where(i < 4, i, u[0])

    x = np.linspace(0.25, 3.0, n)
    expect = np.where(np.arange(n) < 4, np.arange(n, dtype=float), x)
    y = ntt.get_context().compiled().opdef("mixed")(x)
    np.testing.assert_allclose(y.numpy(), expect, atol=1e-12)
    module = ntt.get_context().module
    _same_cpp(module, jax_parse(print_module(module)))


def test_field_typed_return_native():
    b = ntt.get_context().builder
    n = 16
    bounds = Bounds.of([0], [n])
    ft = FieldType("float64", bounds)
    entry = b.make_function("entry", "func", [TensorType("float64", (n,))], [ft])
    b.push_block(entry.body)
    f = b.wrap(entry.body.args[0], ft)
    u = b.load(f)
    op, body = b.start_apply([u], Bounds.of([1], [n - 1]))
    b.push_block(body)
    b.yield_(b.mul(b.constant(3.0, F64), b.access(body.args[1], [0])))
    b.pop_block()
    b.store(b.finish_apply(op), f)
    b.return_([f])
    b.pop_block()
    ntt.get_context().bump()
    module = ntt.get_context().module
    _same_cpp(module, jax_parse(print_module(module)))
    x = np.arange(1.0, n + 1.0)
    y = compile_native(module).function("entry")(x)
    expect = x.copy()
    expect[1:-1] = 3.0 * x[1:-1]
    np.testing.assert_allclose(y.numpy(), expect, atol=1e-12)


def test_concurrent_builds_leave_whole_libraries(tmp_path, monkeypatch):
    """Two builds of one hash at once (as parallel workers do) both load:
    each writes a temporary name and renames it into place."""
    from concurrent.futures import ThreadPoolExecutor

    monkeypatch.setattr(torch_config, "cache_dir", str(tmp_path))
    m = _port(programs.build_bs_program())
    with ThreadPoolExecutor(2) as pool:
        nms = list(pool.map(lambda _: compile_native(m), range(2)))
    args = _inputs("bs")
    assert torch.equal(nms[0].function("entry")(*args), nms[1].function("entry")(*args))
    assert not list(tmp_path.glob("tmp*"))


# bench.py's f64_*_vs_native rows: (the port's builder, the JAX package's
# builder of the same program or None, inputs)
BENCH_ROWS = {
    "f64_accuracy_vs_native": (
        stencils.heat_gmres_f64, None,
        lambda: [np.zeros((48, 48)), np.sin(np.linspace(0, np.pi, 48))[:, None]
                 * np.cos(np.linspace(0, np.pi, 48))[None, :]]),
    "f64_bs_vs_native": (stencils.black_scholes, programs.build_bs_program,
                         lambda: _inputs("bs")),
    "f64_jfnk_vs_native": (stencils.allen_cahn_jfnk, programs.build_allen_cahn_nonlinear,
                           lambda: _inputs("allen_cahn_nonlinear")),
}


@pytest.mark.parametrize("row", BENCH_ROWS)
def test_bench_native_rows_on_the_cpu(row):
    """bench.py's three native-oracle rows through the port's executor in
    f64 on the CPU against its native runtime, within bench.py's 1e-10;
    the programs print as the JAX package's builders print them."""
    build, jax_build, inputs = BENCH_ROWS[row]
    module = build()
    if jax_build is not None:
        assert print_module(module) == jax_print(jax_build())
    args = inputs()
    got = compile_ir(module, device="cpu").function("entry")(*args)
    want = compile_native(module).function("entry")(*args)
    assert float((got - want).abs().max()) <= 1e-10
