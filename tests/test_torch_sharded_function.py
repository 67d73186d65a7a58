"""The port's `sharded_function` on four processes against the JAX
package's.

One spawn for the whole file (`ranks` fixture): four CPU processes join a
gloo group on localhost (`torch_ca_worker.py function`) and run each
program of `torch_ca_cases.FUNCTIONS` on their own blocks through
`sharded_function`. Here, in the parent, the JAX package runs the same
printed IR through its own `sharded_function` (GSPMD) on four of the eight
virtual CPU devices, with the same mesh shape: f64 results within 1e-10
relative. The Allen-Cahn program is the JAX package's own
`test_sharded_full_function` program, printed from its builder; the others
are the port's 2-D CG and 3-D GMRES heat steps, a reach-2 operator under
GMRES + Jacobi (whose probes must follow the global lattice), a program of
bounded stores and reductions, CG with `precond="mg"` (the V-cycle on
blocks, Jacobi and Chebyshev smoothing), `solver="chebyshev"` (Jacobi with
`check_every`, and given bounds), and a 2-D implicit Allen-Cahn step
through `solve_nonlinear` (with and without `jacobian=`; Newton's
iterations, read from both packages' SNES lines, must be equal) and
through an interpreted implicit-nonlinear `time_advance`; CG with
`precond="ssor"` and "ssor_dense", `solver="direct"` and
`precision="mixed"` (Krylov iterations within 1 and refinement rounds
equal, read from both packages' KSP lines; the mixed solution's true
residual under tol); an apply with no field input, an apply whose reach
exceeds a block (bounded and periodic), and a bounded store between
different bounds. What the JAX package refuses, the port refuses with the
same kind of error; odd multigrid blocks, which the JAX package's GSPMD
reshards, raise naming the ROADMAP item.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import programs  # noqa: E402
import torch_ca_cases as cases  # noqa: E402
from neptune_tpu.ir import print_module as jax_print  # noqa: E402
from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.lowering.executor import CompiledModule as JaxCompiledModule  # noqa: E402
from neptune_tpu.parallel import GridMesh as JaxGridMesh  # noqa: E402
from neptune_tpu.parallel import sharded_function as jax_sharded_function  # noqa: E402
from neptune_tpu.passes import compile_ir as jax_compile_ir  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from neptune_tpu_torch.parallel import GridMesh, sharded_function  # noqa: E402
from neptune_tpu_torch.passes import compile_ir  # noqa: E402

WORLD = 4


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port puts NumPy inputs on `config.device`, the card by default:
    these CPU tests ask for the CPU."""
    monkeypatch.setattr(torch_config, "device", "cpu")


def _jax_program(kind):
    """(JAX compiled module, function name, global arguments) of a program."""
    module, fname, args = cases.function_module(kind)
    parsed = jax_parse(print_module(module))
    # the Allen-Cahn 2-D programs run as written (their time_advance
    # interpreted); the others went through the port's pipeline
    lowered = not kind.startswith("ac2d_")
    cm = jax_compile_ir(parsed) if lowered else JaxCompiledModule(jax_verify(parsed))
    return cm, fname, args


def _jax_reference(name):
    """The JAX package's sharded_function outputs for one program, and
    Newton's iterations from its SNES lines and the (solver, iterations or
    rounds) of its KSP lines."""
    kind, mesh = cases.FUNCTIONS[name]
    gm = JaxGridMesh(mesh, cases.AXES[: len(mesh)], devices=jax.devices()[:WORLD])
    if kind == "allen_cahn":
        cm = jax_compile_ir(programs.build_allen_cahn_implicit_linear(n=16))
        fname, args = "entry", [np.zeros(16), np.sin(np.linspace(0, np.pi, 16))]
    else:
        cm, fname, args = _jax_program(kind)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        out = jax_sharded_function(cm, fname, gm)(*[gm.shard(jnp.asarray(a)) for a in args])
        outs = [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]
        jax.effects_barrier()
    return outs, cases.snes_iters(log.getvalue()), cases.ksp_counts(log.getvalue())


def _jax_raises(name):
    """The type name of what the JAX package's sharded_function raises on a
    RAISING program, or None when it runs."""
    kind, mesh, *_ = cases.RAISING[name]
    gm = JaxGridMesh(mesh, cases.AXES[: len(mesh)], devices=jax.devices()[:WORLD])
    cm, fname, args = _jax_program(kind)
    try:
        out = jax_sharded_function(cm, fname, gm)(*[gm.shard(jnp.asarray(a)) for a in args])
        jax.block_until_ready(out)
    except Exception as e:  # noqa: BLE001 -- the test compares the type
        return type(e).__name__
    return None


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks once, and meanwhile every JAX reference."""
    out = tmp_path_factory.mktemp("function")
    (out / "allen_cahn.mlir").write_text(jax_print(programs.build_allen_cahn_implicit_linear(n=16)))
    spawn = cases.Spawn("function", out)
    try:
        refs = {name: _jax_reference(name) for name in cases.FUNCTIONS}
        refs.update({name: _jax_raises(name) for name in cases.RAISING})
    finally:
        results, infos = spawn.results()
    return results, infos, refs


@pytest.mark.parametrize("name", cases.FUNCTIONS)
def test_sharded_function_matches_jax(ranks, name):
    results, infos, refs = ranks
    outs, snes, ksp = refs[name]
    for i, ref in enumerate(outs):
        got = results[f"fn/{name}/{i}"]
        assert got.shape == ref.shape
        err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)
        assert err <= 1e-10, (i, err)
    if name == "allen_cahn_4":
        oracle = programs.allen_cahn_implicit_linear_oracle(np.sin(np.linspace(0, np.pi, 16)))
        np.testing.assert_allclose(results[f"fn/{name}/0"], oracle, atol=1e-9)
    # every program exchanged strips with the neighbours, or gathered
    info = infos[name]
    assert info["shifts"] + info["gathers"] > 0
    assert info["snes_iters"] == snes
    if name.startswith("newton"):
        assert snes and all(it > 0 for it in snes)
    # Krylov iterations within 1, refinement rounds equal
    assert [k for k, _ in info["ksp"]] == [k for k, _ in ksp]
    for (kind, got), (_, want) in zip(info["ksp"], ksp):
        assert got == want if kind.endswith("/mixed") else abs(got - want) <= 1, (kind, got, want)
    kind = cases.FUNCTIONS[name][0]
    if kind in cases.SOLVE_PROGRAMS:
        assert ksp, "a solve program prints its KSP line"
        # the true residual of the gathered solution, under tol
        module, _, (b,) = cases.function_module(kind)
        A = CompiledModule(module, backend="torch", device="cpu").opdef("poisson")
        x = results[f"fn/{name}/0"]
        rel = np.linalg.norm(b - A(torch.from_numpy(x)).numpy()) / np.linalg.norm(b)
        assert rel <= cases.SOLVE_PROGRAMS[kind].get("tol", 1e-12), rel
    if kind in ("far32", "far32_periodic", "stores32"):
        # the reach took two hops on (4,1); the blocks of the stored temp
        # did not line up with the field's
        assert info["gathers"] == (1 if kind == "stores32" else 0)


@pytest.mark.parametrize("name", [n for n, c in cases.RAISING.items() if c[4]])
def test_refused_as_the_jax_package_refuses(ranks, name):
    _, infos, refs = ranks
    _, _, error, pattern, _ = cases.RAISING[name]
    assert infos[name]["error"] == error == refs[name]
    assert pattern in infos[name]["message"]


@pytest.mark.parametrize("name", [n for n, c in cases.RAISING.items() if not c[4]])
def test_unsharded_ops_raise_naming_the_roadmap_item(ranks, name):
    """What the port still refuses where the JAX package runs: every
    process raises, and the message names the ROADMAP item."""
    _, infos, refs = ranks
    _, _, error, pattern, _ = cases.RAISING[name]
    assert refs[name] is None
    assert infos[name]["error"] == error
    assert pattern in infos[name]["message"]


def _solve_program(**solve):
    module = stencils.with_solve(stencils.poisson5(32, "float64"), "poisson", **solve)
    return compile_ir(module, device="cpu")


def test_arg_ranks_must_match_the_signature():
    cm = _solve_program(solver="cg", tol=1e-8, max_iters=50)
    gm = GridMesh((1,), ("x",), device="cpu")
    sharded_function(cm, "solve", gm, arg_ranks=[2])
    with pytest.raises(ValueError, match="arg_ranks"):
        sharded_function(cm, "solve", gm, arg_ranks=[None])
