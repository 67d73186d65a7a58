"""Pinned arithmetic and the one cache directory of the port.

`config.pinned_arithmetic` (NEPTUNE_TORCH_PINNED) against the JAX
package's own pinned mode, on the CPU:

  * the pinned `tdot` bitwise equal to `neptune_tpu.utils.tree.tdot` under
    its pinned flag, f32 and f64, at lengths 0, 1, 2^k and 2^k +- 1, over
    tuple states, with +-inf products turned to NaN as there;
  * test_scale_stability's pinned whole-grid CG (256^2 f64 Poisson, tol
    1e-8): the JAX package's iteration count and x bit for bit;
  * toggling the mode between two calls of one compiled module: the result
    turns into the unfolded one, and the kernels' generated sources (A, C
    and D; not B) and launch data into the fenced ones, read from the
    source text, so no nvcc is needed;
  * the scope: the CA solvers' Gram reductions and GMRES's Arnoldi products
    gather nothing, CG's reductions gather every product;
  * `config.cache_dir` routing the kernels' and the native runtime's builds;
  * over four gloo processes (`torch_ca_worker.py pinned`), CG on that
    system and 50 applies of test_scale_stability's f32 adv4 operator,
    bitwise equal on (1,1), (2,2) and (4,1) and to the whole grid.
"""

import os
import stat
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_ca_cases as cases  # noqa: E402
from neptune_tpu.config import config as jax_config  # noqa: E402
from neptune_tpu.solvers import krylov as jax_krylov  # noqa: E402
from neptune_tpu.utils import tree as jax_tree  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import arithmetic  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.kernels import build, codegen  # noqa: E402
from neptune_tpu_torch.lowering import chain, cuda_backend, sweeps, torch_backend  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from neptune_tpu_torch.parallel import GridMesh, cg_sharded, sharded_opdef  # noqa: E402
from neptune_tpu_torch.passes.smoother import colour_pass  # noqa: E402
from neptune_tpu_torch.runtime import aot, compile_native  # noqa: E402
from neptune_tpu_torch.solvers import fused, krylov  # noqa: E402
from neptune_tpu_torch.utils import tree  # noqa: E402
from test_scale_stability import _poisson_module, _rhs  # noqa: E402


@pytest.fixture(autouse=True)
def default_config(monkeypatch):
    """Both packages' arithmetic and the port's cache directory at their
    defaults around every test."""
    monkeypatch.setattr(torch_config, "device", "cpu")
    monkeypatch.setattr(torch_config, "pinned_arithmetic", False)
    monkeypatch.setattr(torch_config, "cache_dir", None)
    monkeypatch.setattr(jax_config, "pinned_arithmetic", False)


def _pin(monkeypatch):
    monkeypatch.setattr(torch_config, "pinned_arithmetic", True)
    monkeypatch.setattr(jax_config, "pinned_arithmetic", True)


def _spread(rng, n, dtype):
    """Values over six decades, so that the association order shows."""
    return (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(dtype)


LENGTHS = [0, 1, 2, 3, 4, 5, 7, 8, 9, 15, 16, 17, 255, 256, 257, 4095, 4096, 4097]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("n", LENGTHS)
def test_pinned_tdot_bitwise_matches_jax(monkeypatch, n, dtype):
    _pin(monkeypatch)
    rng = np.random.default_rng(n)
    a, b = _spread(rng, n, dtype), _spread(rng, n, dtype)
    want = np.asarray(jax_tree.tdot(jnp.asarray(a), jnp.asarray(b)))
    got = tree.tdot(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), (got, want)
    norm = tree.tnorm(torch.from_numpy(a)).numpy()
    assert norm.tobytes() == np.asarray(jax_tree.tnorm(jnp.asarray(a))).tobytes()
    # the pinned tree is not the default sum: CG in f64 gives way to it too
    assert tree.tdot_f64(torch.from_numpy(a), torch.from_numpy(b)).numpy().tobytes() \
        == want.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_pinned_tdot_tuple_states(monkeypatch, dtype):
    """Leaves reduce in order, each through its own tree (2-D leaves in C
    order)."""
    _pin(monkeypatch)
    rng = np.random.default_rng(1)
    shapes = [(33, 17), (5,), (8, 8)]
    xs = [_spread(rng, int(np.prod(s)), dtype).reshape(s) for s in shapes]
    ys = [_spread(rng, int(np.prod(s)), dtype).reshape(s) for s in shapes]
    want = np.asarray(jax_tree.tdot(tuple(map(jnp.asarray, xs)), tuple(map(jnp.asarray, ys))))
    got = tree.tdot(tuple(map(torch.from_numpy, xs)), tuple(map(torch.from_numpy, ys)))
    assert got.numpy().tobytes() == want.tobytes()


def test_pinned_inf_products_become_nan(monkeypatch):
    """The JAX package's fence turns a non-finite product into NaN: so do
    the port's tdot, taxpy and apply bodies."""
    _pin(monkeypatch)
    x = np.array([1.0, np.inf, 2.0, -np.inf, 3.0])
    y = np.array([1.0, 1.0, 0.5, 2.0, 0.0])
    want = np.asarray(jax_tree.tdot(jnp.asarray(x), jnp.asarray(y)))
    got = tree.tdot(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert np.isnan(want) and np.isnan(got)
    want = np.asarray(jax_tree.taxpy(2.0, jnp.asarray(x), jnp.asarray(y)))
    got = tree.taxpy(2.0, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, want)  # NaN where NaN
    assert np.isnan(got[1]) and np.isnan(got[3])
    ops = torch_backend.TorchOps("cpu")
    assert torch.isnan(ops.fence(float("inf"), "float64"))
    assert torch.isnan(ops.fence(torch.tensor([-np.inf]), "float32")).all()


def test_pinned_reduction_needs_the_mesh_layout(monkeypatch):
    """A bare process group carries no global positions: the pinned tree
    refuses it, default arithmetic does not need it."""
    x = torch.ones(4)
    _pin(monkeypatch)
    with pytest.raises(ValueError, match="mesh_group"):
        tree.tdot(x, x, group=object())


def test_pinned_cg_matches_jax_whole_grid(monkeypatch, ranks):
    """test_scale_stability's pinned CG on the whole grid (the port's, run
    by `ranks`): the JAX package's iterations and x, bit for bit."""
    _pin(monkeypatch)
    xj, info_j = jax.jit(
        lambda bb: jax_krylov.cg(_poisson_module().opdef("poisson"), bb, tol=cases.PINNED_TOL,
                                 maxiter=3000)
    )(jnp.asarray(_rhs()))
    whole = ranks[2]
    assert whole["iters"] == int(info_j.iters)
    assert whole["cg"].tobytes() == np.asarray(xj).tobytes(), np.abs(whole["cg"] - xj).max()


def _constant_chain(ir):
    """@cc(u) = u + ((1 + 2^-24) + 2^-24) in f32: in f32 each add rounds
    back to 1, in one f64 pass the constants sum to 1 + 2^-23."""
    n = 8
    tt = ir.TempType("float32", ir.Bounds.of((0, 0), (n, n)))
    b = ir.NeptuneBuilder()
    fn = b.make_opdef("cc", "nonlinear_opdef", [tt], [tt])
    b.push_block(fn.body)
    op, body = b.start_apply([fn.body.args[0]], tt.bounds)
    b.push_block(body)
    c = b.add(b.constant(1.0, ir.F32), b.constant(2.0 ** -24, ir.F32))
    c = b.add(c, b.constant(2.0 ** -24, ir.F32))
    b.yield_(b.add(b.access(body.args[2], (0, 0)), c))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return b.module


def test_unfolded_constants_round_each_operation(monkeypatch):
    """With folding off (pinned mode) two constants combine in the body's
    type, one rounding per operation, as the JAX package and the kernels'
    literals compute them, not in one f64 pass."""
    import neptune_tpu.ir as jax_ir
    import neptune_tpu_torch.ir as torch_ir
    from neptune_tpu.passes import compile_ir as jax_compile
    from neptune_tpu_torch.passes import compile_ir

    _pin(monkeypatch)
    x = np.zeros((8, 8), np.float32)
    want = np.asarray(jax_compile(_constant_chain(jax_ir), backend="jnp").opdef("cc")(x))
    got = compile_ir(_constant_chain(torch_ir), device="cpu").opdef("cc")(torch.from_numpy(x))
    assert float(want[0, 0]) == 1.0 and got.numpy().tobytes() == want.tobytes()
    src = cuda_backend.source(stencils.the_apply(_constant_chain(torch_ir)))
    assert "((0x1.0000000000000p+0f) + (0x1.0000000000000p-24f))" in src


def _adv4_and_input(n=(40, 72)):
    module = stencils.advection4(n)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(n).astype(np.float32))
    return module, x


def test_toggling_pinned_mode_changes_the_result(monkeypatch):
    """One compiled module, the mode toggled between its calls: the pinned
    call gives the unfolded result, the default call the folded one."""
    module, x = _adv4_and_input()
    f = CompiledModule(module, device="cpu").opdef("adv4")
    folded = f(x)
    monkeypatch.setattr(torch_config, "fold_affine", False)
    unfolded = f(x)
    monkeypatch.setattr(torch_config, "fold_affine", True)
    assert not torch.equal(folded, unfolded)  # folding rounds differently here
    assert arithmetic() == (True, False)
    monkeypatch.setattr(torch_config, "pinned_arithmetic", True)
    assert arithmetic() == (False, True)
    assert torch.equal(f(x), unfolded)
    monkeypatch.setattr(torch_config, "pinned_arithmetic", False)
    assert torch.equal(f(x), folded)


def _sources(module, name):
    op = stencils.the_apply(module)
    return {
        "A": cuda_backend.source(op),
        "C": sweeps.source(sweeps.sweep_plan(module, name, 4)),
        "D": codegen.chain_source(chain.chain_plan(stencils.composite((64, 128)), "wrapped")),
        "B": codegen.fused_cg_source(fused.cg_plan(stencils.poisson5(64), "poisson")),
    }


def test_pinned_kernel_sources_are_fenced(monkeypatch):
    """Kernels A, C and D follow the mode with fenced, unfolded bodies;
    kernel B keeps default arithmetic, as the JAX package's fused CG."""
    module, _ = _adv4_and_input()
    default = _sources(module, "adv4")
    monkeypatch.setattr(torch_config, "pinned_arithmetic", True)
    pinned = _sources(module, "adv4")
    for k in "ACD":
        assert "isfinite(" in pinned[k] and "isfinite(" not in default[k], k
    assert pinned["B"] == default["B"] and "isfinite(" not in pinned["B"]


def test_launch_data_keyed_on_the_arithmetic(monkeypatch):
    """The launch-data caches of kernels A (its whole grid and its colour
    form), C and D: toggling the mode between two calls builds the fenced
    kernel, and toggling back reuses the first (`builder.load` recorded,
    no nvcc)."""
    loaded = []

    def load(source, stem):
        loaded.append(source)
        return mock.MagicMock()

    monkeypatch.setattr(build.builder, "load", load)
    for mod in (cuda_backend, sweeps, chain):
        monkeypatch.setattr(mod, "_kernels", {})
    module, _ = _adv4_and_input()
    op = stencils.the_apply(module)
    plan_c = sweeps.sweep_plan(module, "adv4", 4)
    plan_d = chain.chain_plan(stencils.composite((64, 128)), "wrapped")
    pass_op = stencils.the_apply(colour_pass(stencils.hpcg27((10, 10, 10)), "hpcg27"))
    launchers = (
        lambda: cuda_backend._launcher(op), lambda: sweeps._entry(plan_c),
        lambda: chain._launcher(plan_d), lambda: cuda_backend._launcher(pass_op, form="colour"),
    )
    for launch in launchers:
        first = launch()
        monkeypatch.setattr(torch_config, "pinned_arithmetic", True)
        second = launch()
        monkeypatch.setattr(torch_config, "pinned_arithmetic", False)
        assert second is not first and launch() is first
        assert "isfinite(" not in loaded[-2] and "isfinite(" in loaded[-1]
    assert len(loaded) == 8


def test_pinned_scope_gathers(monkeypatch):
    """On a mesh, pinned CG gathers every product it sums (without M, 2
    reductions before the loop and 2 per iteration: ||r|| is the root of
    r.z); the CA solvers' Gram reductions and GMRES's Arnoldi products keep
    default arithmetic and gather nothing."""
    _pin(monkeypatch)
    module = stencils.poisson5(32, "float64")
    gm = GridMesh((1, 1), device="cpu")
    cm = CompiledModule(module, device="cpu")
    b = gm.shard(cases.pinned_rhs(32))
    mv = sharded_opdef(cm, "poisson", gm)
    _, info = krylov.cg(mv, b, tol=0.0, maxiter=10, group=gm.mesh_group(2))
    assert info.iters == 10 and gm.gathers == 2 + 2 * 10
    gm.gathers = 0
    krylov.gmres(mv, b, tol=0.0, maxiter=12, restart=6, group=gm.mesh_group(2))
    assert gm.gathers == 0
    _, info = cg_sharded(cm, "poisson", gm, s=4, tol=0.0, maxiter=8)(b)
    assert info.iters == 8 and gm.gathers == 0


def _fake_nvcc(path):
    """An `nvcc` that links an empty shared library at its `-o`."""
    path.write_text(
        '#!/bin/sh\nout=""\nwhile [ $# -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then out="$2"; shift; fi\n  shift\ndone\n'
        'exec g++ -shared -fPIC -x c /dev/null -o "$out"\n'
    )
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return str(path)


def test_cache_dir_routes_both_builds(monkeypatch, tmp_path):
    monkeypatch.setattr(build, "nvcc_path", lambda: _fake_nvcc(tmp_path / "nvcc"))
    monkeypatch.setattr(torch_config, "cache_dir", str(tmp_path / "cache"))
    assert build.kernel_dir() == tmp_path / "cache" / "kernels"
    assert build.builder.build_dir == build.kernel_dir()
    build.Builder().load("// a kernel's source\n", "probe")
    assert [p.suffix for p in sorted((tmp_path / "cache" / "kernels").glob("probe_*"))] == [
        ".cu", ".so"]
    module = stencils.with_entry(stencils.poisson5(16, "float64"), "poisson")
    compile_native(module)
    assert aot._cache_dir() == tmp_path / "cache"
    assert any(p.suffix == ".so" for p in (tmp_path / "cache").glob("neptune_*"))


def test_cache_dir_unset_changes_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    assert build.kernel_dir() == build.BUILD_DIR == build.PACKAGE / "_build"
    assert build.builder.build_dir == build.BUILD_DIR
    assert aot._cache_dir() == tmp_path / ".neptune_tpu_torch" / "cache"
    assert build.Builder(tmp_path / "own").build_dir == tmp_path / "own"


# ---- four processes ----------------------------------------------------------


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the four ranks once on (2,2) and (4,1), and meanwhile, pinned,
    the whole grid and the mesh of one position in this process: (every
    mesh's results, their infos, the whole grid's)."""
    spawn = cases.Spawn("pinned", tmp_path_factory.mktemp("pinned"))
    old = torch_config.pinned_arithmetic, torch_config.device, torch.get_num_threads()
    torch_config.pinned_arithmetic, torch_config.device = True, "cpu"
    torch.set_num_threads(1)  # leave the cores to the four ranks, which set the pace
    try:
        poisson, adv4 = (CompiledModule(m, device="cpu") for m in cases.pinned_modules())
        b = cases.pinned_rhs()
        x, info = krylov.cg(poisson.opdef("poisson"), torch.from_numpy(b),
                            tol=cases.PINNED_TOL, maxiter=3000)
        u, mv = torch.from_numpy(b.astype(np.float32)), adv4.opdef("adv4")
        for _ in range(cases.PINNED_STEPS):
            u = mv(u)
        whole = {"cg": x.numpy(), "iters": info.iters, "adv4": u.numpy()}
        one, one_infos = {}, {}
        cases.run_pinned(GridMesh((1, 1), device="cpu"), one, one_infos)
    finally:
        torch_config.pinned_arithmetic, torch_config.device = old[:2]
        torch.set_num_threads(old[2])
        results, infos = spawn.results()
    return {**results, **one}, {**infos, **one_infos}, whole


MESH_IDS = ["x".join(map(str, m)) for m in cases.PINNED_MESHES]


@pytest.mark.parametrize("tag", MESH_IDS)
def test_pinned_cg_bitwise_across_meshes(ranks, tag):
    results, infos, whole = ranks
    info = infos[f"cg/{tag}"]
    assert info["converged"] and info["iters"] == whole["iters"]
    assert results[f"cg/{tag}"].tobytes() == whole["cg"].tobytes(), \
        np.abs(results[f"cg/{tag}"] - whole["cg"]).max()
    # every reduction gathered its products: 2 before the loop, 2 a step
    assert info["gathers"] == 2 + 2 * info["iters"]


@pytest.mark.parametrize("tag", MESH_IDS)
def test_pinned_adv4_chain_bitwise_across_meshes(ranks, tag):
    results, _, whole = ranks
    got = results[f"adv4/{tag}"]
    assert got.tobytes() == whole["adv4"].tobytes(), np.abs(got - whole["adv4"]).max()


def test_pinned_mode_reads_its_environment_variable():
    """NEPTUNE_TORCH_PINNED and NEPTUNE_TORCH_CACHE_DIR set the two fields
    at import, in a fresh process."""
    import subprocess
    import sys

    code = ("from neptune_tpu_torch.config import config; "
            "print(config.pinned_arithmetic, config.cache_dir)")
    env = dict(os.environ, NEPTUNE_TORCH_PINNED="1", NEPTUNE_TORCH_CACHE_DIR="/x/y")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)), check=True).stdout
    assert out.split() == ["True", "/x/y"]
