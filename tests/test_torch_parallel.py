"""The port's `parallel/` against the JAX package's, in one process.

  * `plan_report` prints the JAX package's text and the three goldens
    (`tests/golden/sharded_*_plan.txt`) byte for byte, on abstract meshes;
    `plan_opdef` chooses the JAX package's route;
  * `initialize_multihost` keeps the JAX package's behaviours
    (`tests/test_distributed.py`), with `init_process_group` patched;
  * the shard-local kernel forms against the JAX TPU kernels run in
    interpret mode: kernel A's window form against `execute_apply_window`
    (#5) and the DMA kernels with `global_start` (#2, #3), kernel C's local
    form against `execute_sweeps_window_local` (#7, #8), kernel D's origin
    form against `execute_chain(global_start=...)` (#9). On the CPU each
    form runs its plain version. Reads beyond a block are garbage by
    contract, so the comparison covers the cells more than K x reach from
    every block edge, and the copy-through cells everywhere.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import programs  # noqa: E402
import torch.distributed as tdist  # noqa: E402
from neptune_tpu.config import config as jax_config  # noqa: E402
from neptune_tpu.ir import print_module as jax_print  # noqa: E402
from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.lowering import pallas_backend, pallas_chain, pallas_multisweep  # noqa: E402
from neptune_tpu.parallel import GridMesh as JaxGridMesh  # noqa: E402
from neptune_tpu.parallel import plan_report as jax_plan_report  # noqa: E402
from neptune_tpu.passes import compile_ir as jax_compile_ir  # noqa: E402
from neptune_tpu.passes import run_pipeline as jax_run_pipeline  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.interop import module_from_reference  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.lowering import chain, cuda_backend, sweeps  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from neptune_tpu_torch.parallel import (  # noqa: E402
    GridMesh,
    distributed,
    initialize_multihost,
    plan_opdef,
    plan_report,
    sharded_function,
)
from neptune_tpu_torch.passes import compile_ir, run_pipeline  # noqa: E402
from test_torch_apply import TOL  # noqa: E402

GOLDEN = Path(__file__).parent / "golden"

# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------


def _both(build):
    """The JAX package's compiled module and the port's, from one program."""
    jcm = jax_compile_ir(jax_run_pipeline(build()).module)
    port = module_from_reference(jax_print(build()))
    return jcm, CompiledModule(run_pipeline(port).module)


# golden -> [(program, opdef, mesh shape, mesh axes, the JAX backend)]
GOLDENS = {
    "sharded_heat3d_plan.txt": [
        (programs.build_heat3d_explicit, "heat3d_rhs", (2, 2), ("x", "y"), "jnp")
    ],
    "sharded_ac_plan.txt": [
        (programs.build_allen_cahn_implicit_linear, "ac_lap", (4,), ("x",), "jnp"),
        (programs.build_allen_cahn_implicit_linear, "ac_A", (4,), ("x",), "jnp"),
    ],
    "sharded_adv4_pallas_plan.txt": [
        (programs.build_periodic_advection4, "adv4", (4,), ("x",), "pallas")
    ],
}
_PORT_BACKEND = {"jnp": "auto", "pallas": "cuda"}


@pytest.mark.parametrize("golden", GOLDENS)
def test_plan_report_matches_golden_and_jax(golden):
    text = ""
    for build, name, shape, axes, backend in GOLDENS[golden]:
        jcm, cm = _both(build)
        port = plan_report(cm, name, GridMesh(shape, axes, abstract=True), _PORT_BACKEND[backend])
        assert port == jax_plan_report(jcm, name, JaxGridMesh(shape, axes), backend)
        if backend == "jnp":  # "torch" chooses the routes as "auto" does
            assert port == plan_report(cm, name, GridMesh(shape, axes, abstract=True), "torch")
        text += port
    assert text == (GOLDEN / golden).read_text()


def test_abstract_mesh_plans_beyond_the_processes():
    jcm, cm = _both(programs.build_heat3d_explicit)
    big = GridMesh((16, 2), ("x", "y"), abstract=True)
    assert big.n_devices == 32
    # 8x8x8 over a 16-way dim 0: neither fused route divides it
    assert plan_opdef(cm, "heat3d_rhs", big).kind == "extended-block"
    assert plan_report(cm, "heat3d_rhs", big) == jax_plan_report(
        jcm, "heat3d_rhs", JaxGridMesh((16, 2), ("x", "y"), abstract=True)
    )


def test_mesh_topology():
    gm = GridMesh((4, 2), ("x", "y"), abstract=True)
    assert gm.n_devices == 8 and gm.pspec(2) == ("x", "y") and gm.pspec(3) == ("x", "y", None)
    with pytest.raises(ValueError, match="divisible"):
        gm.check_divisible((63, 64))


def test_mesh_needs_its_processes_and_a_device(monkeypatch):
    with pytest.raises(RuntimeError, match="initialize_multihost"):
        GridMesh((2, 2), ("x", "y"), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GridMesh((1,), ("x",))
    gm = GridMesh((1,), ("x",), device="cpu")
    assert gm.rank == 0 and gm.coords == (0,) and gm.group is None


# (opdef builder, opdef, mesh, backend, the JAX package's route)
ROUTES = [
    (lambda: stencils.jacobi5((64, 64)), "jacobi", (4, 2), "auto", "fused-strip"),
    (lambda: stencils.heat7((16, 16, 16)), "heat", (2, 2), "auto", "fused-strip"),
    (lambda: stencils.advection4((64, 64), periodic=True), "adv4", (4, 2), "auto", "fused-strip"),
    (lambda: stencils.advection4((64, 64), periodic=True), "adv4", (4, 2), "cuda", "extended-block"),
    (lambda: stencils.composite((64, 64)), "wrapped", (4, 2), "auto", "fused-composite"),
    (lambda: stencils.composite((64, 64)), "wrapped", (4, 2), "cuda", "extended-block"),
    (lambda: stencils.composite((64, 64), mixed=True), "wrapped", (4, 2), "auto", None),
    (lambda: stencils.coupled((64, 64)), "couple", (2, 2), "auto", "fused-composite"),
    (lambda: stencils.jacobi5((64, 64)), "jacobi", (64, 2), "auto", "extended-block"),
]


@pytest.mark.parametrize("i", range(len(ROUTES)))
def test_plan_opdef_chooses_the_jax_route(i):
    from neptune_tpu.lowering.executor import CompiledModule as JaxCompiledModule
    from neptune_tpu.parallel import plan_opdef as jax_plan_opdef

    build, name, mesh, backend, want = ROUTES[i]
    module = build()
    jcm = JaxCompiledModule(jax_verify(jax_parse(print_module(module))), "jnp")
    gm = GridMesh(mesh, ("x", "y"), abstract=True)
    jgm = JaxGridMesh(mesh, ("x", "y"), abstract=True)
    jb = {"cuda": "pallas"}.get(backend, "jnp")
    if want is None:  # mixed periodic and bounded applies: both refuse
        with pytest.raises(NotImplementedError, match="mixes periodic"):
            plan_opdef(CompiledModule(module), name, gm, backend)
        with pytest.raises(NotImplementedError, match="mixes periodic"):
            jax_plan_opdef(jcm, name, jgm, jb)
        return
    assert plan_opdef(CompiledModule(module), name, gm, backend).kind == want
    assert jax_plan_opdef(jcm, name, jgm, jb).kind == want


def test_unknown_backend_and_sharded_function():
    cm = CompiledModule(stencils.jacobi5((16, 16)))
    gm = GridMesh((2,), ("x",), abstract=True)
    with pytest.raises(ValueError, match="backend"):
        plan_opdef(cm, "jacobi", gm, "pallas")
    # sharded_function runs (test_torch_sharded_function.py), the multigrid
    # preconditioner too: on a one-process mesh it is the whole-grid function
    module = stencils.with_solve(stencils.poisson5(32, "float64"), "poisson", solver="cg",
                                 tol=1e-8, max_iters=50, precond="mg")
    cm = compile_ir(module, device="cpu")
    f = sharded_function(cm, "solve", GridMesh((1,), ("x",), device="cpu"))
    b = np.random.default_rng(5).standard_normal((32, 32))
    assert torch.equal(f(b), cm.function("solve")(b))


def test_shardmap_opdef_carries_its_mesh_and_a_jvp_rule():
    """The sharded matvec carries its mesh and the verifier's halo, and a
    forward-mode rule: its tangent on a one-process mesh is the eager
    view's, bitwise, for a nonlinear opdef; for a linear one it is the
    matvec of the tangent. The reverse-mode rule's cotangent is the eager
    view's too, to roundoff (the unpadding adds each ghost's zero
    cotangent)."""
    import neptune_tpu_torch as ntt
    from neptune_tpu_torch.lowering.executor import rule_counter
    from neptune_tpu_torch.parallel import shardmap_opdef, single_device_mesh

    n = 32
    ntt.reset_context()

    @ntt.nonlinear_op_def(bounds=([0, 0], [n, n]), dtype="float64", name="cubic")
    def cubic(u, up):
        lap = u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1] - 4.0 * u[0, 0]
        return u[0, 0] - up[0, 0] - 0.05 * (lap + u[0, 0] - u[0, 0] * u[0, 0] * u[0, 0])

    cm = ntt.get_context().compiled()
    gm = single_device_mesh("cpu")
    f = shardmap_opdef(cm, "cubic", gm)
    assert f.gmesh is gm and f.halo == ((1, 1), (1, 1))
    x, up, v = torch.from_numpy(np.random.default_rng(0).standard_normal((3, n, n)))
    before = rule_counter.count
    out, tan = torch.func.jvp(lambda a: f(a, up), (x,), (v,))
    assert rule_counter.count == before + 1
    view = cm.opdef("cubic", differentiable=True)
    ref_out, ref_tan = torch.func.jvp(lambda a: view(a, up), (x,), (v,))
    assert torch.equal(out, ref_out) and torch.equal(tan, ref_tan)
    w = torch.from_numpy(np.random.default_rng(1).standard_normal((n, n)))
    xg, upg = x.clone().requires_grad_(True), up.clone().requires_grad_(True)
    before = rule_counter.count
    (f(xg, upg) * w).sum().backward()
    assert rule_counter.count == before + 1
    _, pull = torch.func.vjp(view, x, up)
    for got, ref in zip((xg.grad, upg.grad), pull(w)):
        assert (got - ref).abs().max() <= 1e-14 * ref.abs().max()

    mv = shardmap_opdef(CompiledModule(stencils.poisson5(n, "float64")), "poisson", gm)
    _, tan = torch.func.jvp(mv, (x,), (v,))
    assert torch.equal(tan, mv(v))


def test_odd_blocks_name_the_level_and_the_mesh():
    """Above the coarsest level every sharded block extent must be even:
    the V-cycle restricts block-locally. The message names the remedies:
    precond="mg", which runs such levels on the whole grid, or whole-grid
    operators from that level on."""
    from neptune_tpu_torch.parallel import shardmap_opdef, single_device_mesh
    from neptune_tpu_torch.solvers.multigrid import build_levels

    gm = single_device_mesh("cpu")
    mvs = [
        shardmap_opdef(CompiledModule(stencils.poisson5(n, "float64")), "poisson", gm)
        for n in (20, 10, 5)
    ]
    with pytest.raises(ValueError, match=r"level 2 grid \(5, 5\) on mesh \(1,\)") as e:
        build_levels(mvs + [None], torch.zeros(20, 20, dtype=torch.float64))
    assert "precond='mg'" in str(e.value) and "whole-grid operators from level 2" in str(e.value)


def _mg_ops(sizes, gm, whole_from):
    """The rediscretized Poisson hierarchy (f64, eager, level l scaled by
    4^-l): sharded on `gm` above level `whole_from`, whole-grid opdefs from
    it on."""
    from neptune_tpu_torch.lowering.executor import _CoarseOp
    from neptune_tpu_torch.parallel import shardmap_opdef

    ops = []
    for lvl, n in enumerate(sizes):
        cm = CompiledModule(stencils.poisson5(n, "float64"), "torch", "cpu")
        sharded = lvl < whole_from
        mv = shardmap_opdef(cm, "poisson", gm, "torch") if sharded else cm.opdef("poisson")
        ops.append(_CoarseOp(lambda x, f=mv, s=0.25**lvl: s * f(x), ((1, 1), (1, 1)),
                             gm if sharded else None))
    return ops


@pytest.mark.parametrize("whole_from", [1, 2, 3])
def test_mixed_hierarchy_equals_the_whole_grid(whole_from):
    """Sharded levels, then whole-grid ones replicated on every process, on
    a mesh of one process: one preconditioner cycle and a red-black
    multigrid_solve bitwise those of the whole-grid hierarchy, with one
    gather per transition crossed."""
    from neptune_tpu_torch.parallel import single_device_mesh
    from neptune_tpu_torch.solvers import multigrid

    sizes, gm = (64, 32, 16, 8), single_device_mesh("cpu")
    like = torch.zeros(64, 64, dtype=torch.float64)
    mixed = multigrid.build_levels(_mg_ops(sizes, gm, whole_from), like)
    whole = multigrid.build_levels(_mg_ops(sizes, gm, 0), like)
    assert [lv.mesh for lv in mixed] == [gm] * whole_from + [None] * (4 - whole_from)
    for a, b in zip(mixed, whole):
        assert torch.equal(a.inv_diag, b.inv_diag) and a.cheb_lmax == b.cheb_lmax
    r = torch.from_numpy(np.random.default_rng(7).standard_normal((64, 64)))
    gm.gathers = 0
    y = multigrid.mg_preconditioner(None, like, levels=mixed)(r)
    assert gm.gathers == 1
    assert torch.equal(y, multigrid.mg_preconditioner(None, like, levels=whole)(r))
    x, info = multigrid.multigrid_solve(None, r, levels=mixed, tol=1e-8)
    x_ref, info_ref = multigrid.multigrid_solve(None, r, levels=whole, tol=1e-8)
    assert info.converged and info.iters == info_ref.iters and torch.equal(x, x_ref)
    x0 = multigrid.fmg_start(mixed, r)
    assert torch.equal(x0, multigrid.fmg_start(whole, r))


def test_sharded_level_below_a_whole_one_raises():
    from neptune_tpu_torch.parallel import single_device_mesh
    from neptune_tpu_torch.solvers import multigrid

    gm = single_device_mesh("cpu")
    ops = _mg_ops((32, 16, 8), gm, 3)
    ops[1] = _mg_ops((32, 16, 8), gm, 0)[1]
    with pytest.raises(ValueError, match="level 2 is sharded .* below a whole-grid level"):
        multigrid.build_levels(ops, torch.zeros(32, 32, dtype=torch.float64))


@pytest.mark.parametrize("mesh, coarse", [
    ((2, 2), (12, 16)), ((4, 1), (12, 16)), ((1, 4), (12, 16)), ((2, 2), (34, 34)),
])
def test_prolong_block_is_a_block_of_the_whole_interpolation(mesh, coarse):
    """Each process's block of the interpolated correction, taken from the
    replicated coarse grid with its one-cell halo, is that block of the
    whole-grid interpolation (no exchange: the mesh needs only its shape
    and coordinates here). On the CPU, whose interpolation kernel orders
    its passes by the input's size, within a rounding where a coarse block
    is odd (34^2 on (2,2)); bitwise on the card
    (test_torch_gpu.py::test_prolong_block_on_the_card)."""
    from types import SimpleNamespace

    from neptune_tpu_torch.solvers.multigrid import prolong, prolong_block

    e = torch.from_numpy(np.random.default_rng(8).standard_normal(coarse))
    fine = tuple(2 * n for n in coarse)
    ref = prolong(e, fine)
    block = (fine[0] // mesh[0], fine[1] // mesh[1])
    odd = any((b // 2) % 2 and m > 1 for b, m in zip(block, mesh))
    for i in range(mesh[0]):
        for j in range(mesh[1]):
            gm = SimpleNamespace(shape=mesh, coords=(i, j))
            got = prolong_block(e, block, gm)
            want = ref[i * block[0]:(i + 1) * block[0], j * block[1]:(j + 1) * block[1]]
            if odd:
                assert float((got - want).abs().max()) <= 4e-16 * float(e.abs().max()), (i, j)
            else:
                assert torch.equal(got, want), (i, j)


def test_first_whole_level():
    """The level from which a hierarchy runs on the whole grid: the first
    whose block is odd above the coarsest (the mesh cases: 36^2 in 3 levels,
    1800^2 in 4)."""
    from types import SimpleNamespace

    from neptune_tpu_torch.solvers.multigrid import first_whole_level

    def mesh(shape):
        return SimpleNamespace(shape=shape)

    assert first_whole_level((36, 36), mesh((2, 2)), 3) == 1
    assert first_whole_level((36, 36), mesh((4, 1)), 3) == 0
    assert first_whole_level((1800, 1800), mesh((2, 2)), 4) == 2
    assert first_whole_level((1800, 1800), mesh((4, 1)), 4) == 1
    assert first_whole_level((512, 512), mesh((2, 2)), 6) == 6
    assert first_whole_level((64, 64), mesh((4, 1)), 3) == 3


# ---------------------------------------------------------------------------
# initialize_multihost (the JAX package's tests/test_distributed.py)
# ---------------------------------------------------------------------------


@pytest.fixture
def no_env(monkeypatch):
    for k in distributed._ENV:
        monkeypatch.delenv(k, raising=False)


def test_single_process_noop(monkeypatch, no_env):
    called = []
    monkeypatch.setattr(tdist, "init_process_group", lambda *a, **k: called.append(1))
    assert initialize_multihost() == 1
    assert not called


def test_already_initialized_is_swallowed(monkeypatch):
    def boom(**kw):
        raise RuntimeError("Distributed system is already initialized")

    monkeypatch.setattr(tdist, "init_process_group", boom)
    assert initialize_multihost("10.0.0.1:1234", 2, 0) == 1


def test_real_failure_propagates(monkeypatch):
    def boom(**kw):
        raise RuntimeError("failed to connect to coordinator after 5 attempts")

    monkeypatch.setattr(tdist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="coordinator"):
        initialize_multihost("10.0.0.1:1234", 2, 0)


def test_env_rendezvous_and_explicit_arguments(monkeypatch):
    calls = []
    monkeypatch.setattr(tdist, "init_process_group", lambda **kw: calls.append(kw))
    for k, v in zip(distributed._ENV, ("head", "8476", "4", "1")):
        monkeypatch.setenv(k, v)
    initialize_multihost(backend="gloo")
    initialize_multihost("head:8476", 4, 1)
    assert calls[0] == {"backend": "gloo", "init_method": "env://"}
    assert calls[1]["init_method"] == "tcp://head:8476"
    assert (calls[1]["world_size"], calls[1]["rank"]) == (4, 1)
    assert calls[1]["backend"] == distributed.default_backend()


# ---------------------------------------------------------------------------
# the shard-local kernel forms against the JAX TPU kernels
# ---------------------------------------------------------------------------


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jax_config, "pallas_interpret", True)


def _rand(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _compare(got, ref, margin, op, gstart, k=1):
    """Cells more than `margin` from every block edge within k x 4 f32
    ulps (relative to the largest value); copy-through cells bit-equal."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    inner = tuple(slice(m, n - m) for m, n in zip(margin, got.shape))
    err = np.abs(got[inner] - ref[inner]).max()
    assert err <= k * TOL["float32"] * np.abs(ref[inner]).max(), err
    bounds = op.attrs["bounds"]
    inside = np.ones(got.shape, bool)
    for d, (g, n) in enumerate(zip(gstart, got.shape)):
        iv = np.arange(n) + g
        view = [1] * got.ndim
        view[d] = n
        inside &= ((iv >= bounds.lb[d]) & (iv < bounds.ub[d])).reshape(view)
    np.testing.assert_array_equal(got[~inside], ref[~inside])


def _apply_of(module):
    op = stencils.the_apply(module)
    (jop,) = [o for o in jax_verify(jax_parse(print_module(module))).walk() if o.name == "neptune.apply"]
    return op, jop


# (module, block shape, global starts, the TPU kernel the JAX side reaches)
WINDOWS = {
    "jacobi5_h0_1": (lambda: stencils.jacobi5((96, 128)), (32, 128), [(0, 0), (32, 0), (64, 0)], "window"),
    "adv4_h0_2": (lambda: stencils.advection4((96, 128)), (32, 128), [(0, 0), (32, 0), (64, 0)], "dma"),
    "heat7_rank3": (lambda: stencils.heat7((16, 16, 128)), (8, 8, 128), [(0, 0, 0), (8, 8, 0)], "dma"),
    "graded_index": (
        lambda: stencils.graded((96, 128), lb=(3, -5)), (32, 64), [(3, -5), (35, 59), (67, 27)], "window"
    ),
}


@pytest.mark.parametrize("case", WINDOWS)
def test_window_form_matches_execute_apply_window(case, interpret):
    build, block, starts, kernel = WINDOWS[case]
    op, jop = _apply_of(build())
    assert pallas_backend._dma_profitable(jop, block) == (kernel == "dma")
    reach = [max(h) for h in op.attrs["shape"].halo()]
    for i, gstart in enumerate(starts):
        x = _rand(block, i)
        ref = pallas_backend.execute_apply_window(jop, [x], [], block, gstart, interpret=True)
        got = cuda_backend.apply_window(op, [torch.from_numpy(x)], [], gstart).numpy()
        _compare(got, ref, reach, op, gstart)


# (block shape, k, VMEM budget or None, two-level)
LOCAL_SWEEPS = {
    "jacobi5_k2_one_level": (lambda: stencils.jacobi5((128, 128)), (64, 128), 2, None, False),
    "jacobi5_k4_one_level": (lambda: stencils.jacobi5((128, 128)), (64, 128), 4, None, False),
    "adv4_k2_two_level": (lambda: stencils.advection4((512, 1024)), (256, 1024), 2, 1000, True),
    "adv4_k4_two_level": (lambda: stencils.advection4((512, 1024)), (256, 1024), 4, 1000, True),
}


@pytest.mark.parametrize("case", LOCAL_SWEEPS)
def test_local_sweeps_match_execute_sweeps_window_local(case, interpret, monkeypatch):
    build, block, k, budget_kb, two_level = LOCAL_SWEEPS[case]
    if budget_kb:
        monkeypatch.setattr(pallas_multisweep, "_VMEM_BUDGET", budget_kb * 1024)
        monkeypatch.setattr(pallas_multisweep, "_VMEM_BUDGET_WIDE", budget_kb * 1024)
    op, jop = _apply_of(build())
    jplan = pallas_multisweep.local_window_plan(jop, block, k)
    assert jplan is not None and bool(jplan.get("two_level")) == two_level
    plan = sweeps.local_sweep_plan(op, block, k)
    assert plan is not None and plan.depth == k
    gstart = (block[0], 0)
    x = _rand(block)
    ref = pallas_multisweep.execute_sweeps_window_local(jop, x, [], k, gstart, interpret=True)
    got = sweeps.sweeps_local(op, torch.from_numpy(x), [], k, gstart).numpy()
    reach = [k * max(h) for h in op.attrs["shape"].halo()]
    _compare(got, ref, reach, op, gstart, k)


def test_local_sweep_plan_refusals():
    op = stencils.the_apply(stencils.jacobi5((64, 128)))
    assert sweeps.local_sweep_plan(op, (32, 128), 1) is None
    assert sweeps.local_sweep_plan(op, (1, 128), 4) is None  # halo >= block extent
    assert sweeps.local_sweep_plan(stencils.the_apply(stencils.advection4((64, 128), periodic=True)),
                                   (32, 128), 4) is None
    assert sweeps.local_sweep_plan(stencils.the_apply(stencils.jacobi5((64, 128), "float64")),
                                   (32, 128), 4) is None


@pytest.mark.parametrize("gstart", [(0, 0), (64, 0), (128, 0)])
def test_origin_form_matches_execute_chain(gstart, interpret):
    module = stencils.composite((192, 128))
    jm = jax_verify(jax_parse(print_module(module)))
    block = (64, 128)
    jplan = pallas_chain.chain_plan(jm, "wrapped", block)
    assert jplan is not None
    plan = chain.chain_plan(module, "wrapped", block)
    assert plan is not None and plan.shape == block
    x = _rand(block, gstart[0])
    ref = pallas_chain.execute_chain(jplan, [x], [], global_start=gstart, interpret=True)
    got = chain.run_chain(plan, [torch.from_numpy(x)], [], global_start=gstart).numpy()
    _compare(got, ref, plan.reach, plan.stages[-1].op, gstart)


def test_origin_form_takes_bounded_chains_only():
    mixed = stencils.composite((64, 128), mixed=True)
    assert chain.chain_plan(mixed, "wrapped") is not None
    assert chain.chain_plan(mixed, "wrapped", (32, 128)) is None
    assert chain.chain_plan(stencils.composite((64, 128)), "wrapped", (2, 128)) is None


def test_origin_form_needs_a_block_plan_and_compiles_its_boxes_at_run_time():
    from neptune_tpu_torch.kernels import codegen

    module = stencils.composite((64, 128))
    whole = chain.chain_plan(module, "wrapped")
    block = chain.chain_plan(module, "wrapped", (64, 128))
    assert not whole.origin and block.origin and whole.shape == block.shape
    # the whole grid's stage boxes are constants; a block's are mapped at run time
    assert "nt_box_at" not in codegen.chain_source(whole)
    assert codegen.chain_source(block).count("nt_box_at(g, ") == len(block.stages)
    x = torch.from_numpy(_rand((64, 128)))
    with pytest.raises(ValueError, match="whole grid's"):
        chain.stencil_chain(whole, [x], [], global_start=(0, 0))


def test_composite_route_plans_its_chain_once(monkeypatch):
    from neptune_tpu_torch.parallel import shardmap_opdef

    cm = CompiledModule(stencils.composite((64, 128)))
    gm = GridMesh((1,), ("x",), device="cpu")
    assert plan_opdef(cm, "wrapped", gm).kind == "fused-composite"
    calls = []
    planner = chain.chain_plan
    monkeypatch.setattr(chain, "chain_plan", lambda *a: calls.append(a) or planner(*a))
    f = shardmap_opdef(cm, "wrapped", gm)
    x = torch.from_numpy(_rand((64, 128)))
    ys = [f(x) for _ in range(3)]
    assert len(calls) == 1 and calls[0][2] == (64, 128)
    assert all(torch.equal(y, ys[0]) for y in ys)
    assert torch.equal(ys[0], cm.opdef("wrapped")(x))


@pytest.mark.parametrize("backend", ["torch", "auto"])
def test_shardmap_routes_follow_a_kernels_off_module(monkeypatch, backend):
    """shardmap_opdef and shardmap_sweeps of a module compiled with backend
    "torch" (kernels off, as config.backend = "torch" compiles it) call no
    kernel form unless asked; a kernel module ("auto") calls kernel A's
    window form and kernel C's local form (their plain versions on the CPU)."""
    from neptune_tpu_torch.parallel import shardmap_opdef, shardmap_sweeps

    calls = []
    window, local = cuda_backend.apply_window, sweeps.sweeps_local

    def counted_window(*args, **kw):
        calls.append("window")
        return window(*args, **kw)

    def counted_local(*args, **kw):
        calls.append("local")
        return local(*args, **kw)

    monkeypatch.setattr(cuda_backend, "apply_window", counted_window)
    monkeypatch.setattr(sweeps, "sweeps_local", counted_local)
    cm = CompiledModule(stencils.poisson5(32), backend, "cpu")
    gm = GridMesh((1, 1), ("x", "y"), device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((32, 32), dtype=np.float32))
    y = shardmap_opdef(cm, "poisson", gm)(x)
    z = shardmap_sweeps(cm, "poisson", gm, 4)(x)
    whole = cm.opdef("poisson")
    assert torch.equal(y, whole(x))
    assert torch.equal(z, whole(whole(whole(whole(x)))))
    if backend == "torch":
        assert calls == []
        shardmap_opdef(cm, "poisson", gm, "auto")(x)  # asked for: the window form
        assert calls == ["window"]
    else:
        assert "window" in calls and "local" in calls
