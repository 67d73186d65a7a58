"""The port's CUDA kernels against their plain PyTorch versions.

The kernels have no CPU mode, so the `gpu` tests skip without a card. This
file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neptune_tpu_torch import entry, stencils  # noqa: E402
from neptune_tpu_torch.config import config  # noqa: E402
from neptune_tpu_torch.ir import F32, Bounds, NeptuneBuilder, TempType  # noqa: E402
from neptune_tpu_torch.ir import verify_and_annotate  # noqa: E402
from neptune_tpu_torch.kernels.build import Builder  # noqa: E402
from neptune_tpu_torch.lowering import chain, cuda_backend, sweeps, torch_backend  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from neptune_tpu_torch.solvers import fused  # noqa: E402
from neptune_tpu_torch.solvers.precond import extract_diagonal, safe_inv_diag  # noqa: E402

APPLIES = {
    "jacobi5_f32": lambda: stencils.jacobi5((64, 128)),
    "jacobi5_bf16": lambda: stencils.jacobi5((64, 128), "bfloat16"),
    "adv4_f32": lambda: stencils.advection4((64, 128)),
    "adv4_periodic_f32": lambda: stencils.advection4((32, 40), periodic=True),
    "heat7_f32": lambda: stencils.heat7((8, 16, 24)),
    "heat7_bf16": lambda: stencils.heat7((8, 16, 24), "bfloat16"),
    "heat7_periodic_f32": lambda: stencils.heat7((8, 16, 24), periodic=True),
    "adv4_bf16": lambda: stencils.advection4((64, 128), "bfloat16"),
    "combination_f32": lambda: stencils.combination((64, 128)),
    "two_results_f32": lambda: stencils.gradients((64, 128)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in bf16 steps between same-signed values."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int()).abs().max())


def composite(n):
    """@shifted(x) = x + 0.1 * poisson(x): a two-stage operator."""
    b = NeptuneBuilder(stencils.poisson5(n))
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
    return verify_and_annotate(b.module)


def test_wrapper_refuses_other_devices():
    op = stencils.the_apply(stencils.jacobi5((8, 8)))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        cuda_backend.try_execute_apply(op, [torch.empty((8, 8), device="meta")])


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        Builder(tmp_path).load("int x;", "probe")


@pytest.mark.gpu
@pytest.mark.parametrize("case", APPLIES)
def test_stencil_apply_matches_plain(case, cuda):
    _kernel_against_plain(case, cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["adv4_f32", "heat7_bf16", "combination_f32"])
def test_unfolded_stencil_apply_matches_plain(case, cuda, monkeypatch):
    monkeypatch.setattr(config, "fold_affine", False)
    _kernel_against_plain(case, cuda)


def _kernel_against_plain(case, cuda):
    op = stencils.the_apply(APPLIES[case]())
    tt = op.results[0].type
    dtype = torch_backend.DTYPES[tt.element]
    rng = np.random.default_rng(0)
    n_in = op.attrs["num_inputs"]
    args = [
        torch.from_numpy(rng.standard_normal(tt.bounds.shape).astype(np.float32)).to(cuda, dtype)
        for _ in range(n_in)
    ] + [torch.tensor(0.1, dtype=dtype)] * (len(op.operands) - n_in)
    before = cuda_backend.counter.count
    got = cuda_backend.try_execute_apply(op, args)
    torch.cuda.synchronize()
    assert cuda_backend.counter.count == before + 1
    ref = torch_backend.execute_apply(op, args)
    if len(op.results) == 1:
        got, ref = (got,), (ref,)
    for g, r in zip(got, ref):
        if tt.element == "float32":
            assert torch.equal(g, r)  # --fmad=false: bitwise the plain version
        else:
            assert bf16_ulps(g, r) <= 1


@pytest.mark.gpu
def test_division_is_the_ieee_quotient(cuda):
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32)
    t, c = torch.from_numpy(x).to(cuda), np.float32(12.0)
    ops = torch_backend.TorchOps(cuda)
    np.testing.assert_array_equal(ops.binop("arith.div", 12.0, t, "float32").cpu().numpy(), c / x)
    np.testing.assert_array_equal(ops.binop("arith.div", t, 12.0, "float32").cpu().numpy(), x / c)
    by_cpu_scalar = ops.binop("arith.div", t, torch.tensor(12.0), "float32")
    np.testing.assert_array_equal(by_cpu_scalar.cpu().numpy(), x / c)


# (module, opdef, Jacobi, tol, maxiter): kernel B cases, from bands of whole
# rows to 2-D tiles, with ragged last tiles, a composite halo and a torus
FUSED = {
    "poisson": (lambda: stencils.poisson5(64), "poisson", False, 1e-4, 2000),
    "poisson_jacobi": (lambda: stencils.poisson5(64), "poisson", True, 1e-4, 2000),
    "composite": (lambda: composite(64), "shifted", False, 1e-4, 2000),
    "poisson512_jacobi": (lambda: stencils.poisson5(512), "poisson", True, 1e-4, 5500),
    "heat_A256": (lambda: entry.build_step(256, "float32").module, "heat_A", False, 1e-6, 200),
    "lap_lap_256": (lambda: stencils.composite((256, 256)), "wrapped", False, 1e-5, 2000),
    "periodic": (lambda: stencils.shifted_laplacian((300, 256), periodic=True), "shifted", True,
                 1e-6, 2000),
    "uneven_509x300": (lambda: stencils.shifted_laplacian((509, 300)), "shifted", True, 1e-6, 2000),
    "narrow_16x28000": (lambda: stencils.shifted_laplacian((16, 28000)), "shifted", False, 1e-6,
                        2000),
    # not symmetric: a fixed 30 iterations, through the wrapped tiles'
    # bounded-stage reads
    "mixed_periodic_bounded": (lambda: stencils.composite((100, 70), mixed=True), "wrapped", False,
                               1e-12, 30),
    # dims that are not cut store no halo: reads off them read 0, or wrap
    # onto the tile itself; the first three are at the working-set cap
    "periodic_composite_column": (lambda: stencils.composite((449389, 1), periodic=True),
                                  "wrapped", False, 1e-6, 2000),
    "reach8_periodic_3_wide": (lambda: stencils.shifted_laplacian((149796, 3), True, reach=8),
                               "shifted", False, 1e-6, 2000),
    "reach8_17_wide": (lambda: stencils.shifted_laplacian((26434, 17), reach=8), "shifted", True,
                       1e-6, 2000),
    "mixed_rows_not_cut": (lambda: stencils.composite((4, 30000), mixed=True), "wrapped", False,
                           1e-12, 30),
}


@pytest.mark.gpu
@pytest.mark.parametrize("which", FUSED)
def test_fused_cg_matches_plain(which, cuda):
    build, name, jacobi, tol, maxiter = FUSED[which]
    module = build()
    shape = module.lookup(name).ftype.inputs[0].bounds.shape
    matvec = fused.plain_matvec(fused.matvec_plan(module, name))
    b = torch.from_numpy(np.random.default_rng(1).standard_normal(shape).astype(np.float32))
    inv = None
    if jacobi:
        inv = safe_inv_diag(extract_diagonal(matvec, torch.zeros(shape), ((1, 1), (1, 1))))
    solve = fused.fused_cg(module, name, tol=tol, maxiter=maxiter, inv_diag=inv)
    bc = b.to(cuda)
    x_p, it_p, _ = fused.fused_cg_plain(matvec, bc, tol=tol, maxiter=maxiter,
                                        inv_diag=None if inv is None else inv.to(cuda))
    before = fused.counter.count
    x_k, it_k, rn_k = solve(bc)
    torch.cuda.synchronize()
    assert fused.counter.count == before + 1
    plan = solve.site(cuda).plan
    if which == "narrow_16x28000":
        assert plan.tiles[1] > 1  # the rows are cut too
    if which in ("periodic_composite_column", "reach8_periodic_3_wide", "reach8_17_wide",
                 "mixed_rows_not_cut"):
        assert 0 in plan.halo and plan.halo != plan.reach
    assert abs(int(it_k) - int(it_p)) <= 1
    bnorm = float(torch.linalg.norm(bc))
    res_k = float(torch.linalg.norm(bc - matvec(x_k)))
    res_p = float(torch.linalg.norm(bc - matvec(x_p)))
    assert res_k <= max(1.01 * tol * bnorm, 2 * res_p)
    assert float(torch.linalg.norm(x_k - x_p) / torch.linalg.norm(x_p)) <= 1e-4


@pytest.mark.gpu
def test_step_on_gpu_matches_cpu(cuda):
    u = torch.from_numpy(entry.gaussian(64))
    ref = entry.build_step(64, "float32").function("step")(u)
    before = fused.counter.count
    got = entry.build_step(64, "float32", device=cuda).function("step")(u)
    assert got.device.type == "cuda" and fused.counter.count == before + 1
    assert float((got.cpu() - ref).abs().max() / ref.abs().max()) <= 1e-5


@pytest.mark.gpu
def test_step_3d_on_gpu_matches_cpu(cuda):
    u = torch.from_numpy(np.random.default_rng(2).standard_normal((16, 16, 16)).astype(np.float32))
    ref = entry.build_step_3d(16, "float32").function("step3d")(u)
    before = cuda_backend.counter.count
    got = entry.build_step_3d(16, "float32", device=cuda).function("step3d")(u)
    assert cuda_backend.counter.count > before
    assert float((got.cpu() - ref).abs().max() / ref.abs().max()) <= 1e-5


# (module, opdef, k, scalars): kernel C cases, with grids that leave partial
# tiles and, for the torus, tiles larger than the grid
SWEEPS = {
    "jacobi5_k16": (lambda: stencils.jacobi5((100, 70)), "jacobi", 16, ()),
    "adv4_k16": (lambda: stencils.advection4((96, 136)), "adv4", 16, ()),
    "adv4_periodic_k5": (lambda: stencils.advection4((32, 40), periodic=True), "adv4", 5, ()),
    "heat7_k8": (lambda: stencils.heat7((20, 18, 40)), "heat", 8, ()),
    "heat7_periodic_k4": (lambda: stencils.heat7((12, 10, 24), periodic=True), "heat", 4, ()),
    "relax_k8": (lambda: stencils.damped_jacobi((64, 128)), "relax", 8, (0.8,)),
    "graded_k8": (lambda: stencils.graded((100, 70), lb=(3, -5)), "graded", 8, ()),
    "graded_periodic_k5": (
        lambda: stencils.graded((36, 44), lb=(3, -5), periodic=True), "graded", 5, ()
    ),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", SWEEPS)
def test_stencil_sweeps_matches_plain_and_kernel_a(case, cuda):
    build, name, k, scalars = SWEEPS[case]
    module = build()
    plan = sweeps.sweep_plan(module, name, k)
    shape = plan.op.results[0].type.bounds.shape
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(np.float32)).to(cuda)
    before = sweeps.counter.count
    got = sweeps.run_sweeps(plan, x, scalars)
    torch.cuda.synchronize()
    assert sweeps.counter.count == before + 1
    assert torch.equal(got, sweeps.sweeps_plain(plan, x, scalars))
    sv = [torch.tensor(s, dtype=torch.float32) for s in scalars]
    ref = x
    for _ in range(plan.depth):
        ref = cuda_backend.try_execute_apply(plan.op, [ref] + sv)
    assert torch.equal(got, ref)  # --fmad=false: bitwise depth launches of kernel A
    # the executor's route: k // depth launches, the rest single applies
    cm = CompiledModule(module)
    before = sweeps.counter.count, cuda_backend.counter.count
    y = cm.sweeps(name, k)(x, *scalars)
    torch.cuda.synchronize()
    assert sweeps.counter.count - before[0] == k // plan.depth
    assert cuda_backend.counter.count - before[1] == k % plan.depth
    z = x
    for _ in range(k):
        z = cm.opdef(name)(z, *scalars)
    assert torch.equal(y, z)


@pytest.mark.gpu
def test_stencil_sweeps_one_launch_at_full_depth(cuda):
    module = stencils.heat7((16, 16, 40))
    plan = sweeps.sweep_plan(module, "heat", 8, depth=8)
    assert plan.depth == 8
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((16, 16, 40)).astype(np.float32)).to(cuda)
    assert torch.equal(sweeps.run_sweeps(plan, x, ()), sweeps.sweeps_plain(plan, x, ()))


# (module, opdef, field count, scalars): kernel D cases
CHAINS = {
    "composite": (lambda: stencils.composite((64, 128)), "wrapped", 1, ()),
    "composite_ragged": (lambda: stencils.composite((70, 45)), "wrapped", 1, ()),
    "mixed": (lambda: stencils.composite((40, 72), mixed=True), "wrapped", 1, ()),
    "coupled": (lambda: stencils.coupled((64, 100)), "couple", 2, (0.7, -1.3)),
    "composite_3d": (lambda: stencils.composite((12, 20, 40)), "wrapped", 1, ()),
    "mixed_3d": (lambda: stencils.composite((10, 12, 36), mixed=True), "wrapped", 1, ()),
    "graded_mixed": (lambda: stencils.graded_chain((40, 72), lb=(3, -5)), "wrapped", 1, ()),
    # kernel D's instances: interior tiles (unchecked, 16-byte loads), rows
    # that are not whole vectors (4-byte loads), a torus, ragged tiles
    "composite_interior_tiles": (lambda: stencils.composite((200, 264)), "wrapped", 1, ()),
    "composite_unaligned_ragged": (lambda: stencils.composite((130, 201)), "wrapped", 1, ()),
    "all_periodic_torus": (lambda: stencils.composite((70, 90), periodic=True), "wrapped", 1, ()),
    "coupled_interior_tiles": (lambda: stencils.coupled((150, 200)), "couple", 2, (0.7, -1.3)),
    "composite_3d_interior": (lambda: stencils.composite((20, 40, 72)), "wrapped", 1, ()),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", CHAINS)
def test_stencil_chain_matches_per_stage(case, cuda):
    build, name, n_fields, scalars = CHAINS[case]
    module = build()
    plan = chain.chain_plan(module, name)
    rng = np.random.default_rng(5)
    fields = [
        torch.from_numpy(rng.standard_normal(plan.outer.shape).astype(np.float32)).to(cuda)
        for _ in range(n_fields)
    ]
    sv = [torch.tensor(s, dtype=torch.float32) for s in scalars]
    cm = CompiledModule(module)
    before = chain.counter.count, cuda_backend.counter.count
    got = cm.opdef(name)(*fields, *scalars)
    torch.cuda.synchronize()
    assert chain.counter.count - before[0] == 1
    assert cuda_backend.counter.count == before[1]
    assert torch.equal(got, chain.chain_plain(plan, fields, sv))
    # stage at a time through kernel A
    before = cuda_backend.counter.count
    per_stage = cm._make_callable(module.lookup(name))(*fields, *scalars)
    assert cuda_backend.counter.count - before == len(plan.stages)
    assert torch.equal(got, per_stage)


# kernel D under candidate schedules (as scripts/torch_tile_times.py times
# them): one tile per block, and a persistent grid one or two tiles ahead
SCHEDULES = {
    "64x64_512_ahead1": ((64, 64), 512, 1, 1, 12),
    "64x64_512": ((64, 64), 512, 0, 1, 12),
    "32x64_256_ahead1_min3": ((32, 64), 256, 1, 3, 8),
    "32x64_128_ahead2": ((32, 64), 128, 2, 1, 8),
    "32x32_256": ((32, 32), 256, 0, 1, 12),
    "8x16x32_512_ahead1": ((8, 16, 32), 512, 1, 1, 12),
    "8x16x32_256_min2": ((8, 16, 32), 256, 0, 2, 8),
    "4x16x32_256_ahead2": ((4, 16, 32), 256, 2, 1, 8),
}


@pytest.mark.gpu
@pytest.mark.parametrize("sched", SCHEDULES)
@pytest.mark.parametrize("case", ["composite", "mixed", "coupled", "unaligned"])
def test_stencil_chain_schedules(case, sched, cuda):
    tile = SCHEDULES[sched][0]
    rank = len(tile)
    build, name, n_fields, scalars = {
        "composite": (lambda: stencils.composite((150, 200) if rank == 2 else (20, 40, 72)),
                      "wrapped", 1, ()),
        "mixed": (lambda: stencils.composite((150, 200) if rank == 2 else (20, 40, 72),
                                             mixed=True), "wrapped", 1, ()),
        "coupled": (lambda: stencils.coupled((150, 200)), "couple", 2, (0.7, -1.3)),
        "unaligned": (lambda: stencils.composite((133, 205) if rank == 2 else (19, 37, 70)),
                      "wrapped", 1, ()),
    }[case]
    module = build()
    if len(module.lookup(name).ftype.inputs[0].bounds.shape) != rank:
        pytest.skip("a rank-2 operator")
    plan = chain.chain_plan(module, name, tiles=(chain.ChainTile(*SCHEDULES[sched]),))
    rng = np.random.default_rng(7)
    fields = [torch.from_numpy(rng.standard_normal(plan.shape).astype(np.float32)).to(cuda)
              for _ in range(n_fields)]
    sv = [torch.tensor(s, dtype=torch.float32) for s in scalars]
    before = chain.counter.count
    got = chain.run_chain(plan, fields, sv)
    torch.cuda.synchronize()
    assert chain.counter.count == before + 1
    assert torch.equal(got, chain.chain_plain(plan, fields, sv))
    assert chain.blocks_per_sm(plan) >= 1


@pytest.mark.gpu
def test_stencil_chain_launcher_is_built_once(cuda):
    """The launcher keeps its argument buffers: a second call refills them;
    a field that is not contiguous f32 is made so."""
    module = stencils.coupled((64, 100))
    plan = chain.chain_plan(module, "couple")
    rng = np.random.default_rng(8)
    u, v = (torch.from_numpy(rng.standard_normal((64, 100)).astype(np.float32)).to(cuda)
            for _ in range(2))
    sv = [torch.tensor(0.7), torch.tensor(-1.3)]
    first = chain.run_chain(plan, [u, v], sv)
    launcher = chain._launcher(plan)
    ptrs = launcher.in_ptrs
    second = chain.run_chain(plan, [u.double(), v.t().contiguous().t()], sv)
    torch.cuda.synchronize()
    assert chain._launcher(plan) is launcher and launcher.in_ptrs is ptrs
    assert torch.equal(first, second)
    assert torch.equal(first, chain.chain_plain(plan, [u, v], sv))


@pytest.mark.gpu
def test_dsl_sweeps_and_composite_on_gpu(cuda):
    import neptune_tpu_torch as ntt

    ntt.reset_context()
    try:
        n = 96

        @ntt.linear_op_def(bounds=([0, 0], [n, n]), interior=([1, 1], [n - 1, n - 1]), dtype="float32")
        def lap(u):
            return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

        x = torch.from_numpy(np.random.default_rng(6).standard_normal((n, n)).astype(np.float32)).to(cuda)
        before = sweeps.counter.count
        y = ntt.sweeps(lap, 8)(x)
        assert sweeps.counter.count == before + 1
        ref = x
        for _ in range(8):
            ref = lap(ref)
        assert torch.equal(y, ref) and y.device.type == "cuda"
    finally:
        ntt.reset_context()


# ---------------------------------------------------------------------------
# the shard-local forms: one block of a larger grid, at a global start that
# is not 0, against each form's plain version over the whole block
# ---------------------------------------------------------------------------

# (module, block, global start)
WINDOWS = {
    "jacobi5": (lambda: stencils.jacobi5((200, 90)), (50, 90), (100, 0)),
    "jacobi5_bf16": (lambda: stencils.jacobi5((200, 90), "bfloat16"), (50, 45), (150, 45)),
    "adv4": (lambda: stencils.advection4((128, 136)), (32, 68), (64, 68)),
    "heat7": (lambda: stencils.heat7((24, 20, 40)), (12, 10, 40), (12, 10, 0)),
    "graded_index": (lambda: stencils.graded((100, 70), lb=(3, -5)), (25, 35), (53, 30)),
    "two_results": (lambda: stencils.gradients((64, 128)), (16, 64), (48, 64)),
    "periodic_adv4": (lambda: stencils.advection4((64, 80), periodic=True), (32, 40), (32, 40)),
}


def _block(shape, dtype, cuda, seed=7):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(cuda, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("case", WINDOWS)
def test_window_form_matches_plain(case, cuda):
    build, block, gstart = WINDOWS[case]
    op = stencils.the_apply(build())
    dtype = torch_backend.DTYPES[op.results[0].type.element]
    x = _block(block, dtype, cuda)
    before = cuda_backend.window_counter.count
    got = cuda_backend.apply_window(op, [x], [], gstart)
    torch.cuda.synchronize()
    assert cuda_backend.window_counter.count == before + 1
    ref = torch_backend.execute_apply_window(op, [x], [], gstart)
    if len(op.results) == 1:
        got, ref = (got,), (ref,)
    for g, r in zip(got, ref):
        if dtype == torch.float32:
            assert torch.equal(g, r)
        else:
            assert bf16_ulps(g, r) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 5])
def test_local_sweeps_match_plain(k, cuda):
    op = stencils.the_apply(stencils.advection4((256, 200)))
    block, gstart = (64, 100), (128, 100)
    plan = sweeps.local_sweep_plan(op, block, k)
    x = _block(block, torch.float32, cuda)
    before = sweeps.local_counter.count, cuda_backend.window_counter.count
    got = sweeps.sweeps_local(op, x, [], k, gstart)
    torch.cuda.synchronize()
    assert sweeps.local_counter.count - before[0] == k // plan.depth
    assert cuda_backend.window_counter.count - before[1] == k % plan.depth
    ref = x
    for _ in range(k):
        ref = torch_backend.execute_apply_window(op, [ref], [], gstart)
    assert torch.equal(got, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["composite", "coupled", "composite_interior", "bounds_inside"])
def test_origin_form_matches_plain(case, cuda):
    module, name, n_fields, scalars, block, gstart = {
        "composite": (stencils.composite((96, 128)), "wrapped", 1, (), (32, 50), (32, 50)),
        "coupled": (stencils.coupled((96, 100)), "couple", 2, (0.7, -1.3), (32, 50), (32, 50)),
        # a block with interior tiles, at a global start that is not 0
        "composite_interior": (stencils.composite((400, 600)), "wrapped", 1, (), (200, 264),
                               (136, 200)),
        # the bounds end inside the block: some tiles straddle them, some
        # lie beyond them and run as copies
        "bounds_inside": (stencils.coupled((250, 300)), "couple", 2, (0.7, -1.3), (200, 400),
                          (120, 100)),
    }[case]
    plan = chain.chain_plan(module, name, block)
    fields = [_block(block, torch.float32, cuda, seed) for seed in range(n_fields)]
    sv = [torch.tensor(s, dtype=torch.float32) for s in scalars]
    before = chain.origin_counter.count
    got = chain.run_chain(plan, fields, sv, global_start=gstart)
    torch.cuda.synchronize()
    assert chain.origin_counter.count == before + 1
    assert torch.equal(got, chain.chain_plain(plan, fields, sv, global_start=gstart))


@pytest.mark.gpu
def test_sharded_routes_on_one_position(cuda):
    from neptune_tpu_torch.parallel import GridMesh, shardmap_opdef, shardmap_sweeps

    gm = GridMesh((1, 1), ("x", "y"))
    x = _block((96, 128), torch.float32, cuda)
    for module, name in ((stencils.jacobi5((96, 128)), "jacobi"), (stencils.composite((96, 128)), "wrapped")):
        cm = CompiledModule(module)
        got = shardmap_opdef(cm, name, gm)(x)
        assert torch.equal(got, shardmap_opdef(cm, name, gm, backend="torch")(x))
        assert torch.equal(got, cm.opdef(name)(x))
    cm = CompiledModule(stencils.jacobi5((96, 128)))
    before = sweeps.local_counter.count
    got = shardmap_sweeps(cm, "jacobi", gm, 8)(x)
    assert sweeps.local_counter.count > before
    assert torch.equal(got, cm.sweeps("jacobi", 8)(x))


# ---------------------------------------------------------------------------
# the tiled kernel A and kernel C's register strips on grids that hold
# interior, edge and ragged tiles, under the default plans and under small
# tiles (so that small grids have interior tiles too)
# ---------------------------------------------------------------------------

SMALL_A = {2: ((8, 32, 4, 1),), 3: ((4, 32, 2, 3),)}

# (module, tiles or None for the default plan, global start or None)
TILED = {
    "jacobi5_interior": (lambda: stencils.jacobi5((200, 600)), None, None),
    "jacobi5_bf16_ragged": (lambda: stencils.jacobi5((197, 555), "bfloat16"), None, None),
    "adv4_small_tiles": (lambda: stencils.advection4((50, 130)), SMALL_A, None),
    "adv4_periodic_torus": (lambda: stencils.advection4((130, 300), periodic=True), None, None),
    "one_cell_wide_torus": (lambda: stencils.advection4((1, 300), periodic=True), None, None),
    "one_cell_tall_torus": (lambda: stencils.advection4((300, 1), periodic=True), SMALL_A, None),
    "heat7_march": (lambda: stencils.heat7((70, 40, 300)), None, None),
    "heat7_bf16_march": (lambda: stencils.heat7((70, 40, 300), "bfloat16"), None, None),
    "heat7_periodic_march": (lambda: stencils.heat7((40, 20, 140), periodic=True), None, None),
    "heat7_dims_under_a_tile": (lambda: stencils.heat7((3, 5, 7)), None, None),
    "heat7_small_tiles": (lambda: stencils.heat7((11, 14, 70)), SMALL_A, None),
    "two_inputs_and_a_scalar": (lambda: stencils.combination((100, 300)), SMALL_A, None),
    "two_results": (lambda: stencils.gradients((100, 300)), None, None),
    "graded_index": (lambda: stencils.graded((100, 300), lb=(3, -5)), SMALL_A, None),
    "window_at_a_global_start": (lambda: stencils.jacobi5((400, 1200)), None, (200, 512)),
    "window_rank3": (lambda: stencils.heat7((80, 40, 300)), None, (40, 0, 0)),
    # the bounds end inside the block, away from its edges
    "window_bounds_inside_the_block": (lambda: stencils.jacobi5((80, 200)), SMALL_A, (50, 110)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", TILED)
@pytest.mark.parametrize("aligned", [True, False])
def test_tiled_stencil_apply_matches_plain(case, aligned, cuda):
    build, tiles, gstart = TILED[case]
    op = stencils.the_apply(build())
    rank = op.results[0].type.bounds.rank
    plan = cuda_backend.apply_plan(op, tiles and tiles[rank])
    dtype = torch_backend.DTYPES[op.results[0].type.element]
    n_in = op.attrs["num_inputs"]
    shape = op.results[0].type.bounds.shape
    if gstart is not None:
        shape = tuple(s // 2 for s in shape)
    xs = []
    for seed in range(n_in):
        x = _block(shape, dtype, cuda, seed)
        if not aligned:  # contiguous, one element off 16-byte alignment
            buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
            buf[1:] = x.reshape(-1)
            x = buf[1:].view(shape)
        xs.append(x)
    sv = [torch.tensor(0.1, dtype=dtype)] * (len(op.operands) - n_in)
    before = cuda_backend.counter.count, cuda_backend.window_counter.count
    got = cuda_backend.stencil_apply(op, xs, sv, xs[0].device, gstart, plan=plan)
    torch.cuda.synchronize()
    assert (cuda_backend.counter.count - before[0], cuda_backend.window_counter.count - before[1]) \
        == ((1, 0) if gstart is None else (0, 1))
    if gstart is None:
        ref = torch_backend.execute_apply(op, xs + sv)
    else:
        ref = torch_backend.execute_apply_window(op, xs, sv, gstart)
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    for g, r in zip(got, ref):
        if dtype == torch.float32:
            assert torch.equal(g, r)
        else:
            assert bf16_ulps(g, r) <= 1


# (module, opdef, k, scalars): kernel C on grids with interior tiles
STRIPS = {
    "jacobi5_k16": (lambda: stencils.jacobi5((300, 500)), "jacobi", 16, ()),
    "adv4_k8": (lambda: stencils.advection4((260, 400)), "adv4", 8, ()),
    "adv4_periodic_k16": (lambda: stencils.advection4((130, 300), periodic=True), "adv4", 16, ()),
    "heat7_k4": (lambda: stencils.heat7((40, 30, 200)), "heat", 4, ()),
    "heat7_periodic_k3": (lambda: stencils.heat7((20, 24, 70), periodic=True), "heat", 3, ()),
    "relax_k16": (lambda: stencils.damped_jacobi((300, 500)), "relax", 16, (0.8,)),
    "graded_k5": (lambda: stencils.graded((200, 300), lb=(3, -5)), "graded", 5, ()),
    "narrow_k4": (lambda: stencils.jacobi5((500, 2)), "jacobi", 4, ()),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", STRIPS)
def test_stencil_sweeps_strips_match_kernel_a(case, cuda):
    build, name, k, scalars = STRIPS[case]
    module = build()
    sv = [torch.tensor(s, dtype=torch.float32) for s in scalars]
    for depth in sorted({2, k}):
        plan = sweeps.sweep_plan(module, name, k, depth=depth)
        x = _block(plan.op.results[0].type.bounds.shape, torch.float32, cuda, 3)
        before = sweeps.counter.count
        got = sweeps.run_sweeps(plan, x, scalars)
        torch.cuda.synchronize()
        assert sweeps.counter.count == before + 1
        ref = x
        for _ in range(plan.depth):
            ref = cuda_backend.try_execute_apply(plan.op, [ref] + sv)
        assert torch.equal(got, ref)  # --fmad=false: bitwise depth launches of kernel A
        assert torch.equal(got, sweeps.sweeps_plain(plan, x, scalars))


@pytest.mark.gpu
def test_local_sweeps_with_interior_tiles(cuda):
    op = stencils.the_apply(stencils.jacobi5((1024, 1024)))
    block, gstart = (512, 512), (512, 0)
    plan = sweeps.local_sweep_plan(op, block, 8)
    x = _block(block, torch.float32, cuda)
    got = sweeps.run_sweeps(plan, x, [], gstart)
    assert torch.equal(got, sweeps.sweeps_plain(plan, x, [], gstart))


# ---------------------------------------------------------------------------
# the default device: NumPy inputs go to the card; without one, the call
# raises and says how to ask for the CPU
# ---------------------------------------------------------------------------


def _numpy_entry_points(device=None):
    """(compiled opdef, eager DSL directive, interop) results of NumPy input."""
    import neptune_tpu_torch as ntt
    from neptune_tpu_torch.interop import arrays_from_numpy

    x = np.random.default_rng(8).standard_normal((16, 24)).astype(np.float32)
    y = CompiledModule(stencils.jacobi5((16, 24)), device=device).opdef("jacobi")(x)
    ntt.reset_context()
    try:
        total = ntt.reduce(ntt.temp(x), "sum") if device is None else None
    finally:
        ntt.reset_context()
    (z,) = arrays_from_numpy([x], device)
    return y, total, z


@pytest.mark.gpu
def test_numpy_inputs_land_on_the_card(cuda, monkeypatch):
    monkeypatch.setattr(config, "device", "cuda")
    y, total, z = _numpy_entry_points()
    assert y.device.type == total.device.type == z.device.type == "cuda"


def test_no_cuda_raises_and_names_the_cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu".*NEPTUNE_TORCH_DEVICE=cpu'):
        _numpy_entry_points()
    with pytest.raises(RuntimeError, match="NEPTUNE_TORCH_DEVICE=cpu"):
        entry.entry()
    y, _, z = _numpy_entry_points("cpu")
    assert y.device.type == z.device.type == "cpu"
    monkeypatch.setattr(config, "device", "cpu")
    y, total, z = _numpy_entry_points()
    assert y.device.type == total.device.type == z.device.type == "cpu"
    fn, (u0,) = entry.entry("cpu")
    assert u0.device.type == "cpu"


def test_tensors_stay_on_their_device(monkeypatch):
    monkeypatch.setattr(config, "device", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = torch.zeros((16, 24))
    assert CompiledModule(stencils.jacobi5((16, 24))).opdef("jacobi")(x).device.type == "cpu"


# ---------------------------------------------------------------------------
# the solver surface on the card: the derivative rule of kernel-routed
# opdefs, Newton, mixed-precision refinement, the direct solve
# ---------------------------------------------------------------------------

RULES = {
    "apply": (lambda: stencils.advection4((64, 128)), "adv4", cuda_backend.counter),
    "chain": (lambda: stencils.composite((64, 128)), "wrapped", chain.counter),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", RULES)
def test_rule_on_the_card(case, cuda):
    """The tangent and cotangent of a kernel-routed opdef on the card equal
    those of the eager view, and its primal is the kernel's."""
    build, name, counter = RULES[case]
    cm = CompiledModule(build())
    f, view = cm.opdef(name), cm.opdef(name, differentiable=True)
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, v = (torch.randn(64, 128, device=cuda, generator=gen) for _ in range(2))
    before = counter.count
    out, tan = torch.func.jvp(f, (x,), (v,))
    assert counter.count == before + 1
    ref_out, ref_tan = torch.func.jvp(view, (x,), (v,))
    # a nonzero tangent: the rule was taken (a torch release that hides the
    # transform from `_differentiating` would give none from the kernel)
    assert torch.equal(out, ref_out) and torch.equal(tan, ref_tan) and bool(tan.abs().max() > 0)
    xr = x.clone().requires_grad_(True)
    (cot,) = torch.autograd.grad(f(xr), xr, v)
    (ref_cot,) = torch.autograd.grad(view(xr), xr, v)
    assert torch.equal(cot, ref_cot) and bool(cot.abs().max() > 0)


def allen_cahn_step(n: int, dt=0.05, k=5.0):
    """An implicit Allen–Cahn step at n^2 f32 through the DSL: the residual
    (5-pt Laplacian plus u - u^3; F = u - u_prev on the boundary) and the
    compiled step. Returns (step, compiled module)."""
    import neptune_tpu_torch as ntt

    ntt.reset_context()

    @ntt.nonlinear_op_def(bounds=([0, 0], [n, n]), dtype="float32", name="ac_res")
    def ac_res(u, up):
        i, j = ntt.index(0), ntt.index(1)
        boundary = (i == 0) | (i == n - 1) | (j == 0) | (j == n - 1)
        lap = u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1] - 4.0 * u[0, 0]
        interior = u[0, 0] - up[0, 0] - dt * (k * lap + u[0, 0] - u[0, 0] * u[0, 0] * u[0, 0])
        return ntt.where(boundary, u[0, 0] - up[0, 0], interior)

    @ntt.jit_class
    class AC:
        def __init__(self):
            self.n = n

        def step(self, u):
            return ntt.time_advance(u, dt, "implicit_nonlinear", residual=ac_res, tol=1e-5,
                                    max_iters=20, options={"atol": 1e-4})

    return AC(), ntt


@pytest.mark.gpu
def test_newton_on_the_kernel_route(cuda, monkeypatch):
    """Newton with the residual on kernel A takes the iterations of the same
    solve with the kernels off, and gives the same state."""
    from neptune_tpu_torch.lowering import executor

    infos = []
    real = executor.newton_krylov

    def recording(*a, **k):
        x, info = real(*a, **k)
        infos.append(info)
        return x, info

    monkeypatch.setattr(executor, "newton_krylov", recording)
    ac, ntt = allen_cahn_step(128)
    gen = torch.Generator(device=cuda).manual_seed(1)
    u = 0.9 * torch.tanh(4 * torch.randn(128, 128, device=cuda, generator=gen))
    before = cuda_backend.counter.count
    got = ac.step(u)
    assert cuda_backend.counter.count > before
    cm = ntt.get_context().compiled()
    off = CompiledModule(cm.module, "torch").function("AC_step")(u)
    (on, off_info) = infos
    assert on.converged and (on.iters, on.krylov_iters) == (off_info.iters, off_info.krylov_iters)
    assert torch.equal(got, off)


@pytest.mark.gpu
def test_mixed_refinement_on_the_card(cuda):
    """precision="mixed": the f32 twin's applies launch kernel A; the rounds
    equal those with the kernels off, the inner iterations within 1 per
    round, and the f64 result meets its tolerance."""
    from neptune_tpu_torch.solvers.refine import refined_solve

    cm = CompiledModule(stencils.poisson5(128, "float64"))
    off = CompiledModule(cm.module, "torch")
    gen = torch.Generator(device=cuda).manual_seed(2)
    b = torch.randn(128, 128, device=cuda, dtype=torch.float64, generator=gen)
    infos = []
    for c in (cm, off):
        before = cuda_backend.counter.count
        hi, lo = c.opdef("poisson"), c.low_precision_opdef("poisson")
        x, info = refined_solve(hi, lo, b, tol=1e-10, inner_tol=1e-4, inner_iters=3000)
        launched = cuda_backend.counter.count - before
        assert info.converged and bool(torch.linalg.vector_norm(b - hi(x))
                                       <= 1e-10 * torch.linalg.vector_norm(b))
        infos.append((info, launched))
    (on, n_on), (plain, n_off) = infos
    assert n_on >= on.inner_iters and n_off == 0
    assert on.rounds == plain.rounds and abs(on.inner_iters - plain.inner_iters) <= on.rounds


@pytest.mark.gpu
def test_dense_launches_kernel_a_per_column(cuda, monkeypatch):
    """dense() with no device assembles on the card (the default device)
    through kernel A, one launch per column, equal to the eager view's."""
    from neptune_tpu_torch.solvers.assemble import MatrixHandle

    monkeypatch.setattr(config, "device", "cuda")
    cm = CompiledModule(stencils.poisson5(24))
    fn = cm.module.lookup("poisson")
    H = MatrixHandle("poisson", cm.opdef("poisson"), fn.ftype.inputs[0])
    before = cuda_backend.counter.count
    A = H.dense()
    assert A.device.type == "cuda" and cuda_backend.counter.count == before + 24 * 24
    assert H.dense(cuda) is A and cuda_backend.counter.count == before + 24 * 24
    view = cm.opdef("poisson", differentiable=True)
    eye = torch.eye(24 * 24, device=cuda)
    assert torch.equal(A, torch.func.vmap(lambda e: view(e.reshape(24, 24)).reshape(-1))(eye).T)


@pytest.mark.gpu
def test_direct_is_full_precision_on_the_card(cuda):
    """solver="direct" in f32 with TF32 asked for by the caller: the solve
    still runs at full f32 precision, and leaves the caller's setting."""
    from neptune_tpu_torch.solvers import krylov
    from neptune_tpu_torch.solvers.assemble import MatrixHandle

    cm = CompiledModule(stencils.poisson5(24))
    fn = cm.module.lookup("poisson")
    H = MatrixHandle("poisson", cm.opdef("poisson"), fn.ftype.inputs[0],
                     halo=fn.attrs.get("halo", ()))
    gen = torch.Generator(device=cuda).manual_seed(3)
    b = torch.randn(24, 24, device=cuda, generator=gen)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        A = H.dense(cuda)
        x, _ = krylov.direct(A, b)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    A64, b64 = A.double().cpu(), b.double().cpu().reshape(-1)
    rel = torch.linalg.vector_norm(A64 @ x.double().cpu().reshape(-1) - b64) / torch.linalg.vector_norm(b64)
    assert float(rel) <= 1e-5


def _launches_by_shape(monkeypatch) -> dict:
    """Kernel-A launches by output shape, as `stencil_apply` makes them."""
    shapes: dict = {}
    real = cuda_backend.stencil_apply

    def counting(op, *a, **k):
        out = real(op, *a, **k)
        shape = op.results[0].type.bounds.shape
        shapes[shape] = shapes.get(shape, 0) + 1
        return out

    monkeypatch.setattr(cuda_backend, "stencil_apply", counting)
    return shapes


def _recorded_solves(monkeypatch) -> list:
    """The SolveInfo of every `krylov.solve` the executor makes."""
    from neptune_tpu_torch.solvers import krylov

    infos = []
    real = krylov.solve

    def recording(*a, **k):
        x, info = real(*a, **k)
        infos.append(info)
        return x, info

    monkeypatch.setattr(krylov, "solve", recording)
    return infos


MG_SYSTEMS = {
    "poisson5_256_jacobi": (lambda: stencils.poisson5(256), {}),
    "poisson5_256_cheb": (lambda: stencils.poisson5(256), {"mg_smoother": "cheb"}),
    "poisson7_64": (lambda: stencils.poisson7(64), {}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", MG_SYSTEMS)
def test_precond_mg_on_the_kernel_route(case, cuda, monkeypatch):
    """precond="mg" through the executor in f32: every level's matvec
    launches kernel A; the iterations equal those with the kernels off and
    the solutions are bitwise equal; the true residual meets tol."""
    build, options = MG_SYSTEMS[case]
    module = stencils.with_solve(build(), "poisson", tol=1e-4, max_iters=200, precond="mg",
                                 options=options or None)
    shape = module.lookup("poisson").ftype.inputs[0].bounds.shape
    gen = torch.Generator(device=cuda).manual_seed(4)
    b = torch.randn(shape, device=cuda, generator=gen)
    shapes = _launches_by_shape(monkeypatch)
    infos = _recorded_solves(monkeypatch)
    x = CompiledModule(module, "auto", cuda).function("solve")(b)
    on_shapes = dict(shapes)
    x_off = CompiledModule(module, "torch", cuda).function("solve")(b)
    assert shapes == on_shapes  # the kernels-off route launched nothing
    levels = [tuple(s >> k for s in shape) for k in range(len(on_shapes))]
    assert sorted(on_shapes) == sorted(levels) and min(levels)[0] >= 16, on_shapes
    (on, off) = infos
    assert on.converged and on.iters == off.iters and torch.equal(x, x_off)
    A = CompiledModule(module, "torch", cuda).opdef("poisson")
    assert float(torch.linalg.vector_norm(b - A(x))) <= 1e-4 * float(torch.linalg.vector_norm(b))


@pytest.mark.gpu
def test_mg_preconditioner_reads_nothing_on_the_host(cuda):
    """One cycle of precond="mg"'s M: no host synchronisation (so that a
    CUDA graph could capture it whole), and kernel A on every level."""
    from neptune_tpu_torch.lowering import executor

    cm = CompiledModule(stencils.poisson5(256), "auto", cuda)
    M = executor.auto_mg_preconditioner(cm.module, cm._handle_for("poisson"), "auto",
                                        mg_smoother="cheb", device=cuda)
    r = torch.randn(256, 256, device=cuda, generator=torch.Generator(device=cuda).manual_seed(5))
    M(r)
    torch.cuda.synchronize()
    before = cuda_backend.counter.count
    torch.cuda.set_sync_debug_mode("error")
    try:
        y = M(r)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cuda_backend.counter.count - before > 0 and bool(torch.isfinite(y).all())


@pytest.mark.gpu
def test_chebyshev_on_the_kernel_route(cuda, monkeypatch):
    """solver="chebyshev" (Jacobi, check_every=10) through the executor in
    f32: iterations and solution equal to the kernels-off route's."""
    module = stencils.with_solve(
        stencils.poisson5(256), "poisson", solver="chebyshev", tol=1e-4, max_iters=4000,
        precond="jacobi", options={"lam_min": 1e-4, "lam_max": 2.0, "check_every": 10})
    b = torch.randn(256, 256, device=cuda, generator=torch.Generator(device=cuda).manual_seed(6))
    infos = _recorded_solves(monkeypatch)
    before = cuda_backend.counter.count
    x = CompiledModule(module, "auto", cuda).function("solve")(b)
    assert cuda_backend.counter.count - before > infos[0].iters
    x_off = CompiledModule(module, "torch", cuda).function("solve")(b)
    (on, off) = infos
    assert on.converged and on.iters == off.iters and (on.iters - 1) % 10 == 0
    assert torch.equal(x, x_off)


def _ca_system():
    """bench.py's CA system: the 256^2 f32 5-pt Poisson operator with a
    Dirichlet ring, the rhs from default_rng(0) on the interior, and its
    spectral bounds."""
    n = 256
    b = np.zeros((n, n), np.float32)
    b[1:-1, 1:-1] = np.random.default_rng(0).standard_normal((n - 2, n - 2))
    return stencils.poisson5(n), b, 2.0 * (2.0 - 2.0 * np.cos(np.pi / (n + 1))), 8.0


def _ca_solve(case, cm, gm, lmin, lmax):
    from neptune_tpu_torch import parallel as par

    lam = dict(lam_min=lmin, lam_max=lmax)
    return {
        "cg": lambda: par.cg_sharded(cm, "poisson", gm, s=8, basis="chebyshev", maxiter=2000,
                                     tol=1e-4, **lam),
        "gmres": lambda: par.gmres_sharded(cm, "poisson", gm, s=8, basis="chebyshev",
                                           maxiter=2000, tol=1e-4, **lam),
        "bicgstab": lambda: par.bicgstab_sharded(cm, "poisson", gm, s=2, maxiter=2000, tol=1e-4),
        "chebyshev": lambda: par.chebyshev_sharded(cm, "poisson", gm, k_fuse=8, maxiter=3200,
                                                   tol=1e-4, **lam),
    }[case]()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cg", "gmres", "bicgstab", "chebyshev"])
def test_ca_solver_on_the_kernel_route(case, cuda):
    """A CA solver on a one-process mesh on the card: every chain's core
    matvec launches kernel A's window form; the kernels-off module takes the
    same iterations to a bitwise-equal x and launches nothing."""
    from neptune_tpu_torch.parallel import single_device_mesh

    module, b, lmin, lmax = _ca_system()
    gm = single_device_mesh(cuda)
    before = cuda_backend.window_counter.count
    x, info = _ca_solve(case, CompiledModule(module, "auto", cuda), gm, lmin, lmax)(b)
    launched = cuda_backend.window_counter.count - before
    x_off, info_off = _ca_solve(case, CompiledModule(module, "torch", cuda), gm, lmin, lmax)(b)
    assert cuda_backend.window_counter.count - before == launched > 0
    assert x.is_cuda and info.iters == info_off.iters and torch.equal(x, x_off)
    assert bool(torch.isfinite(x).all())


@pytest.mark.gpu
def test_ca_coefficients_ignore_tf32(cuda):
    """The Gram matrices and recombinations stay f32-exact when the caller
    allows TF32: the solve is bitwise the one with TF32 off, and the
    caller's setting is back afterwards."""
    from neptune_tpu_torch.parallel import single_device_mesh

    module, b, lmin, lmax = _ca_system()
    gm = single_device_mesh(cuda)
    cm = CompiledModule(module, "auto", cuda)
    x_ref, info_ref = _ca_solve("gmres", cm, gm, lmin, lmax)(b)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x, info = _ca_solve("gmres", cm, gm, lmin, lmax)(b)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert info.iters == info_ref.iters and torch.equal(x, x_ref)


@pytest.mark.gpu
def test_sharded_function_heat_step_on_the_kernel_route(cuda):
    """sharded_function of the 2-D heat step on a one-process mesh: its
    applies launch kernel A's window form, and the kernels-off module gives
    a bitwise-equal step; the whole-grid function (kernel B's CG) agrees to
    the solve's tol."""
    from neptune_tpu_torch.parallel import sharded_function, single_device_mesh

    cm = entry.build_step(256, "float32", device=cuda)
    gm = single_device_mesh(cuda)
    u = torch.from_numpy(entry.gaussian(256)).to(cuda)
    before = cuda_backend.window_counter.count
    y = sharded_function(cm, "step", gm)(u)
    assert cuda_backend.window_counter.count - before > 0
    y_off = sharded_function(CompiledModule(cm.module, "torch", cuda), "step", gm)(u)
    assert torch.equal(y, y_off)
    ref = cm.function("step")(u)
    assert float(torch.linalg.vector_norm(y - ref) / torch.linalg.vector_norm(ref)) <= 1e-5


@pytest.mark.gpu
def test_ca_smoother_on_the_kernel_route(cuda):
    """The CA multigrid smoother on a one-process mesh on the card: its core
    matvecs launch kernel A's window form, and the kernels-off module gives
    bitwise-equal (x', r') from zero and from a live guess."""
    from neptune_tpu_torch.parallel import build_ca_levels, ca_smoother, single_device_mesh

    module, b, _, _ = _ca_system()
    gm = single_device_mesh(cuda)
    bs = torch.from_numpy(b).to(cuda)
    x1 = torch.randn(bs.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    outs = []
    for backend in ("auto", "torch"):
        cm = CompiledModule(module, backend, cuda)
        (lvl,) = build_ca_levels(cm, ["poisson"], gm, torch.zeros_like(bs), k=3)
        sm, sm0 = ca_smoother(cm, "poisson", gm, k=3, lam_min=lvl.cheb_lmax / 4,
                              lam_max=lvl.cheb_lmax, inv_diag=lvl.inv_diag)
        before = cuda_backend.window_counter.count
        outs.append((sm0(bs), sm(bs, x1)))
        launched = cuda_backend.window_counter.count - before
        assert launched == (7 if backend == "auto" else 0), launched
    for got, ref in zip(outs[0], outs[1]):
        assert all(torch.equal(g, r) for g, r in zip(got, ref))
        assert got[0].is_cuda and bool(torch.isfinite(got[0]).all())


@pytest.mark.gpu
def test_sharded_rule_on_the_card(cuda):
    """The derivative rule of shardmap_opdef on the card: a nonlinear
    residual's tangent on a one-process mesh equals the eager view's,
    bitwise, and its primal is the window form's."""
    from neptune_tpu_torch.lowering.executor import rule_counter
    from neptune_tpu_torch.parallel import shardmap_opdef, single_device_mesh

    _, ntt = allen_cahn_step(64)
    cm = ntt.get_context().compiled()
    f = shardmap_opdef(CompiledModule(cm.module, "auto", cuda), "ac_res", single_device_mesh(cuda))
    view = CompiledModule(cm.module, "torch", cuda).opdef("ac_res")
    gen = torch.Generator(device=cuda).manual_seed(0)
    x, up, v = (torch.randn(64, 64, device=cuda, generator=gen) for _ in range(3))
    before = (rule_counter.count, cuda_backend.window_counter.count)
    out, tan = torch.func.jvp(lambda a: f(a, up), (x,), (v,))
    assert rule_counter.count == before[0] + 1 and cuda_backend.window_counter.count > before[1]
    ref_out, ref_tan = torch.func.jvp(lambda a: view(a, up), (x,), (v,))
    assert torch.equal(out, ref_out) and torch.equal(tan, ref_tan) and bool(tan.abs().max() > 0)


def _mesh_routes(module, fname, x, cuda):
    """fname through sharded_function on a one-process mesh, on the kernel
    route and the kernels-off route: (kernel result, kernels-off result,
    window-form launches of the kernel route)."""
    from neptune_tpu_torch.parallel import sharded_function, single_device_mesh

    gm = single_device_mesh(cuda)
    outs = []
    for route in ("auto", "torch"):
        before = cuda_backend.window_counter.count
        outs.append(sharded_function(CompiledModule(module, route, cuda), fname, gm)(x))
        if route == "auto":
            launched = cuda_backend.window_counter.count - before
    return outs[0], outs[1], launched


@pytest.mark.gpu
def test_sharded_ssor_on_the_card(cuda):
    """CG + precond="ssor" through sharded_function on a one-process mesh:
    the kernel route equals the kernels-off route bitwise, with kernel A's
    window form in both SSOR sweeps and the matvec."""
    module = stencils.with_solve(stencils.poisson5(128), "poisson", solver="cg", tol=1e-4,
                                 max_iters=500, precond="ssor")
    b = torch.randn(128, 128, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    got, ref, launched = _mesh_routes(module, "solve", b, cuda)
    assert launched > 0 and got.is_cuda and torch.equal(got, ref)
    assert float(torch.linalg.vector_norm(b - CompiledModule(module, "torch", cuda).opdef(
        "poisson")(got)) / torch.linalg.vector_norm(b)) <= 1.01e-4


@pytest.mark.gpu
@pytest.mark.parametrize("program", ["no_input", "far", "far_periodic"])
def test_sharded_apply_shapes_on_the_card(program, cuda):
    """An apply with no field input (kernel A's window form at the block's
    start) and an apply whose reach exceeds a block (on the extended block;
    the window form where the op is bounded) through sharded_function on a
    one-process mesh: bitwise the kernels-off route's and the whole grid's."""
    import torch_ca_cases as cases

    module = {
        "no_input": lambda: cases.no_input_program(dtype="float32"),
        "far": lambda: cases.far_program(dtype="float32"),
        "far_periodic": lambda: cases.far_program(periodic=True, dtype="float32"),
    }[program]()
    fname = module.funcs()[0].name
    x = torch.randn(32, 32, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    got, ref, launched = _mesh_routes(module, fname, x, cuda)
    assert torch.equal(got, ref) and (launched > 0) == (program != "far_periodic")
    assert torch.equal(got, CompiledModule(module, "torch", cuda).function(fname)(x))


@pytest.mark.gpu
def test_sharded_reverse_rule_on_the_card(cuda):
    """The reverse-mode rule of shardmap_opdef on the card: the gradient of
    a loss through a nonlinear residual on a one-process mesh is the
    kernels-off route's, bitwise; the primal ran kernel A's window form."""
    from neptune_tpu_torch.lowering.executor import rule_counter
    from neptune_tpu_torch.parallel import shardmap_opdef, single_device_mesh

    _, ntt = allen_cahn_step(64)
    cm = ntt.get_context().compiled()
    gm = single_device_mesh(cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    x, up, w = (torch.randn(64, 64, device=cuda, generator=gen) for _ in range(3))
    grads = []
    for route in ("auto", "torch"):
        f = shardmap_opdef(CompiledModule(cm.module, route, cuda), "ac_res", gm)
        xg, upg = x.clone().requires_grad_(True), up.clone().requires_grad_(True)
        before = (rule_counter.count, cuda_backend.window_counter.count)
        (w * f(xg, upg)).sum().backward()
        if route == "auto":
            assert rule_counter.count == before[0] + 1
            assert cuda_backend.window_counter.count > before[1]
        grads.append((xg.grad, upg.grad))
    assert all(torch.equal(g, r) for g, r in zip(*grads))
    assert bool(grads[0][0].abs().max() > 0)


def _mixed_levels(route, device, whole_from, sizes=(256, 128, 64, 32)):
    """The rediscretized f32 Poisson hierarchy on a one-process mesh:
    sharded levels (kernel A's window form) above `whole_from`, whole-grid
    opdefs (kernel A) from it on."""
    from neptune_tpu_torch.lowering.executor import _CoarseOp
    from neptune_tpu_torch.parallel import shardmap_opdef, single_device_mesh
    from neptune_tpu_torch.solvers import multigrid

    gm = single_device_mesh(device)
    ops = []
    for lvl, n in enumerate(sizes):
        cm = CompiledModule(stencils.poisson5(n), route, device)
        sharded = lvl < whole_from
        mv = shardmap_opdef(cm, "poisson", gm, route) if sharded else cm.opdef("poisson")
        ops.append(_CoarseOp(lambda x, f=mv, s=0.25**lvl: s * f(x), ((1, 1), (1, 1)),
                             gm if sharded else None))
    like = torch.zeros(sizes[0], sizes[0], device=device)
    return gm, multigrid.build_levels(ops, like)


@pytest.mark.gpu
def test_mixed_hierarchy_on_the_card(cuda):
    """A multigrid hierarchy of sharded levels then whole-grid levels on a
    one-process mesh: one preconditioner cycle launches kernel A's window
    form on the sharded levels and kernel A on the whole-grid ones, gathers
    once, and equals the kernels-off route bitwise."""
    from neptune_tpu_torch.solvers import multigrid

    r = torch.randn(256, 256, device=cuda, generator=torch.Generator(cuda).manual_seed(9))
    out = {}
    for route in ("auto", "torch"):
        gm, levels = _mixed_levels(route, cuda, 2)
        assert [lv.mesh is None for lv in levels] == [False, False, True, True]
        M = multigrid.mg_preconditioner(None, r, smoother="cheb", levels=levels)
        gm.gathers = 0
        before = (cuda_backend.window_counter.count, cuda_backend.counter.count)
        out[route] = M(r)
        launched = (cuda_backend.window_counter.count - before[0],
                    cuda_backend.counter.count - before[1])
        assert gm.gathers == 1
        if route == "auto":
            assert launched[0] > 0 and launched[1] > 0, launched
        else:
            assert launched == (0, 0)
    assert out["auto"].is_cuda and torch.equal(out["auto"], out["torch"])


@pytest.mark.gpu
def test_driver_round_trip_on_the_card(cuda, tmp_path):
    """SimulationDriver over the implicit heat step on the card: one kernel-B
    launch per step, the state stays on the card, and a run stopped after
    its first checkpoint and resumed is bitwise the uninterrupted one."""
    from neptune_tpu_torch.utils.driver import SimulationDriver

    cm = entry.build_step(64, "float32", device=cuda)
    fn = cm.function("step")
    u0 = torch.from_numpy(entry.gaussian(64)).to(cuda)

    def step(s):
        return {"u": fn(s["u"])}

    before = fused.counter.count
    whole, n = SimulationDriver(step, tmp_path / "a.npz", 3).run({"u": u0}, 9)
    assert n == 9 and fused.counter.count - before == 9
    assert whole["u"].is_cuda
    _, stopped = SimulationDriver(step, tmp_path / "b.npz", 3).run(
        {"u": u0}, 9, walltime_budget_s=1e-9)
    assert stopped == 3
    resumed, n = SimulationDriver(step, tmp_path / "b.npz", 3).run({"u": u0}, 9)
    assert n == 9 and resumed["u"].is_cuda and torch.equal(resumed["u"], whole["u"])


@pytest.mark.gpu
def test_native_runtime_takes_card_tensors(cuda, tmp_path, monkeypatch):
    """The native runtime copies tensors on the card to host f64 and returns
    CPU f64 tensors: the 5-pt apply of a card tensor equals kernel A's
    within f32 rounding."""
    from neptune_tpu_torch.runtime import compile_native

    monkeypatch.setattr(config, "cache_dir", str(tmp_path))
    m32 = stencils.with_entry(stencils.jacobi5((64, 64)), "jacobi")
    m64 = stencils.with_entry(stencils.jacobi5((64, 64), "float64"), "jacobi")
    x = torch.randn(64, 64, device=cuda, generator=torch.Generator(cuda).manual_seed(3))
    y = compile_native(m64).function("entry")(x)
    assert y.device.type == "cpu" and y.dtype == torch.float64
    ref = CompiledModule(m32, "auto", cuda).function("entry")(x)
    assert float((y - ref.cpu().double()).abs().max()) <= 1e-6


@pytest.mark.gpu
def test_prolong_block_on_the_card(cuda):
    """On the card each block of the interpolation, taken from the whole
    coarse grid with its one-cell halo, is bitwise that block of the
    whole-grid interpolation, odd coarse blocks included: 34^2 on (2,2)
    (blocks of 17) and 450^2, phase 15a's (2,2) transition (blocks of
    225)."""
    from types import SimpleNamespace

    from neptune_tpu_torch.solvers.multigrid import prolong, prolong_block

    for n in (34, 450):
        e = torch.randn(n, n, device=cuda, generator=torch.Generator(cuda).manual_seed(n))
        ref = prolong(e, (2 * n, 2 * n))
        for i in range(2):
            for j in range(2):
                got = prolong_block(e, (n, n), SimpleNamespace(shape=(2, 2), coords=(i, j)))
                assert torch.equal(got, ref[i * n:(i + 1) * n, j * n:(j + 1) * n]), (n, i, j)


# ---- random programs and pinned arithmetic -----------------------------------

def _fuzz():
    import torch_fuzz_programs  # tests/: imports neither package

    from neptune_tpu_torch import ir

    return torch_fuzz_programs, ir


def _randn(shape, cuda, seed):
    return torch.randn(shape, device=cuda, generator=torch.Generator(cuda).manual_seed(seed))


@pytest.mark.gpu
@pytest.mark.parametrize("pinned", [False, True], ids=["default", "pinned"])
@pytest.mark.parametrize("case", range(4))
def test_random_programs_through_kernel_a(case, pinned, cuda, monkeypatch):
    """Random f32 bodies (tests/torch_fuzz_programs.py): kernel A bitwise
    equal to eager PyTorch, in default and in pinned arithmetic."""
    fp, ir = _fuzz()
    monkeypatch.setattr(config, "pinned_arithmetic", pinned)
    rank = 2 + case % 2
    shape = (256, 512) if rank == 2 else (32, 48, 64)
    n_in = 1 + case % 2
    module = fp.kernel_opdef(ir, np.random.default_rng(9000 + case), shape,
                             periodic=case % 3 == 1, h0=case % 3, n_in=n_in)
    op = stencils.the_apply(module)
    xs = [_randn(shape, cuda, 10 * case + k) for k in range(n_in)]
    before = cuda_backend.counter.count
    got = cuda_backend.try_execute_apply(op, xs)
    assert cuda_backend.counter.count - before == 1
    assert fp.same_bits(got, torch_backend.execute_apply(op, xs))


@pytest.mark.gpu
@pytest.mark.parametrize("pinned", [False, True], ids=["default", "pinned"])
@pytest.mark.parametrize("case", range(3))
def test_random_programs_through_kernel_c(case, pinned, cuda, monkeypatch):
    fp, ir = _fuzz()
    monkeypatch.setattr(config, "pinned_arithmetic", pinned)
    rng = np.random.default_rng(9100 + case)
    shape = (256, 512) if case % 2 == 0 else (32, 48, 64)
    module = fp.kernel_opdef(ir, rng, shape, periodic=case == 1, h0=1 + case % 2, bounded=True)
    k = int(rng.integers(2, 10))
    plan = sweeps.sweep_plan(module, "kf", k) or sweeps.sweep_plan(module, "kf", k, depth=2)
    x = _randn(shape, cuda, case)
    before = sweeps.counter.count
    got = sweeps.run_sweeps(plan, x, [])
    assert sweeps.counter.count - before == 1
    assert fp.same_bits(got, sweeps.sweeps_plain(plan, x, []))


@pytest.mark.gpu
@pytest.mark.parametrize("pinned", [False, True], ids=["default", "pinned"])
@pytest.mark.parametrize("case", range(3))
def test_random_programs_through_kernel_d(case, pinned, cuda, monkeypatch):
    fp, ir = _fuzz()
    monkeypatch.setattr(config, "pinned_arithmetic", pinned)
    shape = (256, 512) if case % 2 == 0 else (32, 48, 64)
    module = fp.chain_opdef(ir, np.random.default_rng(9200 + case), shape, n_in=1 + case // 2)
    plan = chain.chain_plan(module, "kd")
    fields = [_randn(shape, cuda, 10 * case + k) for k in range(plan.n_fields)]
    before = chain.counter.count
    got = chain.run_chain(plan, fields, [])
    assert chain.counter.count - before == 1
    assert fp.same_bits(got, chain.chain_plain(plan, fields, []))


@pytest.mark.gpu
def test_pinned_cg_kernel_route_equals_kernels_off(cuda, monkeypatch):
    """Pinned whole-grid CG (f32 5-pt Poisson): kernel A's fenced body and
    the eager route take the same iterations to the same bits."""
    from neptune_tpu_torch.solvers import krylov

    monkeypatch.setattr(config, "pinned_arithmetic", True)
    module = stencils.poisson5(256)
    b = _randn((256, 256), cuda, 7)
    runs = {}
    for route in ("auto", "torch"):
        before = cuda_backend.counter.count
        x, info = krylov.cg(CompiledModule(module, route, cuda).opdef("poisson"), b, tol=1e-5,
                            maxiter=2000)
        runs[route] = (x, info.iters, cuda_backend.counter.count - before)
    assert runs["auto"][1] == runs["torch"][1] and torch.equal(runs["auto"][0], runs["torch"][0])
    assert runs["auto"][2] == runs["auto"][1] + 1 and runs["torch"][2] == 0


# ---- the port's spans on the card -------------------------------------------


def _profiled_kernels(fn, tmp_path, part: str):
    """fn() under torch.profiler (CPU and CUDA): the kernels in the trace
    whose name holds `part`."""
    import json

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "kernel" and part in e.get("name", "")]


def _poisson_solve(cuda):
    module = stencils.with_solve(stencils.poisson5(64), "poisson", solver="cg", tol=1e-4,
                                 max_iters=500, precond="jacobi")
    b = torch.zeros((64, 64), device=cuda)
    b[1:-1, 1:-1] = _randn((62, 62), cuda, 1)
    return CompiledModule(module).function("solve"), b


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["stencil_apply", "fused_cg"])
def test_launch_spans_equal_counters_and_kernels(which, cuda, tmp_path):
    from neptune_tpu_torch.utils import profiling

    if which == "stencil_apply":
        op = CompiledModule(stencils.jacobi5((96, 128))).opdef("jacobi")
        x = torch.rand((96, 128), device=cuda)
        counter, part, n = cuda_backend.counter, "nt_apply", 7

        def run():
            for _ in range(n):
                op(x)
    else:
        solve, b = _poisson_solve(cuda)
        counter, part, n = fused.counter, "nt_fused_cg", 3

        def run():
            for _ in range(n):
                solve(b)

    run()  # built and warmed outside the profile
    torch.cuda.synchronize()
    profiling.clear()
    before = counter.count
    kernels = _profiled_kernels(run, tmp_path, part)
    spans = [s for s in profiling.spans() if s["name"] == f"nt.launch.{which}"]
    assert len(spans) == counter.count - before == len(kernels) == n
    profiling.clear()


@pytest.mark.gpu
def test_fused_iters_attribute_is_the_kernels_scalar(cuda, tmp_path, monkeypatch):
    from neptune_tpu_torch.utils import profiling

    wrote = []
    site_solve = fused._Site.solve

    def spy(self, b, tol, maxiter):
        out = site_solve(self, b, tol, maxiter)
        wrote.append(out[1])
        return out

    monkeypatch.setattr(fused._Site, "solve", spy)
    solve, b = _poisson_solve(cuda)
    solve(b)
    torch.cuda.synchronize()
    wrote.clear()
    profiling.clear()
    _profiled_kernels(lambda: solve(b), tmp_path, "nt_fused_cg")
    (s,) = [s for s in profiling.spans() if s["name"] == "nt.solve"]
    assert s["attrs"]["route"] == "fused" and s["attrs"]["iters"] == int(wrote[0].item()) > 0
    profiling.clear()
