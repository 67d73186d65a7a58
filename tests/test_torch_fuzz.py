"""Differential fuzzing of the port against the JAX package and itself.

The programs come from `torch_fuzz_programs` (the generators of
`tests/test_fuzz.py`, taking either package's IR namespace), so one seed
builds the same program in both packages:

  * the port's eager route against the JAX package's jnp route: the 25
    random rank 1-3 f64 opdefs (seeds 1000 + case) at 1e-9, and the 6
    periodic ones (3000 + case) at 1e-10;
  * the port's `runtime.compile_native` against its eager route, the same
    programs, at the same tolerances;
  * K eager sweeps (`CompiledModule.sweeps`) against a loop of single
    applies, bitwise, and against the JAX package's `cm.sweeps` through its
    Pallas interpreter at 1e-5 (seeds 4000 + case), as test_fuzz.py holds
    the JAX kernel to its loop;
  * random f32 programs through the CPU schedule emulations of the port's
    kernels, bitwise against eager PyTorch: kernel A (`emulate_apply`; rank 2
    and 3, bounded and periodic, dim-0 reach 0-2, one or two inputs, whole
    grid and window form), kernel C (`emulate_sweeps`; bounded bodies, 2-9
    sweeps) and kernel D (`emulate_chain`; two-stage chains), each in
    default and in pinned arithmetic, and test_fuzz.py's two-level programs
    (seeds 5000 + case) through kernel C.

The JAX side of the f64 programs is one module and one `jax.jit` (each
program's own would cost a second of compilation); the port's native side
is one library.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import neptune_tpu.ir as jax_ir  # noqa: E402
import neptune_tpu_torch.ir as torch_ir  # noqa: E402
import torch_fuzz_programs as fp  # noqa: E402
from neptune_tpu.config import config  # noqa: E402
from neptune_tpu.lowering import pallas_multisweep  # noqa: E402
from neptune_tpu.passes import compile_ir as jax_compile  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.lowering import chain, cuda_backend, sweeps, torch_backend  # noqa: E402
from neptune_tpu_torch.passes import compile_ir  # noqa: E402
from neptune_tpu_torch.runtime import compile_native  # noqa: E402
from test_torch_chain_tiles import emulate_chain  # noqa: E402
from test_torch_tiles import emulate_apply, emulate_sweeps  # noqa: E402

N_RANDOM, N_PERIODIC, N_SWEEPS, N_TWO_LEVEL = 25, 6, 8, 8
N_KERNEL = 16  # random f32 programs per kernel emulation

# small schedules, so that small grids have interior, edge and ragged tiles
TILES_A = {2: ((8, 32, 4, 1),), 3: ((4, 32, 2, 3),)}
TILES_D = {2: (chain.ChainTile((8, 16), 64, 1),), 3: (chain.ChainTile((4, 8, 16), 64, 1),)}


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    monkeypatch.setattr(torch_config, "device", "cpu")
    monkeypatch.setattr(torch_config, "pinned_arithmetic", False)


def _build_f64(ir):
    """The random and periodic programs of both test_fuzz.py generators in
    one module: ({case: (name, inputs)}, {case: (name, input)}, module)."""
    module, rand, per = None, {}, {}
    for case in range(N_RANDOM):
        rng = np.random.default_rng(1000 + case)
        module, name, shape, n_in = fp.random_opdef(ir, rng, case, module=module)
        rand[case] = (name, [rng.standard_normal(shape) for _ in range(n_in)])
    for case in range(N_PERIODIC):
        rng = np.random.default_rng(3000 + case)
        module, shape = fp.periodic_opdef(ir, rng, f"p_{case}", module=module)
        per[case] = (f"p_{case}", [rng.standard_normal(shape)])
    return rand, per, module


@pytest.fixture(scope="module")
def f64_runs():
    """Every f64 program through the JAX jnp route, the port's eager route
    and the port's native runtime: {route: {name: array}}."""
    rand, per, jm = _build_f64(jax_ir)
    programs = list(rand.values()) + list(per.values())
    jcm = jax_compile(jm, backend="jnp")
    outs = jax.jit(lambda xs: [jcm.opdef(n)(*a) for (n, _), a in zip(programs, xs)])(
        [a for _, a in programs])
    runs = {"jax": {n: np.asarray(y) for (n, _), y in zip(programs, outs)}}

    *_, tm = _build_f64(torch_ir)
    cm = compile_ir(tm, backend="torch", device="cpu")
    runs["eager"] = {n: cm.opdef(n)(*a).numpy() for n, a in programs}
    for n, _ in programs:
        fp.with_main(torch_ir, tm, n, f"main_{n}")
    nm = compile_native(tm)
    runs["native"] = {n: nm.function(f"main_{n}")(*a).numpy() for n, a in programs}
    return runs


@pytest.mark.parametrize("case", range(N_RANDOM))
def test_eager_vs_jax_random_programs(f64_runs, case):
    name = f"fuzz_{case}"
    np.testing.assert_allclose(f64_runs["eager"][name], f64_runs["jax"][name], atol=1e-9,
                               err_msg=f"case {case}: the port's eager route vs jnp")


@pytest.mark.parametrize("case", range(N_RANDOM))
def test_native_vs_eager_random_programs(f64_runs, case):
    name = f"fuzz_{case}"
    np.testing.assert_allclose(f64_runs["native"][name], f64_runs["eager"][name], atol=1e-9,
                               err_msg=f"case {case}: native vs the port's eager route")


@pytest.mark.parametrize("case", range(N_PERIODIC))
def test_periodic_programs(f64_runs, case):
    """Wrap semantics: eager against jnp and native against eager."""
    name = f"p_{case}"
    np.testing.assert_allclose(f64_runs["eager"][name], f64_runs["jax"][name], atol=1e-10)
    np.testing.assert_allclose(f64_runs["native"][name], f64_runs["eager"][name], atol=1e-10)


@pytest.mark.parametrize("case", range(N_SWEEPS))
def test_sweeps_vs_loop_and_jax(case):
    """K eager sweeps equal K single applies bit for bit, and the JAX
    package's fused sweeps (its Pallas interpreter) within 1e-5."""
    rng = np.random.default_rng(4000 + case)
    jm, shape, k, h = fp.multisweep_opdef(jax_ir, rng)
    x = rng.standard_normal(shape).astype(np.float32)
    tm, *_ = fp.multisweep_opdef(torch_ir, np.random.default_rng(4000 + case))
    cm = compile_ir(tm, device="cpu")
    y = cm.sweeps("ms", k)(torch.from_numpy(x))
    one, ref = cm.opdef("ms"), torch.from_numpy(x)
    for _ in range(k):
        ref = one(ref)
    assert torch.equal(y, ref), f"case {case}: {k} sweeps != {k} applies"

    jcm = jax_compile(jm, backend="auto")
    assert pallas_multisweep.best_depth(jcm.module, "ms", k) is not None
    config.pallas_interpret = True
    try:
        yj = np.asarray(jcm.sweeps("ms", k)(x))
    finally:
        config.pallas_interpret = False
    np.testing.assert_allclose(y.numpy(), yj, atol=1e-5,
                               err_msg=f"case {case}: k={k} sweeps vs the JAX kernel (h={h})")


def _arith(monkeypatch, pinned: bool):
    monkeypatch.setattr(torch_config, "pinned_arithmetic", pinned)


def _data(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("case", range(N_TWO_LEVEL))
def test_two_level_programs_through_kernel_c(case):
    """test_fuzz.py's wide programs (its two-level window's) through kernel
    C's emulated strips at the plan's depth: bitwise the same sweeps as
    single eager applies."""
    rng = np.random.default_rng(5000 + case)
    module, shape, k, h, _ = fp.two_level_opdef(torch_ir, rng)
    plan = sweeps.sweep_plan(module, "tl", k)
    assert plan is not None
    x = _data(rng, shape)
    got = emulate_sweeps(plan, x, [])
    ref = x
    for _ in range(plan.depth):
        ref = torch_backend.execute_apply(plan.op, [ref])
    assert fp.same_bits(got, ref)


def _kernel_case(case: int):
    """(rank, periodic, h0, inputs, tanh, window) of kernel-A case `case`."""
    rank = 2 + case % 2
    return rank, case % 4 >= 2, case % 3, 1 + (case // 4) % 2, case % 5 == 4, case % 8 == 1


@pytest.mark.parametrize("pinned", [False, True], ids=["default", "pinned"])
@pytest.mark.parametrize("case", range(N_KERNEL))
def test_kernel_a_random_programs(monkeypatch, case, pinned):
    _arith(monkeypatch, pinned)
    rank, periodic, h0, n_in, tanh, window = _kernel_case(case)
    rng = np.random.default_rng(6000 + case)
    shape = (40, 100) if rank == 2 else (9, 12, 70)
    module = fp.kernel_opdef(torch_ir, rng, shape, periodic=periodic and not window, h0=h0,
                             n_in=n_in, tanh=tanh)
    op = stencils.the_apply(module)
    plan = cuda_backend.apply_plan(op, TILES_A[rank])
    assert plan is not None
    if window:  # the window form: a block at a global start
        block = tuple(n // 2 for n in shape)
        start = tuple(n // 4 for n in shape)
        xs = [_data(rng, block) for _ in range(n_in)]
        got = emulate_apply(op, xs, [], plan, start)
        ref = torch_backend.execute_apply_window(op, xs, [], start)
    else:
        xs = [_data(rng, shape) for _ in range(n_in)]
        got = emulate_apply(op, xs, [], plan)
        ref = torch_backend.execute_apply(op, xs)
    assert fp.same_bits(got, ref), f"case {case}: kernel A's schedule != eager"


@pytest.mark.parametrize("pinned", [False, True], ids=["default", "pinned"])
@pytest.mark.parametrize("case", range(N_KERNEL // 2))
def test_kernel_c_random_programs(monkeypatch, case, pinned):
    _arith(monkeypatch, pinned)
    rng = np.random.default_rng(7000 + case)
    rank = 2 + case % 2
    shape = (60, 130) if rank == 2 else (12, 20, 70)
    module = fp.kernel_opdef(torch_ir, rng, shape, periodic=case % 4 == 2, h0=1 + case % 2,
                             tanh=case % 3 == 0, bounded=True)
    k = int(rng.integers(2, 10))
    # the executor's depth for k sweeps, or (where the recompute of a wide
    # rank-3 reach rules every depth out) two sweeps per launch
    plan = sweeps.sweep_plan(module, "kf", k) or sweeps.sweep_plan(module, "kf", k, depth=2)
    assert plan is not None, f"case {case}: kernel C takes no plan"
    x = _data(rng, shape)
    got = emulate_sweeps(plan, x, [])
    ref = x
    for _ in range(plan.depth):
        ref = torch_backend.execute_apply(plan.op, [ref])
    assert bool(torch.isfinite(ref).all())
    assert fp.same_bits(got, ref), f"case {case}: kernel C's {plan.depth} sweeps != eager applies"


@pytest.mark.parametrize("pinned", [False, True], ids=["default", "pinned"])
@pytest.mark.parametrize("case", range(N_KERNEL // 2))
def test_kernel_d_random_programs(monkeypatch, case, pinned):
    _arith(monkeypatch, pinned)
    rng = np.random.default_rng(8000 + case)
    rank = 2 + case % 2
    shape = (41, 100) if rank == 2 else (11, 14, 40)
    n_in = 1 + case % 2
    module = fp.chain_opdef(torch_ir, rng, shape, n_in=n_in, tanh=case % 3 == 0)
    plan = chain.chain_plan(module, "kd", None, TILES_D[rank])
    assert plan is not None, f"case {case}: kernel D takes no plan"
    fields = [_data(rng, shape) for _ in range(n_in)]
    got, _ = emulate_chain(plan, fields, [])
    per_stage = compile_ir(module, backend="torch", device="cpu").opdef("kd")(*fields)
    assert fp.same_bits(got, per_stage), f"case {case}: kernel D's schedule != the stages one at a time"
    assert fp.same_bits(chain.chain_plain(plan, fields, []), per_stage)
