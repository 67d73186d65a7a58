"""Kernel C's route and plain version against the JAX package's K-sweep
TPU kernels (`pallas_multisweep`), run in interpret mode.

The operator is built once (`neptune_tpu_torch.stencils`), printed, and
parsed by the JAX package. The port's `CompiledModule.sweeps` runs kernel
C's plain version on the CPU; the JAX side runs `cm.sweeps` with
`config.pallas_interpret`, and each case checks which TPU kernel it reached:
the VMEM-resident grid (#6, `execute_sweeps_resident`), the one-level window
(#7, `_sweeps_window_impl`) or the two-level window (#8,
`_sweeps_window2_impl`). The window kernels are reached at small sizes by
shrinking the JAX package's VMEM budgets inside the test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import neptune_tpu_torch as ntt  # noqa: E402
from neptune_tpu.config import config  # noqa: E402
from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.lowering import pallas_multisweep  # noqa: E402
from neptune_tpu.lowering.executor import CompiledModule as JaxCompiledModule  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.lowering import sweeps  # noqa: E402
from neptune_tpu_torch.lowering.executor import CompiledModule  # noqa: E402
from test_torch_apply import TOL  # noqa: E402


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port puts NumPy inputs on `config.device`, the card by default:
    these CPU tests ask for the CPU."""
    monkeypatch.setattr(torch_config, "device", "cpu")


# name -> (module, opdef, k, scalars, TPU kernel the JAX side reaches)
CASES = {
    "jacobi5_resident": (lambda: stencils.jacobi5((64, 128)), "jacobi", 8, (), "resident"),
    "jacobi5_window": (lambda: stencils.jacobi5((64, 128)), "jacobi", 4, (), "window"),
    "heat7_window_3d": (lambda: stencils.heat7((32, 16, 128)), "heat", 4, (), "window"),
    "adv4_periodic_window": (
        lambda: stencils.advection4((64, 128), periodic=True), "adv4", 4, (), "window"
    ),
    "relax_scalar_window": (lambda: stencils.damped_jacobi((64, 128)), "relax", 4, (0.8,), "window"),
    "adv4_two_level": (lambda: stencils.advection4((256, 1024)), "adv4", 8, (), "two_level"),
    # index() bodies on a grid whose logical origin is not 0
    "graded_periodic_resident": (
        lambda: stencils.graded((64, 128), lb=(3, -5), periodic=True), "graded", 8, (), "resident"
    ),
    "graded_window": (lambda: stencils.graded((64, 128), lb=(3, -5)), "graded", 4, (), "window"),
}


@pytest.fixture
def jax_interpret(monkeypatch):
    monkeypatch.setattr(config, "pallas_interpret", True)


def _route(jm, name, k, kernel, monkeypatch):
    """Shrink the JAX package's budgets so that `kernel` takes the case,
    and check that it does."""
    if kernel != "resident":
        monkeypatch.setattr(pallas_multisweep, "_RESIDENT_BYTES", 0)
    if kernel == "two_level":
        monkeypatch.setattr(pallas_multisweep, "_VMEM_BUDGET", 1900 * 1024)
        monkeypatch.setattr(pallas_multisweep, "_VMEM_BUDGET_WIDE", 1900 * 1024)
    kin = pallas_multisweep.best_depth(jm, name, k)
    assert kin == k
    if kernel == "resident":
        assert pallas_multisweep.resident_plan(jm, name, kin) is not None
    else:
        plan = pallas_multisweep.sweeps_plan(jm, name, kin)
        assert bool(plan.get("two_level")) == (kernel == "two_level"), plan


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_multisweep(case, jax_interpret, monkeypatch):
    build, name, k, scalars, kernel = CASES[case]
    module = build()
    jm = jax_verify(jax_parse(print_module(module)))
    _route(jm, name, k, kernel, monkeypatch)
    assert sweeps.sweep_plan(module, name, k) is not None
    shape = module.lookup(name).ftype.inputs[0].bounds.shape
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = np.asarray(JaxCompiledModule(jm, "auto").sweeps(name, k)(x, *map(np.float32, scalars)))
    got = CompiledModule(module).sweeps(name, k)(x, *scalars).numpy()
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= k * TOL["float32"] * np.abs(ref).max(), err


def test_leftover_sweeps_run_as_single_applies():
    module = stencils.advection4((64, 128))
    plan = sweeps.sweep_plan(module, "adv4", 17)
    assert 17 % plan.depth  # 17 = depth + leftover single applies
    cm = CompiledModule(module)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 128)).astype(np.float32))
    ref = x
    for _ in range(17):
        ref = cm.opdef("adv4")(ref)
    assert torch.equal(cm.sweeps("adv4", 17)(x), ref)


# (module, opdef, k, forced depth) -> (depth, tile, columns per lane, rows per
# strip, left halo, shared-memory bytes: two f32 buffers of the padded tile
# rows and its halo, and the int table of wrapped cells)
PLANS = [
    (lambda: stencils.jacobi5((4096, 4096)), "jacobi", 16, None, (16, (64, 96), 4, 8, 16, 103316)),
    (lambda: stencils.advection4((8192, 8192)), "adv4", 16, None, (8, (64, 96), 4, 8, 16, 103316)),
    (lambda: stencils.heat7((256, 256, 256)), "heat", 8, None,
     (2, (16, 16, 24), 1, 4, 4, 112936)),
    (lambda: stencils.heat7((256, 256, 256)), "heat", 8, 4, (4, (8, 16, 24), 1, 4, 4, 106792)),
    (lambda: stencils.advection4((8192, 8192)), "adv4", 16, 4, (4, (64, 112), 4, 8, 8, 86868)),
]


@pytest.mark.parametrize("i", range(len(PLANS)))
def test_planner_arithmetic(i):
    build, name, k, depth, want = PLANS[i]
    plan = sweeps.sweep_plan(build(), name, k, depth=depth)
    assert (plan.depth, plan.tile, plan.cols, plan.strip, plan.pad, plan.smem_bytes) == want
    assert plan.smem_bytes <= sweeps.SMEM_PAIR
    if depth is None:
        assert plan.recompute <= sweeps.MAX_RECOMPUTE
    spec = (plan.cols, *((1,) * (3 - len(plan.tile)) + plan.tile)[:2], plan.strip, plan.run)
    geo = sweeps.strip_geometry(plan.halo, spec, plan.depth)
    assert (geo["smem"], geo["recompute"], geo["rows"]) == (
        plan.smem_bytes, plan.recompute, plan.rows)
    # the tile row, halo included, is one warp's columns, the left halo
    # whole 16-byte vectors, and interior tiles start on a vector
    t2 = plan.tile[-1]
    assert plan.pad % 4 == 0 and t2 % 4 == 0
    assert plan.pad + t2 + plan.depth * plan.halo[-1] <= 32 * plan.cols


def test_refused_operators():
    assert sweeps.sweep_plan(stencils.jacobi5((64, 128)), "jacobi", 1) is None
    assert sweeps.find_sweep_apply(stencils.jacobi5((64, 128), "float64"), "jacobi") is None
    assert sweeps.find_sweep_apply(stencils.composite((64, 128)), "wrapped") is None
    assert sweeps.find_sweep_apply(stencils.combination((64, 128)), "combine") is None


def test_non_unary_operator_raises():
    cm = CompiledModule(stencils.combination((16, 16)))
    with pytest.raises(ValueError, match="unary"):
        cm.sweeps("combine", 4)


def test_sweeps_while_tracing_raises():
    ntt.reset_context()
    try:
        @ntt.linear_op_def(bounds=([0, 0], [16, 16]), interior=([1, 1], [15, 15]), dtype="float32")
        def jac(u):
            return 0.25 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1])

        @ntt.jit_class
        class Smoother:
            def run(self, u):
                return ntt.sweeps(jac, 4)(u)

        with pytest.raises(RuntimeError, match="sweeps"):
            Smoother().run(np.ones((16, 16), np.float32))
        assert "Smoother_run" not in ntt.get_context().module.functions
        x = np.random.default_rng(2).standard_normal((16, 16)).astype(np.float32)
        ref = torch.from_numpy(x)
        for _ in range(4):
            ref = jac(ref)
        assert torch.equal(ntt.sweeps(jac, 4)(x), ref)
    finally:
        ntt.reset_context()


def test_generated_source():
    plan = sweeps.sweep_plan(stencils.heat7((32, 16, 128)), "heat", 4)
    src = sweeps.source(plan)
    assert src.startswith('#include "nt_sweeps.cuh"')
    assert src.rstrip().endswith("NT_DEFINE_SWEEPS(NtSweepPlan)")
    assert "static constexpr int kT0 = 16, kT1 = 16, kT2 = 24, kP2 = 4;" in src
    assert "static constexpr int kC = 1, kR = 4, kL = 8;" in src
    assert "kDepth = 2;" in src
