"""Kernel A's plain version against the JAX package's Pallas apply kernels.

The same operator is built once (`neptune_tpu_torch.stencils`), printed, and
parsed by the JAX package; the JAX side runs its Pallas kernels in interpret
mode, routed as on a TPU. Only the cells the apply contract defines are
compared: inside the apply bounds (every read in the domain, or wrapped on
a torus) within the dtype's tolerance, and the copy-through cells outside
the bounds bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neptune_tpu.config import config  # noqa: E402
from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.lowering import jnp_backend, pallas_backend  # noqa: E402
from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.kernels import codegen  # noqa: E402
from neptune_tpu_torch.lowering import cuda_backend, torch_backend  # noqa: E402

# relative to max|ref|: a few f32 ulps (XLA may contract a multiply-add the
# port rounds twice), two bf16 ulps, and f64 round-off
TOL = {"float32": 4 * 2.0**-23, "bfloat16": 2 * 2.0**-7, "float64": 1e-12}

# name -> (builder, the JAX kernel the case reaches: pallas_backend._execute
# for 5-pt at h0 = 1, _execute_dma_rank2 for the h0 = 2 advection,
# _execute_dma_rank3 for 7-pt)
CASES = {
    "jacobi5_f32": (lambda: stencils.jacobi5((64, 128)), "_execute"),
    "jacobi5_bf16": (lambda: stencils.jacobi5((64, 128), "bfloat16"), "_execute"),
    "adv4_h0_2_f32": (lambda: stencils.advection4((64, 128)), "_execute_dma_rank2"),
    "adv4_periodic_f32": (
        lambda: stencils.advection4((64, 128), periodic=True), "_execute_dma_rank2"
    ),
    "heat7_f32": (lambda: stencils.heat7((8, 16, 128)), "_execute_dma_rank3"),
    "heat7_bf16": (lambda: stencils.heat7((8, 16, 128), "bfloat16"), "_execute_dma_rank3"),
    "heat7_periodic_f32": (
        lambda: stencils.heat7((8, 16, 128), periodic=True), "_execute_dma_rank3"
    ),
    "adv4_h0_2_bf16": (
        lambda: stencils.advection4((64, 128), "bfloat16"), "_execute_dma_rank2"
    ),
    "combination_f32": (lambda: stencils.combination((64, 128)), "_execute"),
    "two_results_f32": (lambda: stencils.gradients((64, 128)), "_execute"),
}


@pytest.fixture(autouse=True)
def pallas_interpret():
    old = config.pallas_interpret
    config.pallas_interpret = True
    yield
    config.pallas_interpret = old


@pytest.fixture
def unfolded():
    """Affine folding off in both packages: every body runs op by op."""
    old = config.fold_affine, torch_config.fold_affine
    config.fold_affine = torch_config.fold_affine = False
    yield
    config.fold_affine, torch_config.fold_affine = old


def _both(module):
    """(port apply op, JAX apply op) of one module."""
    jax_module = jax_verify(jax_parse(print_module(module)))
    return stencils.the_apply(module), stencils.the_apply(jax_module)


def _operands(op, seed, np_dtype):
    rng = np.random.default_rng(seed)
    tt = op.results[0].type
    n_in = op.attrs["num_inputs"]
    grids = [rng.standard_normal(tt.bounds.shape).astype(np_dtype) for _ in range(n_in)]
    scalars = [np_dtype(0.1)] * (len(op.operands) - n_in)
    return grids, scalars


def _compare(op, refs, gots, dtype):
    """Defined cells only: tolerance inside the bounds, bits outside."""
    inside = torch_backend.interior_mask(
        op.attrs["bounds"], op.results[0].type.bounds, "cpu"
    ).numpy()
    if not isinstance(gots, tuple):
        refs, gots = (refs,), (gots,)
    assert len(refs) == len(gots) == len(op.results)
    for ref, got in zip(refs, gots):
        ref = np.asarray(ref, np.float64)
        got = np.asarray(got, np.float64)
        err = np.abs(ref - got)[inside].max()
        assert err <= TOL[dtype] * np.abs(ref).max(), err
        np.testing.assert_array_equal(got[~inside], ref[~inside])


def _np64(results):
    if isinstance(results, tuple):
        return tuple(_np64(r) for r in results)
    return np.asarray(results, np.float64)


def _f32(results):
    if isinstance(results, tuple):
        return tuple(_f32(r) for r in results)
    if isinstance(results, torch.Tensor):
        return results.float().numpy()
    return np.asarray(results.astype(jnp.float32))


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_kernel(case):
    _plain_against_pallas(case)


@pytest.mark.parametrize("case", ["jacobi5_f32", "adv4_h0_2_f32", "heat7_f32", "combination_f32"])
def test_unfolded_plain_matches_pallas_kernel(case, unfolded):
    _plain_against_pallas(case)


def _plain_against_pallas(case):
    build, kernel = CASES[case]
    op, jop = _both(build())
    dtype = op.results[0].type.element
    route = "_execute_dma_" if pallas_backend._dma_profitable(jop) else "_execute"
    assert kernel.startswith(route)
    grids, scalars = _operands(op, 0, np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ref = pallas_backend.try_execute_apply(
        jop, [jnp.asarray(a, jd) for a in grids] + [jnp.asarray(s) for s in scalars]
    )
    td = torch_backend.DTYPES[dtype]
    got = cuda_backend.try_execute_apply(
        op, [torch.from_numpy(a).to(td) for a in grids] + [torch.tensor(s) for s in scalars]
    )
    _compare(op, _f32(ref), _f32(got), dtype)


# the same operators in f64: the eager route
F64_BUILDS = {
    "jacobi5": lambda: stencils.jacobi5((16, 24), "float64"),
    "adv4": lambda: stencils.advection4((16, 24), "float64"),
    "adv4_periodic": lambda: stencils.advection4((16, 24), "float64", periodic=True),
    "heat7": lambda: stencils.heat7((6, 8, 10), "float64"),
    "combination": lambda: stencils.combination((16, 24), "float64"),
    "two_results": lambda: stencils.gradients((16, 24), "float64"),
}


@pytest.mark.parametrize("case", F64_BUILDS)
def test_eager_matches_jnp_backend_f64(case):
    _eager_against_jnp_backend(F64_BUILDS[case]())


@pytest.mark.parametrize("case", F64_BUILDS)
def test_unfolded_eager_matches_jnp_backend_f64(case, unfolded):
    _eager_against_jnp_backend(F64_BUILDS[case]())


def test_fold_setting_reaches_generated_source(unfolded):
    op, _ = _both(stencils.advection4((64, 128)))
    unfolded_src = cuda_backend.source(op)
    torch_config.fold_affine = True
    assert cuda_backend.source(op) != unfolded_src


def _eager_against_jnp_backend(module):
    op, jop = _both(module)
    assert cuda_backend.try_execute_apply(op, []) is None  # f64: eager route
    grids, scalars = _operands(op, 1, np.float64)
    ref = jnp_backend.execute_apply(
        jop, [jnp.asarray(a) for a in grids] + [jnp.asarray(s) for s in scalars]
    )
    got = torch_backend.execute_apply(
        op, [torch.from_numpy(a) for a in grids] + [torch.tensor(s) for s in scalars]
    )
    _compare(op, _np64(ref), _np64(got), "float64")


@pytest.mark.parametrize("case", CASES)
def test_generated_source(case):
    op, _ = _both(CASES[case][0]())
    src = cuda_backend.source(op)
    assert src.startswith('#include "nt_apply.cuh"')
    assert src.rstrip().endswith("NT_DEFINE_APPLY_TILED(NtBody, NtApplyPlan)")
    assert f"kH0 = {'1' if op.results[0].type.bounds.rank == 3 else '0'}" in src
    assert ("__nv_bfloat16" in src) == (op.results[0].type.element == "bfloat16")
    reads = {
        (a.operands[0].uid, tuple(a.attrs["offset"]))
        for a in op.region(0).ops
        if a.name == "neptune.access"
    }
    assert src.count("a.ld(") == len(reads)  # one load per distinct read


def test_division_is_the_ieee_quotient():
    """`number / t` and `t / number` give the IEEE quotient, as the kernels
    and the JAX package compute it; PyTorch's operators may round through a
    reciprocal instead."""
    x = np.random.default_rng(5).standard_normal(4096).astype(np.float32)
    t = torch.from_numpy(x)
    ops = torch_backend.TorchOps("cpu")
    c = np.float32(12.0)
    np.testing.assert_array_equal(ops.binop("arith.div", 12.0, t, "float32").numpy(), c / x)
    np.testing.assert_array_equal(ops.binop("arith.div", t, 12.0, "float32").numpy(), x / c)


def test_constants_are_exact_hex_literals():
    assert codegen.c_literal(0.1, "float32") == "(0x1.99999a0000000p-4f)"
    assert codegen.c_literal(0.1, "bfloat16") == "(0x1.9a00000000000p-4f)"
    assert codegen.c_literal(0.1, "float64") == "(0x1.999999999999ap-4)"
    assert codegen.c_literal(-3, "index") == "(-3)"
