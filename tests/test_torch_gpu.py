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
from neptune_tpu_torch.lowering import cuda_backend, torch_backend  # noqa: E402
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


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["poisson", "poisson_jacobi", "composite"])
def test_fused_cg_matches_plain(which, cuda):
    n = 64
    module = composite(n) if which == "composite" else stencils.poisson5(n)
    name = "shifted" if which == "composite" else "poisson"
    matvec = fused.plain_matvec(fused.matvec_plan(module, name))
    b = torch.from_numpy(np.random.default_rng(1).standard_normal((n, n)).astype(np.float32))
    inv = None
    if which == "poisson_jacobi":
        inv = safe_inv_diag(extract_diagonal(matvec, torch.zeros(n, n), ((1, 1), (1, 1))))
    solve = fused.fused_cg(module, name, tol=1e-4, maxiter=2000, inv_diag=inv)
    x_p, it_p, _ = solve(b)
    before = fused.counter.count
    x_k, it_k, rn_k = solve(b.to(cuda))
    torch.cuda.synchronize()
    assert fused.counter.count == before + 1
    assert abs(int(it_k) - int(it_p)) <= 1
    assert float(torch.linalg.norm(x_k.cpu() - x_p) / torch.linalg.norm(x_p)) <= 1e-4


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
