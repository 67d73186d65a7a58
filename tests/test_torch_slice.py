"""The slice end to end: the flagship implicit heat step and the golden
programs through the JAX package's `compile_ir` and the port's, against
each other and against the NumPy oracles of `tests/programs.py`."""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import __graft_entry__ as graft  # noqa: E402
import programs  # noqa: E402
from neptune_tpu.config import config  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.passes import compile_ir as jax_compile_ir  # noqa: E402
from neptune_tpu_torch import entry  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.interop import arrays_from_numpy, module_from_reference  # noqa: E402
from neptune_tpu_torch.passes import compile_ir  # noqa: E402
from neptune_tpu_torch.solvers import fused  # noqa: E402


@pytest.fixture(autouse=True)
def port_on_cpu(monkeypatch):
    """The port puts NumPy inputs on `config.device`, the card by default:
    these CPU tests ask for the CPU."""
    monkeypatch.setattr(torch_config, "device", "cpu")


GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture
def pallas_interpret():
    old = config.pallas_interpret
    config.pallas_interpret = True
    yield
    config.pallas_interpret = old


def _rel(ref, got):
    ref = np.asarray(ref, np.float64)
    return np.abs(ref - np.asarray(got, np.float64)).max() / np.abs(ref).max()


def test_step_f32_matches_fused_route(pallas_interpret):
    # both packages route the CG solve to their fused kernel
    u = entry.gaussian(64)
    ref = graft._build_step(64, "float32").function("step")(u)
    cm = entry.build_step(64, "float32")
    before = fused.counter.count
    got = cm.function("step")(u)
    assert fused.counter.count == before  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (64, 64)
    assert _rel(ref, got.numpy()) <= 1e-5


def test_step_f64_matches_generic_route():
    # f64 is outside the fused kernel: both take generic CG with the ring lift
    assert not config.pallas_interpret
    u = entry.gaussian(64, "float64")
    ref = graft._build_step(64, "float64").function("step")(u)
    got = entry.build_step(64, "float64").function("step")(u)
    assert _rel(ref, got.numpy()) <= 1e-10


def test_step_3d_gmres_f64():
    u = np.random.default_rng(5).standard_normal((8, 8, 8))
    ref = graft._build_step_3d(8, "float64").function("step3d")(u)
    got = entry.build_step_3d(8, "float64").function("step3d")(u)
    assert _rel(ref, got.numpy()) <= 1e-10


def test_step_3d_gmres_f32(pallas_interpret):
    u = np.random.default_rng(6).standard_normal((8, 8, 8)).astype(np.float32)
    ref = graft._build_step_3d(8, "float32").function("step3d")(u)
    got = entry.build_step_3d(8, "float32").function("step3d")(u)
    assert _rel(ref, got.numpy()) <= 1e-5


def test_entry_on_cpu():
    fn, (u0,) = entry.entry("cpu")
    out = fn(u0)
    assert out.shape == (256, 256) and out.device.type == "cpu"
    assert torch.isfinite(out).all()


GOLDEN_RUNS = {
    "allen_cahn_input.ntir": (
        lambda rng: (np.zeros(16), np.sin(np.linspace(0, np.pi, 16))),
        lambda args: programs.allen_cahn_implicit_linear_oracle(args[1]),
        1e-10,
    ),
    "heat3d_input.ntir": (
        lambda rng: (rng.standard_normal((8, 8, 8)),),
        lambda args: programs.heat3d_explicit_oracle(args[0]),
        1e-12,
    ),
    "periodic_adv4_input.ntir": (
        lambda rng: (rng.standard_normal((16, 16)),),
        lambda args: programs.periodic_advection4_oracle(args[0]),
        1e-12,
    ),
}


@pytest.mark.parametrize("name", GOLDEN_RUNS)
def test_golden_program_through_both_compilers(name):
    make_args, oracle, atol = GOLDEN_RUNS[name]
    text = (GOLDEN / name).read_text()
    args = make_args(np.random.default_rng(7))
    ref = np.asarray(jax_compile_ir(jax_parse(text)).function("entry")(*args))
    got = compile_ir(module_from_reference(text)).function("entry")(
        *arrays_from_numpy(args, "cpu")
    )
    got = got.numpy()
    np.testing.assert_allclose(got, oracle(args), atol=atol)
    np.testing.assert_allclose(got, ref, atol=atol)


def test_arrays_from_numpy():
    a, b = arrays_from_numpy([np.ones((2, 3)), [1, 2]], "cpu", "float32")
    assert a.dtype == torch.float32 and a.shape == (2, 3)
    assert b.dtype == torch.float32 and b.tolist() == [1.0, 2.0]
