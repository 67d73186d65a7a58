"""The port's auxiliary modules against the JAX package's: solver
observability (`utils.profiling`), checkpoints (`utils.checkpoint`) and the
long-simulation driver (`utils.driver`).

The cases of tests/test_aux.py through the port, with the iteration counts
of both packages' KSP lines compared on the same seeded inputs; checkpoint
files written by each package and loaded by the other; the driver over the
port's implicit heat step (`entry.build_step`) against the JAX package's
driver over the same printed IR, on the CPU.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import neptune_tpu as ntp  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu.passes import compile_ir as jax_compile_ir  # noqa: E402
from neptune_tpu.utils.checkpoint import load_checkpoint as jax_load  # noqa: E402
from neptune_tpu.utils.checkpoint import save_checkpoint as jax_save  # noqa: E402
from neptune_tpu.utils.driver import SimulationDriver as JaxDriver  # noqa: E402

import neptune_tpu_torch as ntt  # noqa: E402
from neptune_tpu_torch import entry, stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.ir import print_module  # noqa: E402
from neptune_tpu_torch.passes import compile_ir  # noqa: E402
from neptune_tpu_torch.utils import profiling  # noqa: E402
from neptune_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from neptune_tpu_torch.utils.driver import SimulationDriver  # noqa: E402


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.setattr(torch_config, "device", "cpu")
    monkeypatch.delenv(profiling.VERBOSE_ENV, raising=False)
    monkeypatch.delenv("NEPTUNE_TPU_VERBOSE", raising=False)
    ntp.reset_context()
    ntt.reset_context()
    yield
    ntp.reset_context()
    ntt.reset_context()


def _iters(text, kind):
    """The iteration counts of the lines of `kind` ("KSP" or "SNES") in
    `text`, as either package prints them."""
    return [int(m) for m in re.findall(rf"{kind}\([^)]*\) \S+: iters=(\d+)", text)]


# ---- verbose reporting -------------------------------------------------------


def _lap(nt, n):
    @nt.linear_op_def(bounds=([0], [n]), interior=([1], [n - 1]))
    def lap(u):
        return 2.0 * u[0] - u[-1] - u[1]

    return lap


def test_ksp_line_printed(capfd):
    b = np.random.default_rng(0).standard_normal(32)
    for nt in (ntp, ntt):
        nt.solve_linear(nt.assemble_matrix(_lap(nt, 32)), b, solver="bicgstab", tol=1e-10,
                        max_iters=500, verbose=True)
    out = capfd.readouterr().out
    assert out.count("converged=True") == 2
    ref, port = _iters(out, "KSP")
    assert abs(port - ref) <= 1


def test_snes_line_printed(capfd):
    def residual(u):
        return u[0] * u[0] * u[0] + u[0] - 2.0

    for nt in (ntp, ntt):
        nt.solve_nonlinear(residual, np.zeros(8), tol=1e-12, verbose=True)
    out = capfd.readouterr().out
    ref, port = _iters(out, "SNES")
    assert port == ref


def test_silent_by_default(capfd):
    ntt.solve_linear(ntt.assemble_matrix(_lap(ntt, 16)), np.ones(16), solver="bicgstab",
                     tol=1e-8)
    assert "KSP" not in capfd.readouterr().out


def test_verbose_switch_reaches_the_dsl_and_the_executor(capfd, monkeypatch):
    """NEPTUNE_TORCH_VERBOSE=1 prints every solve's line, as
    NEPTUNE_TPU_VERBOSE=1 does in the JAX package: the eager DSL's and the
    IR executor's (a solve_linear op without verbose=)."""
    monkeypatch.setenv(profiling.VERBOSE_ENV, "1")
    monkeypatch.setenv("NEPTUNE_TPU_VERBOSE", "1")
    ntt.solve_linear(ntt.assemble_matrix(_lap(ntt, 16)), np.ones(16), solver="bicgstab",
                     tol=1e-8)
    module = stencils.with_solve(stencils.poisson5(16, "float64"), "poisson", solver="gmres",
                                 tol=1e-10, max_iters=200)
    b = np.random.default_rng(1).standard_normal((16, 16))
    compile_ir(module, device="cpu").function("solve")(b)
    jax_compile_ir(jax_parse(print_module(module))).function("solve")(b)
    out = capfd.readouterr().out
    assert "KSP(bicgstab)" in out
    _, port, ref = _iters(out, "KSP")
    assert abs(port - ref) <= 1
    assert profiling.verbose_default()


def test_report_solve_is_the_executors():
    from neptune_tpu_torch.lowering import executor

    assert executor.report_solve is profiling.report_solve


# ---- checkpoints -------------------------------------------------------------


def test_roundtrip(tmp_path):
    p = tmp_path / "state.npz"
    u = np.random.default_rng(1).standard_normal((8, 8))
    q = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 8)))
    save_checkpoint(p, {"u": u, "q": q}, step=42, time=4.2, meta={"dt": 0.1})
    fields, meta = load_checkpoint(p)
    np.testing.assert_array_equal(fields["u"], u)
    np.testing.assert_array_equal(fields["q"], q.numpy())
    assert meta == {"step": 42, "time": 4.2, "dt": 0.1}


def test_atomic_overwrite(tmp_path):
    p = tmp_path / "state.npz"
    save_checkpoint(p, {"u": np.zeros(4)}, step=1)
    save_checkpoint(p, {"u": torch.ones(4)}, step=2)
    fields, meta = load_checkpoint(p)
    assert meta["step"] == 2
    np.testing.assert_array_equal(fields["u"], np.ones(4))
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_load_across_the_packages(tmp_path, writer):
    """A file written by either package loads in the other, fields and
    metadata alike (f64, f32 and integer fields)."""
    rng = np.random.default_rng(3)
    fields = {
        "u": rng.standard_normal((6, 5)),
        "v": rng.standard_normal(7).astype(np.float32),
        "n": np.arange(4, dtype=np.int32),
    }
    p = tmp_path / f"{writer}.npz"
    if writer == "jax":
        jax_save(p, {k: jnp.asarray(v) for k, v in fields.items()}, step=7, time=0.7,
                 meta={"dt": 0.1})
        got, meta = load_checkpoint(p)
    else:
        save_checkpoint(p, {k: torch.from_numpy(v) for k, v in fields.items()}, step=7,
                        time=0.7, meta={"dt": 0.1})
        got, meta = jax_load(p)
    assert meta == {"step": 7, "time": 0.7, "dt": 0.1}
    assert set(got) == set(fields)
    for k, v in fields.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)


def test_bf16_is_refused_naming_the_field(tmp_path):
    with pytest.raises(TypeError, match="'w'"):
        save_checkpoint(tmp_path / "s.npz", {"u": torch.zeros(2), "w": torch.zeros(
            2, dtype=torch.bfloat16)})
    assert not (tmp_path / "s.npz").exists()


@pytest.mark.parametrize("name", ["__meta__", "file"])
def test_reserved_field_names(tmp_path, name):
    with pytest.raises(ValueError, match="reserved"):
        save_checkpoint(tmp_path / "s.npz", {name: np.zeros(2)})


# ---- the simulation driver ---------------------------------------------------


def test_checkpoint_resume(tmp_path):
    def step(state):
        return {"u": state["u"] + 1.0}

    p = tmp_path / "sim.npz"
    init = {"u": np.zeros(4)}
    state, n = SimulationDriver(step, p, checkpoint_every=10).run(init, 25)
    assert n == 25
    np.testing.assert_array_equal(state["u"].numpy(), 25.0)
    # a fresh driver resumes from the checkpoint, not from init
    state2, n2 = SimulationDriver(step, p, checkpoint_every=10).run(init, 40)
    assert n2 == 40
    np.testing.assert_array_equal(state2["u"].numpy(), 40.0)


def test_walltime_budget_stops_early(tmp_path):
    import time as _t

    def slow_step(state):
        return {"u": state["u"] + 1.0}

    p = tmp_path / "sim2.npz"
    d = SimulationDriver(slow_step, p, checkpoint_every=1)
    orig = d._chunk_runner

    def wrapped(n):
        f = orig(n)

        def run(s):
            _t.sleep(0.05)
            return f(s)

        return run

    d._chunk_runner = wrapped
    state, n = d.run({"u": np.zeros(2)}, 1000, walltime_budget_s=0.2)
    assert 0 < n < 1000
    _, meta = load_checkpoint(p)
    assert meta["step"] == n


def test_resumed_state_takes_the_init_tensors_device_and_dtype(tmp_path):
    p = tmp_path / "sim3.npz"
    save_checkpoint(p, {"u": np.full(3, 2.0), "v": np.ones(2)}, step=5)
    init = {"u": torch.zeros(3, dtype=torch.float32), "v": np.zeros(2)}
    state, step = SimulationDriver(lambda s: s, p).resume_or_init(init)
    assert step == 5
    assert state["u"].dtype == torch.float32 and torch.equal(state["u"], torch.full((3,), 2.0))
    assert isinstance(state["v"], torch.Tensor) and state["v"].device.type == "cpu"


def test_driver_over_the_heat_step_matches_the_jax_driver(tmp_path):
    """Both packages' drivers over the implicit heat step's IR (16^2 f64, CG
    each step), 12 steps in chunks of 5, one stopped and resumed: within
    1e-10 of the JAX package's state, and the resumed run bitwise the
    uninterrupted one."""
    cm = entry.build_step(16, "float64", device="cpu")
    jfn = jax_compile_ir(jax_parse(print_module(cm.module))).function("step")
    fn = cm.function("step")
    u0 = entry.gaussian(16, "float64")

    def step(s):
        return {"u": fn(s["u"])}

    whole, n = SimulationDriver(step, tmp_path / "a.npz", 5).run({"u": u0}, 12)
    assert n == 12
    d = SimulationDriver(step, tmp_path / "b.npz", 5)
    _, stopped = d.run({"u": u0}, 12, walltime_budget_s=1e-9)
    assert stopped == 5
    resumed, n = SimulationDriver(step, tmp_path / "b.npz", 5).run({"u": u0}, 12)
    assert n == 12 and torch.equal(resumed["u"], whole["u"])
    ref, _ = JaxDriver(lambda s: {"u": jfn(s["u"])}, tmp_path / "j.npz", 5).run({"u": u0}, 12)
    got = whole["u"].numpy()
    assert np.abs(got - ref["u"]).max() <= 1e-10 * np.abs(ref["u"]).max()


# ---- profiling ---------------------------------------------------------------


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    import json

    cm = entry.build_step(16, "float32", device="cpu")
    u = torch.from_numpy(entry.gaussian(16, "float32"))
    with profiling.trace(tmp_path / "prof"):
        with profiling.annotate("two_steps"):
            cm.function("step")(cm.function("step")(u))
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "two_steps" for e in events)
