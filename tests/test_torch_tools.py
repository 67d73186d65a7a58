"""The port's CLI (`neptune-opt-torch`, `neptune_tpu_torch.tools.opt`)
against the JAX package's `neptune-opt`.

The cases of tests/test_tools.py through the port's parser and CLI, on the
CPU (`--device cpu`): the printed IR and stage dumps equal the JAX CLI's,
`--run` checksums equal the JAX CLI's within 1e-10 for f64 and
`--native` agrees, `--plan` prints the JAX package's plan and names each
opdef's kernel route, and `--source` prints the CUDA source of the kernels
a function launches.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import programs  # noqa: E402
from neptune_tpu.ir import print_module as jax_print  # noqa: E402
from neptune_tpu.tools.opt import main as jax_opt_main  # noqa: E402

from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.config import config as torch_config  # noqa: E402
from neptune_tpu_torch.interop import module_from_reference  # noqa: E402
from neptune_tpu_torch.ir import print_module, verify_and_annotate  # noqa: E402
from neptune_tpu_torch.ir.parser import ParseError, parse_module  # noqa: E402
from neptune_tpu_torch.passes import compile_ir  # noqa: E402
from neptune_tpu_torch.tools.opt import main as opt_main  # noqa: E402

REPO = Path(__file__).parent.parent

ALL_PROGRAMS = [
    programs.build_allen_cahn_implicit_linear,
    programs.build_allen_cahn_nonlinear,
    programs.build_bs_program,
]

BAD = """module @m {
  neptune.linear_opdef @sq : (temp<f64, [0,8), cell>) -> (temp<f64, [0,8), cell>) {
    ^(%0: temp<f64, [0,8), cell>):
    %1 = neptune.apply(%0) {bounds = [0,8), num_inputs = 1} : temp<f64, [0,8), cell>
      {
        ^(%2: index, %3: temp<f64, [0,8), cell>):
        %4 = neptune.access %3[0] : f64
        %5 = arith.mul(%4, %4) : f64
        neptune.yield(%5)
      }
    neptune.return(%1)
  }
}
"""


@pytest.fixture(scope="module", autouse=True)
def native_cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("native_cache")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NEPTUNE_TORCH_CACHE_DIR", str(root / "torch"))
        mp.setattr(torch_config, "cache_dir", str(root / "torch"))
        mp.setenv("NEPTUNE_TPU_CACHE_DIR", str(root / "jax"))
        yield root


def _write(tmp_path, build=programs.build_allen_cahn_implicit_linear):
    p = tmp_path / "prog.ntir"
    p.write_text(jax_print(build()))
    return str(p)


def _checksums(text):
    return [float(line.split("checksum=")[1]) for line in text.splitlines()
            if "checksum=" in line]


class TestParserRoundTrip:
    @pytest.mark.parametrize("build", ALL_PROGRAMS, ids=lambda f: f.__name__)
    def test_print_parse_print_fixpoint(self, build):
        m = module_from_reference(jax_print(build()))
        verify_and_annotate(m)
        d1 = print_module(m)
        assert print_module(parse_module(d1)) == d1

    def test_parsed_module_executes(self):
        m = parse_module(jax_print(programs.build_allen_cahn_implicit_linear()))
        uin = np.sin(np.linspace(0, np.pi, 16))
        out = compile_ir(m, device="cpu").function("entry")(np.zeros(16), uin)
        oracle = programs.allen_cahn_implicit_linear_oracle(uin)
        np.testing.assert_allclose(out.numpy(), oracle, atol=1e-10)

    def test_lex_error_reported_with_line(self):
        with pytest.raises(ParseError, match="line"):
            parse_module("module @m {\n  $garbage\n}")


class TestOptCLI:
    @pytest.mark.parametrize("flags", [[], ["--pipeline"], ["--dump-all"],
                                       ["--until", "high-level-convertion"]],
                             ids=["verify", "pipeline", "dump_all", "until"])
    def test_ir_output_equals_the_jax_cli(self, tmp_path, capsys, flags):
        path = _write(tmp_path)
        assert jax_opt_main([path, *flags]) == 0
        ref = capsys.readouterr().out
        assert opt_main([path, *flags]) == 0
        assert capsys.readouterr().out == ref

    def test_verify_and_print(self, tmp_path, capsys):
        assert opt_main([_write(tmp_path)]) == 0
        out = capsys.readouterr().out
        assert "neptune.linear_opdef @ac_lap" in out
        assert "structure_key_hash" in out

    def test_pipeline_rewrites_time_advance(self, tmp_path, capsys):
        assert opt_main([_write(tmp_path), "--pipeline"]) == 0
        out = capsys.readouterr().out
        assert "neptune.time_advance" not in out
        assert "neptune.solve_linear" in out

    def test_dump_all_stages(self, tmp_path, capsys):
        assert opt_main([_write(tmp_path), "--dump-all"]) == 0
        out = capsys.readouterr().out
        for stage in ("input", "verify-annotate", "high-level-convertion"):
            assert f"IR after {stage}" in out

    def test_invalid_ir_rejected(self, tmp_path, capsys):
        p = tmp_path / "bad.ntir"
        p.write_text(BAD)
        assert opt_main([str(p)]) == 1
        err = capsys.readouterr().err
        assert "linearity" in err or "mul" in err

    def test_plan_dump(self, tmp_path, capsys):
        """The JAX CLI's plan text, then each opdef's kernel route (f64
        opdefs: eager)."""
        path = _write(tmp_path)
        assert jax_opt_main([path, "--plan", "16"]) == 0
        ref = capsys.readouterr().out
        assert opt_main([path, "--plan", "16"]) == 0
        out = capsys.readouterr().out
        assert "sharded plan of @ac_lap on mesh 16" in out
        assert "sharded plan of @ac_A on mesh 16" in out
        assert "route: " in out and "halo (verified reach):" in out
        assert [line for line in out.splitlines() if "kernels on the whole grid" not in line] == \
            ref.splitlines()
        assert out.count("kernels on the whole grid: eager") == 2

    def test_plan_names_the_kernels(self, tmp_path, capsys):
        module = stencils.with_solve(stencils.poisson5(64), "poisson", solver="cg", tol=1e-4,
                                     max_iters=500, precond="jacobi")
        p = tmp_path / "p5.ntir"
        p.write_text(print_module(module))
        assert opt_main([str(p), "--plan", "2x2"]) == 0
        out = capsys.readouterr().out
        assert "local block=32x32" in out
        assert "kernels on the whole grid: kernel A (stencil_apply); sweeps: kernel C" in out
        assert "solve_linear @poisson on the whole grid: kernel B (fused_cg)" in out
        p.write_text(print_module(stencils.composite((64, 64))))
        assert opt_main([str(p), "--plan", "2x2"]) == 0
        assert "kernel D (stencil_chain)" in capsys.readouterr().out

    def test_plan_bad_mesh(self, tmp_path, capsys):
        assert opt_main([_write(tmp_path), "--plan", "4xq"]) == 1
        assert "bad --plan mesh" in capsys.readouterr().err

    def test_output_file(self, tmp_path):
        outp = tmp_path / "out.ntir"
        assert opt_main([_write(tmp_path), "--pipeline", "-o", str(outp)]) == 0
        text = outp.read_text()
        assert "neptune.assemble_matrix" in text
        parse_module(text)

    def test_source_prints_the_kernels(self, tmp_path, capsys):
        """--source, the counterpart of the JAX CLI's --jaxpr: the CUDA
        source of kernel B for a fused CG site (and kernel A for its
        opdef), the generated source exactly."""
        from neptune_tpu_torch.kernels import codegen
        from neptune_tpu_torch.solvers import fused

        module = stencils.with_solve(stencils.poisson5(64), "poisson", solver="cg", tol=1e-4,
                                     max_iters=500)
        p = tmp_path / "p5.ntir"
        p.write_text(print_module(module))
        assert opt_main([str(p), "--source", "solve"]) == 0
        out = capsys.readouterr().out
        assert "kernel B (fused_cg) source for solve_linear @poisson" in out
        assert "kernel A (stencil_apply) source for @poisson apply 0" in out
        assert codegen.fused_cg_source(fused.cg_plan(module, "poisson")) in out
        f64 = _write(tmp_path)
        assert opt_main([f64, "--source", "entry"]) == 0
        assert "launches no kernel" in capsys.readouterr().out


class TestOptRun:
    def _inputs(self, tmp_path):
        np.save(tmp_path / "zero.npy", np.zeros(16))
        np.save(tmp_path / "uin.npy", np.sin(np.linspace(0, np.pi, 16)))
        return ["--inputs", str(tmp_path / "zero.npy"), str(tmp_path / "uin.npy")]

    def test_run_matches_the_jax_cli_and_native(self, tmp_path, capsys):
        path = _write(tmp_path)
        inputs = self._inputs(tmp_path)
        assert jax_opt_main([path, "--run", "entry", *inputs]) == 0
        (ref,) = _checksums(capsys.readouterr().out)
        assert opt_main([path, "--run", "entry", "--device", "cpu", *inputs]) == 0
        out = capsys.readouterr().out
        assert "output 0: shape=(16,) dtype=float64" in out
        (got,) = _checksums(out)
        assert abs(got - ref) <= 1e-10 * max(abs(ref), 1.0)
        if shutil.which("g++"):
            assert opt_main([path, "--run", "entry", "--native", *inputs]) == 0
            (nat,) = _checksums(capsys.readouterr().out)
            assert abs(nat - ref) < 1e-8

    def test_run_f32_apply(self, tmp_path, capsys):
        """A 5-pt f32 apply (`stencils.with_entry`): the checksum of the
        in-process call."""
        module = stencils.with_entry(stencils.jacobi5((32, 32)), "jacobi")
        p = tmp_path / "j5.ntir"
        p.write_text(print_module(module))
        x = np.random.default_rng(0).standard_normal((32, 32)).astype(np.float32)
        np.save(tmp_path / "x.npy", x)
        assert opt_main([str(p), "--run", "entry", "--device", "cpu", "--inputs",
                         str(tmp_path / "x.npy")]) == 0
        (got,) = _checksums(capsys.readouterr().out)
        want = compile_ir(module, device="cpu").function("entry")(torch.from_numpy(x))
        assert got == float(f"{float(want.numpy().sum()):.10g}")

    def test_module_entry_point(self, tmp_path):
        """`python -m neptune_tpu_torch.tools.opt`, as the script runs it."""
        r = subprocess.run(
            [sys.executable, "-m", "neptune_tpu_torch.tools.opt", _write(tmp_path), "--pipeline"],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert r.returncode == 0, r.stderr
        assert "neptune.solve_linear" in r.stdout
