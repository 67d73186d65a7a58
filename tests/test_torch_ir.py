"""The port's copy of the IR against the JAX package's: every program of
`tests/programs.py` and every golden file prints identically through both
parsers and printers, with equal structure-key hashes; and importing the
port loads no JAX."""

import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

import programs  # noqa: E402
from neptune_tpu.ir import print_module as jax_print  # noqa: E402
from neptune_tpu.ir import verify_and_annotate as jax_verify  # noqa: E402
from neptune_tpu.ir.parser import parse_module as jax_parse  # noqa: E402
from neptune_tpu_torch.interop import module_from_reference  # noqa: E402
from neptune_tpu_torch.ir import print_module, verify_and_annotate  # noqa: E402

GOLDEN = Path(__file__).parent / "golden"
REPO = Path(__file__).parent.parent

BUILDERS = [
    programs.build_allen_cahn_implicit_linear,
    programs.build_allen_cahn_nonlinear,
    programs.build_bs_program,
    programs.build_heat3d_explicit,
    programs.build_periodic_advection4,
]


def _hashes(module):
    return {
        name: fn.attrs.get("structure_key_hash")
        for name, fn in module.functions.items()
        if fn.is_opdef
    }


@pytest.mark.parametrize("build", BUILDERS, ids=lambda f: f.__name__)
def test_builder_programs_print_and_hash_alike(build):
    ref = build()
    text = jax_print(ref)
    port = module_from_reference(text)
    assert print_module(port) == text
    jax_verify(ref)
    verify_and_annotate(port)
    assert print_module(port) == jax_print(ref)
    hashes = _hashes(port)
    assert hashes and hashes == _hashes(ref)


@pytest.mark.parametrize("name", sorted(p.name for p in GOLDEN.glob("*.ntir")))
def test_golden_files_round_trip_alike(name):
    text = (GOLDEN / name).read_text()
    port = module_from_reference(text)
    assert print_module(port) == jax_print(jax_parse(text))
    assert print_module(port) == text


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import neptune_tpu_torch, neptune_tpu_torch.entry, neptune_tpu_torch.interop\n"
        "import neptune_tpu_torch.stencils, neptune_tpu_torch.solvers.fused\n"
        "import neptune_tpu_torch.lowering.cuda_backend, neptune_tpu_torch.kernels.codegen\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'neptune_tpu.')) or m == 'neptune_tpu')\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
