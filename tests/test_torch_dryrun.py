"""The port's multi-process dry run (`neptune_tpu_torch.entry.dryrun_multichip`),
the counterpart of the JAX package's `__graft_entry__.dryrun_multichip`, on
the CPU: four gloo processes on localhost run its seven parts, each
asserting what the JAX part asserts. A process that fails in a part makes
the call raise, naming the part: three processes cannot split the wide
stencil's 256-row grid."""

import os
import sys

import pytest

pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft  # noqa: E402
from neptune_tpu_torch import entry  # noqa: E402

PARTS = ("sharded 3-D GMRES step", "2-D implicit CG step", "sharded_stencil sweep", "CA-Krylov",
         "sharded JFNK", "MG-PCG over the mesh", "wide stencil")


def test_dryrun_multichip_passes_on_the_cpu():
    out = entry.dryrun_multichip(4, "cpu")
    assert out["mesh"] == graft._mesh_shape_2d(4) == (2, 2)
    assert out["backend"] == "gloo" and out["device"] == "cpu"
    assert tuple(out["seconds"]) == PARTS


def test_a_failing_part_is_named():
    with pytest.raises(RuntimeError, match=r"part 7 \(wide stencil\) failed on rank \d of mesh "
                                           r"\(3, 1\)") as e:
        entry.dryrun_multichip(3, "cpu")
    assert "not divisible" in str(e.value)


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_shape_is_the_jax_packages(n):
    assert entry.mesh_shape_2d(n) == graft._mesh_shape_2d(n)
