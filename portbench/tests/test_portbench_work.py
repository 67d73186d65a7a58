"""The work counts equal hand counts for each cell, and a roofline share
comes from the least time over the kernel's device time."""

import pytest

from portbench import harness, work
from portbench.reference import jacobi2d_5pt, poisson2d_5pt


def test_jacobi8192_apply_by_hand():
    w = work.stencil_call(harness.load_cell("jacobi8192_apply").cfg, jacobi2d_5pt.FLOPS_PER_CELL, 1)
    assert w.bytes == 2 * 8192 * 8192 * 4  # read once, written once
    assert w.flops == 4 * 8190 * 8190
    assert w.bound() == "bytes" and w.least_s() == pytest.approx(536870912 / 3.35e12)


def test_k_sweeps_by_hand():
    cfg = harness.load_cell("jacobi8192_apply").cfg
    w = work.stencil_call(cfg, jacobi2d_5pt.FLOPS_PER_CELL, 16)
    assert w.bytes == 2 * 8192 * 8192 * 4  # once per call, whatever the sweeps
    assert w.flops == 16 * 4 * 8190 * 8190
    assert w.bound() == "bytes"


def test_poisson512_cg_jacobi_by_hand():
    w = work.cg_solve(harness.load_cell("poisson512_cg_jacobi").cfg, poisson2d_5pt.FLOPS_PER_CELL,
                      poisson2d_5pt.CG_FLOPS_PER_CELL, 4000)
    assert w.bytes == 2 * 512 * 512 * 4
    assert w.flops == 4000 * (5 * 510 * 510 + 13 * 512 * 512)
    assert w.bound() == "operations" and w.least_s() == pytest.approx(w.flops / 67e12)


class _Trace:
    def kernel_seconds(self, part):
        return {"nt_apply": 0.002}.get(part, 0.0)


def test_roofline_pct():
    cell = harness.load_cell("jacobi8192_apply")
    w = work.Work(flops=0.0, bytes=3.35e9, dtype="float32")  # least 1 ms a call
    reading = harness.Reading(cell, 1, _Trace(), [], w)
    assert work.roofline_pct(reading, "stencil_apply", "nt_apply") == pytest.approx(50.0)
    assert work.roofline_pct(reading, "fused_cg", "nt_fused_cg") is None
