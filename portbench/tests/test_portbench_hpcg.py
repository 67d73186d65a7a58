"""HPCG's cell on the CPU at a small 3-D size: a sound run is correct, and
the control (the reference in float32 in the program's place) and both
faults are not; the reference's HPCG b against a count of each unknown's
neighbours; `work_hpcg`'s counts and the four new metrics on known
readings."""

import itertools
import time

import pytest
import torch

from portbench import devtrace, harness, work_hpcg
from portbench.reference import hpcg27 as reference

CELL = "hpcg320_mgcg_f64"
SEED = 2**31 + 4099


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    from neptune_tpu_torch import config

    monkeypatch.setattr(config, "device", "cpu")


def run(n, swap=None):
    cfg = dict(harness.load_cell(CELL).cfg, bounds=[[0] * 3, [n + 2] * 3],
               interior=[[1] * 3, [n + 1] * 3])
    result, _, _ = harness.run_cell(CELL, SEED, 0.2, False, t0=time.perf_counter(),
                                    device="cpu", cfg=cfg, swap=swap)
    return result


def test_sound_run_is_correct():
    result = run(8)  # 8^3 unknowns: four levels, 8 -> 4 -> 2 -> 1
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"setup_s", "solve_ms", "solve_ms_p95"}
    assert set(result["checks"]) == {"max_residual_gap", "max_rel_diff"}


@pytest.mark.parametrize("swap", ["control", "unchanged", "altered"])
def test_control_and_faults_are_not_correct(swap):
    if swap == "control":
        def put(system, driver, c, ref):
            return driver.control(c, ref)
    else:
        def put(system, driver, c, ref):
            return driver.faults(system)[swap]
    result = run(8, put)
    assert not result["correct"] and result["failed"] > 0


def test_levels_follow_the_unknowns():
    from portbench.traffic import hpcg

    cfg = harness.load_cell(CELL).cfg
    assert hpcg.levels(cfg) == 4
    assert hpcg.levels(dict(cfg, interior=[[1, 1], [47, 47]])) == 2  # 46 -> 23
    assert hpcg.grid(cfg) == ((322, 322, 322), ((1, 1, 1), (321, 321, 321)))


@pytest.mark.parametrize("n", [3, 5])
def test_hpcg_rhs_is_27_minus_the_neighbours(n):
    """b_i = 27 - nnz_i, nnz_i counting the unknown itself and its
    neighbours inside the grid; 0 on the ring."""
    interior = ((1, 1, 1), (n + 1,) * 3)
    b = reference.hpcg_rhs((n + 2,) * 3, interior)
    for i, j, k in itertools.product(range(n), repeat=3):
        nnz = sum(0 <= i + a < n and 0 <= j + c < n and 0 <= k + d < n
                  for a, c, d in itertools.product((-1, 0, 1), repeat=3))
        assert b[i + 1, j + 1, k + 1].item() == 27 - nnz
    assert b[0].abs().sum() == 0 and b[:, :, -1].abs().sum() == 0


def test_work_by_hand():
    """Two levels of 4^3 and 2^3 unknowns, 3 iterations: 4 SpMVs (the
    start's and one an iteration) and 3 V-cycles."""
    interior = ((1, 1, 1), (5, 5, 5))
    w = work_hpcg.solve_work(interior, 2, 3)
    assert work_hpcg.level_unknowns(interior, 2) == [(4, 4, 4), (2, 2, 2)]
    nnz0, nnz1 = 10**3, 4**3  # (3n - 2)^3
    assert work_hpcg.nnz((4, 4, 4)) == nnz0 and work_hpcg.nnz((2, 2, 2)) == nnz1
    mg_flops = 10 * nnz0 + 4 * nnz1
    mg_passes = 13.625 * 64 + 6 * 8
    assert w.flops == 2 * nnz0 + 3 * (2 * nnz0 + 12 * 64 + mg_flops)
    assert w.bytes == 8 * (2 * 64 + 3 * (16 * 64 + mg_passes))
    assert w.bound() == "bytes"
    assert work_hpcg.apply_least_s(1000, 4, 8) == pytest.approx(32000 / 3.35e12)


US = 1000  # ns


def span(name, start_us, end_us, parent, **attrs):
    return {"name": name, "start_ns": start_us * US, "end_ns": end_us * US, "parent": parent,
            "request": 1, "attrs": attrs}


def spans():
    """One solve of 50 iterations: two 400 us cycles, three float64 launches
    (a colour pass of 4 grids of 1000 cells and two matvecs of 2) and an
    f32 one the roofline leaves out."""
    return [
        span("nt.solve", 0, 10_000, None, solver="cg", precond="mg", route="generic", iters=50),
        span("nt.mg.cycle", 100, 500, 0, levels=4),
        span("nt.mg.cycle", 600, 1000, 0, levels=4),
        span("nt.launch.stencil_apply", 110, 120, 1, cells=1000, grids=4, itemsize=8),
        span("nt.launch.stencil_apply", 130, 140, 1, cells=1000, grids=2, itemsize=8),
        span("nt.launch.stencil_apply", 150, 160, 1, cells=1000, grids=2, itemsize=8),
        span("nt.launch.stencil_apply", 170, 180, 1, cells=1000, grids=2, itemsize=4),
    ]


def reading(cell=CELL):
    # 200 kernels: two of kernel A, 32 ns each, and 198 others of 1 us
    dev = [("kernel", "void nt_apply_tiled_kernel<B, P, int>()", 0.0, 0.032),
           ("kernel", "void nt_apply_tiled_kernel<B, P, int>()", 0.1, 0.132)]
    dev += [("kernel", "elementwise", 10.0 + 5 * i, 11.0 + 5 * i) for i in range(198)]
    trace = devtrace.Trace(device=dev, host=[], start_us=0.0, end_us=10_000.0)
    return harness.Reading(harness.load_cell(cell), 1, trace, [], None)


def test_metrics_on_a_known_reading(monkeypatch):
    from neptune_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", spans)
    r = reading()
    least = (4 + 2 + 2) * 1000 * 8 / 3.35e12
    assert harness.metric_reader("kernelA_f64_roofline.hpcg")(r) == pytest.approx(
        100 * least / 64e-9)
    assert harness.metric_reader("mg_cycle_host_us.hpcg")(r) == pytest.approx(400.0)
    assert harness.metric_reader("launches_per_iter.hpcg")(r) == pytest.approx(200 / 50)
    w = work_hpcg.solve_work(((1, 1, 1), (321, 321, 321)), 4, 50)
    assert harness.metric_reader("mgcg_roofline.hpcg")(r) == pytest.approx(
        100 * w.least_s() / r.trace.busy_s)


@pytest.mark.parametrize("metric", ["kernelA_f64_roofline.hpcg", "mg_cycle_host_us.hpcg",
                                    "launches_per_iter.hpcg", "mgcg_roofline.hpcg"])
def test_metrics_stay_out_of_other_cells_and_need_the_spans(monkeypatch, metric):
    from neptune_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", spans)
    assert harness.metric_reader(metric)(reading("poisson512_cg_jacobi")) is None
    if metric != "mgcg_roofline.hpcg":  # read from the trace alone
        monkeypatch.delattr(profiling, "spans")
        assert harness.metric_reader(metric)(reading()) is None
