"""Each cell driven through the rest of a run on the CPU at a small size
(the harness's look for a card skipped): a sound run is correct, and the
control (the reference in bfloat16 in the program's place) and each fault
a cell can have (a step or solve that returns its state unchanged, an
answer altered where it is produced) come out not correct."""

import json
import time

import pytest

from portbench import devtrace, harness

SMALL = {"bounds": [[0, 0], [48, 48]], "interior": [[1, 1], [47, 47]]}
CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = 2**31 + 977


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    from neptune_tpu_torch import config

    monkeypatch.setattr(config, "device", "cpu")


def run(cell, swap=None):
    cfg = dict(harness.load_cell(cell).cfg, **SMALL)
    result, checks, _ = harness.run_cell(cell, SEED, 0.2, False, t0=time.perf_counter(),
                                         device="cpu", cfg=cfg, swap=swap)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result = run(cell)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in harness.load_cell(cell).end_to_end}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    result = run(cell, lambda system, driver, c, reference: driver.control(c, reference))
    assert not result["correct"] and result["failed"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    result = run(cell, lambda system, driver, c, reference: driver.faults(system)[fault])
    assert not result["correct"] and result["failed"] > 0


def test_trace_reading():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": devtrace.SEGMENT, "ts": 0, "dur": 100,
         "pid": 1, "tid": 7},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.call", "ts": 0, "dur": 60,
         "pid": 1, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 30, "dur": 5,
         "pid": 1, "tid": 7},
        {"ph": "X", "cat": "kernel", "name": "void nt_apply_tiled_kernel<B>()", "ts": 10,
         "dur": 20, "pid": 0, "tid": 3},
        {"ph": "X", "cat": "kernel", "name": "void nt_apply_tiled_kernel<B>()", "ts": 40,
         "dur": 20, "pid": 0, "tid": 3},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "ts": 50, "dur": 30, "pid": 0,
         "tid": 3},
    ]
    tr = devtrace.parse(ev)
    assert tr.window_s == pytest.approx(100e-6) and tr.busy_s == pytest.approx(60e-6)
    assert tr.kernel_count("nt_apply") == 2
    assert tr.kernel_seconds("nt_apply") == pytest.approx(40e-6)
    # gaps: 0-10 in portbench.call, 30-40 from within the launch, 80-100 after the call
    idle = dict(tr.idle_by_host())
    assert idle == pytest.approx(
        {"portbench.call": 10e-6, "cudaLaunchKernel": 10e-6, devtrace.SEGMENT: 20e-6})
    assert tr.top_ops()[0][0].startswith("void nt_apply")
