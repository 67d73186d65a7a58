"""`cg_vectors_share.hpcg` on recorded spans: the "update" launches of the
CG vector kernels over the solves' iterations, 100 where every iteration
made one, 0 where iterations exist and no such span does (a program
without the kernels), and nothing outside HPCG's cell or without spans."""

import pytest

from portbench import devtrace, harness

CELL = "hpcg320_mgcg_f64"
METRIC = "cg_vectors_share.hpcg"


def span(name, start_us, end_us, **attrs):
    return {"name": name, "start_ns": 1000 * start_us, "end_ns": 1000 * end_us,
            "parent": None, "request": 1, "attrs": attrs}


def solve_spans(steps):
    """One solve of 50 iterations, each with one `nt.launch.cg_vectors`
    span of each step in `steps`."""
    out = [span("nt.solve", 0, 10_000, solver="cg", precond="mg", route="generic", iters=50)]
    t = 100
    for _ in range(50):
        for step in steps:
            out.append(span("nt.launch.cg_vectors", t, t + 5, step=step))
            t += 10
    return out


def reading(cell=CELL):
    trace = devtrace.Trace(device=[("kernel", "elementwise", 0.0, 1.0)], host=[],
                           start_us=0.0, end_us=10_000.0)
    return harness.Reading(harness.load_cell(cell), 1, trace, [], None)


@pytest.mark.parametrize("steps, want", [
    (("dot_alpha", "update", "dot_beta", "direction"), 100.0),
    (("dot_alpha", "dot_beta", "direction"), 0.0),
    ((), 0.0),
], ids=["every update", "no update", "no kernels"])
def test_cg_vectors_share_on_recorded_spans(monkeypatch, steps, want):
    from neptune_tpu_torch.utils import profiling

    read = harness.metric_reader(METRIC)
    monkeypatch.setattr(profiling, "spans", lambda: solve_spans(steps))
    assert read(reading()) == pytest.approx(want)
    assert read(reading("poisson512_cg_jacobi")) is None
    monkeypatch.delattr(profiling, "spans")
    assert read(reading()) is None
