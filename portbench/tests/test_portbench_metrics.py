"""The metrics that read the port's own spans give the known values on a
synthetic reading with known spans and kernel time, and nothing where the
program records no spans."""

import pytest

from portbench import devtrace, harness

US = 1000  # ns


def span(name, start_us, end_us, parent, request, **attrs):
    return {"name": name, "start_ns": start_us * US, "end_ns": end_us * US, "parent": parent,
            "request": request, "attrs": attrs}


def stepping_spans():
    """Two calls, each nt.call 100 us > nt.run 85 > nt.run 70 > launch 40:
    frontend 15, executor 15 + 30, launch 40 us a call."""
    out = []
    for k in range(2):
        t, i = 1000 * k, len(out)
        out += [
            span("nt.call", t, t + 100, None, k + 1, symbol="jacobi"),
            span("nt.run", t + 10, t + 95, i, k + 1, symbol="jacobi"),
            span("nt.run", t + 20, t + 90, i + 1, k + 1, symbol="jacobi"),
            span("nt.launch.stencil_apply", t + 40, t + 80, i + 2, k + 1),
        ]
    return out


def solving_spans():
    """Two solves of 4000 and 4200 iterations, each root span 300 us."""
    out = []
    for k, iters in enumerate((4000, 4200)):
        t, i = 50_000 * k, len(out)
        out += [
            span("nt.call", t, t + 300, None, k + 1, symbol="PoissonSolver.solve"),
            span("nt.run", t + 10, t + 290, i, k + 1, symbol="PoissonSolver_solve"),
            span("nt.solve", t + 20, t + 280, i + 1, k + 1, solver="cg", precond="jacobi",
                 route="fused", iters=iters),
            span("nt.launch.fused_cg", t + 30, t + 270, i + 2, k + 1),
        ]
    return out


def reading(cell, calls):
    # kernel B: 41 ms on the device over the segment, 5 us for each of 8200 iterations
    trace = devtrace.Trace(
        device=[("kernel", "void nt_fused_cg_kernel<P>()", 0.0, 20_500.0),
                ("kernel", "void nt_fused_cg_kernel<P>()", 50_000.0, 70_500.0)],
        host=[], start_us=0.0, end_us=100_000.0)
    return harness.Reading(harness.load_cell(cell), calls, trace, [], None)


STEPPING = {"frontend_us_per_call.step": 15.0, "executor_us_per_call.step": 45.0,
            "launch_us_per_call.step": 40.0}
SOLVING = {"solve_host_us.solve": 300.0, "cg_iters_per_solve.solve": 4100.0,
           "cg_us_per_iter.solve": 5.0}
CASES = [("jacobi8192_apply", stepping_spans, m, v) for m, v in STEPPING.items()] + [
    ("poisson512_cg_jacobi", solving_spans, m, v) for m, v in SOLVING.items()]


@pytest.mark.parametrize("cell, spans, metric, value", CASES, ids=[c[2] for c in CASES])
def test_known_value(monkeypatch, cell, spans, metric, value):
    from neptune_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", spans)
    assert harness.metric_reader(metric)(reading(cell, 2)) == pytest.approx(value)


@pytest.mark.parametrize("cell, spans, metric, value", CASES, ids=[c[2] for c in CASES])
def test_nothing_without_the_programs_spans(monkeypatch, cell, spans, metric, value):
    from neptune_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert harness.metric_reader(metric)(reading(cell, 2)) is None
    monkeypatch.setattr(profiling, "spans", list, raising=False)  # records none
    assert harness.metric_reader(metric)(reading(cell, 2)) is None


def test_stepping_metrics_add_up_to_the_root_spans():
    spans = stepping_spans()
    from portbench import program_spans

    roots = program_spans.roots(spans)
    assert sum(STEPPING.values()) == pytest.approx(
        sum(map(program_spans.duration_us, roots)) / len(roots))


@pytest.mark.parametrize("metric", list(STEPPING), ids=list(STEPPING))
def test_stepping_metrics_stay_out_of_a_solving_cell(monkeypatch, metric):
    from neptune_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", solving_spans)
    assert harness.metric_reader(metric)(reading("poisson512_cg_jacobi", 2)) is None
