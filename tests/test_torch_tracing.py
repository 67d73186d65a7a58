"""The port's spans (`utils.profiling.span`) on the CPU: off outside a
profiler, and under one the frontend's `nt.call`, the executor's `nt.run`,
the solve site's `nt.solve` with its route and iterations, and the launch
boundary of `LaunchCounter`, each with its RecordFunction event in the
exported trace."""

import json
import threading

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import neptune_tpu_torch as ntt  # noqa: E402
from neptune_tpu_torch.config import config  # noqa: E402
from neptune_tpu_torch.kernels.build import LaunchCounter  # noqa: E402
from neptune_tpu_torch.solvers import fused, krylov, refine  # noqa: E402
from neptune_tpu_torch.utils import profiling  # noqa: E402

N = 16


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")
    ntt.reset_context()
    profiling.clear()
    yield
    ntt.reset_context()
    profiling.clear()


def jacobi(dtype="float32"):
    @ntt.linear_op_def(bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]), dtype=dtype)
    def jacobi(u):
        return 0.25 * (u[-1, 0] + u[1, 0] + u[0, -1] + u[0, 1])

    return jacobi


def solver(dtype, **solve_kw):
    @ntt.linear_op_def(bounds=([0, 0], [N, N]), interior=([1, 1], [N - 1, N - 1]), dtype=dtype,
                       name="poisson")
    def poisson(u):
        return 4.0 * u[0, 0] - u[-1, 0] - u[1, 0] - u[0, -1] - u[0, 1]

    @ntt.jit_class
    class PoissonSolver:
        def __init__(self):
            self.H = ntt.assemble_matrix(poisson)

        def solve(self, b):
            return ntt.solve_linear(self.H, b, **solve_kw)

    return PoissonSolver().solve


def profiled(fn):
    """fn() under torch.profiler (CPU activity); the profile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def named(spans, name):
    return [s for s in spans if s["name"] == name]


# ---- off ---------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["opdef", "jit_class solve"])
def test_no_span_outside_a_profiler(entry):
    if entry == "opdef":
        op = jacobi()
        op(torch.rand(N, N))
    else:
        solve = solver("float32", solver="cg", tol=1e-4, max_iters=200, precond="jacobi")
        solve(torch.randn(N, N))
    assert profiling.spans() == []


def test_annotate_is_a_no_op_outside_a_profiler():
    s = profiling.annotate("user.region", k=1)
    assert s is profiling.OFF and profiling.span("nt.call") is profiling.OFF
    with s as inner:
        inner.set(x=2)
    assert profiling.spans() == []


# ---- the frontend and the executor -------------------------------------------


def test_opdef_call_nests_call_and_run_with_one_request_per_call():
    op = jacobi()
    u = torch.rand(N, N)
    op(u)  # traced and compiled outside the profile
    profiled(lambda: (op(u), op(u)))
    spans = profiling.spans()
    calls = named(spans, "nt.call")
    assert len(calls) == 2 and all(c["parent"] is None for c in calls)
    assert [c["attrs"]["symbol"] for c in calls] == ["jacobi", "jacobi"]
    assert calls[0]["request"] != calls[1]["request"]
    for s in spans:
        if s["parent"] is None:
            continue
        parent = spans[s["parent"]]
        assert s["request"] == parent["request"]
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
    # each call: nt.call -> nt.run (the derivative rule's callable) -> nt.run
    for c in calls:
        i = spans.index(c)
        kids = [s for s in spans if s["parent"] == i]
        assert [k["name"] for k in kids] == ["nt.run"]
        grand = [s for s in spans if s["parent"] == spans.index(kids[0])]
        assert [g["name"] for g in grand] == ["nt.run"]
        assert sum(s["request"] == c["request"] for s in spans) == 3
    assert len(spans) == 6


def test_each_span_has_its_record_function_event(tmp_path):
    op = jacobi()
    u = torch.rand(N, N)
    op(u)
    prof = profiled(lambda: op(op(u)))
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    doc = json.loads((tmp_path / "trace.json").read_text())
    base = doc.get("baseTimeNanoseconds", 0)
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    spans = profiling.spans()
    assert spans
    slack_us = 2000.0
    for s in spans:
        start_us = (s["start_ns"] - base) / 1e3
        assert any(
            e["name"] == s["name"]
            and e["ts"] - slack_us <= start_us <= e["ts"] + e["dur"] + slack_us
            for e in events
        ), s


# ---- the solve site ----------------------------------------------------------


def test_fused_route_records_kernel_b_iterations(monkeypatch):
    got = []
    plain = fused.fused_cg_plain

    def spy(*a, **k):
        out = plain(*a, **k)
        got.append(out[1])
        return out

    monkeypatch.setattr(fused, "fused_cg_plain", spy)
    solve = solver("float32", solver="cg", tol=1e-4, max_iters=500, precond="jacobi")
    b = torch.zeros(N, N)
    b[1:-1, 1:-1] = torch.randn(N - 2, N - 2, generator=torch.Generator().manual_seed(3))
    solve(b)
    got.clear()
    profiled(lambda: solve(b))
    (s,) = named(profiling.spans(), "nt.solve")
    assert s["attrs"] == {"solver": "cg", "precond": "jacobi", "route": "fused",
                          "iters": int(got[0])}
    assert 0 < s["attrs"]["iters"] < 500
    root = profiling.spans()[0]
    assert root["name"] == "nt.call" and root["attrs"]["symbol"] == "PoissonSolver.solve"


@pytest.mark.parametrize(
    "kw, route, where",
    [
        ({"solver": "gmres", "precond": "none"}, "generic", "solve"),
        ({"solver": "cg", "precond": "ssor"}, "generic", "solve"),
        ({"solver": "direct", "precond": "none"}, "direct", "direct"),
    ],
    ids=["gmres", "cg_ssor", "direct"],
)
def test_generic_routes_record_the_solvers_iterations(monkeypatch, kw, route, where):
    infos = []
    original = getattr(krylov, where)

    def spy(*a, **k):
        x, info = original(*a, **k)
        infos.append(info)
        return x, info

    monkeypatch.setattr(krylov, where, spy)
    solve = solver("float64", tol=1e-8, max_iters=300, **kw)
    b = torch.randn(N, N, dtype=torch.float64, generator=torch.Generator().manual_seed(5))
    solve(b)
    infos.clear()
    profiled(lambda: solve(b))
    (s,) = named(profiling.spans(), "nt.solve")
    assert s["attrs"]["route"] == route and s["attrs"]["solver"] == kw["solver"]
    assert s["attrs"]["iters"] == infos[0].iters


def test_mixed_route_records_the_inner_iterations(monkeypatch):
    infos = []
    original = refine.refined_solve

    def spy(*a, **k):
        x, info = original(*a, **k)
        infos.append(info)
        return x, info

    monkeypatch.setattr(refine, "refined_solve", spy)
    solve = solver("float64", solver="cg", tol=1e-8, max_iters=200, precond="jacobi",
                   precision="mixed")
    b = torch.randn(N, N, dtype=torch.float64, generator=torch.Generator().manual_seed(7))
    solve(b)
    infos.clear()
    profiled(lambda: solve(b))
    (s,) = named(profiling.spans(), "nt.solve")
    assert s["attrs"] == {"solver": "cg", "precond": "jacobi", "route": "mixed",
                          "iters": infos[0].inner_iters}


# ---- the launch boundary and the record --------------------------------------


@pytest.mark.parametrize("profiling_on", [False, True], ids=["off", "on"])
def test_launch_boundary_counts_clean_launches(profiling_on):
    c = LaunchCounter("probe")

    def launches():
        with c.launch():
            pass
        with pytest.raises(ValueError):
            with c.launch():
                raise ValueError("refused before the launch")

    if profiling_on:
        profiled(launches)
    else:
        launches()
    assert c.count == 1
    spans = profiling.spans()
    assert [s["name"] for s in spans] == (["nt.launch.probe"] * 2 if profiling_on else [])


def test_device_scalars_are_read_after_the_work_and_clear_empties():
    def work():
        with profiling.span("nt.solve") as s:
            s.set(iters=torch.tensor(41, dtype=torch.int32), resnorm=torch.tensor(0.5))
        with profiling.span("user.region"):
            pass

    profiled(work)
    spans = profiling.spans()
    assert spans[0]["attrs"] == {"iters": 41, "resnorm": 0.5}
    assert type(spans[0]["attrs"]["iters"]) is int
    assert spans[1]["request"] == spans[0]["request"] + 1
    profiling.clear()
    assert profiling.spans() == []


def test_threads_keep_their_own_stacks():
    def work():
        def inner():
            with profiling.span("thread.child"):
                pass

        with profiling.span("main.root"):
            t = threading.Thread(target=inner)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive()

    profiled(work)
    spans = {s["name"]: s for s in profiling.spans()}
    assert spans["thread.child"]["parent"] is None
    assert spans["thread.child"]["request"] != spans["main.root"]["request"]


def test_trace_writes_spans_beside_the_chrome_trace(tmp_path):
    op = jacobi()
    u = torch.rand(N, N)
    op(u)
    profiled(lambda: op(u))  # recorded before the trace starts: cleared by it
    with profiling.trace(tmp_path / "prof"):
        with profiling.annotate("two_steps", steps=2):
            op(op(u))
    out = tmp_path / "prof"
    doc = json.loads((out / "trace.json").read_text())
    rows = json.loads((out / "spans.json").read_text())
    assert rows["baseTimeNanoseconds"] == doc.get("baseTimeNanoseconds", 0)
    names = [r["name"] for r in rows["spans"]]
    assert names[0] == "two_steps" and names.count("nt.call") == 2
    assert rows["spans"][0]["attrs"] == {"steps": 2}
    root = rows["spans"][0]
    event = next(e for e in doc["traceEvents"] if e.get("name") == "two_steps")
    assert float(event["ts"]) - 2000 <= root["ts"] <= float(event["ts"]) + float(event["dur"])
    assert all(r["dur"] is not None and r["dur"] >= 0 for r in rows["spans"])
