"""Profiling + solver observability.

The port of `neptune_tpu/utils/profiling.py`. The reference's only
observability is PETSc's per-solve convergence printout (iterations /
residual norm / converged reason, `NeptunePETScRuntime.cpp:345-359,
402-416`). Equivalents here:

  * ``report_solve`` — one KSP/SNES-style convergence line, printed on the
    host (the solvers test convergence there), enabled per op with
    verbose=True or for every solve with NEPTUNE_TORCH_VERBOSE=1;
  * ``trace`` — a context manager around ``torch.profiler.profile`` (CPU
    activity, and CUDA activity when a card is present) that writes a
    Chrome trace (`trace.json`) and the port's spans (`spans.json`) into a
    directory;
  * ``span`` (public name ``annotate``) — a named span at a layer boundary.

Spans are on exactly while a `torch.profiler` profile runs
(`torch.autograd.profiler._is_profiler_enabled`); there is no other switch.
Off, `span` returns one shared object that does nothing. On, a span opens a
RecordFunction of its name, so it lands in the profiler's trace, and is
kept in memory with its start and end (`time.time_ns()`, the clock the
trace's `ts` + `baseTimeNanoseconds` follow), its parent, a request id (each
root span opens one, its children inherit it) and its attributes. Device
tensors held as attributes are read back by `spans()`, after the work.

The port's spans (PERF.md §3 names the metric each feeds):

  * ``nt.call`` — an eager opdef call (`OpDef.__call__`) or a `jit_class`
    method call: the DSL frontend;
  * ``nt.run`` — each callable the executor hands out; nested ones nest;
  * ``nt.solve`` — the executor's solve site (`solver`, `precond`, `route`:
    fused, generic, direct or mixed, and `iters`: kernel B's own device
    scalar on the fused route);
  * ``nt.launch.<counter>`` — a kernel launch wrapper, from its argument
    checks to the return of its C call, where its `LaunchCounter` counts.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from pathlib import Path

import torch
import torch.autograd.profiler as _autograd_profiler

VERBOSE_ENV = "NEPTUNE_TORCH_VERBOSE"


def verbose_default() -> bool:
    """Whether every solve prints its convergence line (NEPTUNE_TORCH_VERBOSE=1)."""
    return os.environ.get(VERBOSE_ENV, "0") == "1"


def report_solve(kind: str, name: str, info) -> None:
    """One KSP/SNES-style convergence line, as the JAX package prints it."""
    print(
        f"[neptune] {kind} {name}: iters={info.iters} resnorm={info.resnorm:.3e} "
        f"converged={info.converged}"
    )


# ---- spans -------------------------------------------------------------------

# A span's trace event: the RecordFunction that torch's own generated code
# opens (`_RecordFunctionFast`, a `cpu_op` event). A whole span costs 2.8-4.1
# us under a profiler with it and 19.6 us with `record_function` (a
# `user_annotation`), on the host of an H100 machine (torch 2.11); the latter
# serves where a torch build lacks the former
_record_function = getattr(torch._C._profiler, "_RecordFunctionFast",
                           torch.profiler.record_function)
_record: list = []  # the spans opened while a profiler ran, in the order they opened
_open = threading.local()  # .stack: this thread's open spans, innermost last
_requests = itertools.count(1)


class _Off:
    """The span while no profiler runs: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def set(self, **attrs) -> None:
        pass


OFF = _Off()


class _Span:
    """One span while a profiler runs. `counter`, a `LaunchCounter`, closes
    with it."""

    __slots__ = ("name", "attrs", "parent", "request", "start_ns", "end_ns", "counter", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.parent = self.request = self.start_ns = self.end_ns = self.counter = None

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span (a solve's iterations)."""
        self.attrs.update(attrs)

    def __enter__(self):
        self._rf = _record_function(self.name)
        self._rf.__enter__()
        stack = _stack()
        if stack:
            self.parent, self.request = stack[-1], stack[-1].request
        else:
            self.request = next(_requests)
        stack.append(self)
        _record.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end_ns = time.time_ns()
        _stack().pop()  # spans close innermost first: `with` nests them
        self._rf.__exit__(exc_type, exc, tb)
        self._rf = None
        if self.counter is not None:
            self.counter.__exit__(exc_type, exc, tb)
        return False


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def span(name: str, **attrs):
    """A span named `name` with attributes `attrs`, as a context manager
    whose `set(**attrs)` adds attributes; the shared no-op `OFF` while no
    profiler runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return OFF
    return _Span(name, attrs)


annotate = span  # a named span inside a trace: the name user code has for `span`


def clear() -> None:
    """Forget the recorded spans."""
    _record.clear()


def _read_back(spans: list) -> None:
    """Replace each tensor attribute by its value: one read per device and
    dtype, after the work."""
    groups: dict = {}
    for s in spans:
        for k, v in s.attrs.items():
            if isinstance(v, torch.Tensor):
                groups.setdefault((v.device, v.dtype), []).append((s, k, v))
    for items in groups.values():
        values = torch.stack([v.detach().reshape(()) for _, _, v in items]).tolist()
        for (s, k, _), value in zip(items, values):
            s.attrs[k] = value


def spans() -> list:
    """The recorded spans, in the order they opened, as dicts: `name`,
    `start_ns` and `end_ns` (None while open), `parent` (the parent's
    index in this list, or None for a root), `request` and `attrs`."""
    record = list(_record)
    _read_back(record)
    index = {id(s): i for i, s in enumerate(record)}
    return [
        {
            "name": s.name,
            "start_ns": s.start_ns,
            "end_ns": s.end_ns,
            "parent": None if s.parent is None else index.get(id(s.parent)),
            "request": s.request,
            "attrs": dict(s.attrs),
        }
        for s in record
    ]


def _json_value(v):
    return v if isinstance(v, (bool, int, float, str)) or v is None else str(v)


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed block and write a Chrome trace (`trace.json`)
    and the port's spans (`spans.json`, times in microseconds on
    `trace.json`'s axis) into `logdir`; yields the `torch.profiler.profile`.

    with neptune_tpu_torch.utils.profiling.trace("prof"):
        step(u)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    clear()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
    base = json.loads((out / "trace.json").read_text()).get("baseTimeNanoseconds", 0)
    rows = [
        {
            "name": s["name"],
            "ts": (s["start_ns"] - base) / 1e3,
            "dur": None if s["end_ns"] is None else (s["end_ns"] - s["start_ns"]) / 1e3,
            "parent": s["parent"],
            "request": s["request"],
            "attrs": {k: _json_value(v) for k, v in s["attrs"].items()},
        }
        for s in spans()
    ]
    (out / "spans.json").write_text(json.dumps({"baseTimeNanoseconds": base, "spans": rows}))
