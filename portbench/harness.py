"""One run of one cell: the cell found by name, its system built through
the port, set up and warmed, measured for a window, judged against the
plain reference, and reported as one JSON line.

A cell is an entry of `BENCHMARK.json`'s `workloads`; its files, found by
name: `configs/` (through the configuration's `file`), `traffic/<mix>.json`
and the driver it names (`traffic/<driver>.py`), `workloads/<cell>.json`
(the work kernel, the route and the limits), `programs/` and `reference/`
(through the configuration's `program`), and `metrics/<metric>.py` for
each per-layer metric.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from portbench import devtrace
from portbench import work as work_mod

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "neptune_tpu")


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    cfg: dict
    mix: dict
    spec: dict  # workloads/<cell>.json
    end_to_end: list
    per_layer: list


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    cfg = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((HERE / "traffic" / f"{entry['traffic']}.json").read_text())
    spec = json.loads((HERE / "workloads" / f"{name}.json").read_text())
    if (spec["config"], spec["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names another configuration or mix "
                         "than BENCHMARK.json")

    def mine(m):
        return name in m.get("workloads", [name])

    return Cell(name, entry, cfg, mix, spec,
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def modules(cell: Cell):
    """(driver, program, reference) of a cell."""
    return (importlib.import_module(f"portbench.traffic.{cell.mix['driver']}"),
            importlib.import_module(f"portbench.programs.{cell.cfg['program']}"),
            importlib.import_module(f"portbench.reference.{cell.cfg['program']}"))


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def launch_counters() -> dict:
    """The port's LaunchCounters by name, from every loaded module of it."""
    from neptune_tpu_torch.kernels.build import LaunchCounter
    from neptune_tpu_torch.lowering import cuda_backend, sweeps  # noqa: F401  (their counters)
    from neptune_tpu_torch.solvers import fused  # noqa: F401

    found = {}
    for mod_name, mod in list(sys.modules.items()):
        if mod_name.split(".")[0] == "neptune_tpu_torch" and mod is not None:
            for v in vars(mod).values():
                if isinstance(v, LaunchCounter):
                    found[v.name] = v
    return found


@dataclass
class Reading:
    """What a per-layer metric reads: the profiled segment's trace, its
    calls (or solves), the host spans of single calls, the cell's work per
    call and the counter of the kernel that does it."""

    cell: Cell
    calls: int
    trace: devtrace.Trace
    host_spans_s: list
    work: object

    @property
    def driver(self) -> str:
        return self.cell.mix["driver"]

    @property
    def work_kernel(self):
        return self.cell.spec["work_kernel"]


def route_checks(cell: Cell, calls: int, before: dict, after: dict) -> list:
    """The cell's route, by the port's own counters over the window: each
    entry's kernel launched `per_call` times a call (or at least that)."""
    out = []
    for r in cell.spec["route"]:
        got = after[r["counter"]] - before[r["counter"]]
        want = r["per_call"] * calls
        off = abs(got - want) if r["exact"] else max(0, want - got)
        print(f"route: {r['counter']} launched {got} times in {calls} calls "
              f"({'exactly' if r['exact'] else 'at least'} {r['per_call']} a call)", flush=True)
        out.append((f"launches_off.{r['counter']}", off, 0))
    return out


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t0: float,
             device: str = "cuda", cfg: dict | None = None, swap=None) -> tuple:
    """Run the cell once: (result, checks, setup_s). `cfg` replaces the
    cell's configuration (tests, at a small size); `swap(system, driver,
    cell, reference)` gives what runs in the program's place (a control or
    a fault)."""
    import torch

    cell = load_cell(name)
    if cfg is not None:
        cell.cfg = cfg
    driver, program, reference = modules(cell)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    counters = launch_counters() if on_card else {}

    def counts():
        return {k: c.count for k, c in counters.items()}

    system = driver.build(cell, program)
    if swap is not None:
        system = swap(system, driver, cell, reference)
    state = driver.setup(cell, system, seed, dev, seconds)
    setup_s = time.perf_counter() - t0
    before = counts()
    out = driver.window(state, seconds)
    after = counts()
    checks = route_checks(cell, out["attempted"], before, after) if on_card else []

    metrics, extra, breakdown = {}, {}, None
    if not trace:
        peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
        produced = dict(out["metrics"], setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": produced[m["name"]], "unit": m["unit"]}
    else:
        seg_before = counts()
        calls = 0

        def run_segment():
            nonlocal calls
            calls = driver.segment(state)

        tr = devtrace.record(run_segment)
        seg_after = counts()
        for r in cell.spec["route"]:
            got = seg_after[r["counter"]] - seg_before[r["counter"]]
            print(f"segment: {r['counter']} launches {got} by the port's counter, "
                  f"{tr.kernel_count(r['kernel'])} kernels named {r['kernel']} in the trace",
                  flush=True)
        print(f"segment: {calls} calls in {tr.window_s!r} s traced, device busy {tr.busy_s!r} s, "
              f"{tr.kernel_count()} kernels; the window's {out['window_s'] / out['attempted']!r} "
              f"s a call untraced", flush=True)
        spans = driver.host_spans(state)
        peak = torch.cuda.max_memory_allocated(dev)
        work = driver.work(state, reference, work_mod) if cell.spec["work_kernel"] else None
        if work is not None:
            print(f"work a call: {work.flops!r} operations, {work.bytes!r} bytes, least "
                  f"{work.least_s()!r} s, bound by {work.bound()}", flush=True)
        reading = Reading(cell, calls, tr, spans, work)
        for m in cell.per_layer:
            v = metric_reader(m["name"])(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
        breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_by_host()}

    limits = cell.spec["limits"]
    judged, failed, notes = driver.check(state, reference, limits)
    for line in notes:
        print(f"check: {line}", flush=True)
    checks += [(n, v, limits[n]) for n, v in judged]
    correct = failed == 0 and all(v <= lim for _, v, lim in checks)
    result = {
        "correct": correct,
        "attempted": out["attempted"],
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else dev.type,
            "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
            "count": cell.entry["chips"],
            "memory_peak_bytes": peak,
            **extra,
        },
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks, setup_s


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (whole names: `neptune_tpu_torch` is not `neptune_tpu`)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(args, t0: float) -> int:
    """The command: exit 0 and print the result as the last line of standard
    output, or exit non-zero and print no result."""
    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
        print(f"portbench: {args.workload} needs {cell.entry['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    try:
        import neptune_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is missing ({e})", file=sys.stderr)
        return 2
    from neptune_tpu_torch.kernels.build import builder

    result, checks, setup_s = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                       t0=t0)
    print(f"card: {card_line()}", flush=True)
    if builder.build_seconds:
        print(f"setup_s {setup_s!r} in a compiling run: {len(builder.build_seconds)} libraries "
              f"built, {sum(builder.build_seconds.values())!r} nvcc s", flush=True)
    else:
        print(f"setup_s {setup_s!r}, every kernel from the cache", flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
