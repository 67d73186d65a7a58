"""Linear solves to tolerance, one caller in a closed loop: each solve is
timed from its call to a `synchronize()` after it, and the next starts
after. Right-hand sides come from a pool made from the seed on the device
and are used in turn.

Mix parameters: `precond` (the solve's preconditioner), `pool`,
`warmup_solves`, and `trace_solves`, the solves of the profiled segment.

`solve_ms` is the window's whole length over the solves it completed;
`solve_ms_p95` the 95th percentile of the solves' own times. Every solve
of the window is checked once it has closed.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}
CHUNK = 64  # solves judged per batch by the reference


@dataclass
class State:
    cell: object
    system: object
    device: torch.device
    pool: torch.Tensor
    xs: list = field(default_factory=list)  # the window's answers, in order


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cell, program):
    return program.solver(cell.cfg, cell.mix["precond"])


def control(cell, reference):
    cfg = cell.cfg
    return reference.lower_precision_solver(cfg["interior"], cfg["tol"], cfg["max_iters"])


def faults(system) -> dict:
    """The faults a solving cell can have, each put in the program's place:
    the solver's state returned unchanged (x0 = 0), one answer altered."""

    def altered(b):
        x = system(b).clone()
        x[tuple(n // 2 for n in x.shape)] += 1.0
        return x

    return {"unchanged": torch.zeros_like, "altered": altered}


def setup(cell, system, seed: int, device, seconds: float) -> State:
    """The pool of right-hand sides (standard normal on every cell: the
    ring's values are the boundary data), the solve warmed up on it, memory
    for the window's answers taken before the window."""
    cfg, mix = cell.cfg, cell.mix
    shape = tuple(h - l for l, h in zip(*cfg["bounds"]))
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pool = torch.randn((mix["pool"], *shape), generator=gen, device=device, dtype=dtype)
    state = State(cell, system, device, pool)
    took = 0.0
    for i in range(mix["warmup_solves"]):
        t = time.perf_counter()
        system(pool[i % mix["pool"]])
        sync(device)
        took = time.perf_counter() - t
    # the caching allocator keeps these blocks, so holding every answer
    # asks it for no new memory inside the window
    expect = int(1.5 * seconds / max(took, 1e-3)) + 8
    spare = [torch.empty(shape, dtype=dtype, device=device) for _ in range(expect)]
    del spare
    sync(device)
    return state


def window(state: State, seconds: float) -> dict:
    system, pool, device = state.system, state.pool, state.device
    times = []
    sync(device)
    t0 = time.perf_counter()
    end = t0 + seconds
    i = 0
    while True:
        s = time.perf_counter()
        x = system(pool[i % len(pool)])
        sync(device)
        e = time.perf_counter()
        times.append(e - s)
        state.xs.append(x)
        i += 1
        if e >= end:
            break
    p95 = statistics.quantiles(times, n=20, method="inclusive")[18] if i > 1 else times[0]
    return {
        "metrics": {"solve_ms": (e - t0) * 1e3 / i, "solve_ms_p95": p95 * 1e3},
        "attempted": i,
        "window_s": e - t0,
    }


def segment(state: State) -> int:
    """The profiled segment: `trace_solves` solves, each in a span."""
    from torch.profiler import record_function

    n = state.cell.mix["trace_solves"]
    for i in range(n):
        with record_function("portbench.solve"):
            state.system(state.pool[i % len(state.pool)])
            sync(state.device)
    return n


def host_spans(state: State) -> list:
    return []


def work(state: State, reference, work_mod):
    """The work of one solve of the segment: the reference's own CG, in
    float64, on each of the segment's right-hand sides sets the iterations."""
    cfg = state.cell.cfg
    n = state.cell.mix["trace_solves"]
    iters = [
        reference.cg(state.pool[i % len(state.pool)], cfg["interior"], cfg["tol"],
                     cfg["max_iters"], torch.float64)[1]
        for i in range(n)
    ]
    print(f"reference CG iterations on the segment's right-hand sides: {iters}", flush=True)
    return work_mod.cg_solve(cfg, reference.FLOPS_PER_CELL, reference.CG_FLOPS_PER_CELL,
                             sum(iters) / n)


def check(state: State, reference, limits: dict) -> tuple:
    """Every answer of the window judged by the reference's residual:
    ([(name, value)], answers over the limit, notes)."""
    interior, pool, xs = state.cell.cfg["interior"], state.pool, state.xs
    rels = []
    for c in range(0, len(xs), CHUNK):
        idx = torch.arange(c, min(c + CHUNK, len(xs)), device=pool.device) % len(pool)
        rels.append(reference.rel_residuals(torch.stack(xs[c:c + CHUNK]), pool[idx], interior))
    rel = torch.cat(rels)
    worst = rel.max().item()
    failed = int((rel > limits["max_rel_residual"]).sum().item())
    top = [round(v, 7) for v in rel.topk(min(5, len(rel))).values.tolist()]
    notes = [f"{len(xs)} solves: relative residual median {rel.median().item()!r}, "
             f"max {worst!r}, the five largest {top}"]
    xs.clear()
    return [("max_rel_residual", worst)], failed, notes
