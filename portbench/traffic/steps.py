"""Explicit time stepping: `u = op(u)` back to back, as a time-stepping loop
calls it, the state left on the card.

Mix parameters: `sweeps` (steps per call: 1 calls the opdef, k > 1 calls
`ntt.sweeps(op, k)`), `warmup_calls`, `sample_calls` calls drawn from the
seed among the window's first `sample_from` (checked, with the window's
last call and the first call from the seeded state), `host_bursts` bursts
of `host_burst_calls` calls timed one by one on the host (traced runs), and
`trace_calls`, the calls of the profiled segment.

The window's `step_ms` is its whole length over the steps it completed: the
clock is read after the `synchronize()` that follows the last call, so the
queued work counts. A call of k sweeps counts k steps.
"""

from __future__ import annotations

import math
import random
import time
from dataclasses import dataclass, field

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


@dataclass
class State:
    cell: object
    system: object
    device: torch.device
    u: torch.Tensor
    sample: frozenset
    kept: list = field(default_factory=list)  # (label, input, output) of checked calls


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cell, program):
    return program.stepper(cell.cfg, cell.mix["sweeps"])


def control(cell, reference):
    return reference.lower_precision_stepper(cell.cfg["interior"], cell.mix["sweeps"])


def faults(system) -> dict:
    """The faults a stepping cell can have, each put in the program's place."""

    def altered(u):
        v = system(u).clone()
        v[tuple(n // 2 for n in v.shape)] += 1.0
        return v

    return {"unchanged": lambda u: u, "altered": altered}


def setup(cell, system, seed: int, device, seconds: float) -> State:
    """The initial state from the seed, on the device; the cell's one shape
    warmed up; memory for the checked calls taken before the window."""
    shape = tuple(h - l for l, h in zip(*cell.cfg["bounds"]))
    dtype = DTYPES[cell.cfg["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u0 = torch.rand(shape, generator=gen, device=device, dtype=dtype)
    mix = cell.mix
    picks = random.Random(seed).sample(range(1, mix["sample_from"]), mix["sample_calls"])
    state = State(cell, system, device, u0, frozenset(picks))
    u = system(u0)
    state.kept.append(("first call, from the seeded state", u0, u))
    for _ in range(mix["warmup_calls"] - 1):
        u = system(u)
    state.u = u
    # the caching allocator keeps these blocks: holding a checked call's
    # input and output asks it for no new memory inside the window
    spare = [torch.empty_like(u) for _ in range(2 * len(picks) + 4)]
    del spare
    sync(device)
    return state


def window(state: State, seconds: float) -> dict:
    system, u, device = state.system, state.u, state.device
    n, prev = 0, None
    sync(device)
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        v = system(u)
        if n in state.sample:
            state.kept.append((f"window call {n}", u, v))
        prev, u = u, v
        n += 1
        if time.perf_counter() >= end:
            break
    sync(device)
    t1 = time.perf_counter()
    if n - 1 not in state.sample:
        state.kept.append((f"window call {n - 1}, the last", prev, u))
    state.u = u
    steps = n * state.cell.mix["sweeps"]
    return {"metrics": {"step_ms": (t1 - t0) * 1e3 / steps}, "attempted": n, "window_s": t1 - t0}


def segment(state: State) -> int:
    """The profiled segment: `trace_calls` calls, each in a span."""
    from torch.profiler import record_function

    u = state.u
    n = state.cell.mix["trace_calls"]
    for _ in range(n):
        with record_function("portbench.call"):
            u = state.system(u)
    state.u = u
    return n


def host_spans(state: State) -> list:
    """Host seconds of each call in short bursts, each burst after a
    synchronize, so the launch queue never fills and a call's span is its
    host work alone."""
    mix, u = state.cell.mix, state.u
    spans = []
    for _ in range(mix["host_bursts"]):
        sync(state.device)
        for _ in range(mix["host_burst_calls"]):
            t = time.perf_counter()
            u = state.system(u)
            spans.append(time.perf_counter() - t)
    sync(state.device)
    state.u = u
    return spans


def work(state: State, reference, work_mod):
    """The work of one call."""
    return work_mod.stencil_call(state.cell.cfg, reference.FLOPS_PER_CELL, state.cell.mix["sweeps"])


def check(state: State, reference, limits: dict) -> tuple:
    """Each checked call against the reference from the call's own input:
    ([(name, value)], answers over the limit, notes)."""
    state.u = None  # the program's running state is no longer needed
    interior, k = state.cell.cfg["interior"], state.cell.mix["sweeps"]
    worst, failed, notes = 0.0, 0, []
    for label, a, b in state.kept:
        want = reference.steps(a, interior, k)
        if b.shape != want.shape:
            d = math.inf
        else:
            d = torch.nan_to_num((b.to(want.dtype) - want).abs(), nan=math.inf).max().item()
        worst = max(worst, d)
        failed += d > limits["max_abs_diff"]
        notes.append(f"{label}: max |program - reference| {d!r}")
    state.kept.clear()
    return [("max_abs_diff", worst)], failed, notes
