"""HPCG's timed sets: one caller in a closed loop, each solve 50 iterations
of multigrid-preconditioned CG from x = 0 (the configuration's solver,
tolerance 0 and options), timed from its call to a `synchronize()` after
it, the next after. `solves.py`'s window, segment and timing, with a pool
of HPCG's right-hand sides and a check against the reference's own
50-iteration answers.

Mix parameters: `pool` (2: HPCG's own b, then A x* with x* uniform on
[0, 2) from the seed, used in turn), `warmup_solves`, and `trace_solves`,
the solves of the profiled segment.

Each answer of the window is judged against the reference's 50-iteration
answer x_ref for its b: `max_rel_diff`, ||x - x_ref|| / ||x_ref||, and
`max_residual_gap`, |res(x) - res(x_ref)| with res(x) = ||b - A x|| /
||b|| by the reference's operator in float64. The residual is held to the
reference's own for the same b, from above and from below: 50 iterations
of HPCG's PCG reach a residual of their own (5.6e-3 on HPCG's b, 4.5e-4
on the random one at 320^3; the rounding floor on a small grid), and an
answer whose residual differs from it, lower or higher, is another
computation.
"""

from __future__ import annotations

import time

import torch

from portbench.traffic.solves import (  # noqa: F401  (the shared window and segment)
    DTYPES, State, faults, host_spans, segment, sync, window,
)


def grid(cfg: dict) -> tuple:
    """(grid shape, interior as (lo, hi) tuples) of the configuration."""
    (lo, hi), (ilo, ihi) = cfg["bounds"], cfg["interior"]
    return tuple(h - l for l, h in zip(lo, hi)), (tuple(ilo), tuple(ihi))


def levels(cfg: dict) -> int:
    """The configuration's multigrid levels, or as many as its unknowns
    allow where fewer (each coarser level halves every extent)."""
    extents = [h - l for l, h in zip(*cfg["interior"])]
    n = 1
    while n < cfg["options"]["mg_levels"] and all(e % 2**n == 0 for e in extents):
        n += 1
    return n


def build(cell, program):
    cfg = cell.cfg
    return program.solver(cfg, dict(cfg["options"], mg_levels=levels(cfg)))


def control(cell, reference):
    cfg = cell.cfg
    return reference.lower_precision_solver(grid(cfg)[1], cfg["max_iters"], levels(cfg))


def setup(cell, system, seed: int, device, seconds: float) -> State:
    """The pool of right-hand sides, made on the device, the solve warmed
    up on it (which builds the hierarchy and its kernels), memory for the
    window's answers taken before the window."""
    from portbench.reference import hpcg27 as reference

    cfg, mix = cell.cfg, cell.mix
    shape, interior = grid(cfg)
    dtype = DTYPES[cfg["dtype"]]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    made = [reference.hpcg_rhs(shape, interior, dtype, device)]
    while len(made) < mix["pool"]:
        made.append(reference.random_rhs(shape, interior, gen, dtype, device))
    state = State(cell, system, device, torch.stack(made))
    del made
    took = 0.0
    for i in range(mix["warmup_solves"]):
        t = time.perf_counter()
        system(state.pool[i % mix["pool"]])
        sync(device)
        took = time.perf_counter() - t
    # the caching allocator keeps these blocks, so holding every answer
    # asks it for no new memory inside the window
    expect = int(1.5 * seconds / max(took, 1e-3)) + 8
    spare = [torch.empty(shape, dtype=dtype, device=device) for _ in range(expect)]
    del spare
    sync(device)
    return state


def check(state: State, reference, limits: dict) -> tuple:
    """Every answer of the window judged against the reference's answer for
    its right-hand side (computed once for each, in float64) and by its
    true residual: ([(name, value)], answers over a limit, notes)."""
    cfg = state.cell.cfg
    interior = grid(cfg)[1]
    pool, xs = state.pool, state.xs
    t = time.perf_counter()
    refs = [reference.pcg(b.double(), interior, cfg["max_iters"], levels(cfg)) for b in pool]
    sync(state.device)
    ref_s = time.perf_counter() - t
    res_ref = [reference.rel_residuals(x[None], b[None], interior).item()
               for x, b in zip(refs, pool)]
    res, gap, diff = [], [], []
    for i, x in enumerate(xs):
        b, xr, rr = pool[i % len(pool)], refs[i % len(pool)], res_ref[i % len(pool)]
        res.append(reference.rel_residuals(x[None], b[None], interior).item())
        gap.append(abs(res[-1] - rr))
        diff.append(reference.rel_diffs(x[None], xr[None]).item())
    failed = sum(g > limits["max_residual_gap"] or d > limits["max_rel_diff"]
                 for g, d in zip(gap, diff))
    notes = [
        f"{len(xs)} solves: relative residual max {max(res)!r} min {min(res)!r} (the "
        f"reference's on the pool {res_ref!r}), its gap from the reference's max {max(gap)!r}; "
        f"relative difference from the reference's answer max {max(diff)!r} min {min(diff)!r}; "
        f"the reference's answers took {ref_s!r} s",
    ]
    xs.clear()
    return [("max_residual_gap", max(gap)), ("max_rel_diff", max(diff))], failed, notes
