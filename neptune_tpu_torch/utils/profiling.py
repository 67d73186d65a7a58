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
    Chrome trace into a directory;
  * ``annotate`` — a named span inside a trace
    (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch

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


@contextlib.contextmanager
def trace(logdir):
    """Profile the enclosed block and write a Chrome trace
    (`trace.json`) into `logdir`; yields the `torch.profiler.profile`.

    with neptune_tpu_torch.utils.profiling.trace("prof"):
        step(u)
    """
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


def annotate(name: str):
    """A named span inside a trace."""
    return torch.profiler.record_function(name)
