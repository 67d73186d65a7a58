"""The work of one call, counted from the problem and never from the port's
plans, and the least time the card could take for it.

Each input byte is read once and each output byte written once per call,
whatever the kernel reads again, also for K sweeps and for a whole solve;
operations are the stencil's per interior cell and step, and a solve's are
its iterations (the plain reference's count) times one iteration's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense rates, at its 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS_PER_S = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8, "bfloat16": 2}


@dataclass(frozen=True)
class Work:
    flops: float
    bytes: float
    dtype: str

    def least_s(self) -> float:
        """The larger of bytes over peak bandwidth and operations over peak
        rate: the least time the card could take."""
        return max(self.bytes / PEAK_BYTES_PER_S, self.flops / PEAK_FLOPS_PER_S[self.dtype])

    def bound(self) -> str:
        return "bytes" if self.bytes / PEAK_BYTES_PER_S >= self.flops / PEAK_FLOPS_PER_S[
            self.dtype] else "operations"


def box_cells(lo, hi) -> int:
    return math.prod(h - l for l, h in zip(lo, hi))


def stencil_call(cfg: dict, flops_per_cell: int, k: int) -> Work:
    """k steps of a stencil in one call: the grid read once and written once,
    the stencil's operations on every interior cell k times."""
    grid = box_cells(*cfg["bounds"])
    return Work(
        flops=float(k * flops_per_cell * box_cells(*cfg["interior"])),
        bytes=float(2 * grid * ITEMSIZE[cfg["dtype"]]),
        dtype=cfg["dtype"],
    )


def cg_solve(cfg: dict, matvec_flops_per_cell: int, other_flops_per_cell: int, iters: int) -> Work:
    """A whole CG solve in one call: b read and x written once, and `iters`
    iterations of a matvec on the interior plus the vector work on every
    cell."""
    grid = box_cells(*cfg["bounds"])
    per_iter = matvec_flops_per_cell * box_cells(*cfg["interior"]) + other_flops_per_cell * grid
    return Work(
        flops=float(iters * per_iter),
        bytes=float(2 * grid * ITEMSIZE[cfg["dtype"]]),
        dtype=cfg["dtype"],
    )


def roofline_pct(reading, counter: str, kernel: str):
    """The kernel's share of its roofline in a traced run: the least time of
    the calls it served over its device time, in percent; None where the
    cell's work is not this kernel's or the trace shows none of it."""
    if reading.work is None or reading.work_kernel != counter:
        return None
    device_s = reading.trace.kernel_seconds(kernel)
    if not device_s:
        return None
    return 100.0 * reading.work.least_s() * reading.calls / device_s
