"""HPCG's solve against its roofline (%): a solve's least time, counted from
HPCG's algorithm (`work_hpcg.solve_work`: the matrix-free minimum of vector
passes on every level, HPCG's operation count beside it), over the
device's busy time a solve in the profiled segment."""

from portbench import work_hpcg
from portbench.traffic.hpcg import grid, levels


def read(reading):
    if reading.driver != "hpcg" or not reading.calls or not reading.trace.busy_s:
        return None
    cfg = reading.cell.cfg
    w = work_hpcg.solve_work(grid(cfg)[1], levels(cfg), cfg["max_iters"], cfg["dtype"])
    print(f"work a solve: {w.flops!r} operations (HPCG's count), {w.bytes!r} bytes, least "
          f"{w.least_s()!r} s, bound by {w.bound()}", flush=True)
    return 100.0 * w.least_s() * reading.calls / reading.trace.busy_s
