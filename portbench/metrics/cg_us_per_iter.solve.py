"""Kernel B's device microseconds per CG iteration: its kernels' device time
in the profiled segment over the iterations that the port's `nt.solve`
spans on kernel B's route (`route` fused) report for the segment."""

from portbench import program_spans


def read(reading):
    if reading.driver != "solves":
        return None
    spans = program_spans.recorded()
    if spans is None:
        return None
    iters = [s["attrs"].get("iters") for s in program_spans.named(spans, "nt.solve")
             if s["attrs"].get("route") == "fused"]
    device_s = reading.trace.kernel_seconds("nt_fused_cg")
    if not iters or None in iters or not sum(iters) or not device_s:
        return None
    return 1e6 * device_s / sum(iters)
