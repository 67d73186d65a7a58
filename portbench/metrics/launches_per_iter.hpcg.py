"""CUDA kernels per CG iteration in HPCG's cell: the kernels of the profiled
segment over the iterations its `nt.solve` spans report."""

from portbench import program_spans


def read(reading):
    if reading.driver != "hpcg":
        return None
    spans = program_spans.recorded()
    if spans is None:
        return None
    iters = [s["attrs"].get("iters") for s in program_spans.named(spans, "nt.solve")]
    n = reading.trace.kernel_count()
    if not iters or None in iters or not sum(iters) or not n:
        return None
    return n / sum(iters)
