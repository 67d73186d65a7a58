"""Share (%) of HPCG's CG iterations whose vector update ran as the CG
vector kernels: the profiled segment's `nt.launch.cg_vectors` spans whose
`step` is "update", over the iterations its `nt.solve` spans report. A
program without those kernels, which records no such span, reads 0. Read
where the cell's driver is HPCG's."""

from portbench import program_spans

LAUNCH = "nt.launch.cg_vectors"


def read(reading):
    if reading.driver != "hpcg":
        return None
    spans = program_spans.recorded()
    if spans is None:
        return None
    iters = [s["attrs"].get("iters") for s in program_spans.named(spans, "nt.solve")]
    if not iters or None in iters or not sum(iters):
        return None
    updates = sum(s["attrs"].get("step") == "update" for s in program_spans.named(spans, LAUNCH))
    return 100.0 * updates / sum(iters)
