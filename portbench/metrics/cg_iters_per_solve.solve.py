"""CG iterations per solve of a solving cell: the `iters` of the port's
`nt.solve` spans (on kernel B's route the scalar the kernel wrote, read
after the segment) summed over the profiled segment's solves. Prints each
solve's count beside the reference's, which the run prints before."""

from portbench import program_spans


def read(reading):
    if reading.driver != "solves" or not reading.calls:
        return None
    spans = program_spans.recorded()
    if spans is None:
        return None
    iters = [s["attrs"].get("iters") for s in program_spans.named(spans, "nt.solve")]
    if not iters or None in iters:
        return None
    print(f"program CG iterations on the segment's right-hand sides: {iters}", flush=True)
    return sum(iters) / reading.calls
