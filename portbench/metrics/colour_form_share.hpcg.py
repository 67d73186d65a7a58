"""Share (%) of kernel A's float64 launches in HPCG's cell that run its
colour form: of the profiled segment's `nt.launch.stencil_apply` spans of
8-byte elements, those whose `form` is "colour". A program whose launch
spans carry no `form` reads 0. Read where the cell's driver is HPCG's."""

from portbench import program_spans

LAUNCH = "nt.launch.stencil_apply"


def read(reading):
    if reading.driver != "hpcg":
        return None
    spans = program_spans.recorded()
    if spans is None:
        return None
    f64 = [s["attrs"] for s in program_spans.named(spans, LAUNCH)
           if s["attrs"].get("itemsize") == 8]
    if not f64:
        return None
    return 100.0 * sum(a.get("form") == "colour" for a in f64) / len(f64)
