"""Host microseconds per solve of a solving cell from the call to its
kernel queued: the mean duration of the port's root spans (the `jit_class`
method's `nt.call`, which returns once the solve is queued) over the
profiled segment's solves. A closed loop's card is idle through it."""

from portbench import program_spans


def read(reading):
    if reading.driver != "solves" or not reading.calls:
        return None
    spans = program_spans.recorded()
    if spans is None:
        return None
    roots = program_spans.roots(spans)
    if not roots:
        return None
    return sum(map(program_spans.duration_us, roots)) / reading.calls
