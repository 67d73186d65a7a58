"""Host microseconds per call of a stepping cell in the DSL frontend: the
self time of the port's `nt.call` spans (`OpDef.__call__`'s eager branch:
each one's duration less its `nt.run` children) over the profiled
segment's calls."""

from portbench import program_spans


def read(reading):
    if reading.driver != "steps" or not reading.calls:
        return None
    spans = program_spans.recorded()
    if spans is None or not program_spans.named(spans, "nt.call"):
        return None
    return program_spans.self_us(spans, "nt.call") / reading.calls
