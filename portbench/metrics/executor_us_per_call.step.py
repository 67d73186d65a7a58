"""Host microseconds per call of a stepping cell in the executor: the summed
self time of the port's `nt.run` spans (each callable the executor hands
out, nested ones apart) over the profiled segment's calls."""

from portbench import program_spans


def read(reading):
    if reading.driver != "steps" or not reading.calls:
        return None
    spans = program_spans.recorded()
    if spans is None or not program_spans.named(spans, "nt.run"):
        return None
    return program_spans.self_us(spans, "nt.run") / reading.calls
