"""Host microseconds per V-cycle in HPCG's cell: the mean duration of the
port's `nt.mg.cycle` spans in the profiled segment (from the cycle's call
to its last launch queued)."""

from portbench import program_spans


def read(reading):
    if reading.driver != "hpcg":
        return None
    spans = program_spans.recorded()
    if spans is None:
        return None
    cycles = program_spans.named(spans, "nt.mg.cycle")
    if not cycles:
        return None
    return program_spans.total_us(spans, "nt.mg.cycle") / len(cycles)
