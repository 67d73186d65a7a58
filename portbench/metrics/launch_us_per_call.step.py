"""Host microseconds per call of a stepping cell in kernel A's launch
wrapper: the duration of the port's `nt.launch.stencil_apply` spans (from
the wrapper's argument checks to the return of its C call) over the
profiled segment's calls. Prints the spans' count, the root spans' mean and
the sum of the three stepping metrics, which is that mean."""

from portbench import program_spans

LAUNCH = "nt.launch.stencil_apply"


def read(reading):
    if reading.driver != "steps" or not reading.calls:
        return None
    spans = program_spans.recorded()
    if spans is None or not program_spans.named(spans, LAUNCH):
        return None
    launch = program_spans.total_us(spans, LAUNCH) / reading.calls
    roots = program_spans.roots(spans)
    parts = (program_spans.self_us(spans, "nt.call") + program_spans.self_us(spans, "nt.run")
             ) / reading.calls + launch
    print(f"segment: {len(program_spans.named(spans, LAUNCH))} {LAUNCH} spans; "
          f"{len(roots)} root spans, {sum(map(program_spans.duration_us, roots)) / len(roots)!r} "
          f"us each; frontend + executor + launch {parts!r} us a call", flush=True)
    return launch
