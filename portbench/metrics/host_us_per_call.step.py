"""Host microseconds per call of a stepping cell: the mean of the harness's
own spans around single calls (host clock, no synchronize inside a span,
the launch queue never full)."""


def read(reading):
    if reading.driver != "steps" or not reading.host_spans_s:
        return None
    return 1e6 * sum(reading.host_spans_s) / len(reading.host_spans_s)
