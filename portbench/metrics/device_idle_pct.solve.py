"""The device's idle share (%) of the profiled segment of a solving cell:
the time in which no kernel, copy or fill ran."""


def read(reading):
    if reading.driver != "solves" or reading.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - reading.trace.busy_s / reading.trace.window_s)
