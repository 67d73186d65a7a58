"""CUDA kernels per solve in the profiled segment of a solving cell."""


def read(reading):
    if reading.driver != "solves" or not reading.calls:
        return None
    n = reading.trace.kernel_count()
    return n / reading.calls if n else None
