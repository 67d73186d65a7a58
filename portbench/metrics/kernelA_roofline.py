"""Kernel A's share of its roofline (%): the least time of the calls it
served over its device time in the profiled segment. Read where a call's
work is kernel A's (the cell's `work_kernel` is stencil_apply)."""

from portbench.work import roofline_pct


def read(reading):
    return roofline_pct(reading, "stencil_apply", "nt_apply")
