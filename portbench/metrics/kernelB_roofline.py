"""Kernel B's share of its roofline (%): the least time of the solves it
served (the plain reference's iterations on their right-hand sides) over
its device time in the profiled segment. Read where a solve is kernel B's
(the cell's `work_kernel` is fused_cg)."""

from portbench.work import roofline_pct


def read(reading):
    return roofline_pct(reading, "fused_cg", "nt_fused_cg")
