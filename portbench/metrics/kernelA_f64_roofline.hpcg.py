"""Kernel A's share of its roofline (%) in float64, in HPCG's cell: the least
time of the profiled segment's float64 launches (each `nt.launch.
stencil_apply` span's `cells` times its `grids` times 8 bytes, over
3.35 TB/s), summed, over kernel A's device time there. Read where the
cell's driver is HPCG's and the program's launch spans carry their
sizes."""

from portbench import program_spans, work_hpcg

LAUNCH = "nt.launch.stencil_apply"


def read(reading):
    if reading.driver != "hpcg":
        return None
    spans = program_spans.recorded()
    if spans is None:
        return None
    sized = [s["attrs"] for s in program_spans.named(spans, LAUNCH)
             if s["attrs"].get("itemsize") == 8]
    device_s = reading.trace.kernel_seconds("nt_apply")
    if not sized or not device_s:
        return None
    least = sum(work_hpcg.apply_least_s(a["cells"], a["grids"], a["itemsize"]) for a in sized)
    print(f"segment: {len(sized)} float64 kernel-A launches, least {least!r} s, "
          f"device {device_s!r} s", flush=True)
    return 100.0 * least / device_s
