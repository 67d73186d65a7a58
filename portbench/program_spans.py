"""The port's own spans in a traced run: what the program recorded while
the profiled segment ran (`neptune_tpu_torch.utils.profiling.spans()`,
which records only while a profiler runs), summed as the per-layer metrics
read them. A span is a dict with `name`, `start_ns`, `end_ns`, `parent`
(an index into the same list, or None for a root), `request` and `attrs`.

`recorded()` is None where the program has no `spans` (a port that
records none), and every metric that reads it then reports nothing.
"""

from __future__ import annotations


def recorded():
    """The closed spans the program recorded, or None where it records none."""
    try:
        from neptune_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    spans = read()
    if not spans or any(s["end_ns"] is None for s in spans):
        return None
    return spans


def duration_us(s) -> float:
    return (s["end_ns"] - s["start_ns"]) / 1e3


def named(spans, name: str) -> list:
    return [s for s in spans if s["name"] == name]


def total_us(spans, name: str) -> float:
    """The summed duration (us) of the spans named `name`."""
    return sum(duration_us(s) for s in named(spans, name))


def self_us(spans, name: str) -> float:
    """The summed self time (us) of the spans named `name`: each one's
    duration less the durations of its child spans."""
    children = [0.0] * len(spans)
    for s in spans:
        if s["parent"] is not None:
            children[s["parent"]] += duration_us(s)
    return sum(duration_us(s) - children[i] for i, s in enumerate(spans) if s["name"] == name)


def roots(spans) -> list:
    return [s for s in spans if s["parent"] is None]
