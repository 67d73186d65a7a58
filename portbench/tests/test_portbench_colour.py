"""`colour_form_share.hpcg` on synthetic span lists: 0 where the launch
spans carry no `form`, 5712/5917 on HPCG's counts a solve (51 V-cycles of
112 colour passes, against 5,917 float64 kernel-A launches), float32
launches left out, and nothing outside HPCG's cell or without spans."""

import pytest

from portbench import devtrace, harness

CELL = "hpcg320_mgcg_f64"
METRIC = "colour_form_share.hpcg"


def launch(i, **attrs):
    return {"name": "nt.launch.stencil_apply", "start_ns": 1000 * i, "end_ns": 1000 * i + 500,
            "parent": None, "request": 1, "attrs": attrs}


def solve_spans(form: bool):
    """One solve's float64 launches, the colour passes sized as the colour
    form's (and marked, where `form`), and one float32 launch."""
    colour = dict(cells=160**3, grids=11, itemsize=8, form="colour") if form else dict(
        cells=322**3, grids=4, itemsize=8)
    out = [launch(i, **colour) for i in range(5712)]
    out += [launch(5712 + i, cells=322**3, grids=2, itemsize=8) for i in range(205)]
    return out + [launch(6000, cells=1000, grids=2, itemsize=4)]


def reading(cell=CELL):
    trace = devtrace.Trace(device=[("kernel", "void nt_apply_colour_kernel<B, P, int>()",
                                    0.0, 1.0)], host=[], start_us=0.0, end_us=10.0)
    return harness.Reading(harness.load_cell(cell), 1, trace, [], None)


@pytest.mark.parametrize("form, want", [(False, 0.0), (True, 100 * 5712 / 5917)])
def test_share_on_hpcgs_counts(monkeypatch, form, want):
    from neptune_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: solve_spans(form))
    assert harness.metric_reader(METRIC)(reading()) == pytest.approx(want)


def test_nothing_outside_the_cell_or_without_spans(monkeypatch):
    from neptune_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: solve_spans(True))
    assert harness.metric_reader(METRIC)(reading("poisson512_cg_jacobi")) is None
    monkeypatch.setattr(profiling, "spans", lambda: [launch(0, cells=10, grids=2, itemsize=4)])
    assert harness.metric_reader(METRIC)(reading()) is None
    monkeypatch.delattr(profiling, "spans")
    assert harness.metric_reader(METRIC)(reading()) is None
