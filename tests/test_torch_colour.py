"""Kernel A's colour form on the CPU: its plain version against the
out-of-place colour pass, which applies take it, the sizes its launch spans
carry, and the symgs V-cycle that runs it in place against the out-of-place
cycle. The kernel itself is held against the same pass on the card
(`tests/test_torch_gpu.py`) and emulated block by block in
`tests/test_torch_tiles.py`."""

import pytest
import torch

from neptune_tpu_torch import config, stencils
from neptune_tpu_torch.lowering import cuda_backend
from neptune_tpu_torch.lowering.executor import CompiledModule, auto_mg_preconditioner
from neptune_tpu_torch.passes.coarsen import coarsen_opdef
from neptune_tpu_torch.passes.smoother import MARK, SUFFIX, colour_pass
from neptune_tpu_torch.solvers import multigrid

NAME = "hpcg27" + SUFFIX


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setattr(config, "device", "cpu")


def _data(shape, seed, dtype=torch.float64):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed), dtype=dtype)


# (grid, element type): odd and even extents, each with the copy-through ring
CASES = {
    "rank3_f64_even": ((10, 12, 14), "float64"),
    "rank3_f64_odd": ((9, 11, 13), "float64"),
    "rank3_f32_odd": ((7, 9, 15), "float32"),
    "rank2_f64_odd": ((21, 33), "float64"),
    "rank2_f32_even": ((20, 26), "float32"),
}


@pytest.mark.parametrize("case", CASES)
def test_plain_colour_form_is_the_colour_pass_in_place(case):
    """For every colour, the form writes into x, and only at the colour's
    cells, exactly what the `__colour` opdef returns."""
    shape, dtype = CASES[case]
    rank = len(shape)
    cm = CompiledModule(colour_pass(stencils.hpcg27(shape, dtype), "hpcg27"), "auto", "cpu")
    form = cm.colour_form(NAME)
    op = stencils.the_apply(cm.module)
    td = getattr(torch, dtype)
    x, b = _data(shape, 1, td), _data(shape, 2, td)
    d = torch.full(shape, 1 / (3**rank - 1), dtype=td)
    for c in range(2**rank):
        want = cm.opdef(NAME)(x, b, d, float(c))
        got = x.clone()
        assert form(got, b, d, float(c)) is got
        assert torch.equal(got, want)
        mask = torch.zeros(shape, dtype=torch.bool)
        mask[tuple(slice(f, f + 2 * n, 2) for f, n in cuda_backend.colour_cells(op, c))] = True
        assert not ((got != x) & ~mask).any() and (got != x).any()
        x = want


@pytest.mark.parametrize("shape, cells, grids", [
    ((322, 322, 322), [160**3] * 8, 11),  # HPCG's finest level: an eighth of 320^3 each
    ((9, 11, 13), [4 * 5 * 6, 4 * 5 * 5, 4 * 4 * 6, 4 * 4 * 5, 3 * 5 * 6, 3 * 5 * 5,
                   3 * 4 * 6, 3 * 4 * 5], 11),
    ((21, 33), [10 * 16, 10 * 15, 9 * 16, 9 * 15], 7),
])
def test_launch_sizes_are_the_colours_cells(shape, cells, grids):
    """A colour-form launch's span: the colour's cells inside the bounds,
    2^rank + 3 grids of them (x read whole, b, 1/diag and x at the colour's
    cells), 8-byte elements, form "colour"."""
    op = stencils.the_apply(colour_pass(stencils.hpcg27(shape), "hpcg27"))
    got = [cuda_backend.colour_sizes(op, c) for c in range(2 ** len(shape))]
    assert [s["cells"] for s in got] == cells
    assert all(s == dict(cells=s["cells"], grids=grids, itemsize=8, form="colour") for s in got)


def test_only_marked_colour_passes_take_the_form():
    """Kernel A's form needs the colour pass's mark and a bounded apply;
    everything else keeps its route, and the eager backend's in-place pass
    is the out-of-place one written into x."""
    module = colour_pass(stencils.hpcg27((10, 10, 10)), "hpcg27")
    op = stencils.the_apply(module)
    assert op.attrs[MARK] == "parity" and cuda_backend.colour_form(op)
    assert not cuda_backend.colour_form(stencils.the_apply(stencils.hpcg27((10, 10, 10))))
    del op.attrs[MARK]
    assert not cuda_backend.colour_form(op)
    periodic = stencils.the_apply(colour_pass(stencils.heat7((8, 8, 8), "float64",
                                                             periodic=True), "heat"))
    assert not cuda_backend.colour_form(periodic)
    fresh = colour_pass(stencils.hpcg27((10, 10, 10)), "hpcg27")
    x, b, d = (_data((10,) * 3, s) for s in (1, 2, 3))
    want = CompiledModule(fresh, "auto", "cpu").opdef(NAME)(x, b, d, 6.0)
    for backend in ("auto", "torch"):
        got = x.clone()
        assert CompiledModule(fresh, backend, "cpu").colour_form(NAME)(got, b, d, 6.0) is got
        assert torch.equal(got, want)
        with pytest.raises(ValueError, match="is not one of 0..7"):
            CompiledModule(fresh, backend, "cpu").colour_form(NAME)(x, b, d, 8.0)
    with pytest.raises(ValueError, match="is not a colour pass"):
        CompiledModule(stencils.hpcg27((10, 10, 10)), "auto", "cpu").colour_form("hpcg27")


def _hpcg_levels(shape, n_levels, device, monkeypatch):
    """HPCG's preconditioner on `shape`, the levels it built, and the same
    levels with each colour pass out of place, its result taking x's
    place, as the cycle ran before the colour form."""
    built = []
    real = multigrid.build_levels
    monkeypatch.setattr(multigrid, "build_levels",
                        lambda *a, **k: built.append(real(*a, **k)) or built[-1])
    cm = CompiledModule(stencils.hpcg27(shape), "auto", device)
    M = auto_mg_preconditioner(cm.module, cm._handle_for("hpcg27"), "auto", device=device,
                               mg_levels=n_levels, mg_smoother="symgs", mg_coarsen="vertex",
                               mg_coarse_sweeps=1)
    (levels,) = built
    mods = [cm.module]
    while len(mods) < n_levels:
        mods.append(coarsen_opdef(mods[-1], "hpcg27", mode="vertex"))
    passes = [CompiledModule(colour_pass(m, "hpcg27"), "auto", device).opdef(NAME) for m in mods]
    out_of_place = [L._replace(colour=lambda x, b, c, f=f, d=L.inv_diag: x.copy_(f(x, b, d, c)))
                    for L, f in zip(levels, passes)]
    return levels, out_of_place, M


@pytest.mark.parametrize("rank, n", [(3, 16), (2, 40)])
def test_symgs_cycle_in_place_is_the_out_of_place_cycle(rank, n, monkeypatch):
    """The V-cycle whose colour passes run in place equals, bit for bit,
    the cycle of out-of-place passes, from the caller's x and from M's
    zeros, and leaves the caller's x, b and r as they were."""
    shape = (n + 2,) * rank
    levels, out_of_place, M = _hpcg_levels(shape, 3 if rank == 3 else 4, "cpu", monkeypatch)
    kw = dict(pre=1, post=1, smoother="symgs", coarse_solver="jacobi", coarse_iters=1,
              transfer="injection")
    x, b = _data(shape, 3), _data(shape, 4)
    x0, b0 = x.clone(), b.clone()
    got = multigrid.v_cycle(levels, b, x, **kw)
    assert torch.equal(x, x0) and torch.equal(b, b0)
    assert torch.equal(got, multigrid.v_cycle(out_of_place, b, x, **kw))
    r = _data(shape, 5)
    r0 = r.clone()
    assert torch.equal(M(r), multigrid.v_cycle(out_of_place, r, torch.zeros_like(r),
                                               _x_is_zero=True, **kw))
    assert torch.equal(r, r0)


def test_smoother_copies_the_callers_x_once():
    """The in-place smoother writes a copy of a caller's x, and the cycle's
    own tensor (owned) in place."""
    n = 8
    shape = (n + 2,) * 3
    cm = CompiledModule(colour_pass(stencils.hpcg27(shape), "hpcg27"), "auto", "cpu")
    d = torch.full(shape, 1 / 26, dtype=torch.float64)
    form = cm.colour_form(NAME)
    L = multigrid.MGLevel(None, d, None, colour=lambda x, b, c: form(x, b, d, c))
    x, b = _data(shape, 6), _data(shape, 7)
    x0 = x.clone()
    smooth = multigrid._smoother(L, b, "symgs", 0.8)
    y = smooth(x, 2)
    assert y is not x and torch.equal(x, x0)
    assert smooth(y, 1, owned=True) is y
