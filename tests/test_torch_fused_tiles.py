"""Kernel B's tiling and communication schedule on the CPU.

`emulate` runs the kernel's schedule (csrc/nt_fused_cg.cuh) tile by tile in
plain PyTorch: each tile keeps its own copy of p over the tile and its halo,
computes Ap on its tile from that copy alone, publishes the z values of its
edge to an exchange grid, and updates p on its tile and halo from its own z
and the published edges. Cells a tile may not read hold NaN, so a halo too
shallow or an edge not published shows in the result. It must give
`fused_cg_plain`'s x, iterations and residual bit for bit.

The planner's tests hold every plan to its contract: each cell owned by one
tile, tiles as deep as the reach along a cut dim, every halo cell published
by its owner, the reach equal to the stages' summed halos and stored along
each cut dim, and the shared memory within one block's 232,448 bytes (with
room for the kernel's static shared memory) wherever `supported` admits a
grid -- which is wherever the JAX package's fused route admits one.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neptune_tpu_torch import entry, stencils  # noqa: E402
from neptune_tpu_torch.ir import F32, Bounds, NeptuneBuilder, TempType  # noqa: E402
from neptune_tpu_torch.ir import verify_and_annotate  # noqa: E402
from neptune_tpu_torch.solvers import fused  # noqa: E402
from neptune_tpu_torch.solvers.precond import extract_diagonal, safe_inv_diag  # noqa: E402

CAP_CELLS = 12 * 1024 * 1024 // 28  # the fused route's working-set cap, in cells


def torus(shape):
    return stencils.shifted_laplacian(shape, periodic=True)


def x_plus_lap(n):
    """@shifted(x) = x + 0.1 * poisson(x): the composite of tests/test_fused.py."""
    b = NeptuneBuilder(stencils.poisson5(n))
    tt = TempType("float32", Bounds.of([0, 0], [n, n]))
    fn = b.make_opdef("shifted", "linear_opdef", [tt], [tt])
    b.push_block(fn.body)
    lapx = b.apply_linear("poisson", [fn.body.args[0]])
    op, body = b.start_apply([fn.body.args[0], lapx], tt.bounds)
    b.push_block(body)
    x0 = b.access(body.args[2], [0, 0])
    l0 = b.access(body.args[3], [0, 0])
    b.yield_(b.add(x0, b.mul(b.constant(0.1, F32), l0)))
    b.pop_block()
    b.return_([b.finish_apply(op)])
    b.pop_block()
    return verify_and_annotate(b.module)


def with_bands(plan, rows):
    """The plan cut into bands of `rows` whole rows instead."""
    n0, n1 = plan.shape
    tile, tiles = (rows, n1), (-(-n0 // rows), 1)
    halo = (plan.reach[0] if tiles[0] > 1 else 0, 0)
    edge = fused.edge_depth(plan.shape, halo, tile, tiles, plan.periodic)
    return dataclasses.replace(plan, tile=tile, tiles=tiles, halo=halo, edge=edge)


class Tile:
    """One block's view: flat cell index per tile-and-halo position (-1
    where a bounded tile reaches beyond the grid), which positions it owns,
    and which owned cells it publishes."""

    def __init__(self, plan, org):
        (n0, n1), (t0, t1), (h0, h1), (e0, e1) = plan.shape, plan.tile, plan.halo, plan.edge
        q0 = org[0] - h0 + torch.arange(t0 + 2 * h0)
        q1 = org[1] - h1 + torch.arange(t1 + 2 * h1)
        a0, a1 = q0 - org[0], q1 - org[1]  # tile coordinates
        if plan.periodic:
            inside = torch.ones(len(q0), len(q1), dtype=torch.bool)
            q0, q1 = q0 % n0, q1 % n1
        else:
            inside = ((q0 >= 0) & (q0 < n0))[:, None] & ((q1 >= 0) & (q1 < n1))[None, :]
        in_tile = ((a0 >= 0) & (a0 < t0))[:, None] & ((a1 >= 0) & (a1 < t1))[None, :]
        unwrapped = ((org[0] + a0) < n0)[:, None] & ((org[1] + a1) < n1)[None, :]
        self.owned = in_tile & unwrapped
        near = ((a0 < e0) | (a0 >= t0 - e0))[:, None] | ((a1 < e1) | (a1 >= t1 - e1))[None, :]
        self.publish = (self.owned & near)[self.owned]
        self.valid = inside
        flat = q0[:, None].clamp(0, n0 - 1) * n1 + q1[None, :].clamp(0, n1 - 1)
        self.idx = torch.where(inside, flat, torch.tensor(-1))


def tiles_of(plan):
    (t0, t1), (g0, g1) = plan.tile, plan.tiles
    return [Tile(plan, (i * t0, j * t1)) for i in range(g0) for j in range(g1)]


def emulate(plan, b, *, tol, maxiter, inv_diag=None):
    """Kernel B's schedule tile by tile; returns (x, iters, resnorm)."""
    n = b.numel()
    matvec = fused.plain_matvec(plan.stages)
    tiles = tiles_of(plan)
    bf = b.flatten()
    df = None if inv_diag is None else inv_diag.flatten()
    z0 = bf * df if df is not None else bf
    one = torch.ones((), dtype=torch.float32)

    def total(parts):
        return torch.stack(parts).sum().to(torch.float32)

    st = []
    for t in tiles:
        own = t.idx[t.owned]
        p = torch.zeros(t.idx.shape, dtype=torch.float32)
        p[t.valid] = z0[t.idx[t.valid]]
        st.append({"own": own, "p": p, "x": torch.zeros(len(own)), "r": bf[own],
                   "d": None if df is None else df[own]})
    bnorm = torch.sqrt(total([torch.sum(s["r"] * s["r"], dtype=torch.float64) for s in st]))
    rz = total([torch.sum(s["r"] * (s["r"] * s["d"] if df is not None else s["r"]),
                          dtype=torch.float64) for s in st])
    target = tol * torch.where(bnorm == 0, one, bnorm)
    rn, k = bnorm, 0
    while k < maxiter and bool(rn > target):
        parts = []
        for t, s in zip(tiles, st):  # 1. Ap from the tile's own copy of p
            full = torch.full((n,), float("nan"))
            full[t.idx[t.valid]] = s["p"][t.valid]
            assert torch.equal(full[t.idx[t.valid]], s["p"][t.valid]), "halo copies disagree"
            s["Ap"] = matvec(full.view(b.shape)).flatten()[s["own"]]
            parts.append(torch.sum(s["p"][t.owned] * s["Ap"], dtype=torch.float64))
        pap = total(parts)  # barrier 1
        alpha = rz / torch.where(pap == 0, one, pap)
        exch = torch.full((n,), float("nan"))
        rzs, rrs = [], []
        for t, s in zip(tiles, st):  # 2. x, r, z; the edges published
            s["x"] = s["x"] + alpha * s["p"][t.owned]
            s["r"] = s["r"] - alpha * s["Ap"]
            s["z"] = s["r"] * s["d"] if df is not None else s["r"]
            rzs.append(torch.sum(s["r"] * s["z"], dtype=torch.float64))
            rrs.append(torch.sum(s["r"] * s["r"], dtype=torch.float64))
            exch[s["own"][t.publish]] = s["z"][t.publish]
        rz_new, rr = total(rzs), total(rrs)  # barrier 2
        beta = rz_new / torch.where(rz == 0, one, rz)
        for t, s in zip(tiles, st):  # 3. p on the tile and its halo
            z = torch.zeros(t.idx.shape, dtype=torch.float32)
            z[t.valid] = exch[t.idx[t.valid]]
            z[t.owned] = s["z"]
            s["p"][t.valid] = z[t.valid] + beta * s["p"][t.valid]
        rz, rn, k = rz_new, torch.sqrt(rr), k + 1
    x = torch.full((n,), float("nan"))
    for s in st:
        x[s["own"]] = s["x"]
    return x.view(b.shape), torch.tensor(k, dtype=torch.int32), rn


def _zero_ring(b):
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = 0.0
    return b


# (module, opdef, jacobi, tol, maxiter, cut: None for the planner's at 16
# SMs, or bands of that many rows)
SCHEDULES = {
    "poisson64_jacobi": (lambda: stencils.poisson5(64), "poisson", True, 1e-4, 2000, None),
    "poisson64_jacobi_bands": (lambda: stencils.poisson5(64), "poisson", True, 1e-4, 2000, 5),
    "x_plus_lap": (lambda: x_plus_lap(48), "shifted", False, 1e-5, 2000, None),
    "lap_lap_thin_bands": (lambda: stencils.composite((48, 40)), "wrapped", False, 1e-9, 40, 2),
    "periodic": (lambda: torus((40, 36)), "shifted", False, 1e-6, 2000, None),
    "periodic_uneven_bands": (lambda: torus((61, 45)), "shifted", True, 1e-6, 2000, 4),
    "uneven": (lambda: stencils.shifted_laplacian((61, 45)), "shifted", True, 1e-6, 2000, None),
    "mixed_periodic_bounded": (lambda: stencils.composite((38, 30), mixed=True), "wrapped", False,
                               1e-9, 30, None),
    # dims that are not cut store no halo: reads off them read 0 or wrap
    # onto the tile itself
    "composite_rows_not_cut": (lambda: stencils.composite((5, 300)), "wrapped", False, 1e-9, 40,
                               None),
    "mixed_rows_not_cut": (lambda: stencils.composite((4, 300), mixed=True), "wrapped", False,
                           1e-9, 30, None),
    "periodic_column": (lambda: torus((300, 1)), "shifted", False, 1e-6, 2000, None),
    "periodic_composite_column": (lambda: stencils.composite((300, 1), periodic=True), "wrapped",
                                  False, 1e-20, 8, None),
    "reach3_periodic": (lambda: stencils.shifted_laplacian((40, 36), True, reach=3), "shifted",
                        False, 1e-6, 2000, None),
    "reach3_periodic_column": (lambda: stencils.shifted_laplacian((200, 1), True, reach=3),
                               "shifted", False, 1e-6, 2000, None),
}


@pytest.mark.parametrize("case", SCHEDULES)
def test_schedule_matches_plain_bitwise(case):
    build, name, jacobi, tol, maxiter, cut = SCHEDULES[case]
    module = build()
    plan = fused.cg_plan(module, name, sms=16)
    if cut is not None:
        plan = with_bands(plan, cut)
    shape = plan.shape
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(shape).astype(np.float32))
    inv = None
    if jacobi:
        b = _zero_ring(b)
        matvec = fused.plain_matvec(plan.stages)
        inv = safe_inv_diag(extract_diagonal(matvec, torch.zeros(shape), ((1, 1), (1, 1))))
    x_p, it_p, rn_p = fused.fused_cg_plain(fused.plain_matvec(plan.stages), b, tol=tol,
                                           maxiter=maxiter, inv_diag=inv)
    x_e, it_e, rn_e = emulate(plan, b, tol=tol, maxiter=maxiter, inv_diag=inv)
    assert int(it_e) == int(it_p) > 5
    assert torch.equal(rn_e, rn_p)
    assert torch.equal(x_e, x_p)


def _owned_cells(plan):
    seen = torch.zeros(int(np.prod(plan.shape)), dtype=torch.int64)
    for t in tiles_of(plan):
        seen.index_add_(0, t.idx[t.owned], torch.ones(int(t.owned.sum()), dtype=torch.int64))
    return seen


PLANS = {
    "poisson512": (lambda: stencils.poisson5(512), "poisson"),
    "poisson256": (lambda: stencils.poisson5(256), "poisson"),
    "heat_A256": (lambda: entry.build_step(256, "float32").module, "heat_A"),
    "composite256": (lambda: stencils.composite((256, 256)), "wrapped"),
    "periodic_509x300": (lambda: torus((509, 300)), "shifted"),
    "uneven_509x300": (lambda: stencils.shifted_laplacian((509, 300)), "shifted"),
    "mixed_100x70": (lambda: stencils.composite((100, 70), mixed=True), "wrapped"),
    "narrow_16x28000": (lambda: stencils.jacobi5((16, 28000)), "jacobi"),
    "cap_670": (lambda: stencils.poisson5(670), "poisson"),
    "cap_composite_133x3378": (lambda: stencils.composite((133, 3378)), "wrapped"),
    "cap_composite_column": (lambda: stencils.composite((CAP_CELLS, 1), periodic=True), "wrapped"),
    "cap_composite_row": (lambda: stencils.composite((1, CAP_CELLS), periodic=True), "wrapped"),
    "cap_reach8_column": (lambda: stencils.shifted_laplacian((CAP_CELLS, 1), True, reach=8),
                          "shifted"),
    "cap_reach8_17_wide": (lambda: stencils.shifted_laplacian((CAP_CELLS // 17, 17), reach=8),
                           "shifted"),
    "cap_reach8_periodic_2_wide": (
        lambda: stencils.shifted_laplacian((CAP_CELLS // 2, 2), True, reach=8), "shifted"),
}


@pytest.mark.parametrize("case", PLANS)
def test_plan_covers_every_cell_once_within_shared_memory(case):
    build, name = PLANS[case]
    module = build()
    plan = fused.cg_plan(module, name)
    assert fused.supported(module, name, module.lookup(name).ftype.inputs[0])
    assert plan.blocks <= fused.SMS
    assert plan.smem_bytes <= fused.SMEM_MAX == 232448 - fused.STATIC_SMEM
    assert torch.equal(_owned_cells(plan), torch.ones(int(np.prod(plan.shape)), dtype=torch.int64))
    for n, t, g, r, h in zip(plan.shape, plan.tile, plan.tiles, plan.reach, plan.halo):
        assert g == -(-n // t)
        assert g == 1 or t >= r  # a cut dim's tiles are at least the reach deep
        assert h == (r if g > 1 else 0)  # the halo is stored along cut dims only
    # the reach is the stages' summed halos: each stage adds its own halo to
    # the deepest of its inputs
    halos = [fused._stage_halo(st.op) for st in plan.stages]
    if "composite" in case or "mixed" in case:
        assert plan.reach == tuple(map(sum, zip(*halos))) == (2, 2)
    else:
        assert plan.reach == halos[-1] == ((8, 8) if "reach8" in case else (1, 1))


@pytest.mark.parametrize("case", ["periodic_61x45_bands4", "periodic_61x45", "bounded_61x45_bands4",
                                  "mixed_38x30", "composite_48x40_bands2", "periodic_5x7",
                                  "mixed_4x300", "reach3_periodic_61x45_bands4"])
def test_every_halo_cell_is_published_by_its_owner(case):
    module, name, bands = {
        "periodic_61x45_bands4": (torus((61, 45)), "shifted", 4),
        "periodic_61x45": (torus((61, 45)), "shifted", None),
        "bounded_61x45_bands4": (stencils.shifted_laplacian((61, 45)), "shifted", 4),
        "mixed_38x30": (stencils.composite((38, 30), mixed=True), "wrapped", None),
        "composite_48x40_bands2": (stencils.composite((48, 40)), "wrapped", 2),
        "periodic_5x7": (torus((5, 7)), "shifted", None),
        "mixed_4x300": (stencils.composite((4, 300), mixed=True), "wrapped", None),
        "reach3_periodic_61x45_bands4": (stencils.shifted_laplacian((61, 45), True, reach=3),
                                         "shifted", 4),
    }[case]
    plan = fused.cg_plan(module, name, sms=16)
    if bands is not None:
        plan = with_bands(plan, bands)
    tiles = tiles_of(plan)
    published = torch.zeros(int(np.prod(plan.shape)), dtype=torch.bool)
    for t in tiles:
        published[t.idx[t.owned][t.publish]] = True
    for t in tiles:
        copies = t.valid & ~t.owned
        assert bool(published[t.idx[copies]].all())


def test_supported_admits_the_same_grids():
    """The fused route's gates are the JAX package's: the new plan refuses
    none of these grids, down to the working-set cap and grids one cell
    wide, with composite and reach-8 operators."""
    for module, name in (
        (stencils.poisson5(670), "poisson"),  # 449,900 cells: just under the cap
        (stencils.poisson5(671), "poisson"),  # just over
        (stencils.jacobi5((16, 28000)), "jacobi"),
        (stencils.jacobi5((16, 28100)), "jacobi"),
        (stencils.composite((2, CAP_CELLS // 2)), "wrapped"),
        (stencils.composite((CAP_CELLS // 2, 2)), "wrapped"),
        (stencils.composite((CAP_CELLS, 1), periodic=True), "wrapped"),
        (stencils.composite((CAP_CELLS + 1, 1), periodic=True), "wrapped"),
        (stencils.composite((1, CAP_CELLS), periodic=True), "wrapped"),
        (stencils.composite((CAP_CELLS // 3, 3), mixed=True), "wrapped"),
        (stencils.advection4((CAP_CELLS // 700, 700)), "adv4"),
        (stencils.shifted_laplacian((CAP_CELLS, 1), True, reach=8), "shifted"),
        (stencils.shifted_laplacian((CAP_CELLS // 17, 17), reach=8), "shifted"),
        (stencils.shifted_laplacian((1, CAP_CELLS), True, reach=8), "shifted"),
        (stencils.shifted_laplacian((CAP_CELLS // 3, 3), True, reach=8), "shifted"),
        (stencils.shifted_laplacian((16, CAP_CELLS // 16), reach=8), "shifted"),
        (stencils.shifted_laplacian((670, 670), True, reach=8), "shifted"),
        (torus((3, 5)), "shifted"),
        (stencils.shifted_laplacian((3, 9)), "shifted"),
    ):
        tt = module.lookup(name).ftype.inputs[0]
        assert fused.supported(module, name, tt) == (tt.bounds.size * 28 <= 12 * 1024 * 1024), tt


def _cap_shapes():
    """Grids at the working-set cap, from one cell wide to square, both
    ways round, and the just smaller ones whose last tiles are short."""
    out = set()
    for n0 in [*range(1, 40), 50, 64, 65, 100, 128, 131, 132, 133, 150, 200, 263, 265, 400, 670]:
        for n1 in (CAP_CELLS // n0, CAP_CELLS // n0 - 1):
            if n1 >= 1:
                out |= {(n0, n1), (n1, n0)}
    return sorted(out)


@pytest.mark.parametrize("reach", [1, 2, 8, 16])
def test_every_grid_under_the_cap_has_a_plan(reach):
    """For operators of reach up to 16 and up to two intermediate buffers,
    bounded or periodic, every grid at the cap has a cut whose state fits
    one block's shared memory."""
    for shape in _cap_shapes():
        for n_buffers in (0, 1, 2):
            for periodic in (False, True):
                cut = fused.tile_grid(
                    shape, (reach, reach),
                    lambda t, h: fused.cg_smem_bytes(t, h, n_buffers, periodic) <= fused.SMEM_MAX,
                )
                assert cut is not None, (shape, n_buffers, periodic)
                tile, tiles, halo = cut
                assert tiles[0] * tiles[1] <= fused.SMS
                assert all(g * t >= n for n, t, g in zip(shape, tile, tiles))
