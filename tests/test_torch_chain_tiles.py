"""Kernel D's schedule, emulated tile by tile on the CPU.

Kernel D (`csrc/nt_chain.cuh`) runs only on the card. Here its schedule is
emulated in Python tile by tile under the plans `chain.chain_plan` builds:
the tile origins in C order, the interior test (`chain.tile_interior`), the
field loads (unchecked, zeroed or wrapped, as whole 16-byte vectors where
rows are whole vectors), each stage over its region as strips of cells down
dim 1 (the last strip of a column ending at the region's end), the
copy-through seed and the neighbour rule of checked tiles, the shared-memory
buffers the planner assigns, and the stores. Shared memory that the kernel
has not written in this tile is NaN and an unchecked load or store off the
grid raises, so a schedule that reads what it must not cannot equal the
plain version. Each emulation must equal `chain.chain_plain` bit for bit.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.lowering import chain  # noqa: E402
from neptune_tpu_torch.lowering.torch_backend import TorchOps, eval_scalar_dag  # noqa: E402

NAN = float("nan")


def _stage_fields(x3, cells, interior, periodic, n, vec):
    """x3 at the staged cells (per dim) as the kernel loads them."""
    c0, c1, c2 = cells
    if vec:
        # the tile's first column and n2 are whole vectors: a vector lies on
        # the grid or off it whole, and wraps whole
        assert int(c2[0]) % chain.VEC == 0 and len(c2) % chain.VEC == 0
        for v in c2.reshape(-1, chain.VEC):
            on = (v >= 0) & (v < n[2])
            assert bool(on.all()) or not bool(on.any())
            assert torch.equal(v % n[2], v[0] % n[2] + torch.arange(chain.VEC))
    if interior:
        for c, m in zip(cells, n):
            assert 0 <= int(c.min()) and int(c.max()) < m, "unchecked load off the grid"
        return x3[c0][:, c1][:, :, c2]
    if periodic:
        return x3[c0 % n[0]][:, c1 % n[1]][:, :, c2 % n[2]]
    ok = [(c >= 0) & (c < m) for c, m in zip(cells, n)]
    ok = ok[0][:, None, None] & ok[1][None, :, None] & ok[2][None, None, :]
    v = x3[c0.clamp(0, n[0] - 1)][:, c1.clamp(0, n[1] - 1)][:, :, c2.clamp(0, n[2] - 1)]
    return torch.where(ok, v, torch.zeros(()))


def _strip_rows(lo: int, extent: int, r: int) -> torch.Tensor:
    """The rows the strips of one column cover: strip s starts at
    min(s r, extent - r), so the last one ends at the region's end."""
    starts = [min(s * r, extent - r) for s in range(-(-extent // r))]
    assert min(starts) >= 0
    return torch.tensor(sorted({lo + s + k for s in starts for k in range(r)}))


def emulate_chain(plan, fields, scalars, global_start=None):
    """Kernel D's schedule, tile by tile (nt_chain_kernel)."""
    rank = plan.rank
    pad = 3 - rank
    n = (1,) * pad + tuple(plan.shape)
    gs = plan.outer.lb if global_start is None else global_start
    lb = (0,) * pad + tuple(int(x) for x in gs)
    boxes = chain.stage_boxes(plan, plan.shape, global_start)
    x3 = [f.reshape(n) for f in fields]
    t, h, w = plan.tile3, plan.halo, plan.width
    vec = n[2] % chain.VEC == 0
    out = torch.full(n, NAN)
    tiles = [-(-m // tt) for m, tt in zip(n, t)]
    last = len(plan.stages) - 1
    n_interior = 0
    for tix in range(math.prod(tiles)):
        t0, r = divmod(tix, tiles[1] * tiles[2])
        t1, t2 = divmod(r, tiles[2])
        org = (t0 * t[0], t1 * t[1], t2 * t[2])
        interior, copy = chain.tile_interior(plan, org, n, boxes)
        n_interior += interior
        wrap = plan.periodic and not interior
        cells = [torch.arange(o - hh, o - hh + ww) for o, hh, ww in zip(org, h, w)]
        # the wrapped-cell table, filled for a checked tile of a wrapped chain
        wc = [c % m for c, m in zip(cells, n)] if wrap else cells
        bufs = [torch.full(w, NAN) for _ in range(plan.n_buffers)]
        for f in range(plan.n_fields):
            bufs[f] = _stage_fields(x3[f], cells, interior, plan.periodic, n, vec)
        for i, st in enumerate(plan.stages):
            op = st.op
            lo, r_ = plan.regions[i], plan.strips[i]
            ext = [ww - 2 * ll for ww, ll in zip(w, lo)]
            assert all(e >= 1 for e in ext) and 1 <= r_ <= ext[1]
            pos = [torch.arange(lo[0], lo[0] + ext[0]), _strip_rows(lo[1], ext[1], r_),
                   torch.arange(lo[2], lo[2] + ext[2])]
            ins = [bufs[plan.buffer[s]] for s in st.in_slots]
            q = [wc[d][pos[d]] for d in range(3)]  # the cells computed: wrapped or raw
            check = wrap and not op.attrs.get("periodic")

            def access(k, offset, ins=ins, pos=pos, q=q, check=check):
                o = (0,) * pad + tuple(offset)
                idx = [p + oo for p, oo in zip(pos, o)]
                for d in range(3):
                    assert 0 <= int(idx[d].min()) and int(idx[d].max()) < w[d], "read off the tile"
                v = ins[k][idx[0]][:, idx[1]][:, :, idx[2]]
                if check:  # a bounded stage in a wrapped tile: off the grid from q reads 0
                    ok = [(qq + oo >= 0) & (qq + oo < m) for qq, oo, m in zip(q, o, n)]
                    ok = ok[0][:, None, None] & ok[1][None, :, None] & ok[2][None, None, :]
                    v = torch.where(ok, v, torch.zeros(()))
                return v

            coords = ((q[0] + lb[0]).int()[:, None, None], (q[1] + lb[1]).int()[None, :, None],
                      (q[2] + lb[2]).int()[None, None, :])
            (y,) = eval_scalar_dag(op.region(0), rank, len(st.in_slots), access,
                                   lambda d, coords=coords: coords[d + pad],
                                   chain._stage_scalars(st, scalars), TorchOps("cpu"))
            shape = tuple(len(p) for p in pos)
            y = torch.as_tensor(y).to(torch.float32).expand(shape)
            seed = ins[0][pos[0]][:, pos[1]][:, :, pos[2]]
            if not interior:
                blo, bhi = boxes[i]
                inb = [(qq >= a) & (qq < b) for qq, a, b in zip(q, blo, bhi)]
                inb = inb[0][:, None, None] & inb[1][None, :, None] & inb[2][None, None, :]
                v = torch.where(inb, y, seed)
            else:
                v = seed if i in copy else y
            if i < last:
                dst = bufs[plan.buffer[st.out_slot]]
                assert all(dst is not b for b in ins), "a stage writes over its input"
                idx = torch.meshgrid(*pos, indexing="ij")
                dst[idx] = v
                continue
            # the last stage's region is the tile itself: store the grid's cells
            cell = [o - hh + p for o, hh, p in zip(org, h, pos)]
            ok = [(c >= 0) & (c < m) for c, m in zip(cell, n)]
            if interior:
                assert all(bool(x.all()) for x in ok), "unchecked store off the grid"
            sel = [c[k] for c, k in zip(cell, ok)]
            vv = v[ok[0]][:, ok[1]][:, :, ok[2]]
            out[torch.meshgrid(*sel, indexing="ij")] = vv
    return out.reshape(plan.shape), n_interior


def _data(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


# small schedules, so that small grids have interior, edge and ragged tiles
# (and tiles whose halo leaves the grid by one cell: 41 and 25 rows, 71
# columns)
SMALL = {2: (chain.ChainTile((8, 16), 64, 1),), 3: (chain.ChainTile((4, 8, 16), 64, 1),)}

# name -> (module, opdef, fields, scalars, schedules or None for the default,
#          block shape and global start for the origin form, or None)
CASES = {
    "composite": (lambda: stencils.composite((41, 100)), "wrapped", 1, (), SMALL, None),
    "composite_ragged_unaligned": (lambda: stencils.composite((37, 71)), "wrapped", 1, (), SMALL,
                                   None),
    "mixed_periodic_bounded": (lambda: stencils.composite((40, 72), mixed=True), "wrapped", 1,
                               (), SMALL, None),
    "mixed_unaligned_torus": (lambda: stencils.composite((21, 30), mixed=True), "wrapped", 1,
                              (), SMALL, None),
    "all_periodic": (lambda: stencils.composite((25, 48), periodic=True), "wrapped", 1, (),
                     SMALL, None),
    "two_fields_scalars": (lambda: stencils.coupled((40, 100)), "couple", 2, (0.7, -1.3), SMALL,
                           None),
    "composite_3d": (lambda: stencils.composite((12, 20, 40)), "wrapped", 1, (), SMALL, None),
    "mixed_3d": (lambda: stencils.composite((10, 12, 36), mixed=True), "wrapped", 1, (), SMALL,
                 None),
    "graded_mixed_lb": (lambda: stencils.graded_chain((40, 72), lb=(3, -5)), "wrapped", 1, (),
                        SMALL, None),
    "grid_under_a_tile": (lambda: stencils.composite((5, 7)), "wrapped", 1, (), None, None),
    "grid_under_a_tile_3d": (lambda: stencils.composite((3, 5, 9)), "wrapped", 1, (), None, None),
    "default_plan": (lambda: stencils.composite((140, 300)), "wrapped", 1, (), None, None),
    "default_plan_two_fields": (lambda: stencils.coupled((140, 200)), "couple", 2, (0.7, -1.3),
                                None, None),
    "default_plan_3d": (lambda: stencils.composite((12, 40, 72)), "wrapped", 1, (), None, None),
    "origin_at_a_global_start": (lambda: stencils.composite((80, 200)), "wrapped", 1, (), SMALL,
                                 ((40, 100), (24, 64))),
    # a block that reaches past the bounds' far edge, which lies inside it
    # away from its edges: some stage regions straddle their box, others
    # lie wholly outside it
    "origin_bounds_inside_the_block": (lambda: stencils.coupled((80, 200)), "couple", 2,
                                       (0.7, -1.3), SMALL, ((60, 160), (40, 60))),
    "origin_two_fields": (lambda: stencils.coupled((80, 200)), "couple", 2, (0.7, -1.3), SMALL,
                          ((40, 100), (40, 0))),
}


@pytest.mark.parametrize("case", CASES)
def test_kernel_d_tiles_equal_plain(case):
    build, name, n_fields, sc, tiles, origin = CASES[case]
    module = build()
    rank = len(module.lookup(name).ftype.inputs[0].bounds.shape)
    block, gstart = origin if origin else (None, None)
    plan = chain.chain_plan(module, name, block, tiles and tiles[rank])
    assert plan is not None
    fields = [_data(plan.shape, seed) for seed in range(n_fields)]
    sv = [torch.tensor(v, dtype=torch.float32) for v in sc]
    got, n_interior = emulate_chain(plan, fields, sv, gstart)
    ref = chain.chain_plain(plan, fields, sv, gstart)
    assert not torch.isnan(got).any()
    assert torch.equal(got, ref)
    if case in ("composite", "default_plan", "composite_3d", "origin_bounds_inside_the_block"):
        assert n_interior > 0  # both instances ran


def test_origin_bounds_inside_the_block_copies_through():
    """The case that needs both halves of the interior test: tiles whose
    regions straddle a stage's box run checked, and tiles wholly beyond the
    bounds run unchecked as copies."""
    module = stencils.coupled((80, 200))
    plan = chain.chain_plan(module, "couple", (60, 160), SMALL[2])
    n = (1, 60, 160)
    boxes = chain.stage_boxes(plan, plan.shape, (40, 60))
    kinds = set()
    for o1 in range(0, 60, 8):
        for o2 in range(0, 160, 16):
            kinds.add(chain.tile_interior(plan, (0, o1, o2), n, boxes))
    assert {(True, ()), (True, (0, 1, 2)), (False, ())} <= kinds


def test_kernel_d_plans():
    """The default schedules: tile, threads, the widened column halo, the
    stage regions and strips, shared memory; and the regions' lanes."""
    plan = chain.chain_plan(stencils.composite((4096, 4096)), "wrapped")
    assert (plan.tile, plan.threads, plan.ahead, plan.min_blocks) == ((32, 64), 128, 1, 5)
    assert plan.halo == (0, 2, 4) and plan.width == (1, 36, 72)
    # lap over [1, W - 1) rows and [3, W - 3) columns, then the tile itself
    assert plan.regions == ((0, 1, 3), (0, 2, 4), (0, 2, 4))
    assert plan.region(0) == ((0, 1), (1, 34), (3, 66))
    # two field sets (the next tile's in flight) and two stage buffers
    assert plan.smem_bytes == 4 * ((2 + 2) * 36 * 72 + (1 + 36 + 72))
    assert 5 * plan.smem_bytes <= chain.SMEM_MAX
    for i in range(len(plan.stages)):
        (_, e0), (_, e1), (_, e2) = plan.region(i)
        r = plan.strips[i]
        assert 1 <= r <= min(e1, 8)
        items = e0 * -(-e1 // r) * e2
        # warps are full but the last one
        assert -(-items // 32) * 32 - items < 32
    p3 = chain.chain_plan(stencils.composite((256, 256, 256)), "wrapped")
    assert (p3.tile, p3.threads, p3.ahead) == ((8, 16, 32), 256, 0)
    assert p3.halo == (2, 2, 4) and p3.width == (12, 20, 40)
    assert p3.smem_bytes == 4 * (3 * 12 * 20 * 40 + (12 + 20 + 40))
    assert 2 * p3.smem_bytes <= chain.SMEM_MAX
    # a grid with vectors of rows: the origin form of the same opdef
    blk = chain.chain_plan(stencils.composite((4096, 4096)), "wrapped", (2048, 2048))
    assert blk.origin and blk.tile == plan.tile and blk.regions == plan.regions


def test_strip_choice():
    """The strip of a region: the fewest warp steps, a strip per item."""
    assert chain._strip((1, 64, 64), 12) == 11
    assert chain._strip((1, 66, 66), 12) == 11
    assert chain._strip((1, 32, 64), 8) == 8
    assert chain._strip((1, 34, 66), 8) == 7
    assert chain._strip((1, 2, 40), 12) == 2
    assert chain._strip((1, 1, 7), 12) == 1
