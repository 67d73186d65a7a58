"""The schedules of kernels A and C, emulated tile by tile on the CPU.

Kernel A's tiled design (`csrc/nt_apply.cuh`) and kernel C's register
strips (`csrc/nt_sweeps.cuh`) run only on the card. Here each is emulated
in Python block by block, under the plans the port builds them from
(`cuda_backend.apply_plan`, `sweeps.sweep_plan`): the same tile origins,
interior test, loads (unchecked, zero-filled or wrapped), staged planes,
strips, sweep regions, the register window's rotating planes and stores. Shared memory
that the kernel has not filled yet, and the values that lanes take from
beyond the warp's edge, are NaN, and an unchecked load off the grid raises,
so a schedule that reads what it must not cannot equal the plain version.
Each emulation must equal the plain version bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from neptune_tpu_torch import stencils  # noqa: E402
from neptune_tpu_torch.lowering import cuda_backend, sweeps, torch_backend  # noqa: E402
from neptune_tpu_torch.lowering.torch_backend import TorchOps, eval_scalar_dag  # noqa: E402

NAN = float("nan")


def _grid(op, shape, global_start):
    """(n, lb, blo, bhi), rank-3 padded, as the launch data gives them."""
    if global_start is None:
        global_start = op.results[0].type.bounds.lb
    m = cuda_backend.window_meta(tuple(shape), op.attrs["bounds"], global_start)
    return m[0:3], m[3:6], m[6:9], m[9:12]


def _rows_cols(x3, q, rows, cols, checked, periodic, n):
    """x3[q, rows, cols] as the kernel loads it: unchecked loads must lie in
    the grid; checked ones wrap (periodic) or read 0 off the grid."""
    q, rows, cols = torch.as_tensor(q), torch.as_tensor(rows), torch.as_tensor(cols)
    if not checked:
        assert 0 <= int(q) < n[0] and 0 <= int(rows.min()) and int(rows.max()) < n[1]
        assert 0 <= int(cols.min()) and int(cols.max()) < n[2]
        return x3[q][rows][:, cols]
    if periodic:
        return x3[q % n[0]][rows % n[1]][:, cols % n[2]]
    ok = ((rows >= 0) & (rows < n[1]))[:, None] & ((cols >= 0) & (cols < n[2]))
    ok = ok & bool(0 <= int(q) < n[0])
    v = x3[q.clamp(0, n[0] - 1)][rows.clamp(0, n[1] - 1)][:, cols.clamp(0, n[2] - 1)]
    return torch.where(ok, v, torch.zeros((), dtype=x3.dtype))


def _coords(rank, values):
    """index_fn over one plane: the logical coordinate tensors of dims
    (0, 1, 2), given as a scalar, a column and a row, dropped to the rank."""
    return values[3 - rank:]


def emulate_apply(op, inputs, scalars, plan, global_start=None):
    """Kernel A's tiled design, block by block (nt_apply_tiled_kernel)."""
    rank = op.results[0].type.bounds.rank
    n_in = op.attrs.get("num_inputs", len(op.operands))
    shape = tuple(inputs[0].shape) if inputs else op.results[0].type.bounds.shape
    n, lb, blo, bhi = (list(map(int, v)) for v in _grid(op, shape, global_start))
    dtype = torch_backend.DTYPES[op.results[0].type.element]
    x3 = [x.reshape(n) for x in inputs]
    (t1, t2), r, d = plan.tile, plan.strip, plan.planes
    h0, h1, h2 = plan.halo
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    h2p = -(-h2 // vec) * vec
    w1, w2 = t1 + 2 * h1, t2 + 2 * h2p
    staged = d + 2 * h0
    periodic = bool(op.attrs.get("periodic"))
    outs = [torch.full(n, NAN, dtype=dtype) for _ in op.results]
    assert plan.threads == t2 * (t1 // r) and t2 % 32 == 0 and t1 % r == 0
    for bz in range(-(-n[0] // d)):
        for by in range(-(-n[1] // t1)):
            for bx in range(-(-n[2] // t2)):
                z0, z1 = bz * d, min(bz * d + d, n[0])
                o1, o2 = by * t1, bx * t2
                interior = (
                    z0 - h0 >= 0 and z1 + h0 <= n[0] and o1 - h1 >= 0 and o1 + t1 + h1 <= n[1]
                    and o2 - h2p >= 0 and o2 + t2 + h2p <= n[2] and z0 >= blo[0]
                    and z1 <= bhi[0] and o1 >= blo[1] and o1 + t1 <= bhi[1] and o2 >= blo[2]
                    and o2 + t2 <= bhi[2]
                )
                checked = not interior
                tile = torch.full((max(n_in, 1), staged, w1, w2), NAN, dtype=dtype)
                first = z0 - h0
                rows = torch.arange(o1 - h1, o1 - h1 + w1)
                cols = torch.arange(o2 - h2p, o2 - h2p + w2)

                def load(q):
                    for k in range(n_in):
                        tile[k, q - first] = _rows_cols(
                            x3[k], q, rows, cols, checked, periodic, n)

                def plane(z):
                    slots = [z + o - first for o in range(-h0, h0 + 1)]

                    def access(k, offset):
                        o0, o1_, o2_ = (0,) * (3 - rank) + tuple(offset)
                        return tile[k, slots[o0 + h0], h1 + o1_: h1 + o1_ + t1,
                                    h2p + o2_: h2p + o2_ + t2]

                    q1 = torch.arange(o1, o1 + t1)[:, None]
                    q2 = torch.arange(o2, o2 + t2)[None, :]
                    coords = (torch.tensor(z + lb[0], dtype=torch.int32),
                              (q1 + lb[1]).int(), (q2 + lb[2]).int())
                    ys = eval_scalar_dag(op.region(0), rank, n_in, access,
                                         lambda dd: _coords(rank, coords)[dd], scalars,
                                         TorchOps("cpu"))
                    inb = ((blo[0] <= z < bhi[0]) & (q1 >= blo[1]) & (q1 < bhi[1])
                           & (q2 >= blo[2]) & (q2 < bhi[2]))
                    for j, y in enumerate(ys):
                        y = torch.as_tensor(y).to(dtype).expand(t1, t2)
                        seed = (tile[j, slots[h0], h1: h1 + t1, h2p: h2p + t2] if j < n_in
                                else torch.zeros((t1, t2), dtype=dtype))
                        v = torch.where(inb, y, seed) if checked else y
                        m1, m2 = min(t1, n[1] - o1), min(t2, n[2] - o2)
                        outs[j][z, o1: o1 + m1, o2: o2 + m2] = v[:m1, :m2]

                for q in range(first, z1 + h0):
                    load(q)
                for z in range(z0, z1):
                    plane(z)
    outs = [o.reshape(shape) for o in outs]
    return outs[0] if len(outs) == 1 else tuple(outs)


def emulate_sweeps(plan, x, scalars, global_start=None):
    """Kernel C's register strips, block by block (nt_sweeps_strip_kernel)."""
    op = plan.op
    rank = len(plan.tile)
    shape = tuple(x.shape)
    n, lb, blo, bhi = (list(map(int, v)) for v in _grid(op, shape, global_start))
    t0, t1, t2 = (1,) * (3 - rank) + tuple(plan.tile)
    h0, h1, h2 = (0,) * (3 - rank) + tuple(plan.halo)
    dp, c, r, rows_p = plan.depth, plan.cols, plan.strip, plan.rows
    w0, w1, w2 = t0 + 2 * dp * h0, t1 + 2 * dp * h1, 32 * c
    pad = plan.pad
    assert pad >= dp * h2 and pad + t2 + dp * h2 <= w2 and h2 <= c
    periodic = bool(op.attrs.get("periodic"))
    n_in = 1
    x3 = x.reshape(n)
    out = torch.full(n, NAN)
    sv = list(scalars)
    for bz in range(-(-n[0] // t0)):
        for by in range(-(-n[1] // t1)):
            for bx in range(-(-n[2] // t2)):
                org = (bz * t0, by * t1, bx * t2)
                b = (org[0] - dp * h0, org[1] - dp * h1, org[2] - pad)
                w = (w0, w1, w2)
                interior = all(
                    b[i] >= 0 and b[i] + w[i] <= n[i] and b[i] >= blo[i] and b[i] + w[i] <= bhi[i]
                    for i in range(3)
                )
                checked = not interior
                wrap = periodic and checked
                pos = [torch.arange(w0), torch.arange(rows_p), torch.arange(w2)]
                cell = [b[i] + pos[i] for i in range(3)]
                if wrap:  # the table of wrapped cells, rows up to the padding
                    cell = [cell[i] % n[i] for i in range(3)]
                buf = [torch.full((w0, rows_p, w2), NAN) for _ in range(2)]
                for p0 in range(w0):
                    buf[0][p0, :w1] = _rows_cols(x3, b[0] + p0, b[1] + pos[1][:w1], b[2] + pos[2],
                                                 checked, periodic, n)
                cur, nxt = buf
                for sw in range(1, dp + 1):
                    l0, l1 = sw * h0, sw * h1
                    n_s = -(-(w1 - 2 * l1) // r)
                    n_p = w0 - 2 * l0
                    tasks = [(l0 + run * plan.run, l1 + i * r)
                             for run in range(-(-n_p // plan.run)) for i in range(n_s)]
                    # each task marches over a run of planes with a window of
                    # nw planes in rotating slots, as nt_strip_task does
                    nw = 2 * h0 + 1
                    n_steps = 0
                    for pa, row0 in tasks:
                        assert row0 - h1 >= 0 and row0 + r + h1 <= rows_p
                        win = [torch.full((r + 2 * h1, w2), NAN) for _ in range(nw)]

                        def window_plane(q, row0=row0):
                            assert 0 <= q < w0
                            return cur[q, row0 - h1: row0 + r + h1].clone()

                        for o in range(2 * h0):
                            win[o] = window_plane(pa - h0 + o)
                        for i, p in enumerate(range(pa, min(pa + plan.run, l0 + n_p))):
                            ph = i % nw
                            win[(ph + 2 * h0) % nw] = window_plane(p + h0)
                            n_steps += 1

                            def access(k, offset, ph=ph):
                                o0, o1, o2 = (0,) * (3 - rank) + tuple(offset)
                                rowsv = win[(ph + o0 + h0) % nw][h1 + o1: h1 + o1 + r]
                                # columns beyond the warp come from no lane: NaN
                                pad = torch.full((r, h2), NAN)
                                ext = torch.cat([pad, rowsv, pad], dim=1)
                                return ext[:, h2 + o2: h2 + o2 + w2]

                            c0 = cell[0][p]
                            c1 = cell[1][row0: row0 + r][:, None]
                            c2 = cell[2][None, :]
                            coords = ((c0 + lb[0]).int(), (c1 + lb[1]).int(),
                                      (c2 + lb[2]).int())
                            (y,) = eval_scalar_dag(op.region(0), rank, n_in, access,
                                                   lambda dd: _coords(rank, coords)[dd], sv,
                                                   TorchOps("cpu"))
                            y = torch.as_tensor(y).to(torch.float32).expand(r, w2)
                            if checked:
                                inb = ((blo[0] <= c0) & (c0 < bhi[0]) & (c1 >= blo[1])
                                       & (c1 < bhi[1]) & (c2 >= blo[2]) & (c2 < bhi[2]))
                                y = torch.where(inb, y, win[(ph + h0) % nw][h1: h1 + r])
                            nxt[p, row0: row0 + r] = y
                    assert n_steps == n_p * n_s
                    cur, nxt = nxt, cur
                m = [min(t, n[i] - org[i]) for i, t in enumerate((t0, t1, t2))]
                out[org[0]: org[0] + m[0], org[1]: org[1] + m[1], org[2]: org[2] + m[2]] = cur[
                    dp * h0: dp * h0 + m[0], dp * h1: dp * h1 + m[1], pad: pad + m[2]]
    return out.reshape(shape)


def _data(shape, dtype=torch.float32, seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


# small tiles so that small grids have interior, edge and ragged tiles
SMALL_A = {2: ((8, 32, 4, 1),), 3: ((4, 32, 2, 3),)}

# (module, tiles or None for the default plan, global start or None)
APPLY_CASES = {
    "jacobi5_interior_and_edges": (lambda: stencils.jacobi5((40, 100)), SMALL_A, None),
    "jacobi5_ragged_bf16": (lambda: stencils.jacobi5((37, 75), "bfloat16"), SMALL_A, None),
    "adv4_h2": (lambda: stencils.advection4((30, 90)), SMALL_A, None),
    "adv4_periodic_torus": (lambda: stencils.advection4((20, 40), periodic=True), SMALL_A, None),
    "one_cell_wide_torus": (lambda: stencils.advection4((1, 70), periodic=True), SMALL_A, None),
    "one_cell_tall_torus": (lambda: stencils.advection4((50, 1), periodic=True), SMALL_A, None),
    "one_cell_wide_combination": (lambda: stencils.combination((1, 70)), SMALL_A, None),
    "heat7_march": (lambda: stencils.heat7((11, 14, 70)), SMALL_A, None),
    "heat7_dims_under_a_tile": (lambda: stencils.heat7((3, 5, 7)), SMALL_A, None),
    "heat7_periodic_march": (lambda: stencils.heat7((7, 9, 40), periodic=True), SMALL_A, None),
    "two_inputs_and_a_scalar": (lambda: stencils.combination((20, 70)), SMALL_A, None),
    "two_results": (lambda: stencils.gradients((20, 70)), SMALL_A, None),
    "graded_index": (lambda: stencils.graded((30, 70), lb=(3, -5)), SMALL_A, None),
    "window_at_a_global_start": (lambda: stencils.jacobi5((80, 200)), SMALL_A, (24, 64)),
    # the bounds end inside the block, away from its edges
    "window_bounds_inside_the_block": (lambda: stencils.jacobi5((80, 200)), SMALL_A, (50, 110)),
    "window_rank3": (lambda: stencils.heat7((16, 20, 80)), SMALL_A, (5, 10, 0)),
    "default_plan_rank2": (lambda: stencils.jacobi5((70, 300)), None, None),
    "default_plan_rank3": (lambda: stencils.heat7((40, 20, 70)), None, None),
}


@pytest.mark.parametrize("case", APPLY_CASES)
def test_kernel_a_tiles_equal_plain(case):
    build, tiles, gstart = APPLY_CASES[case]
    op = stencils.the_apply(build())
    rank = op.results[0].type.bounds.rank
    plan = cuda_backend.apply_plan(op, tiles and tiles[rank])
    assert plan is not None
    dtype = torch_backend.DTYPES[op.results[0].type.element]
    n_in = op.attrs["num_inputs"]
    shape = op.results[0].type.bounds.shape
    if gstart is not None:
        shape = tuple(s // 2 for s in shape)
    xs = [_data(shape, dtype, seed) for seed in range(n_in)]
    scalars = [torch.tensor(0.1, dtype=dtype)] * (len(op.operands) - n_in)
    got = emulate_apply(op, xs, scalars, plan, gstart)
    if gstart is None:
        ref = torch_backend.execute_apply(op, xs + scalars)
    else:
        ref = torch_backend.execute_apply_window(op, xs, scalars, gstart)
    got, ref = (got, ref) if isinstance(got, tuple) else ((got,), (ref,))
    for g, r in zip(got, ref):
        assert not torch.isnan(g).any()
        assert torch.equal(g, r)


def test_kernel_a_plans():
    """The default tiles, their shared memory, and the first design for a
    halo that no tile takes."""
    plan = cuda_backend.apply_plan(stencils.the_apply(stencils.jacobi5((4096, 4096))))
    assert (plan.tile, plan.strip, plan.planes, plan.threads) == ((32, 64), 8, 1, 256)
    assert plan.smem_bytes == 4 * 34 * 72  # one plane, the column halo widened to 4
    bf = cuda_backend.apply_plan(stencils.the_apply(stencils.jacobi5((64, 64), "bfloat16")))
    assert bf.smem_bytes == 2 * 34 * (64 + 16)  # bf16: 8 to the vector
    p3 = cuda_backend.apply_plan(stencils.the_apply(stencils.heat7((256, 256, 256))))
    assert (p3.tile, p3.planes, p3.halo) == ((16, 64), 4, (1, 1, 1))
    assert p3.smem_bytes == 4 * 6 * 18 * 72  # 4 planes and their halo
    wide = stencils.the_apply(stencils.shifted_laplacian((64, 4096), reach=8))
    assert cuda_backend.apply_plan(wide, ((256, 128, 16, 1),)) is None
    src = cuda_backend.source(wide, None)
    assert src.rstrip().endswith("NT_DEFINE_APPLY(NtBody)")


# (module, opdef, k, scalars, global start or None)
SWEEP_CASES = {
    "jacobi5_interior_and_edges": (lambda: stencils.jacobi5((200, 300)), "jacobi", 2, (), None),
    "jacobi5_ragged": (lambda: stencils.jacobi5((45, 101)), "jacobi", 3, (), None),
    "adv4_h2": (lambda: stencils.advection4((40, 150)), "adv4", 2, (), None),
    "adv4_periodic_torus": (lambda: stencils.advection4((20, 40), periodic=True), "adv4", 3, (),
                            None),
    "two_cells_wide": (lambda: stencils.jacobi5((9, 2)), "jacobi", 2, (), None),
    "heat7": (lambda: stencils.heat7((12, 20, 70)), "heat", 2, (), None),
    "heat7_dims_under_a_tile": (lambda: stencils.heat7((4, 5, 9)), "heat", 2, (), None),
    "heat7_periodic": (lambda: stencils.heat7((6, 10, 24), periodic=True), "heat", 2, (), None),
    "relax_scalar": (lambda: stencils.damped_jacobi((40, 130)), "relax", 3, (0.8,), None),
    "graded_index": (lambda: stencils.graded((30, 70), lb=(3, -5)), "graded", 3, (), None),
    "local_at_a_global_start": (lambda: stencils.jacobi5((120, 300)), "jacobi", 3, (), (60, 150)),
}


@pytest.mark.parametrize("case", SWEEP_CASES)
def test_kernel_c_strips_equal_plain(case):
    build, name, k, scalars, gstart = SWEEP_CASES[case]
    module = build()
    if gstart is None:
        plan = sweeps.sweep_plan(module, name, k, depth=k)
        x = _data(plan.op.results[0].type.bounds.shape)
    else:
        op = stencils.the_apply(module)
        shape = tuple(s // 2 for s in op.results[0].type.bounds.shape)
        plan = sweeps._at_depth(op, tuple(max(h) for h in op.attrs["shape"].halo()), k)
        x = _data(shape)
    sv = [torch.tensor(s, dtype=torch.float32) for s in scalars]
    got = emulate_sweeps(plan, x, sv, gstart)
    assert not torch.isnan(got).any()
    assert torch.equal(got, sweeps.sweeps_plain(plan, x, sv if gstart is None else [], gstart))
