"""Kernel A, stencil_apply: one `neptune.apply` as a generated Hopper kernel.

The port of `neptune_tpu/lowering/pallas_backend.py`'s whole-grid applies.
One CUDA kernel (`csrc/nt_apply.cuh` plus a body generated from the IR by
`kernels/codegen.py`) replaces three TPU kernels:

  pallas_backend.py::_execute            (multi-copy dim-0 slabs)
  pallas_backend.py::_execute_dma_rank3  (rolling-window ring fetch, rank 3)
  pallas_backend.py::_execute_dma_rank2  (rolling window, 2 <= h0 <= 8)

Their VMEM slab budgets, sublane halo padding and ring DMA choreography have
no counterpart here. Bound on the H100: bytes (a 5-pt f32 apply moves at
least 8 B per cell). A block stages a tile of a few input planes and their
halo in shared memory with 16-byte `cp.async` copies, and each thread
computes a strip of cells; tiles
inside the grid and the bounds run without per-cell tests (`apply_plan`
plans it, `csrc/nt_apply.cuh` has the design). An apply whose halo makes
every tile too large for shared memory keeps the first design, one thread
per cell reading global memory.

`try_execute_apply` decides by `supported` before any launch, as the JAX
package's does: rank 1 and inputs off the output's domain take the eager
path. Unlike the TPU kernels, kernel A and its window form take f64: the
same design over 8-byte elements, computing in double, bitwise the eager
f64 route. Given CPU tensors it runs the kernel's plain version
(`torch_backend.execute_apply`); given CUDA tensors it launches the kernel
or raises.

The colour form (`apply_colour`, counted as `stencil_apply`) runs an apply
that `passes.smoother.colour_pass` marked as a symgs colour pass over the
cells of one colour only, updating x in place (`csrc/nt_colour.cuh`): x
read whole, b and 1/diag read and x written at the colour's cells, where
the out-of-place launch moves four whole grids. Its plan is
`colour_plan`'s, its tiles `COLOUR_TILES`; every other apply keeps its
source and plan.

The window form (`apply_window`, counted apart as `stencil_apply_window`)
is the same kernel over one local block of a sharded grid. It replaces
`pallas_backend.py::execute_apply_window` and the `global_start` cases of
the two DMA kernels. Only the launch data differ: the extents are the
block's, the logical origin is the block's global start (so index()
bodies see global coordinates), and the apply's bounds are clipped to the
block. Reads that leave the block read 0 (or wrap around it on a periodic
apply): those cells lie in the edge zone that the sharded caller
recomputes or carves off, as the JAX contract has it.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import arithmetic, default_device
from ..ir.core import Operation
from ..ir.types import Bounds, TempType
from ..kernels import codegen
from ..kernels.build import LaunchCounter, builder, check
from . import torch_backend

_SUPPORTED_DTYPES = ("float32", "bfloat16", "float64")
_ITEMSIZE = {"bfloat16": 2, "float32": 4, "float64": 8}

counter = LaunchCounter("stencil_apply")
window_counter = LaunchCounter("stencil_apply_window")

# (id(op), (fold, pinned), plan) -> its launch data (which holds the op);
# the generated body depends on the effective arithmetic (`config.arithmetic`)
_kernels: dict[tuple, "_Launch"] = {}

# Tiles of the tiled design, preferred first: (rows kT1, columns kT2, cells
# per thread kR, planes per block kD). The first whose shared memory stays
# under APPLY_SMEM is taken. Rank 2 is one plane. Timed on the H100
# (scripts/torch_tile_times.py, PERF.md).
APPLY_TILES = {
    2: ((32, 64, 8, 1), (16, 64, 4, 1), (8, 32, 4, 1)),
    3: ((16, 64, 4, 4), (8, 64, 4, 2), (4, 32, 4, 1)),
}
# shared memory one block of kernel A may take, so that several blocks
# share an SM and one block's loads overlap another's compute
APPLY_SMEM = 96 * 1024
# f64 elements: narrower tiles under a smaller budget, so that three or more
# blocks share an SM (timed on the H100 at HPCG's 322^3, HPCG's apply and its
# three-input colour pass: scripts/torch_tile_times.py --kernels F, PERF.md)
APPLY_TILES_F64 = {3: ((16, 32, 4, 4), (8, 32, 2, 4), (4, 32, 2, 8))}
APPLY_SMEM_F64 = 64 * 1024
# Tiles of the colour form, counted in one colour's cells: (colour rows kT1,
# colour columns kT2, cells per thread kR, colour planes kD), the first whose
# staged x fits COLOUR_SMEM taken (timed on the H100 at HPCG's 322^3 and
# 162^3: scripts/torch_tile_times.py --kernels G, PERF.md)
COLOUR_TILES = {2: ((8, 32, 2, 1),), 3: ((8, 32, 2, 1),)}
COLOUR_SMEM = 64 * 1024


@dataclass(frozen=True)
class ApplyPlan:
    """The tiled design of kernel A for one apply (csrc/nt_apply.cuh): an
    output tile of `tile` = (rows, columns) of each of `planes` planes
    along dim 0, `strip` cells per thread down the rows, the body's `halo`
    per dim (rank-3 padded), `threads` per block and `smem_bytes` of shared
    memory."""

    tile: tuple
    strip: int
    planes: int
    halo: tuple
    threads: int
    smem_bytes: int


def apply_smem(n_in: int, itemsize: int, tile, halo, planes: int) -> int:
    """Shared memory of a tile (NtApplyGeom): the tile's planes and halo
    planes of every input, each the tile with its halo, the column halo
    widened to whole 16-byte vectors."""
    vec = 16 // itemsize
    h2p = -(-halo[2] // vec) * vec
    staged = planes + 2 * halo[0]
    return n_in * staged * (tile[0] + 2 * halo[1]) * (tile[1] + 2 * h2p) * itemsize


def apply_plan(op: Operation, tiles=None) -> Optional[ApplyPlan]:
    """The tiled plan of kernel A for a supported apply: the first of
    `tiles` (default APPLY_TILES of its rank, APPLY_TILES_F64 for f64 where
    it has the rank) whose shared memory fits APPLY_SMEM (APPLY_SMEM_F64
    for f64), or None (the first design)."""
    rank = op.results[0].type.bounds.rank
    n_in = op.attrs.get("num_inputs", len(op.operands))
    itemsize = _ITEMSIZE[op.results[0].type.element]
    halo = codegen.body_reach(op)
    budget = APPLY_SMEM_F64 if itemsize == 8 else APPLY_SMEM
    if tiles is None:
        tiles = APPLY_TILES_F64.get(rank) if itemsize == 8 else None
        tiles = tiles or APPLY_TILES[rank]
    for t1, t2, r, d in tiles:
        smem = apply_smem(n_in, itemsize, (t1, t2), halo, d)
        if smem <= budget:
            return ApplyPlan((t1, t2), r, d, halo, t2 * (t1 // r), smem)
    return None


def source(op: Operation, plan="auto") -> str:
    """Kernel A's generated source for one apply, under its plan."""
    return codegen.apply_source(op, apply_plan(op) if plan == "auto" else plan)


def supported(op: Operation) -> bool:
    """f32, bf16 or f64, rank 2 or 3, every input and result on the
    output's domain and type."""
    out_type: TempType = op.results[0].type
    if out_type.element not in _SUPPORTED_DTYPES:
        return False
    if out_type.bounds.rank not in (2, 3):
        return False
    if any(r.type.element != out_type.element for r in op.results):
        return False
    n_in = op.attrs.get("num_inputs", len(op.operands))
    return all(
        v.type.bounds == out_type.bounds and v.type.element == out_type.element
        for v in op.operands[:n_in]
    )


def try_execute_apply(op: Operation, operand_arrays: Sequence, device=None) -> Optional[object]:
    """Run one apply through kernel A, or return None when `supported`
    refuses it. `device` places an apply that has no tensor inputs
    (default `config.device`)."""
    if not supported(op):
        return None
    n_in = op.attrs.get("num_inputs", len(op.operands))
    device = operand_arrays[0].device if n_in else default_device(device)
    if device.type == "cpu":
        return torch_backend.execute_apply(op, operand_arrays, device=device)
    if device.type != "cuda":
        raise ValueError(f"stencil_apply: no kernel for device {device}")
    return stencil_apply(op, operand_arrays[:n_in], operand_arrays[n_in:], device)


def colour_form(op: Operation) -> bool:
    """Whether kernel A runs `op` in its colour form: an apply marked as a
    colour pass (`passes.smoother.MARK`) that `supported` takes, bounded,
    with one result and a colour scalar, reading x (its first input) within
    one cell along each dim and its other inputs at the cell alone, and a
    tile of `COLOUR_TILES` that fits."""
    from ..passes.smoother import MARK, PARITY

    n_in = op.attrs.get("num_inputs", len(op.operands))
    if (op.attrs.get(MARK) != PARITY or not supported(op) or op.attrs.get("periodic")
            or len(op.results) != 1 or n_in < 1 or len(op.operands) == n_in):
        return False
    body, rank = op.region(0), op.results[0].type.bounds.rank
    for a in op.walk():
        if a.name != "neptune.access" or a.operands[0].block_arg_of is not body:
            continue
        k, offset = a.operands[0].index - rank, a.attrs["offset"]
        if any(abs(o) > (1 if k == 0 else 0) for o in offset):
            return False
    return colour_plan(op) is not None


def colour_smem(itemsize: int, tile, planes: int, rank: int) -> int:
    """Shared memory of the colour form's tile (NtColourGeom): x alone, the
    tile's colour planes (one plane in rank 2), rows and columns, each two
    cells apart, with a halo of one cell, the columns widened to whole
    16-byte vectors."""
    vec = 16 // itemsize
    staged = 2 * planes + 1 if rank == 3 else 1
    return staged * (2 * tile[0] + 1) * (2 * tile[1] + vec) * itemsize


def colour_plan(op: Operation, tiles=None) -> Optional[ApplyPlan]:
    """The colour form's plan: the first of `tiles` (default COLOUR_TILES
    of the apply's rank), counted in colour cells, whose staged x fits
    COLOUR_SMEM, or None. Its halo is (1, 1, 1) in rank 3, (0, 1, 1) in
    rank 2, whose tiles have one plane."""
    rank = op.results[0].type.bounds.rank
    itemsize = _ITEMSIZE[op.results[0].type.element]
    for t1, t2, r, d in tiles or COLOUR_TILES[rank]:
        smem = colour_smem(itemsize, (t1, t2), d, rank)
        if smem <= COLOUR_SMEM and (rank == 3 or d == 1):
            return ApplyPlan((t1, t2), r, d, (int(rank == 3), 1, 1), t2 * (t1 // r), smem)
    return None


def colour_cells(op: Operation, colour: int) -> tuple:
    """Per dim, (first, count): the grid index of the first cell of
    `colour` inside the apply's bounds and the number of its cells, a
    cell's colour being the parity of its index from the bounds' lower
    end along each dim, dim 0 the highest bit."""
    tt: TempType = op.results[0].type
    rank = tt.bounds.rank
    meta = window_meta(tt.bounds.shape, op.attrs["bounds"], tt.bounds.lb)
    out = []
    for d in range(rank):
        lo, hi = int(meta[6 + 3 - rank + d]), int(meta[9 + 3 - rank + d])
        first = lo + ((colour >> (rank - 1 - d)) & 1)
        out.append((first, max(0, (hi - first + 1) // 2)))
    return tuple(out)


def colour_sizes(op: Operation, colour: int) -> dict:
    """The sizes a colour-form launch's span carries, for its roofline: the
    colour's cells, 2^rank + 3 grids of them (x read whole, b, 1/diag and x
    at the colour's cells), the element size, and form "colour"."""
    rank = op.results[0].type.bounds.rank
    cells = int(np.prod([n for _, n in colour_cells(op, colour)]))
    return dict(cells=cells, grids=2**rank + 3,
                itemsize=_ITEMSIZE[op.results[0].type.element], form="colour")


def _colour_of(op: Operation, c) -> int:
    rank = op.results[0].type.bounds.rank
    v = float(c)
    if not (v == int(v) and 0 <= v < 2**rank):
        raise ValueError(f"colour pass: colour {c!r} is not one of 0..{2**rank - 1}")
    return int(v)


def colour_slices(op: Operation, c) -> tuple:
    """The grid slices of the cells of colour `c` inside the apply's
    bounds (`colour_cells`)."""
    return tuple(slice(f, f + 2 * n, 2) for f, n in colour_cells(op, _colour_of(op, c)))


class _Launch:
    """What every launch of one apply's kernel shares: its C entry, the grid
    metadata, the output shape and dtype, and the argument buffers, built
    once and refilled per launch."""

    def __init__(self, op: Operation, plan):
        self.op = op  # held so that id(op) stays unique while cached
        out_type: TempType = op.results[0].type
        self.shape = out_type.bounds.shape
        self.cells = int(np.prod(self.shape))
        self.dtype = torch_backend.DTYPES[out_type.element]
        self.n_in = op.attrs.get("num_inputs", len(op.operands))
        self.n_out = len(op.results)
        self.plan = apply_plan(op) if plan == "auto" else plan
        lib = builder.load(codegen.apply_source(op, self.plan), "stencil_apply")
        self.fn = lib.nt_apply
        self.fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
        self.fn.restype = ctypes.c_int
        self.in_ptrs = (ctypes.c_void_p * max(self.n_in, 1))()
        self.out_ptrs = (ctypes.c_void_p * self.n_out)()
        self.scalars = np.zeros(max(len(op.operands) - self.n_in, 1), dtype=np.float64)
        self.addrs = (ctypes.addressof(self.in_ptrs), ctypes.addressof(self.out_ptrs),
                      self.scalars.ctypes.data)
        self.meta = window_meta(self.shape, op.attrs["bounds"], out_type.bounds.lb)
        self.meta_addr = self.meta.ctypes.data
        # (block shape, global start) -> the window form's launch data and
        # its address
        self.metas: dict[tuple, tuple] = {}

    def window(self, shape: tuple, global_start) -> int:
        key = (shape, tuple(int(x) for x in global_start))
        hit = self.metas.get(key)
        if hit is None:
            meta = window_meta(shape, self.op.attrs["bounds"], key[1])
            hit = self.metas[key] = (meta, meta.ctypes.data)
        return hit[1]


def _launcher(op: Operation, plan="auto") -> _Launch:
    key = (id(op), arithmetic(), plan)
    hit = _kernels.get(key)
    if hit is None:
        hit = _kernels[key] = _Launch(op, plan)
    return hit


class _ColourLaunch:
    """What every launch of one colour pass's colour form shares: its C
    entry, the argument buffers, and each colour's launch data (the grid's,
    then the colour's first cells and counts, rank-3 padded) and sizes."""

    def __init__(self, op: Operation, plan):
        self.op = op  # held so that id(op) stays unique while cached
        tt: TempType = op.results[0].type
        self.shape = tt.bounds.shape
        self.dtype = torch_backend.DTYPES[tt.element]
        self.n_in = op.attrs.get("num_inputs", len(op.operands))
        self.plan = colour_plan(op) if plan == "auto" else plan
        lib = builder.load(codegen.colour_source(op, self.plan), "stencil_apply")
        self.fn = lib.nt_apply_colour
        self.fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
        self.fn.restype = ctypes.c_int
        self.in_ptrs = (ctypes.c_void_p * self.n_in)()
        self.in_addr = ctypes.addressof(self.in_ptrs)
        self.scalars = np.zeros(len(op.operands) - self.n_in, dtype=np.float64)
        grid = window_meta(self.shape, op.attrs["bounds"], tt.bounds.lb)
        pad = [(0, 1)] * (3 - len(self.shape))
        self.metas, self.sizes = [], []
        for colour in range(2 ** len(self.shape)):
            cells = pad + list(colour_cells(op, colour))
            meta = np.concatenate([grid, [f for f, _ in cells], [n for _, n in cells]])
            meta = meta.astype(np.int32)
            self.metas.append((meta, meta.ctypes.data))
            self.sizes.append(colour_sizes(op, colour))


def _colour_launcher(op: Operation, plan="auto") -> _ColourLaunch:
    key = (id(op), arithmetic(), "colour", plan)
    hit = _kernels.get(key)
    if hit is None:
        hit = _kernels[key] = _ColourLaunch(op, plan)
    return hit


def apply_colour(op: Operation, x, inputs: Sequence, scalars: Sequence, plan="auto"):
    """Kernel A's colour form of the colour pass `op` (`colour_form(op)`):
    the pass over the cells of colour `scalars[-1]` only, written into x in
    place; returns x. x is the pass's first input, `inputs` its others (b
    and 1/diag), `scalars` its scalars. On CPU tensors the plain version:
    the pass computed out of place, then written into x at the colour's
    cells. On the card one launch, counted as `stencil_apply`, whose span
    carries `colour_sizes`. plan: the plan to build, default
    `colour_plan(op)`."""
    colour = _colour_of(op, scalars[-1])
    if x.device.type == "cpu":
        n_in = op.attrs.get("num_inputs", len(op.operands))
        sv = [torch_backend.scalar_tensor(v, o.type) for v, o in zip(scalars, op.operands[n_in:])]
        cells = colour_slices(op, colour)
        x[cells] = torch_backend.execute_apply(op, [x, *inputs, *sv])[cells]
        return x
    if x.device.type != "cuda":
        raise ValueError(f"stencil_apply colour form: no kernel for device {x.device}")
    with counter.launch() as s:
        k = _colour_launcher(op, plan)
        if s is not counter:
            s.set(**k.sizes[colour])
        if len(inputs) != k.n_in - 1 or len(scalars) != len(k.scalars):
            raise TypeError(f"stencil_apply colour form: {k.n_in - 1} inputs after x and "
                            f"{len(k.scalars)} scalars expected")
        if x.dtype != k.dtype or tuple(x.shape) != k.shape or not x.is_contiguous():
            raise ValueError(
                f"stencil_apply colour form: x {tuple(x.shape)} {x.dtype}, expected a "
                f"contiguous {k.shape} {k.dtype} tensor to update in place")
        ins = []  # held until the launch is queued
        for j, a in enumerate(inputs, 1):
            if a.device != x.device or tuple(a.shape) != k.shape:
                raise ValueError(
                    f"stencil_apply colour form: input {tuple(a.shape)} on {a.device}, "
                    f"expected {k.shape} on {x.device}")
            ins.append(a.to(k.dtype).contiguous())
            k.in_ptrs[j] = ins[-1].data_ptr()
        k.in_ptrs[0] = x.data_ptr()
        for j, v in enumerate(scalars):
            k.scalars[j] = float(v)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        check(k.fn(x.device.index or 0, k.in_addr, k.scalars.ctypes.data, k.metas[colour][1],
                   stream), "stencil_apply colour form launch")
    return x


def window_meta(shape: Sequence[int], bounds: Bounds, global_start: Sequence[int]) -> np.ndarray:
    """Launch data of a grid or a local block: its extents, its logical
    origin (the whole grid's lower bound, or a block's global start), and
    the apply's bounds in its cells, clipped to it (the box may be empty)."""
    pad = 3 - len(shape)
    g = [int(x) for x in global_start]
    lo = [min(max(b - s, 0), n) for b, s, n in zip(bounds.lb, g, shape)]
    hi = [min(max(b - s, 0), n) for b, s, n in zip(bounds.ub, g, shape)]
    return np.array(
        [1] * pad + list(shape) + [0] * pad + g + [0] * pad + lo + [1] * pad + hi,
        dtype=np.int32,
    )


def _launch(k: _Launch, inputs: Sequence, scalars: Sequence, device, shape, meta_addr: int,
            what: str):
    shape = tuple(shape)
    ins = []  # held until the launch is queued
    for j, a in enumerate(inputs):
        if a.device != device or tuple(a.shape) != shape:
            raise ValueError(
                f"{what}: input {tuple(a.shape)} on {a.device}, expected {shape} on {device}"
            )
        ins.append(a.to(k.dtype).contiguous())
        k.in_ptrs[j] = ins[-1].data_ptr()
    outs = [torch.empty(shape, dtype=k.dtype, device=device) for _ in range(k.n_out)]
    for j, o in enumerate(outs):
        k.out_ptrs[j] = o.data_ptr()
    for j, v in enumerate(scalars):
        k.scalars[j] = float(v)
    stream = torch.cuda.current_stream(device).cuda_stream
    check(k.fn(device.index or 0, *k.addrs, meta_addr, stream), f"{what} launch")
    return outs[0] if len(outs) == 1 else tuple(outs)


def stencil_apply(op: Operation, inputs: Sequence, scalars: Sequence, device, global_start=None,
                  plan="auto", shape=None):
    """Launch kernel A on CUDA tensors: returns the result tensor(s). With
    global_start, the window form over one local block whose cell 0 has
    these global logical coordinates (counted as `stencil_apply_window`);
    the block's shape is the inputs', or `shape` for an apply with none.
    plan: the tiled plan to build, default `apply_plan(op)`."""
    if global_start is None:
        with counter.launch() as s:
            k = _launcher(op, plan)
            if s is not counter:  # recording: the launch's sizes, for its roofline
                s.set(cells=k.cells, grids=k.n_in + k.n_out, itemsize=k.dtype.itemsize)
            return _launch(k, inputs, scalars, device, k.shape, k.meta_addr, "stencil_apply")
    with window_counter.launch():
        k = _launcher(op, plan)
        shape = tuple(inputs[0].shape) if inputs else tuple(shape)
        if len(shape) != len(k.shape):
            raise ValueError(f"stencil_apply_window: block {shape} has not the rank of {k.shape}")
        return _launch(k, inputs, scalars, device, shape, k.window(shape, global_start),
                       "stencil_apply_window")


def apply_window(op: Operation, inputs: Sequence, scalars: Sequence, global_start: Sequence[int],
                 shape=None, device=None):
    """Kernel A's window form: the apply over one local block whose cell 0
    has the global logical coordinates `global_start`. The plain version
    for CPU tensors, the kernel for CUDA ones. The caller has checked
    `supported(op)`. An apply with no inputs names its block's `shape` and
    `device`."""
    device = inputs[0].device if inputs else torch.device(device)
    if device.type == "cpu":
        return torch_backend.execute_apply_window(
            op, inputs, scalars, global_start, shape=shape, device=device)
    if device.type != "cuda":
        raise ValueError(f"stencil_apply_window: no kernel for device {device}")
    return stencil_apply(op, inputs, scalars, device, global_start, shape=shape)
