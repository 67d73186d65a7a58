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
package's does: f64, rank 1 and inputs off the output's domain take the
eager path. Given CPU tensors it runs the kernel's plain version
(`torch_backend.execute_apply`); given CUDA tensors it launches the kernel
or raises.

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

_SUPPORTED_DTYPES = ("float32", "bfloat16")

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
    `tiles` (default APPLY_TILES of its rank) whose shared memory fits
    APPLY_SMEM, or None (the first design)."""
    rank = op.results[0].type.bounds.rank
    n_in = op.attrs.get("num_inputs", len(op.operands))
    itemsize = 2 if op.results[0].type.element == "bfloat16" else 4
    halo = codegen.body_reach(op)
    for t1, t2, r, d in tiles or APPLY_TILES[rank]:
        smem = apply_smem(n_in, itemsize, (t1, t2), halo, d)
        if smem <= APPLY_SMEM:
            return ApplyPlan((t1, t2), r, d, halo, t2 * (t1 // r), smem)
    return None


def source(op: Operation, plan="auto") -> str:
    """Kernel A's generated source for one apply, under its plan."""
    return codegen.apply_source(op, apply_plan(op) if plan == "auto" else plan)


def supported(op: Operation) -> bool:
    """f32 or bf16, rank 2 or 3, every input and result on the output's
    domain and type."""
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


class _Launch:
    """What every launch of one apply's kernel shares: its C entry, the grid
    metadata, the output shape and dtype, and the argument buffers, built
    once and refilled per launch."""

    def __init__(self, op: Operation, plan):
        self.op = op  # held so that id(op) stays unique while cached
        out_type: TempType = op.results[0].type
        self.shape = out_type.bounds.shape
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
        with counter.launch():
            k = _launcher(op, plan)
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
