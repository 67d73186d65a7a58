"""Kernel A, stencil_apply: one `neptune.apply` as a generated Hopper kernel.

The port of `neptune_tpu/lowering/pallas_backend.py`'s whole-grid applies.
One CUDA kernel (`csrc/nt_apply.cuh` plus a body generated from the IR by
`kernels/codegen.py`) replaces three TPU kernels:

  pallas_backend.py::_execute            (multi-copy dim-0 slabs)
  pallas_backend.py::_execute_dma_rank3  (rolling-window ring fetch, rank 3)
  pallas_backend.py::_execute_dma_rank2  (rolling window, 2 <= h0 <= 8)

Their VMEM slab budgets, sublane halo padding and ring DMA choreography have
no counterpart here: one thread computes one cell and reads its neighbours
from global memory. Bound on the H100: bytes (a 5-pt f32 apply moves at
least 8 B per cell). This first version does no shared-memory tiling and no
TMA; that is later work.

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
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import config
from ..ir.core import Operation
from ..ir.types import Bounds, TempType
from ..kernels import codegen
from ..kernels.build import LaunchCounter, builder, check
from . import torch_backend

_SUPPORTED_DTYPES = ("float32", "bfloat16")

counter = LaunchCounter("stencil_apply")
window_counter = LaunchCounter("stencil_apply_window")

# (id(op), config.fold_affine) -> its launch data (which holds the op); the
# generated body depends on the fold setting
_kernels: dict[tuple[int, bool], "_Launch"] = {}


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
    refuses it. `device` places an apply that has no tensor inputs."""
    if not supported(op):
        return None
    n_in = op.attrs.get("num_inputs", len(op.operands))
    if n_in:
        device = operand_arrays[0].device
    device = torch.device(device or "cpu")
    if device.type == "cpu":
        return torch_backend.execute_apply(op, operand_arrays, device=device)
    if device.type != "cuda":
        raise ValueError(f"stencil_apply: no kernel for device {device}")
    return stencil_apply(op, operand_arrays[:n_in], operand_arrays[n_in:], device)


class _Launch:
    """What every launch of one apply's kernel shares: its C entry, the grid
    metadata and the output shape and dtype."""

    def __init__(self, op: Operation):
        self.op = op  # held so that id(op) stays unique while cached
        out_type: TempType = op.results[0].type
        self.shape = out_type.bounds.shape
        self.dtype = torch_backend.DTYPES[out_type.element]
        self.n_out = len(op.results)
        lib = builder.load(codegen.apply_source(op), "stencil_apply")
        self.fn = lib.nt_apply
        self.fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
        self.fn.restype = ctypes.c_int
        self.meta = window_meta(self.shape, op.attrs["bounds"], out_type.bounds.lb)


def _launcher(op: Operation) -> _Launch:
    key = (id(op), config.fold_affine)
    hit = _kernels.get(key)
    if hit is None:
        hit = _kernels[key] = _Launch(op)
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


def _launch(k: _Launch, inputs: Sequence, scalars: Sequence, device, shape, meta, what: str):
    ins = []
    for a in inputs:
        if a.device != device or tuple(a.shape) != tuple(shape):
            raise ValueError(
                f"{what}: input {tuple(a.shape)} on {a.device}, expected {tuple(shape)} on {device}"
            )
        ins.append(a.to(k.dtype).contiguous())
    outs = [torch.empty(tuple(shape), dtype=k.dtype, device=device) for _ in range(k.n_out)]
    in_ptrs = (ctypes.c_void_p * max(len(ins), 1))(*[a.data_ptr() for a in ins])
    out_ptrs = (ctypes.c_void_p * k.n_out)(*[o.data_ptr() for o in outs])
    sv = np.array([float(s) for s in scalars] or [0.0], dtype=np.float64)
    stream = torch.cuda.current_stream(device).cuda_stream
    check(
        k.fn(device.index or 0, ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs),
             sv.ctypes.data, meta.ctypes.data, stream),
        f"{what} launch",
    )
    return outs[0] if len(outs) == 1 else tuple(outs)


def stencil_apply(op: Operation, inputs: Sequence, scalars: Sequence, device, global_start=None):
    """Launch kernel A on CUDA tensors: returns the result tensor(s). With
    global_start, the window form over one local block whose cell 0 has
    these global logical coordinates (counted as `stencil_apply_window`)."""
    k = _launcher(op)
    if global_start is None:
        out = _launch(k, inputs, scalars, device, k.shape, k.meta, "stencil_apply")
        counter.count += 1
        return out
    shape = tuple(inputs[0].shape)
    if len(shape) != len(k.shape):
        raise ValueError(f"stencil_apply_window: block {shape} has not the rank of {k.shape}")
    meta = window_meta(shape, op.attrs["bounds"], global_start)
    out = _launch(k, inputs, scalars, device, shape, meta, "stencil_apply_window")
    window_counter.count += 1
    return out


def apply_window(op: Operation, inputs: Sequence, scalars: Sequence, global_start: Sequence[int]):
    """Kernel A's window form: the apply over one local block whose cell 0
    has the global logical coordinates `global_start`. The plain version
    for CPU tensors, the kernel for CUDA ones. The caller has checked
    `supported(op)`."""
    device = inputs[0].device
    if device.type == "cpu":
        return torch_backend.execute_apply_window(op, inputs, scalars, global_start)
    if device.type != "cuda":
        raise ValueError(f"stencil_apply_window: no kernel for device {device}")
    return stencil_apply(op, inputs, scalars, device, global_start)
