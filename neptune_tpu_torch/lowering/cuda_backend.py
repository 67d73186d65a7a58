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
        self.meta = _meta(out_type.bounds, op.attrs["bounds"])


def _launcher(op: Operation) -> _Launch:
    key = (id(op), config.fold_affine)
    hit = _kernels.get(key)
    if hit is None:
        hit = _kernels[key] = _Launch(op)
    return hit


def _meta(out: Bounds, bounds: Bounds) -> np.ndarray:
    pad = 3 - out.rank
    sl = bounds.rel_slices(out)
    return np.array(
        [1] * pad + list(out.shape)
        + [0] * pad + list(out.lb)
        + [0] * pad + [s.start for s in sl]
        + [1] * pad + [s.stop for s in sl],
        dtype=np.int32,
    )


def stencil_apply(op: Operation, inputs: Sequence, scalars: Sequence, device):
    """Launch kernel A on CUDA tensors: returns the result tensor(s)."""
    k = _launcher(op)
    ins = []
    for a in inputs:
        if a.device != device or tuple(a.shape) != k.shape:
            raise ValueError(
                f"stencil_apply: input {tuple(a.shape)} on {a.device}, "
                f"expected {k.shape} on {device}"
            )
        ins.append(a.to(k.dtype).contiguous())
    outs = [torch.empty(k.shape, dtype=k.dtype, device=device) for _ in range(k.n_out)]
    in_ptrs = (ctypes.c_void_p * max(len(ins), 1))(*[a.data_ptr() for a in ins])
    out_ptrs = (ctypes.c_void_p * k.n_out)(*[o.data_ptr() for o in outs])
    sv = np.array([float(s) for s in scalars] or [0.0], dtype=np.float64)
    stream = torch.cuda.current_stream(device).cuda_stream
    check(
        k.fn(device.index or 0, ctypes.addressof(in_ptrs), ctypes.addressof(out_ptrs),
             sv.ctypes.data, k.meta.ctypes.data, stream),
        "stencil_apply launch",
    )
    counter.count += 1
    return outs[0] if len(outs) == 1 else tuple(outs)
