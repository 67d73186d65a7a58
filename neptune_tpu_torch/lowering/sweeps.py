"""Kernel C, stencil_sweeps: K sweeps of one unary apply per pass over
device memory (temporal blocking).

The port of `neptune_tpu/lowering/pallas_multisweep.py`. Its three TPU
kernels -- the VMEM-resident grid (`execute_sweeps_resident`), dim-0 slabs
(`_sweeps_window_impl`) and slabs x panels (`_sweeps_window2_impl`) --
differ only in how they stage the grid through VMEM. On the H100 one kernel
(`csrc/nt_sweeps.cuh`) covers all three: one block per output tile, the
tile and a depth·h halo in shared memory, `depth` sweeps there.

Here:
  * `find_sweep_apply`: the JAX package's eligibility, unchanged;
  * `sweep_plan`: the Hopper plan -- output tile, sweeps per launch
    (`depth`) and shared memory -- as pure Python;
  * `run_sweeps`: `depth` sweeps, through the kernel on a CUDA tensor and
    through the plain version on a CPU tensor;
  * `sweeps_plain`: the plain version, `depth` eager applies;
  * `local_sweep_plan` / `run_sweeps(global_start=)`: the local form over one block
    of a sharded grid (`parallel.shardmap_sweeps`), which replaces
    `pallas_multisweep.py::execute_sweeps_window_local` (kernels #7 and #8
    with `global_start`). The same kernel with other launch data: the
    block's extents, its global start as the logical origin and the bounds
    clipped to the block; cells beyond the block hold 0, so the edge zone
    that the caller's bands recompute is the only one that differs from
    the whole grid's sweeps. Counted apart as `stencil_sweeps_local`.
The TPU-only mechanics (VMEM budgets, slab and panel picking, 8-row and
128-lane alignment, the unroll guard) have no counterpart here.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import config
from ..ir.core import Module, Operation
from ..ir.types import StencilShape, TempType
from ..kernels import codegen
from ..kernels.build import LaunchCounter, builder, check
from . import torch_backend
from .cuda_backend import apply_window, supported, window_meta

counter = LaunchCounter("stencil_sweeps")
local_counter = LaunchCounter("stencil_sweeps_local")

# dynamic shared memory one block may use on the H100 (232,448 bytes)
SMEM_MAX = 227 * 1024

# output tiles, preferred first: the first whose buffers fit is taken
TILES = {2: ((64, 64), (32, 64), (32, 32)), 3: ((16, 16, 32), (8, 16, 32), (8, 8, 32), (4, 8, 32))}

# a depth is planned only while the halo cells recomputed per launch keep
# the cell updates under this multiple of depth x tile cells. Measured on
# an H100 80GB HBM3 at 700 W (PERF.md): rank-3 sweeps are bound by those updates, and
# 7-pt 256^3 K=8 ran fastest at depth 2 (1.17x recompute), slower at depth
# 4 (1.59x) and 8 (5x); rank-2 sweeps gain from depth up to about 2x.
MAX_RECOMPUTE = {2: 2.0, 3: 1.5}

# (id(op), depth, tile, config.fold_affine) -> (op, C entry)
_kernels: dict[tuple, tuple] = {}


def find_sweep_apply(module: Module, name: str) -> Optional[Operation]:
    """The single apply op of a unary opdef eligible for the K-sweep
    kernel, or None (the caller runs k single applies).

    As in the JAX package (`find_sweep_apply` and `sweeps_plan`): the opdef
    body is exactly one apply of the opdef's one temp argument onto its
    own domain, float32, rank 2 or 3, one result, scalar operands exactly
    the opdef's trailing args in order, a nonzero dim-0 halo smaller than
    the grid, and a periodic apply only over the whole domain.
    """
    fn = module.lookup(name)
    if not getattr(fn, "is_opdef", False):
        return None
    if len(fn.ftype.results) != 1 or not fn.ftype.inputs:
        return None
    if not isinstance(fn.ftype.inputs[0], TempType) or any(
        isinstance(t, TempType) for t in fn.ftype.inputs[1:]
    ):
        return None
    apply_op = None
    for op in fn.body.ops:
        if op.name == "neptune.apply":
            if apply_op is not None:
                return None
            apply_op = op
        elif op.name not in ("neptune.return", "arith.constant"):
            return None
    if apply_op is None:
        return None
    out_type: TempType = apply_op.results[0].type
    if not _eligible(apply_op, out_type.bounds.shape):
        return None
    if apply_op.operands[0].uid != fn.body.args[0].uid:
        return None
    if [o.uid for o in apply_op.operands[1:]] != [a.uid for a in fn.body.args[1:]]:
        return None
    if apply_op.attrs.get("periodic") and apply_op.attrs["bounds"] != out_type.bounds:
        return None
    return apply_op


def _eligible(op: Operation, shape: Sequence[int]) -> bool:
    """The checks on the apply itself, over a grid or block of `shape`:
    float32, rank 2 or 3, one input on the result's domain and one result,
    a nonzero dim-0 halo and every halo under the extent."""
    out_type: TempType = op.results[0].type
    rank = len(shape)
    if out_type.element != "float32" or rank not in (2, 3) or out_type.bounds.rank != rank:
        return False
    n_in = op.attrs.get("num_inputs", len(op.operands))
    if n_in != 1 or len(op.results) != 1 or op.operands[0].type.bounds != out_type.bounds:
        return False
    sshape: StencilShape = op.attrs.get("shape") or StencilShape(())
    if not sshape.offsets:
        return False
    halos = [max(h) for h in sshape.halo()]
    return halos[0] >= 1 and all(h < n for h, n in zip(halos, shape))


@dataclass(frozen=True)
class SweepPlan:
    """One launch of kernel C: `depth` sweeps of `op` over output tiles of
    extents `tile`, each held with a halo of depth x `halo` cells per side in
    two shared-memory buffers, `smem_bytes` in all. `recompute` is the cell
    updates of a launch over depth x the tile's cells."""

    op: Operation
    depth: int
    halo: tuple
    tile: tuple
    smem_bytes: int
    recompute: float


def smem_bytes(n_buffers: int, tile: Sequence[int], halo: Sequence[int]) -> int:
    """Shared memory of a tile (csrc/nt_tile.cuh): n_buffers f32 buffers of
    the tile and its halo, then the int table of wrapped cells per dim."""
    w = [t + 2 * h for t, h in zip(tile, halo)]
    if len(w) == 2:
        w = [1] + w
    return 4 * (n_buffers * math.prod(w) + sum(w))


def tile_geometry(halo: Sequence[int], tile: Sequence[int], depth: int) -> tuple[int, float]:
    """(shared-memory bytes, recompute) of `depth` sweeps on one tile."""
    w = [t + 2 * depth * h for t, h in zip(tile, halo)]
    updates = sum(
        math.prod(x - 2 * s * h for x, h in zip(w, halo)) for s in range(1, depth + 1)
    )
    smem = smem_bytes(2, tile, [depth * h for h in halo])
    return smem, updates / (depth * math.prod(tile))


def _at_depth(op: Operation, halo: tuple, depth: int) -> Optional[SweepPlan]:
    """The plan on the largest preferred tile whose buffers fit."""
    for tile in TILES[len(halo)]:
        smem, recompute = tile_geometry(halo, tile, depth)
        if smem <= SMEM_MAX:
            return SweepPlan(op, depth, halo, tile, smem, recompute)
    return None


def sweep_plan(module: Module, name: str, k: int, depth: Optional[int] = None) -> Optional[SweepPlan]:
    """The kernel-C plan for k sweeps of opdef @name, or None (k single
    applies). depth=None picks the deepest depth <= k, divisors of k first,
    whose buffers fit and whose recompute stays under MAX_RECOMPUTE of its
    rank; a given depth is planned as asked, if its buffers fit."""
    op = find_sweep_apply(module, name)
    if op is None or k < 2:
        return None
    return _plan(op, k, depth)


def local_sweep_plan(op: Operation, shape: Sequence[int], k: int) -> Optional[SweepPlan]:
    """The kernel-C plan for k sweeps of apply `op` over a local block of
    `shape`, or None. The eligibility of the JAX package's
    `local_window_plan`: `_eligible` on the block, not periodic, k >= 2."""
    if op.attrs.get("periodic") or k < 2 or not _eligible(op, shape):
        return None
    return _plan(op, k, None)


def _plan(op: Operation, k: int, depth: Optional[int]) -> Optional[SweepPlan]:
    halo = tuple(max(h) for h in op.attrs["shape"].halo())
    if depth is not None:
        return _at_depth(op, halo, depth) if 2 <= depth <= k else None
    order = [d for d in range(k, 1, -1) if k % d == 0] + [d for d in range(k, 1, -1) if k % d]
    for d in order:
        plan = _at_depth(op, halo, d)
        if plan is not None and plan.recompute <= MAX_RECOMPUTE[len(halo)]:
            return plan
    return None


def sweeps_plain(plan: SweepPlan, x: torch.Tensor, scalars: Sequence, global_start=None) -> torch.Tensor:
    """The plain version: plan.depth eager applies, or with global_start
    plan.depth eager window applies over one local block."""
    if global_start is not None:
        for _ in range(plan.depth):
            x = torch_backend.execute_apply_window(plan.op, [x], scalars, global_start)
        return x
    sv = [torch_backend.scalar_tensor(s, v.type) for v, s in zip(plan.op.operands[1:], scalars)]
    for _ in range(plan.depth):
        x = torch_backend.execute_apply(plan.op, [x] + sv)
    return x


def run_sweeps(plan: SweepPlan, x: torch.Tensor, scalars: Sequence, global_start=None) -> torch.Tensor:
    """plan.depth sweeps of x: the plain version for a CPU tensor, one
    launch of kernel C for a CUDA tensor. global_start: the local form,
    over one block whose cell 0 has these global logical coordinates."""
    if x.device.type == "cpu":
        return sweeps_plain(plan, x, scalars, global_start)
    if x.device.type != "cuda":
        raise ValueError(f"stencil_sweeps: no kernel for device {x.device}")
    return stencil_sweeps(plan, x, scalars, global_start)


def sweeps_local(op: Operation, x: torch.Tensor, scalars: Sequence, k: int, global_start):
    """k zero-ghost sweeps of one local block through the kernels, or None
    when neither takes the apply: k // depth launches of kernel C's local
    form, the sweeps left over (or all k, where `local_sweep_plan` refuses
    the block) through kernel A's window form -- the JAX package's order of
    preference (`shardmap_sweeps`)."""

    plan = local_sweep_plan(op, tuple(x.shape), k)
    if plan is None and not supported(op):
        return None
    y = x.to(torch_backend.DTYPES[op.results[0].type.element])
    n_c = 0 if plan is None else k // plan.depth
    for _ in range(n_c):
        y = run_sweeps(plan, y, scalars, global_start)
    for _ in range(k - n_c * (plan.depth if plan else 0)):
        y = apply_window(op, [y], scalars, global_start)
    return y


def source(plan: SweepPlan) -> str:
    """Kernel C's generated source for a plan."""
    pad = 3 - len(plan.tile)
    return codegen.sweeps_source(plan.op, plan.depth, (0,) * pad + plan.halo, (1,) * pad + plan.tile)


def _entry(plan: SweepPlan):
    key = (id(plan.op), plan.depth, plan.tile, config.fold_affine)
    hit = _kernels.get(key)
    if hit is None:
        fn = builder.load(source(plan), "stencil_sweeps").nt_sweeps
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        out = plan.op.results[0].type.bounds
        hit = _kernels[key] = (plan.op, fn, window_meta(out.shape, plan.op.attrs["bounds"], out.lb))
    return hit[1], hit[2]


def stencil_sweeps(plan: SweepPlan, x: torch.Tensor, scalars: Sequence, global_start=None) -> torch.Tensor:
    """Launch kernel C once on a CUDA tensor: plan.depth sweeps. With
    global_start, the local form over one block (counted as
    `stencil_sweeps_local`)."""
    fn, meta = _entry(plan)
    if global_start is None:
        shape, what = plan.op.results[0].type.bounds.shape, "stencil_sweeps"
    else:
        shape, what = tuple(x.shape), "stencil_sweeps_local"
        meta = window_meta(shape, plan.op.attrs["bounds"], global_start)
    if x.device.type != "cuda" or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what}: input {tuple(x.shape)} on {x.device}, expected {tuple(shape)} on cuda")
    x = x.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    sv = np.array([float(s) for s in scalars] or [0.0], dtype=np.float64)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    check(
        fn(x.device.index or 0, x.data_ptr(), out.data_ptr(), sv.ctypes.data, meta.ctypes.data, stream),
        f"{what} launch",
    )
    (counter if global_start is None else local_counter).count += 1
    return out
