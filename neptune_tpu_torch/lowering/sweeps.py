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
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import arithmetic
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


# Tiles of the register-strip design (csrc/nt_sweeps.cuh), as (columns per
# lane kC, planes kT0, rows kT1, rows per strip kR, planes per task kL): a
# tile row is 32 kC cells, halo included. Its left halo is depth h2 widened
# to whole 16-byte vectors, and the output tile is the columns left, down to
# a multiple of 4, so that interior tiles load as 16-byte vectors.
TILES = {
    2: ((4, 1, 64, 8, 1), (8, 1, 64, 8, 1), (4, 1, 32, 8, 1), (8, 1, 32, 8, 1),
        (2, 1, 32, 8, 1)),
    3: ((1, 16, 16, 4, 8), (1, 8, 16, 4, 8), (2, 8, 8, 4, 4), (2, 4, 8, 4, 4), (1, 4, 8, 4, 4)),
}
WARPS_MAX = 16
# tiles under SMEM_PAIR are preferred: two blocks share an SM, so one
# block's load and store overlap the other's sweeps
SMEM_PAIR = SMEM_MAX // 2

# a depth is planned only while the cell updates of a launch (the
# recomputed halo included) stay under this multiple of depth x tile cells.
# Timed on an H100 80GB HBM3 at 700 W (scripts/torch_tile_times.py,
# PERF.md): 5-pt 4096^2 ran faster at depth 16 (1.71x) than at 8 (1.32x),
# adv4 8192^2 at depth 8 (1.67x) than at 16 (3.0x), 7-pt 256^3 at depth 2
# (1.60x) than at 4 (2.01x).
MAX_RECOMPUTE = 1.75

# (plan, (fold, pinned)) -> its launch data (the plan holds its op;
# `config.arithmetic`)
_kernels: dict[tuple, "_Launch"] = {}


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
    two shared-memory buffers of `rows` rows (padded), `smem_bytes` in all,
    the left halo widened to `pad` columns; each lane of `warps` warps owns
    `cols` columns of a row, each task a strip of `strip` rows over a run of
    `run` planes. `recompute` is the cell updates of a launch over depth x
    the tile's cells."""

    op: Operation
    depth: int
    halo: tuple
    tile: tuple
    smem_bytes: int
    recompute: float
    cols: int
    strip: int
    run: int
    pad: int
    warps: int
    rows: int


def strip_geometry(halo: Sequence[int], spec: Sequence[int], depth: int) -> Optional[dict]:
    """The register-strip tile `spec` = (kC, kT0, kT1, kR, kL) at `depth` for an
    apply of per-dim `halo` (rank 2 or 3): its output tile, buffer rows,
    warps, shared memory, cell updates per launch, recompute and bytes per
    launch; None where the tile row leaves no output column or the column
    halo needs more than the next lane."""
    c, t0, t1, r, run = spec
    h0, h1, h2 = (0,) * (3 - len(halo)) + tuple(halo)
    w2 = 32 * c
    pad = -(-depth * h2 // 4) * 4
    t2 = (w2 - pad - depth * h2) // 4 * 4
    if t2 < 1 or h2 > c:
        return None
    w0, w1 = t0 + 2 * depth * h0, t1 + 2 * depth * h1

    def strips(s):
        return -(-(w1 - 2 * s * h1) // r)

    sweeps = range(1, depth + 1)
    rows = max(s * h1 + strips(s) * r + h1 for s in sweeps)
    updates = sum((w0 - 2 * s * h0) * strips(s) * r * w2 for s in sweeps)
    cells = t0 * t1 * t2
    tile = (t1, t2) if len(halo) == 2 else (t0, t1, t2)
    return {
        "tile": tile,
        "pad": pad,
        "rows": rows,
        "warps": min(WARPS_MAX, -(-(w0 - 2 * h0) // run) * strips(1)),
        "smem": 4 * (2 * w0 * rows * w2 + w0 + rows + w2),
        "updates": updates,
        "recompute": updates / (depth * cells),
        "bytes": 4 * (w0 * w1 * w2 + cells),
        "cells": cells,
    }


def _at_depth(op: Operation, halo: tuple, depth: int, tiles=None) -> Optional[SweepPlan]:
    """The plan at `depth` on the tile of least recompute among those (of
    `tiles`, default TILES of the rank) under SMEM_PAIR, or else among
    those that fit at all."""
    for cap in (SMEM_PAIR, SMEM_MAX):
        best = None
        for spec in tiles or TILES[len(halo)]:
            geo = strip_geometry(halo, spec, depth)
            if geo is None or geo["smem"] > cap:
                continue
            if best is None or geo["recompute"] < best.recompute:
                best = SweepPlan(op, depth, halo, geo["tile"], geo["smem"], geo["recompute"],
                                 spec[0], spec[3], spec[4], geo["pad"], geo["warps"], geo["rows"])
        if best is not None:
            return best
    return None


def sweep_plan(module: Module, name: str, k: int, depth: Optional[int] = None,
               tiles=None) -> Optional[SweepPlan]:
    """The kernel-C plan for k sweeps of opdef @name, or None (k single
    applies). depth=None picks the deepest depth <= k, divisors of k first,
    whose tile keeps the recompute under MAX_RECOMPUTE; a given depth is
    planned as asked, if a tile fits. tiles: the tiles to choose from
    (default TILES of the rank)."""
    op = find_sweep_apply(module, name)
    if op is None or k < 2:
        return None
    return _plan(op, k, depth, tiles)


def local_sweep_plan(op: Operation, shape: Sequence[int], k: int) -> Optional[SweepPlan]:
    """The kernel-C plan for k sweeps of apply `op` over a local block of
    `shape`, or None. The eligibility of the JAX package's
    `local_window_plan`: `_eligible` on the block, not periodic, k >= 2."""
    if op.attrs.get("periodic") or k < 2 or not _eligible(op, shape):
        return None
    return _plan(op, k, None)


def _plan(op: Operation, k: int, depth: Optional[int], tiles=None) -> Optional[SweepPlan]:
    halo = tuple(max(h) for h in op.attrs["shape"].halo())
    if depth is not None:
        return _at_depth(op, halo, depth, tiles) if 2 <= depth <= k else None
    order = [d for d in range(k, 1, -1) if k % d == 0] + [d for d in range(k, 1, -1) if k % d]
    for d in order:
        plan = _at_depth(op, halo, d, tiles)
        if plan is not None and plan.recompute <= MAX_RECOMPUTE:
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
    return codegen.sweeps_source(plan)


class _Launch:
    """What every launch of one plan's kernel shares: its C entry, the
    launch data of the whole grid and of each block it ran on, and the
    scalar buffer, built once and refilled per launch."""

    def __init__(self, plan: SweepPlan):
        self.plan = plan
        self.fn = builder.load(source(plan), "stencil_sweeps").nt_sweeps
        self.fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
        self.fn.restype = ctypes.c_int
        out = plan.op.results[0].type.bounds
        self.shape = out.shape
        self.meta = window_meta(out.shape, plan.op.attrs["bounds"], out.lb)
        self.meta_addr = self.meta.ctypes.data
        # (block shape, global start) -> the local form's launch data and
        # its address
        self.metas: dict[tuple, tuple] = {}
        self.scalars = np.zeros(max(len(plan.op.operands) - 1, 1), dtype=np.float64)
        self.scalars_addr = self.scalars.ctypes.data

    def window(self, shape: tuple, global_start) -> int:
        key = (shape, tuple(int(v) for v in global_start))
        hit = self.metas.get(key)
        if hit is None:
            meta = window_meta(shape, self.plan.op.attrs["bounds"], key[1])
            hit = self.metas[key] = (meta, meta.ctypes.data)
        return hit[1]


def _entry(plan: SweepPlan) -> _Launch:
    key = (plan, arithmetic())
    hit = _kernels.get(key)
    if hit is None:
        hit = _kernels[key] = _Launch(plan)
    return hit


def stencil_sweeps(plan: SweepPlan, x: torch.Tensor, scalars: Sequence, global_start=None) -> torch.Tensor:
    """Launch kernel C once on a CUDA tensor: plan.depth sweeps. With
    global_start, the local form over one block (counted as
    `stencil_sweeps_local`)."""
    with (counter if global_start is None else local_counter).launch():
        k = _entry(plan)
        if global_start is None:
            shape, meta_addr, what = k.shape, k.meta_addr, "stencil_sweeps"
        else:
            shape, what = tuple(x.shape), "stencil_sweeps_local"
            meta_addr = k.window(shape, global_start)
        if x.device.type != "cuda" or tuple(x.shape) != tuple(shape):
            raise ValueError(
                f"{what}: input {tuple(x.shape)} on {x.device}, expected {tuple(shape)} on cuda")
        x = x.to(torch.float32).contiguous()
        out = torch.empty_like(x)
        for j, v in enumerate(scalars):
            k.scalars[j] = float(v)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        check(
            k.fn(x.device.index or 0, x.data_ptr(), out.data_ptr(), k.scalars_addr, meta_addr,
                 stream),
            f"{what} launch",
        )
        return out
