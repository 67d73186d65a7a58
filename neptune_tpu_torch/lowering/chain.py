"""Kernel D, stencil_chain: a composite opdef's whole apply DAG in one pass
over device memory.

The port of `neptune_tpu/lowering/pallas_chain.py`. A composite operator
(`apply_linear` / `apply_nonlinear` calls plus applies) run stage at a time
moves every intermediate through device memory; kernel D
(`csrc/nt_chain.cuh`) keeps them in shared memory: a block stages every
field argument's output tile with a halo of the DAG's composed reach
(16-byte copies, the column halo widened to whole vectors) and runs the
stages in DAG order over shrinking regions, each walked as strips of cells
down dim 1; tiles inside the grid and the stages' bounds run without
per-cell tests, and a persistent grid keeps the next tiles' copies in
flight while a tile computes.

Here:
  * `_flatten`: the JAX package's flattening of the DAG into stages over
    value slots, unchanged;
  * `chain_plan`: its semantic gates, a composed reach per dim (the JAX
    package tracks dim 0 only: its trailing dims stay whole in VMEM), peak
    live values from `last_use`, shared-memory buffers, the output tile,
    each stage's region and strip;
  * `tile_interior`: the kernel's test for a tile that runs unchecked;
  * `run_chain`: the kernel on CUDA tensors, the plain version on CPU ones;
  * `chain_plain`: the plain version, the stages one eager apply at a time,
    as `CompiledModule` runs the opdef stage by stage.

The origin form runs the chain over one local block of a sharded grid
(`parallel.shardmap_opdef`'s composite route), which replaces
`pallas_chain.py::execute_chain(global_start=...)`: `chain_plan` takes the
block's shape, and the launch gives the block's extents and its global
start as the logical origin. Its stages' bounds are compiled in logical
coordinates and mapped onto the block at run time (`nt_box_at`), so one
build serves every block; a whole-grid plan compiles them as constant boxes
of the grid's cells, which the whole-grid kernel runs faster with. Bounded
chains only, as in the JAX package. Counted apart as `stencil_chain_origin`.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import arithmetic
from ..ir.core import Function, Module, Operation
from ..ir.types import Bounds, ScalarType, StencilShape, TempType
from ..kernels import codegen
from ..kernels.build import LaunchCounter, builder, check
from . import torch_backend
from .cuda_backend import window_meta
from .sweeps import SMEM_MAX

counter = LaunchCounter("stencil_chain")
origin_counter = LaunchCounter("stencil_chain_origin")


class ChainTile(NamedTuple):
    """A candidate schedule of kernel D: the output tile (rank-sized; dim 2
    a whole number of vectors), threads per block, `ahead`: the tiles whose
    copies are in flight while a block computes one (0: one tile per block;
    else a persistent grid, one field set per tile in flight), `blocks`:
    the blocks per SM the compiler must leave registers for (1: no bound
    below the threads'), and the longest strip a thread computes."""

    tile: tuple
    threads: int
    ahead: int
    blocks: int = 1
    max_strip: int = 8


# candidates, preferred first: the first whose shared memory fits twice on
# an SM is taken, else the first that fits at all. Timed on the H100
# (scripts/torch_tile_times.py, PERF.md).
TILES = {
    2: (ChainTile((32, 64), 128, 1, 5), ChainTile((32, 32), 128, 1, 4),
        ChainTile((16, 32), 128, 0, 4)),
    3: (ChainTile((8, 16, 32), 256, 0, 2), ChainTile((8, 8, 32), 256, 0, 2),
        ChainTile((4, 8, 32), 128, 0, 2)),
}

# field arguments one launch takes (csrc/nt_chain.cuh, kNtChainMaxFields)
MAX_FIELDS = 8
# floats per 16-byte copy: the column halo is widened to whole vectors
VEC = 4

# (id(plan), (fold, pinned)) -> the plan's launch data (`config.arithmetic`)
_kernels: dict[tuple, "_Launch"] = {}


class ChainStage(NamedTuple):
    """One apply of the flattened DAG, operands resolved to env slots."""

    op: Operation
    in_slots: tuple  # env slot per field input, in operand order
    # per scalar operand: ("arg", trailing-arg index) | ("const", value, ScalarType)
    scalars: tuple
    out_slot: int


def _flatten(module: Module, fn: Function, arg_binds: list, next_slot: list) -> Optional[tuple]:
    """Flatten an opdef body into ChainStages over env slots.

    arg_binds: one bind per body arg -- an int env slot for temps, or an
    ("arg"/"const", ...) tuple for scalars. Returns (stages, final_binds)
    or None if the body holds anything the chain cannot express.
    """
    env: dict[int, object] = {a.uid: b for a, b in zip(fn.body.args, arg_binds)}
    stages: list[ChainStage] = []
    final = None
    for op in fn.body.ops:
        if op.name == "neptune.apply":
            if len(op.results) != 1:
                return None
            n_in = op.attrs.get("num_inputs", len(op.operands))
            in_slots, scals = [], []
            for o in op.operands[:n_in]:
                b = env.get(o.uid)
                if not isinstance(b, int):
                    return None
                in_slots.append(b)
            for o in op.operands[n_in:]:
                b = env.get(o.uid)
                if not isinstance(b, tuple):
                    return None
                scals.append(b)
            slot = next_slot[0]
            next_slot[0] += 1
            stages.append(ChainStage(op, tuple(in_slots), tuple(scals), slot))
            env[op.results[0].uid] = slot
        elif op.name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
            callee = module.lookup(op.attrs["symbol"])
            binds = [env.get(o.uid) for o in op.operands]
            if any(b is None for b in binds):
                return None
            sub = _flatten(module, callee, binds, next_slot)
            if sub is None:
                return None
            sub_stages, sub_final = sub
            stages.extend(sub_stages)
            if len(op.results) != len(sub_final):
                return None
            for r, b in zip(op.results, sub_final):
                env[r.uid] = b
        elif op.name == "arith.constant":
            env[op.results[0].uid] = ("const", op.attrs["value"], op.results[0].type)
        elif op.name == "neptune.return":
            final = [env.get(o.uid) for o in op.operands]
            if any(f is None for f in final):
                return None
        else:
            return None
    if final is None:
        return None
    return stages, final


@dataclass
class ChainPlan:
    """One launch of kernel D for opdef @name.

    creep[slot]: per dim, how far the slot's valid region has shrunk from
    the field tiles' (the JAX package's dim-0 creep, in every dim); reach:
    the final slot's creep. buffer[slot]: the shared-memory buffer holding
    the slot (fields first; the last stage writes to device memory and
    needs none). peak: the most values live at once, the final one
    included, as the JAX package counts them.

    The schedule (rank-3 padded where it says so): `tile`, `threads`,
    `ahead` and `min_blocks` from the chosen ChainTile; `halo`, the staged
    halo per dim, the reach with dim 2 widened to whole vectors (padded);
    per stage, the first tile position of its region, `regions[i]`
    (padded; the region is [L, W - L) with W the tile plus halo), and its
    strip of cells per thread down dim 1, `strips[i]`."""

    name: str
    stages: list
    final_slot: int
    n_fields: int
    scalar_types: tuple
    outer: Bounds
    creep: dict
    reach: tuple
    last_use: dict
    peak: int
    periodic: bool
    buffer: dict
    n_buffers: int
    tile: tuple
    threads: int
    ahead: int
    min_blocks: int
    halo: tuple
    regions: tuple
    strips: tuple
    smem_bytes: int
    shape: tuple  # the grid or block the plan runs over
    origin: bool  # a block's plan: stage boxes mapped at run time

    @property
    def rank(self) -> int:
        return self.outer.rank

    @property
    def n_scalars(self) -> int:
        return len(self.scalar_types)

    @property
    def tile3(self) -> tuple:
        return (1,) * (3 - self.rank) + tuple(self.tile)

    @property
    def width(self) -> tuple:
        """The staged tile, halo included, per dim (padded)."""
        return tuple(t + 2 * h for t, h in zip(self.tile3, self.halo))

    def region(self, i: int) -> tuple:
        """Stage i's region as (first position, extent) per dim (padded)."""
        return tuple((lo, w - 2 * lo) for lo, w in zip(self.regions[i], self.width))


def _halo(op: Operation, rank: int) -> tuple:
    sshape: StencilShape = op.attrs.get("shape") or StencilShape(())
    return tuple(max(h) for h in sshape.halo()) if sshape.offsets else (0,) * rank


def _buffers(stages: list, n_fields: int, last_use: dict) -> tuple[dict, int]:
    """Shared-memory buffer per slot: a value takes a free buffer when its
    stage runs and gives it back after its last use. The last stage writes
    to device memory and takes none."""
    buffer = {f: f for f in range(n_fields)}
    free: list[int] = []
    n = n_fields
    for idx, st in enumerate(stages[:-1]):
        if free:
            buffer[st.out_slot] = free.pop(0)
        else:
            buffer[st.out_slot] = n
            n += 1
        for s in set(st.in_slots) | {st.out_slot}:
            if last_use.get(s, -1) <= idx:
                free.append(buffer[s])
        free.sort()
    return buffer, n


def chain_plan(module: Module, name: str, shape: Optional[Sequence[int]] = None,
               tiles: Optional[Sequence[ChainTile]] = None) -> Optional[ChainPlan]:
    """Plan one kernel-D launch of composite opdef @name over a grid of
    `shape` (default: the opdef's own; a local block's for the origin
    form), or None (the opdef runs stage at a time). tiles: the candidate
    schedules, default TILES of the rank.

    The JAX package's semantic gates: >= 2 applies after inlining the
    opdef's calls, field args on the result's bounds and before the scalar
    args, float32, rank 2 or 3, single-result applies, one opdef result;
    periodic stages on the whole grid only. Beside them: at most
    MAX_FIELDS fields, the composed reach under the grid's extent, the last
    stage computing the result, and buffers that fit in shared memory.
    """
    fn = module.lookup(name)
    if not getattr(fn, "is_opdef", False):
        return None
    if len(fn.ftype.results) != 1 or not fn.ftype.inputs:
        return None
    out_t = fn.ftype.results[0]
    if not isinstance(out_t, TempType) or out_t.element != "float32":
        return None
    outer: Bounds = out_t.bounds
    rank = outer.rank
    if rank not in (2, 3):
        return None
    whole_grid = shape is None
    shape = tuple(outer.shape) if shape is None else tuple(shape)
    if len(shape) != rank:
        return None

    n_fields = 0
    seen_scalar = False
    for t in fn.ftype.inputs:
        if isinstance(t, TempType):
            if seen_scalar or t.element != "float32" or t.bounds != outer:
                return None
            n_fields += 1
        elif isinstance(t, ScalarType):
            seen_scalar = True
        else:
            return None
    if not 0 < n_fields <= MAX_FIELDS:
        return None
    scalar_types = tuple(t.name for t in fn.ftype.inputs[n_fields:])

    binds: list = list(range(n_fields)) + [("arg", i) for i in range(len(scalar_types))]
    flat = _flatten(module, fn, binds, [n_fields])
    if flat is None:
        return None
    stages, final = flat
    if len(stages) < 2 or len(final) != 1 or not isinstance(final[0], int):
        return None
    final_slot = final[0]
    if stages[-1].out_slot != final_slot:
        return None

    creep = {s: (0,) * rank for s in range(n_fields)}
    periodic = False
    for st in stages:
        op = st.op
        ot: TempType = op.results[0].type
        if ot.element != "float32" or ot.bounds != outer:
            return None
        n_in = op.attrs.get("num_inputs", len(op.operands))
        if n_in != len(st.in_slots) or n_in < 1:
            return None
        if any(v.type.bounds != outer for v in op.operands[:n_in]):
            return None
        if op.attrs.get("periodic"):
            # the torus is the whole grid: a block's wrap comes from its
            # exchanged strips, so the origin form takes bounded chains only
            if not whole_grid:
                return None
            periodic = True
        h = _halo(op, rank)
        creep[st.out_slot] = tuple(
            max(creep[s][d] for s in st.in_slots) + h[d] for d in range(rank)
        )
    reach = creep[final_slot]
    if any(r >= n for r, n in zip(reach, shape)):
        return None

    last_use = {final_slot: len(stages)}
    for idx, st in enumerate(stages):
        for s in st.in_slots:
            last_use[s] = max(last_use.get(s, -1), idx)
    live = set(range(n_fields))
    peak = len(live)
    for idx, st in enumerate(stages):
        live.add(st.out_slot)
        peak = max(peak, len(live))
        live = {s for s in live if last_use.get(s, -1) > idx}

    buffer, n_buffers = _buffers(stages, n_fields, last_use)
    pad = (0,) * (3 - rank)
    halo = pad + tuple(reach[:-1]) + (-(-reach[-1] // VEC) * VEC,)
    fits = []
    for cand in tiles or TILES[rank]:
        smem = chain_smem(n_fields, n_buffers, cand, halo)
        if smem <= SMEM_MAX:
            fits.append((cand, smem))
    if not fits:
        return None
    cand, smem = next((f for f in fits if 2 * f[1] <= SMEM_MAX), fits[0])
    # stage regions: a slot of creep c is valid at [c, W - c) of the reach's
    # halo; dim 2's staged halo is wider by halo[2] - reach[2]
    regions = tuple(
        pad + tuple(creep[st.out_slot][:-1])
        + (halo[2] - reach[-1] + creep[st.out_slot][-1],)
        for st in stages
    )
    width = tuple(t + 2 * h for t, h in zip((1,) * (3 - rank) + tuple(cand.tile), halo))
    strips = tuple(
        _strip([w - 2 * lo for w, lo in zip(width, reg)], cand.max_strip) for reg in regions
    )
    return ChainPlan(
        name=name, stages=stages, final_slot=final_slot, n_fields=n_fields,
        scalar_types=scalar_types, outer=outer, creep=creep, reach=reach,
        last_use=last_use, peak=peak, periodic=periodic, buffer=buffer,
        n_buffers=n_buffers, tile=tuple(cand.tile), threads=cand.threads, ahead=cand.ahead,
        min_blocks=cand.blocks, halo=halo, regions=regions, strips=strips, smem_bytes=smem,
        shape=shape, origin=not whole_grid,
    )


def chain_smem(n_fields: int, n_buffers: int, cand: ChainTile, halo: Sequence[int]) -> int:
    """Shared memory of a block (nt_chain_smem_bytes): a set of field
    buffers per tile in flight, the stages' own buffers, then the int table
    of wrapped cells per dim; every buffer is the tile and its halo."""
    w = [t + 2 * h for t, h in zip((1,) * (3 - len(cand.tile)) + tuple(cand.tile), halo)]
    sets = cand.ahead + 1
    return 4 * ((sets * n_fields + n_buffers - n_fields) * math.prod(w) + sum(w))


def _strip(extent: Sequence[int], max_strip: int) -> int:
    """The strip of cells down dim 1, at most `max_strip`, that each thread
    computes over a stage region of `extent` (padded): the one whose warps
    do the least work, counted as warps of items times (strip + 6), the 6
    standing for the strip's vertical halo reads and the item's own index
    arithmetic. Items are walked flat, so only the last warp of a region
    has idle lanes."""
    e0, e1, e2 = extent
    best = None
    for r in range(1, min(e1, max_strip) + 1):
        items = e0 * -(-e1 // r) * e2
        cost = -(-items // 32) * (r + 6)
        if best is None or cost < best[0]:
            best = (cost, r)
    return best[1]


def tile_interior(plan: ChainPlan, org: Sequence[int], n: Sequence[int], boxes: Sequence) -> tuple:
    """The kernel's test for the tile at `org` (padded) over a grid of
    extents `n`, with each stage's box as (lo, hi) in the grid's cells
    (nt_chain_tile): (runs unchecked, stages whose region lies wholly
    outside their box). Unchecked: the staged fields, halo included, lie in
    the grid, and every stage's region inside its box or wholly outside."""
    t, h = plan.tile3, plan.halo
    if any(o - hh < 0 or o + tt + hh > nn for o, tt, hh, nn in zip(org, t, h, n)):
        return False, ()
    copy = []
    for i, ((lo, hi), reg) in enumerate(zip(boxes, plan.regions)):
        a = [o - hh + r for o, hh, r in zip(org, h, reg)]
        b = [o + tt + hh - r for o, tt, hh, r in zip(org, t, h, reg)]
        inside = all(a[d] >= lo[d] and b[d] <= hi[d] for d in range(3))
        outside = any(b[d] <= lo[d] or a[d] >= hi[d] for d in range(3))
        if not (inside or outside):
            return False, ()
        if outside:
            copy.append(i)
    return True, tuple(copy)


def stage_boxes(plan: ChainPlan, shape: Sequence[int], global_start=None) -> list:
    """Each stage's box, (lo, hi) per dim (padded) in the cells of the grid
    or block of `shape` whose logical origin is `global_start` (default:
    the grid's lower bound), clipped to it: the boxes the kernel computes
    (`nt_box_at`, or the constant boxes of a whole-grid plan)."""
    if global_start is None:
        global_start = plan.outer.lb
    out = []
    for st in plan.stages:
        meta = window_meta(tuple(shape), st.op.attrs["bounds"], global_start)
        out.append((tuple(int(x) for x in meta[6:9]), tuple(int(x) for x in meta[9:12])))
    return out


def _stage_scalars(st: ChainStage, args: Sequence) -> list:
    """A stage's scalar operands as the executor binds them: 0-dim tensors
    of the scalar's type, constants rounded into theirs."""
    out = []
    for b in st.scalars:
        if b[0] == "arg":
            out.append(args[b[1]])
        else:
            out.append(torch.tensor(b[1], dtype=torch_backend.scalar_dtype(b[2])))
    return out


def chain_plain(plan: ChainPlan, fields: Sequence, scalars: Sequence, global_start=None) -> torch.Tensor:
    """The plain version: the stages one eager apply at a time. fields are
    f32 tensors; scalars 0-dim tensors of the opdef's scalar types. With
    global_start, the fields are one local block and each stage is an
    eager window apply over it (reads beyond the block read 0)."""
    env = dict(enumerate(fields))
    for st in plan.stages:
        ins = [env[s] for s in st.in_slots]
        sv = _stage_scalars(st, scalars)
        if global_start is None:
            env[st.out_slot] = torch_backend.execute_apply(st.op, ins + sv)
        else:
            env[st.out_slot] = torch_backend.execute_apply_window(st.op, ins, sv, global_start)
    return env[plan.final_slot]


def run_chain(plan: ChainPlan, fields: Sequence, scalars: Sequence, global_start=None) -> torch.Tensor:
    """The opdef's result: the plain version for CPU tensors, one launch
    of kernel D for CUDA tensors. global_start: the origin form, over one
    local block whose cell 0 has these global logical coordinates."""
    device = fields[0].device
    if device.type == "cpu":
        return chain_plain(plan, fields, scalars, global_start)
    if device.type != "cuda":
        raise ValueError(f"stencil_chain: no kernel for device {device}")
    return stencil_chain(plan, fields, scalars, global_start)


class _Launch:
    """What every launch of one plan shares: its C entry, the whole grid's
    launch data, and the argument buffers, built once and refilled per
    launch; the origin form's launch data per (block, global start)."""

    def __init__(self, plan: ChainPlan):
        self.plan = plan  # held so that id(plan) stays unique while cached
        self.lib = builder.load(codegen.chain_source(plan), "stencil_chain")
        self.fn = self.lib.nt_chain
        self.fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
        self.fn.restype = ctypes.c_int
        self.in_ptrs = (ctypes.c_void_p * plan.n_fields)()
        self.scalars = np.zeros(max(plan.n_scalars, 1), dtype=np.float64)
        self.meta = window_meta(plan.outer.shape, plan.outer, plan.outer.lb)
        self.addrs = (ctypes.addressof(self.in_ptrs), self.scalars.ctypes.data)
        self.metas: dict[tuple, tuple] = {}

    def meta_addr(self, global_start) -> int:
        if global_start is None:
            return self.meta.ctypes.data
        key = tuple(int(x) for x in global_start)
        hit = self.metas.get(key)
        if hit is None:
            meta = window_meta(self.plan.shape, self.plan.outer, key)
            hit = self.metas[key] = (meta, meta.ctypes.data)
        return hit[1]


def _launcher(plan: ChainPlan) -> _Launch:
    key = (id(plan), arithmetic())
    hit = _kernels.get(key)
    if hit is None:
        hit = _kernels[key] = _Launch(plan)
    return hit


def blocks_per_sm(plan: ChainPlan, device: int = 0) -> int:
    """The blocks of the plan's kernel that one SM of CUDA device `device`
    holds at once (the CUDA occupancy calculator); builds the kernel."""
    fn = _launcher(plan).lib.nt_chain_blocks_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    n = fn(device)
    check(max(-n, 0), "stencil_chain occupancy")
    return n


def stencil_chain(plan: ChainPlan, fields: Sequence, scalars: Sequence, global_start=None) -> torch.Tensor:
    """Launch kernel D once on CUDA tensors: the opdef's result. With
    global_start, the origin form over one local block, which needs a
    block's plan (`chain_plan(module, name, shape)`; counted as
    `stencil_chain_origin`)."""
    with (counter if global_start is None else origin_counter).launch():
        what = "stencil_chain" if global_start is None else "stencil_chain_origin"
        if global_start is not None and not plan.origin:
            raise ValueError(f"{what}: @{plan.name}'s plan is the whole grid's, not a block's")
        k = _launcher(plan)
        shape = plan.shape
        device = fields[0].device
        ins = []  # held until the launch is queued
        for j, a in enumerate(fields):
            if a.device != device or a.device.type != "cuda" or tuple(a.shape) != shape:
                raise ValueError(
                    f"{what}: field {tuple(a.shape)} on {a.device}, expected {shape} on cuda"
                )
            if a.dtype != torch.float32 or not a.is_contiguous():
                a = a.to(torch.float32).contiguous()
            ins.append(a)
            k.in_ptrs[j] = a.data_ptr()
        for j, v in enumerate(scalars):
            k.scalars[j] = float(v)
        out = torch.empty(shape, dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        check(k.fn(device.index or 0, k.addrs[0], out.data_ptr(), k.addrs[1],
                   k.meta_addr(global_start), stream), f"{what} launch")
        return out
