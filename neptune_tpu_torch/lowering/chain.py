"""Kernel D, stencil_chain: a composite opdef's whole apply DAG in one pass
over device memory.

The port of `neptune_tpu/lowering/pallas_chain.py`. A composite operator
(`apply_linear` / `apply_nonlinear` calls plus applies) run stage at a time
moves every intermediate through device memory; kernel D
(`csrc/nt_chain.cuh`) keeps them in shared memory: one block per output
tile, every field argument's tile with a halo of the DAG's composed reach,
the stages in DAG order over shrinking regions.

Here:
  * `_flatten`: the JAX package's flattening of the DAG into stages over
    value slots, unchanged;
  * `chain_plan`: its semantic gates, a composed reach per dim (the JAX
    package tracks dim 0 only: its trailing dims stay whole in VMEM), peak
    live values from `last_use`, shared-memory buffers and the output tile;
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
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import config
from ..ir.core import Function, Module, Operation
from ..ir.types import Bounds, ScalarType, StencilShape, TempType
from ..kernels import codegen
from ..kernels.build import LaunchCounter, builder, check
from . import torch_backend
from .cuda_backend import window_meta
from .sweeps import SMEM_MAX, smem_bytes

counter = LaunchCounter("stencil_chain")
origin_counter = LaunchCounter("stencil_chain_origin")

# output tiles, preferred first: the first whose buffers fit twice on an
# SM is taken, else the first that fits at all
TILES = {2: ((64, 64), (32, 64), (32, 32), (16, 32)), 3: ((8, 16, 32), (8, 8, 32), (4, 8, 32))}

# field arguments one launch takes (csrc/nt_chain.cuh, kNtChainMaxFields)
MAX_FIELDS = 8

# (id(plan), config.fold_affine) -> (plan, C entry, whole-grid launch data)
_kernels: dict[tuple, tuple] = {}


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
    the final slot's creep, the tile halo. buffer[slot]: the shared-memory
    buffer holding the slot (fields first; the last stage writes to device
    memory and needs none). peak: the most values live at once, the final
    one included, as the JAX package counts them."""

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
    smem_bytes: int
    shape: tuple  # the grid or block the plan runs over
    origin: bool  # a block's plan: stage boxes mapped at run time

    @property
    def rank(self) -> int:
        return self.outer.rank

    @property
    def n_scalars(self) -> int:
        return len(self.scalar_types)


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


def chain_plan(module: Module, name: str, shape: Optional[Sequence[int]] = None) -> Optional[ChainPlan]:
    """Plan one kernel-D launch of composite opdef @name over a grid of
    `shape` (default: the opdef's own; a local block's for the origin
    form), or None (the opdef runs stage at a time).

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
    fits = []
    for tile in TILES[rank]:
        smem = smem_bytes(n_buffers, tile, reach)
        if smem <= SMEM_MAX:
            fits.append((tile, smem))
    if not fits:
        return None
    tile, smem = next((f for f in fits if 2 * f[1] <= SMEM_MAX), fits[0])
    return ChainPlan(
        name=name, stages=stages, final_slot=final_slot, n_fields=n_fields,
        scalar_types=scalar_types, outer=outer, creep=creep, reach=reach,
        last_use=last_use, peak=peak, periodic=periodic, buffer=buffer,
        n_buffers=n_buffers, tile=tile, smem_bytes=smem, shape=shape, origin=not whole_grid,
    )


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


def _entry(plan: ChainPlan):
    key = (id(plan), config.fold_affine)
    hit = _kernels.get(key)
    if hit is None:
        fn = builder.load(codegen.chain_source(plan), "stencil_chain").nt_chain
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5
        fn.restype = ctypes.c_int
        meta = window_meta(plan.outer.shape, plan.outer, plan.outer.lb)
        hit = _kernels[key] = (plan, fn, meta)
    return hit[1], hit[2]


def stencil_chain(plan: ChainPlan, fields: Sequence, scalars: Sequence, global_start=None) -> torch.Tensor:
    """Launch kernel D once on CUDA tensors: the opdef's result. With
    global_start, the origin form over one local block, which needs a
    block's plan (`chain_plan(module, name, shape)`; counted as
    `stencil_chain_origin`)."""
    what = "stencil_chain" if global_start is None else "stencil_chain_origin"
    if global_start is not None and not plan.origin:
        raise ValueError(f"{what}: @{plan.name}'s plan is the whole grid's, not a block's")
    fn, meta = _entry(plan)
    if global_start is not None:
        meta = window_meta(plan.shape, plan.outer, global_start)
    shape = plan.shape
    device = fields[0].device
    ins = []
    for a in fields:
        if a.device != device or a.device.type != "cuda" or tuple(a.shape) != shape:
            raise ValueError(
                f"{what}: field {tuple(a.shape)} on {a.device}, expected {shape} on cuda"
            )
        ins.append(a.to(torch.float32).contiguous())
    out = torch.empty(shape, dtype=torch.float32, device=device)
    in_ptrs = (ctypes.c_void_p * len(ins))(*[a.data_ptr() for a in ins])
    sv = np.array([float(s) for s in scalars] or [0.0], dtype=np.float64)
    stream = torch.cuda.current_stream(device).cuda_stream
    check(
        fn(device.index or 0, ctypes.addressof(in_ptrs), out.data_ptr(), sv.ctypes.data,
           meta.ctypes.data, stream),
        f"{what} launch",
    )
    (counter if global_start is None else origin_counter).count += 1
    return out
