"""Kernel B, fused_cg: the whole CG solve in one persistent cooperative kernel.

The port of `neptune_tpu/solvers/fused.py`, which runs the whole CG loop in
one TPU kernel with every vector resident in VMEM. On the H100 the state
stays resident too, in shared memory: one block per SM owns one tile of the
grid, keeps its tile's CG vectors and p over the tile and the operator's
halo, and an iteration crosses two grid barriers (`csrc/nt_fused_cg.cuh`
holds the design and its bound, the barriers' latency).

Here:
  * `matvec_plan`: the operator flattened into stages, one per inner apply
    (composite `apply_linear` chains inline, as `build_inkernel_matvec` does
    in the JAX package); each stage is a body generated by
    `kernels/codegen.py` with kernel A's neighbour rule (zero-fill, or wrap
    on periodic applies; the JAX kernel wraps everywhere, which differs only
    in cells the copy-through contract leaves unspecified);
  * `cg_plan`: the tiles, the halo, the published edges and the
    shared-memory layout, pure Python, decided before any launch;
  * `fused_cg(...)`: a solve site, whose `solve(b)` takes the plain version
    for a CPU tensor and launches the kernel for a CUDA tensor, or raises.
    It plans, builds and allocates its workspace once per device;
  * `fused_cg_plain`: the same recurrence in eager PyTorch.

A solve site starts CG from the Dirichlet lift where the operator has a
copy-through ring (`ring_of`: a single apply whose cells outside an
interior box copy their value through, the structure the generic route's
`MatrixHandle.ring_lift` lifts): x0 = b on the ring and 0 inside, so
r0 = b - A x0 is 0 on the ring and the iterates stay in the symmetric
interior subspace. Elsewhere the plan's interior box is the whole grid and
x0 = 0. The kernel computes the lift in its prologue, with one matvec and
no barrier of its own; `fused_cg_plain` takes the box as `lift`.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..config import config
from ..ir.core import Module, Operation
from ..ir.types import StencilShape, TempType
from ..kernels import codegen
from ..kernels.build import LaunchCounter, builder, check
from ..lowering import torch_backend
from .assemble import lift_outside, ring_box, single_apply_interior

# the JAX package's cap on the fused solve's working set (7 vectors); kept so
# that the same solves take the fused route in both packages
_VMEM_LIMIT = 12 * 1024 * 1024

# the H100's SMs: the blocks of one launch at most (one per SM), which both
# `supported` and the solve site plan for. The shared memory that one block's
# plan may take: the most a block may have, less room for the kernel's static
# shared memory (its block sums, about 400 B), which the solve site holds
# each build to before any launch
SMS = 132
STATIC_SMEM = 1024
SMEM_MAX = 227 * 1024 - STATIC_SMEM

counter = LaunchCounter("fused_cg")


class FusionError(RuntimeError):
    pass


@dataclass
class Stage:
    """One inner apply of the operator: `inputs` are "x" (the operand) or the
    index of an earlier stage; `scalars` are the values of its scalar
    operands (opdef-level f32 constants)."""

    op: Operation
    inputs: list
    scalars: list


def matvec_plan(module: Module, name: str) -> list[Stage]:
    """Flatten unary opdef @name into its apply stages; the last stage
    computes the operator's result. FusionError if it cannot be fused."""
    stages: list[Stage] = []

    def walk(fn_name: str, arg):
        fn = module.lookup(fn_name)
        if len(fn.ftype.inputs) != 1 or len(fn.ftype.results) != 1:
            raise FusionError("fused solve requires a unary operator")
        grid = fn.ftype.inputs[0].bounds.shape
        env = {fn.body.args[0].uid: arg}
        out = None
        for op in fn.body.ops:
            if op.name == "neptune.apply":
                out_type: TempType = op.results[0].type
                if len(op.results) != 1 or out_type.bounds.shape != grid:
                    raise FusionError("fused solve: apply off the operator's grid")
                n_in = op.attrs.get("num_inputs", len(op.operands))
                scalars = [env[o.uid] for o in op.operands[n_in:]]
                if not all(isinstance(s, float) for s in scalars):
                    raise FusionError("fused solve: scalar operand is not a constant")
                stages.append(Stage(op, [env[o.uid] for o in op.operands[:n_in]], scalars))
                env[op.results[0].uid] = len(stages) - 1
            elif op.name == "neptune.apply_linear":
                env[op.results[0].uid] = walk(op.attrs["symbol"], env[op.operands[0].uid])
            elif op.name == "neptune.return":
                out = env[op.operands[0].uid]
            elif op.name == "arith.constant":
                env[op.results[0].uid] = torch_backend.round_to(op.attrs["value"], "float32")
            else:
                raise FusionError(f"fused solve: unsupported op {op.name}")
        return out

    out = walk(name, "x")
    if not isinstance(out, int):
        raise FusionError("fused solve: the operator returns no apply result")
    return stages[: out + 1]  # later stages are dead


@dataclass
class CgPlan:
    """One build of kernel B: how the grid is cut into one tile per block.

    creep[i]: per dim, how far stage i's valid region has shrunk from p's
    (kernel D's creep); reach: the last stage's. halo: per dim, the halo a
    tile stores, the reach along a dim cut into several tiles and none
    along a dim that is not cut (the tile is the whole dim there, so a read
    that leaves the tile leaves the grid: it reads 0, or wraps onto the tile
    itself). buffer[i]: the shared-memory buffer of intermediate stage i (p
    has its own, and the last stage writes Ap). edge: per dim, how deep into
    its tile from each side a block publishes z for the other blocks'
    halos. interior: per dim (start, stop) in grid indices, the box outside
    which the prologue starts x from b: the copy-through ring's interior
    (`ring_of`), or the whole grid, where x0 = 0."""

    stages: list
    shape: tuple
    lb: tuple
    creep: list
    reach: tuple
    halo: tuple
    periodic: bool
    buffer: dict
    n_buffers: int
    tile: tuple
    tiles: tuple
    edge: tuple
    smem_bytes: int
    interior: tuple

    @property
    def blocks(self) -> int:
        return self.tiles[0] * self.tiles[1]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _stage_halo(op: Operation) -> tuple:
    sshape: StencilShape = op.attrs.get("shape") or StencilShape(())
    return tuple(max(h) for h in sshape.halo()) if sshape.offsets else (0, 0)


def _stage_buffers(stages: list) -> tuple[dict, int]:
    """Shared-memory buffer per intermediate stage: a stage takes a free
    buffer and gives it back after its last reader. p has its own buffer
    for the whole solve and the last stage writes Ap, so neither takes one."""
    last = {}
    for idx, st in enumerate(stages):
        for r in st.inputs:
            if r != "x":
                last[r] = idx
    buffer, free, n = {}, [], 0
    for idx in range(len(stages) - 1):
        if free:
            buffer[idx] = free.pop(0)
        else:
            buffer[idx] = n
            n += 1
        for s in {r for r in stages[idx].inputs if r != "x"} | {idx}:
            if last.get(s, -1) <= idx:
                free.append(buffer[s])
        free.sort()
    return buffer, n


def tile_grid(shape, reach, fits: Callable, sms: int = SMS) -> Optional[tuple]:
    """(tile, tiles, halo): cells per tile, tiles per dim and the stored
    halo (CgPlan.halo), one tile per block, at most `sms` blocks, among the
    cuts whose state fits(tile, halo) in shared memory; None if none does.
    The slowest block sets every iteration's pace, and it walks its tile's
    cells (the matvec, the vector updates) and its tile's and halo's cells
    (the p update) once each, so the cut is the one with the fewest of both
    in the largest tile: bands of whole rows (g1 = 1) or 2-D tiles. A dim
    cut into several tiles gets tiles at least as deep as the reach; the
    last tile of a dim may be short."""
    (n0, n1), (h0, h1) = shape, reach
    best = None
    for g0 in range(1, min(n0, sms) + 1):
        t0 = _ceil(n0, g0)
        if _ceil(n0, t0) != g0 or (g0 > 1 and t0 < h0):
            continue
        t1 = _ceil(n1, sms // g0)
        if t1 < n1:
            t1 = min(max(t1, h1), n1)
        tile, tiles = (t0, t1), (g0, _ceil(n1, t1))
        halo = tuple(h if g > 1 else 0 for h, g in zip(reach, tiles))
        key = t0 * t1 + (t0 + 2 * halo[0]) * (t1 + 2 * halo[1])
        if fits(tile, halo) and (best is None or key < best[0]):
            best = (key, tile, tiles, halo)
    return None if best is None else best[1:]


def edge_depth(shape, halo, tile, tiles, periodic: bool) -> tuple:
    """Per dim, how deep into its tile from each side a block publishes z:
    as deep as the stored halo reaches into the neighbouring tiles (nothing
    along a dim that is not cut). Where a periodic dim does not divide
    evenly, the last tile's wrapped cells fall anywhere in the first tiles,
    so every cell is published."""
    out = []
    for n, h, t, g in zip(shape, halo, tile, tiles):
        if h == 0:
            out.append(0)
        elif periodic and g * t != n:
            out.append(t)
        else:
            out.append(min(h, t))
    return tuple(out)


def cg_smem_bytes(tile, halo, n_buffers: int, periodic: bool) -> int:
    """Dynamic shared memory of one block (csrc/nt_fused_cg.cuh): p and the
    intermediate stage buffers over the tile and its stored halo, then x, r,
    Ap and 1/diag over the tile, then, for wrapped tiles, the table of
    wrapped cells (rank-3 padded: W0 = 1)."""
    w1, w2 = tile[0] + 2 * halo[0], tile[1] + 2 * halo[1]
    tab = 1 + w1 + w2 if periodic else 0
    return 4 * ((1 + n_buffers) * w1 * w2 + 4 * tile[0] * tile[1] + tab)


def ring_of(module: Module, name: str) -> Optional[tuple]:
    """The interior box of opdef @name, per dim (start, stop) in grid
    indices, where the cells outside it are a copy-through ring that a solve
    lifts (`MatrixHandle.ring_lift`); None where it has none."""
    fn = module.lookup(name)
    return ring_box(single_apply_interior(fn), fn.ftype.inputs[0].bounds)


def cg_plan(module: Module, name: str, sms: int = SMS) -> Optional[CgPlan]:
    """Plan kernel B for opdef @name on a card with `sms` SMs, or None when
    one block's state does not fit in shared memory. FusionError if the
    operator cannot be fused."""
    stages = matvec_plan(module, name)
    bounds = module.lookup(name).ftype.inputs[0].bounds
    creep: list = []
    for st in stages:
        base = [0, 0]
        for r in st.inputs:
            if r != "x":
                base = [max(a, c) for a, c in zip(base, creep[r])]
        creep.append(tuple(b + h for b, h in zip(base, _stage_halo(st.op))))
    reach = creep[-1]
    periodic = any(st.op.attrs.get("periodic") for st in stages)
    buffer, n_buffers = _stage_buffers(stages)

    def smem(tile, halo):
        return cg_smem_bytes(tile, halo, n_buffers, periodic)

    cut = tile_grid(bounds.shape, reach, lambda t, h: smem(t, h) <= SMEM_MAX, sms)
    if cut is None:
        return None
    tile, tiles, halo = cut
    return CgPlan(
        stages=stages, shape=tuple(bounds.shape), lb=tuple(bounds.lb), creep=creep,
        reach=reach, halo=halo, periodic=periodic, buffer=buffer, n_buffers=n_buffers,
        tile=tile, tiles=tiles, edge=edge_depth(bounds.shape, halo, tile, tiles, periodic),
        smem_bytes=smem(tile, halo),
        interior=ring_of(module, name) or tuple((0, n) for n in bounds.shape),
    )


def supported(module: Module, name: str, tt: TempType) -> bool:
    """The JAX package's gates (f32, rank 2, the 12 MiB working set, a
    fusable operator), and a plan whose state fits in shared memory on the
    H100. Under the cap every grid has one for operators of reach <= 16
    with up to two intermediate buffers (tests/test_torch_fused_tiles.py
    sweeps the shapes); an operator that reaches further may have none, and
    then its solves take generic CG."""
    if tt.element != "float32":
        return False
    if tt.bounds.rank != 2:
        return False
    if tt.bounds.size * 4 * 7 > _VMEM_LIMIT:
        return False
    try:
        return cg_plan(module, name) is not None
    except FusionError:
        return False


def plain_matvec(stages: list[Stage]) -> Callable:
    """The operator of a plan, applied eagerly stage by stage, in default
    arithmetic whatever the mode, as kernel B computes it."""

    def run(x):
        bufs = []
        for st in stages:
            arrays = [x if r == "x" else bufs[r] for r in st.inputs] + st.scalars
            bufs.append(
                torch_backend.execute_apply(st.op, arrays, device=x.device, pinned=False)
            )
        return bufs[-1]

    return run


def _dot(a, b):
    """sum(a * b): the f32 products summed in f64, rounded to f32 once.

    A deliberate change of numerics against the JAX kernel, which sums in
    f32: the kernel sums in f64 too, so its summation order almost never
    shows and kernel and plain version take the same iterations."""
    return torch.sum(a * b, dtype=torch.float64).to(torch.float32)


def fused_cg_plain(matvec: Callable, b, *, tol: float, maxiter: int, inv_diag=None, lift=None):
    """The fused kernel's CG recurrence in eager PyTorch: x0 = 0, r0 = b, the
    recurrence residual against tol * ||b||. With `lift` (an interior box,
    as CgPlan.interior), x0 = lift_outside(b, lift) and r0 = b - A x0, whose
    norm the first test reads; the target stays tol * ||b||. Returns
    (x, iters, resnorm)."""
    b = b.to(torch.float32)
    dinv = None if inv_diag is None else inv_diag.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=b.device)
    bnorm = torch.sqrt(_dot(b, b))
    target = tol * torch.where(bnorm == 0, one, bnorm)
    if lift is None:
        x = torch.zeros_like(b)
        r = b
        rn = bnorm
    else:
        x = lift_outside(b, lift)
        r = b - matvec(x)
        rn = torch.sqrt(_dot(r, r))
    z = r * dinv if dinv is not None else r
    p = z
    rz = _dot(r, z)
    k = 0
    while k < maxiter and bool((rn > target).item()):
        Ap = matvec(p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(pAp == 0, one, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r * dinv if dinv is not None else r
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(rz == 0, one, rz)
        p = z + beta * p
        rz = rz_new
        k += 1
        rn = torch.sqrt(_dot(r, r))
    return x, torch.tensor(k, dtype=torch.int32, device=b.device), rn


class _Site:
    """Kernel B of `plan` on one device: the built library, the inverse
    diagonal on the device, and the workspace that every solve of the site
    reuses (the exchange grid and the blocks' partial sums). Solves of one site run one at a time, in stream order.
    Raises before any launch if the card cannot hold the plan's blocks
    co-resident."""

    def __init__(self, plan: CgPlan, device: torch.device, inv_diag):
        self.index = device.index
        self.plan = plan
        lib = builder.load(codegen.fused_cg_source(self.plan), "fused_cg")
        setup = lib.nt_fused_cg_setup
        setup.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        setup.restype = ctypes.c_int
        self.solve_fn = lib.nt_fused_cg
        self.solve_fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        self.solve_fn.restype = ctypes.c_int
        self.probe_fn = lib.nt_cg_barrier_probe
        self.probe_fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
        self.probe_fn.restype = ctypes.c_int
        most, fixed = ctypes.c_int(0), ctypes.c_int(0)
        check(setup(self.index, ctypes.addressof(most), ctypes.addressof(fixed)), "fused_cg setup")
        if fixed.value > STATIC_SMEM:
            raise RuntimeError(
                f"fused_cg: the kernel's {fixed.value} B of static shared memory exceed the "
                f"{STATIC_SMEM} B that the plans leave for it"
            )
        if self.plan.blocks > most.value:
            raise RuntimeError(
                f"fused_cg: {self.plan.blocks} blocks of {self.plan.smem_bytes} B are not "
                f"co-resident on {device} (at most {most.value})"
            )
        self.exch = torch.zeros(math.prod(self.plan.shape), dtype=torch.float32, device=device)
        self.part = torch.zeros(2 * _SLOTS * self.plan.blocks, dtype=torch.float64, device=device)
        self.dinv = None if inv_diag is None else inv_diag.to(device, torch.float32).contiguous()

    def solve(self, b: torch.Tensor, tol: float, maxiter: int):
        with counter.launch():
            x = torch.empty_like(b)
            iters = torch.empty((), dtype=torch.int32, device=b.device)
            resnorm = torch.empty((), dtype=torch.float32, device=b.device)
            check(
                self.solve_fn(
                    self.index, b.data_ptr(), None if self.dinv is None else self.dinv.data_ptr(),
                    x.data_ptr(), self.exch.data_ptr(), self.part.data_ptr(),
                    iters.data_ptr(), resnorm.data_ptr(), tol, maxiter,
                    torch.cuda.current_stream(b.device).cuda_stream,
                ),
                "fused_cg launch",
            )
            return x, iters, resnorm

    def barrier_floor_us(self, iters: int) -> float:
        """Microseconds per iteration of the barrier probe at this site's
        grid size: the kernel's two grid barriers and its reduction of three
        values per iteration, nothing else. CUDA events around one launch,
        after a warm-up launch."""
        dev = torch.device("cuda", self.index)
        part = torch.zeros(2 * _SLOTS * self.plan.blocks, dtype=torch.float64, device=dev)
        out = torch.zeros((), dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev)

        def launch(k):
            check(self.probe_fn(self.index, k, part.data_ptr(), out.data_ptr(),
                                stream.cuda_stream), "barrier probe launch")

        launch(10)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record(stream)
        launch(iters)
        stop.record(stream)
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3 / iters


# csrc/nt_fused_cg.cuh's kNtCgSlots: sums per block and reduction
_SLOTS = 3


class FusedCG:
    """solve(b) -> (x, iters, resnorm): the whole (optionally
    Jacobi-preconditioned) CG solve of opdef @name in one kernel launch on a
    CUDA tensor, the plain version on a CPU tensor. Both lift the operator's
    copy-through ring, whose interior box is `lift` (None: no ring)."""

    def __init__(self, module: Module, name: str, tol: float, maxiter: int, inv_diag):
        self.module, self.name, self.tol, self.maxiter = module, name, tol, maxiter
        self.shape = module.lookup(name).ftype.inputs[0].bounds.shape
        self.stages = matvec_plan(module, name)
        self.inv_diag = inv_diag
        self.lift = ring_of(module, name)
        self._sites: dict = {}

    def site(self, device) -> _Site:
        """The kernel's site on a CUDA device: planned, built and allocated
        at its first solve there (and again if the affine folding, which the
        generated bodies follow, has changed)."""
        device = torch.device(device)
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (device, config.fold_affine)
        hit = self._sites.get(key)
        if hit is None:
            plan = cg_plan(self.module, self.name)
            if plan is None:
                raise RuntimeError(
                    f"fused_cg: @{self.name}'s tile state does not fit in shared memory"
                )
            hit = self._sites[key] = _Site(plan, device, self.inv_diag)
        return hit

    def __call__(self, b):
        if tuple(b.shape) != self.shape:
            raise ValueError(f"fused_cg: rhs {tuple(b.shape)} != operator grid {self.shape}")
        b = b.to(torch.float32).contiguous()
        if b.device.type == "cpu":
            dinv = None if self.inv_diag is None else self.inv_diag.to(b.device, torch.float32)
            return fused_cg_plain(
                plain_matvec(self.stages), b, tol=self.tol, maxiter=self.maxiter, inv_diag=dinv,
                lift=self.lift,
            )
        if b.device.type != "cuda":
            raise ValueError(f"fused_cg: no kernel for device {b.device}")
        return self.site(b.device).solve(b, self.tol, self.maxiter)


def fused_cg(
    module: Module,
    name: str,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    inv_diag: Optional[torch.Tensor] = None,
) -> FusedCG:
    """A solve site of opdef @name (see FusedCG)."""
    return FusedCG(module, name, tol, maxiter, inv_diag)
