"""Kernel B, fused_cg: the whole CG solve in one persistent cooperative kernel.

The port of `neptune_tpu/solvers/fused.py`, which runs the whole CG loop in
one TPU kernel with every vector resident in VMEM. On the H100 the vectors
live in global memory (7 MB at 512^2 f32, held by the 50 MB L2) and one
cooperative kernel (`csrc/nt_fused_cg.cuh`) separates the phases of each
iteration with grid syncs; see that header for the design and its bound
(grid-sync latency at these sizes).

The operator is evaluated in-kernel from the opdef's IR: `matvec_plan` flattens
it into stages, one per inner apply (composite `apply_linear` chains inline,
as `build_inkernel_matvec` does in the JAX package), and each stage is a body
generated by `kernels/codegen.py` with kernel A's neighbour rule (zero-fill,
or wrap on periodic applies; the JAX kernel wraps everywhere, which differs
only in cells the copy-through contract leaves unspecified).

Beside the kernel, `fused_cg_plain` runs the same recurrence in eager
PyTorch. `fused_cg(...)(b)` takes the plain version for a CPU tensor and
launches the kernel for a CUDA tensor, or raises.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..config import config
from ..ir.core import Module, Operation
from ..ir.types import TempType
from ..kernels import codegen
from ..kernels.build import LaunchCounter, builder, check
from ..lowering import torch_backend

# the JAX package's cap on the fused solve's working set (7 vectors); kept so
# that the same solves take the fused route in both packages
_VMEM_LIMIT = 12 * 1024 * 1024

counter = LaunchCounter("fused_cg")

# (id(module), name, config.fold_affine) -> (module, C entries); the module
# is held so that its id stays unique, and the generated bodies depend on the
# fold setting
_kernels: dict[tuple[int, str, bool], tuple] = {}


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


def supported(module: Module, name: str, tt: TempType) -> bool:
    if tt.element != "float32":
        return False
    if tt.bounds.rank != 2:
        return False
    if tt.bounds.size * 4 * 7 > _VMEM_LIMIT:
        return False
    try:
        matvec_plan(module, name)
    except FusionError:
        return False
    return True


def plain_matvec(stages: list[Stage]) -> Callable:
    """The operator of a plan, applied eagerly stage by stage."""

    def run(x):
        bufs = []
        for st in stages:
            arrays = [x if r == "x" else bufs[r] for r in st.inputs] + st.scalars
            bufs.append(torch_backend.execute_apply(st.op, arrays, device=x.device))
        return bufs[-1]

    return run


def _dot(a, b):
    """sum(a * b): the f32 products summed in f64, rounded to f32 once.

    A deliberate change of numerics against the JAX kernel, which sums in
    f32: the kernel sums in f64 too, so its summation order almost never
    shows and kernel and plain version take the same iterations. It costs
    the kernel about 15% per CG iteration at 512^2."""
    return torch.sum(a * b, dtype=torch.float64).to(torch.float32)


def fused_cg_plain(matvec: Callable, b, *, tol: float, maxiter: int, inv_diag=None):
    """The fused kernel's CG recurrence in eager PyTorch: x0 = 0, r0 = b, the
    recurrence residual against tol * ||b||. Returns (x, iters, resnorm)."""
    b = b.to(torch.float32)
    dinv = None if inv_diag is None else inv_diag.to(torch.float32)
    one = torch.ones((), dtype=torch.float32, device=b.device)
    bnorm = torch.sqrt(_dot(b, b))
    target = tol * torch.where(bnorm == 0, one, bnorm)
    x = torch.zeros_like(b)
    r = b
    z = r * dinv if dinv is not None else r
    p = z
    rz = _dot(r, z)
    rn = bnorm
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


def _entries(module: Module, name: str, stages: list[Stage]):
    key = (id(module), name, config.fold_affine)
    hit = _kernels.get(key)
    if hit is None:
        lib = builder.load(codegen.fused_cg_source(stages), "fused_cg")
        blocks_fn = lib.nt_fused_cg_blocks
        blocks_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        blocks_fn.restype = ctypes.c_int
        solve_fn = lib.nt_fused_cg
        solve_fn.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int]
            + [ctypes.c_void_p] * 2
            + [ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        solve_fn.restype = ctypes.c_int
        hit = _kernels[key] = (module, blocks_fn, solve_fn)
    return hit[1], hit[2]


def _launch(module, name, stages, b, dinv, tol, maxiter):
    device = b.device
    dev = device.index or 0
    blocks_fn, solve_fn = _entries(module, name, stages)
    blocks = ctypes.c_int(0)
    check(
        blocks_fn(dev, int(dinv is not None), ctypes.addressof(blocks)),
        "fused_cg occupancy query",
    )
    n = b.numel()
    x = torch.empty_like(b)
    work = torch.empty((4 + len(stages) - 1) * n, dtype=torch.float32, device=device)
    part = torch.empty(4 * blocks.value, dtype=torch.float64, device=device)
    iters = torch.empty((), dtype=torch.int32, device=device)
    resnorm = torch.empty((), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    check(
        solve_fn(
            dev, b.data_ptr(), None if dinv is None else dinv.data_ptr(),
            x.data_ptr(), work.data_ptr(), part.data_ptr(), blocks.value,
            iters.data_ptr(), resnorm.data_ptr(), n, tol, maxiter, stream,
        ),
        "fused_cg launch",
    )
    counter.count += 1
    return x, iters, resnorm


def fused_cg(
    module: Module,
    name: str,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    inv_diag: Optional[torch.Tensor] = None,
) -> Callable:
    """Returns solve(b) -> (x, iters, resnorm): the whole (optionally
    Jacobi-preconditioned) CG solve of opdef @name in one kernel launch."""
    fn = module.lookup(name)
    shape = fn.ftype.inputs[0].bounds.shape
    stages = matvec_plan(module, name)

    def solve(b):
        if tuple(b.shape) != shape:
            raise ValueError(f"fused_cg: rhs {tuple(b.shape)} != operator grid {shape}")
        b = b.to(torch.float32).contiguous()
        dinv = None if inv_diag is None else inv_diag.to(b.device, torch.float32).contiguous()
        if b.device.type == "cpu":
            return fused_cg_plain(plain_matvec(stages), b, tol=tol, maxiter=maxiter, inv_diag=dinv)
        if b.device.type != "cuda":
            raise ValueError(f"fused_cg: no kernel for device {b.device}")
        return _launch(module, name, stages, b, dinv, tol, maxiter)

    return solve
