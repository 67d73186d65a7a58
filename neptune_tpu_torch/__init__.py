"""neptune_tpu_torch — the PyTorch + CUDA port of neptune_tpu.

The same stencil IR (`ir/`, a copy of the JAX package's) lowered to eager
PyTorch on any device, with hand-written Hopper kernels for the hot paths:

  neptune_tpu_torch.ir        — types, ops, builder, parser, printer, verifier
  neptune_tpu_torch.passes    — high-level conversion + staged pipeline
  neptune_tpu_torch.lowering  — executor; eager torch backend; the CUDA apply,
                                K-sweep and fused-chain kernels
  neptune_tpu_torch.solvers   — CG/BiCGStab/GMRES, Jacobi, the fused-CG kernel
  neptune_tpu_torch.kernels   — nvcc build of the generated kernel sources
  neptune_tpu_torch.frontend  — user DSL: Expr tracing, decorators, jit_class
  neptune_tpu_torch.entry     — the flagship implicit heat step
  neptune_tpu_torch.parallel  — sharded execution over a mesh of processes

`import neptune_tpu_torch as ntt` reads like `import neptune_tpu as ntp`,
less the names whose modules are not ported yet: `simulate`,
`differentiable_solve`, `differentiable_root` and `enable_x64` (PyTorch
needs no switch for f64).

Importing the package imports neither JAX nor the JAX package.
"""

from . import parallel
from .config import config
from .frontend import (
    CompiledLibrary,
    Context,
    Expr,
    GlobalContext,
    MatrixExpr,
    OpDef,
    apply,
    assemble_matrix,
    get_compiler,
    get_context,
    index,
    interior,
    jit_class,
    jit_compile,
    linear_op_def,
    nonlinear_op_def,
    on_boundary,
    reduce,
    reset_context,
    solve_linear,
    solve_nonlinear,
    stencil,
    sweeps,
    temp,
    time_advance,
    where,
)
from .frontend import abs, cos, erf, exp, log, maximum, minimum, sin, sqrt, tanh
from .ir.types import Bounds, Location, StencilShape, TempType, TimeMethod

__version__ = "0.1.0"

__all__ = [
    "config",
    "__version__",
    "CompiledLibrary",
    "Context",
    "Expr",
    "GlobalContext",
    "MatrixExpr",
    "OpDef",
    "apply",
    "assemble_matrix",
    "get_compiler",
    "get_context",
    "index",
    "interior",
    "on_boundary",
    "jit_class",
    "jit_compile",
    "linear_op_def",
    "nonlinear_op_def",
    "reduce",
    "reset_context",
    "solve_linear",
    "sweeps",
    "solve_nonlinear",
    "stencil",
    "temp",
    "time_advance",
    "where",
    "abs",
    "cos",
    "erf",
    "exp",
    "log",
    "maximum",
    "minimum",
    "sin",
    "sqrt",
    "tanh",
    "Bounds",
    "Location",
    "StencilShape",
    "TempType",
    "TimeMethod",
]
