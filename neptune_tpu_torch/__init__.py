"""neptune_tpu_torch — the PyTorch + CUDA port of neptune_tpu.

The same stencil IR (`ir/`, a copy of the JAX package's) lowered to eager
PyTorch on any device, with hand-written Hopper kernels for the hot paths:

  neptune_tpu_torch.ir        — types, ops, builder, parser, printer, verifier
  neptune_tpu_torch.passes    — high-level conversion + staged pipeline
  neptune_tpu_torch.lowering  — executor; eager torch and CUDA apply backends
  neptune_tpu_torch.solvers   — CG/BiCGStab/GMRES, Jacobi, the fused-CG kernel
  neptune_tpu_torch.kernels   — nvcc build of the generated kernel sources
  neptune_tpu_torch.entry     — the flagship implicit heat step

Importing the package imports neither JAX nor the JAX package.
"""

from .config import config

__version__ = "0.1.0"

__all__ = ["config", "__version__"]
