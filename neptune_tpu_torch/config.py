"""Global configuration for neptune_tpu_torch.

The PyTorch counterpart of `neptune_tpu/config.py`, trimmed to what the port
runs today: one process-wide config object with environment overrides.

Environment variables:
  NEPTUNE_TORCH_BACKEND     "auto" | "torch" | "cuda"   (default "auto")
  NEPTUNE_TORCH_DUMP_IR     "1" to print IR after every pipeline stage
  NEPTUNE_TORCH_FOLD_AFFINE "0" to turn off affine folding
  NEPTUNE_TORCH_DTYPE       element dtype of DSL opdefs that name none
                            (default "float64")
  NEPTUNE_TORCH_DEVICE      where inputs that are not tensors go
                            (default "cuda"; "cpu" to run on the CPU)
  NEPTUNE_TORCH_PINNED      "1" for pinned arithmetic (bitwise the same
                            solve on every mesh shape; default off)
  NEPTUNE_TORCH_CACHE_DIR   one directory for both build caches: the CUDA
                            kernels under its `kernels/`, the native runtime
                            in it (default: `neptune_tpu_torch/_build/` and
                            `~/.neptune_tpu_torch/cache`)
"""

from __future__ import annotations

import dataclasses
import os

import torch


@dataclasses.dataclass
class Config:
    # Apply-executor backend: "torch" (eager PyTorch on the tensors' device),
    # "cuda" (generated Hopper kernels; an apply they cannot take raises), or
    # "auto" (the kernels where `cuda_backend.supported` holds, eager
    # otherwise). Mirrors the JAX package's "jnp" / "pallas" / "auto".
    backend: str = os.environ.get("NEPTUNE_TORCH_BACKEND", "auto")

    # Print IR after each pipeline stage.
    dump_ir: bool = os.environ.get("NEPTUNE_TORCH_DUMP_IR", "0") == "1"

    # Affine folding of constant-coefficient sums of stencil accesses
    # (`lowering/torch_backend.py`): the eager path and the kernel generator
    # fold through the same walker, so both see identical arithmetic.
    fold_affine: bool = os.environ.get("NEPTUNE_TORCH_FOLD_AFFINE", "1") == "1"

    # Element dtype of an opdef whose DSL decorator names none. f64, the
    # reference's precision, as in the JAX package; PyTorch runs f64 on
    # every device, so unlike there it never degrades to f32.
    default_dtype: str = os.environ.get("NEPTUNE_TORCH_DTYPE", "float64")

    # Where an input that is not a tensor (a NumPy array, a list) goes when
    # the call names no device: the card, as the JAX package puts NumPy
    # inputs on its default device. Tensors stay on their own device.
    device: str = os.environ.get("NEPTUNE_TORCH_DEVICE", "cuda")

    # Pinned-arithmetic reproducibility mode: make sharded solves BITWISE
    # identical across mesh shapes (BASELINE.md "bit-stable convergence").
    # Two layout-dependent freedoms are removed:
    #   * FMA contraction -- every arith.mul in an apply body (and the axpy
    #     updates inside the Krylov iterations) is fenced with
    #     `utils.tree._fma_fence`, and affine folding is off, so each cell is
    #     computed by the traced op order wherever it lies (a block's core on
    #     a kernel, its edge bands in eager PyTorch);
    #   * reduction association -- tdot/tnorm sum through a fixed
    #     pairwise-halving tree over the flat global vector (log2 N
    #     elementwise adds), so the association order is a function of the
    #     global element order only, never of the block layout; on a mesh
    #     the products are gathered whole and every process runs the tree.
    # Off by default: the tree costs log2(N) launches per dot product
    # against one, and a gather per dot on a mesh. Unlike the JAX package,
    # whose Pallas kernels keep default arithmetic, kernels A, C and D
    # follow the mode (the mesh path runs a block's core on kernel A and its
    # bands eagerly, so both must compute alike); kernel B and the CA
    # solvers' Gram reductions keep default arithmetic, as there.
    pinned_arithmetic: bool = os.environ.get("NEPTUNE_TORCH_PINNED", "0") == "1"

    # One directory for both build caches (None: each cache's default). Read
    # when a build happens: the CUDA kernels go to `cache_dir/kernels`, the
    # native runtime's libraries to `cache_dir` itself.
    cache_dir: str | None = os.environ.get("NEPTUNE_TORCH_CACHE_DIR") or None


config = Config()


def arithmetic() -> tuple[bool, bool]:
    """The effective (fold, pinned) of the generated bodies: pinned mode
    keeps the traced op order, so it turns folding off. The launch-data
    caches of the kernels that follow the mode are keyed on it."""
    pinned = config.pinned_arithmetic
    return config.fold_affine and not pinned, pinned


def default_device(device=None) -> torch.device:
    """`device`, or `config.device` when the call names none. Asking for
    CUDA where there is none raises: nothing moves to the CPU on its own."""
    dev = torch.device(config.device if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"neptune_tpu_torch: no CUDA device for {str(dev)!r} (torch.cuda.is_available() "
            "is false); to run on the CPU pass device=\"cpu\" or set NEPTUNE_TORCH_DEVICE=cpu"
        )
    return dev
