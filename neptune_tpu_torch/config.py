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


config = Config()


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
