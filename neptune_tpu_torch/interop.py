"""Carry programs and state across from the JAX package.

A program is its IR module plus its fields; there are no weights. The JAX
package prints a module with `neptune_tpu.ir.print_module`; the port parses
that text with its own copy of the parser, so both packages run the same
program. Fields cross as NumPy arrays and land on `config.device` (the
card by default) unless the call names a device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .config import default_device
from .ir.core import Module
from .ir.parser import parse_module
from .lowering.torch_backend import DTYPES


def module_from_reference(text: str) -> Module:
    """The port's module for IR text printed by either package."""
    return parse_module(text)


def arrays_from_numpy(arrays: Sequence, device=None, dtype=None) -> list[torch.Tensor]:
    """NumPy arrays (or anything `np.asarray` takes) as tensors on `device`
    (default `config.device`; CUDA where there is none raises), cast to
    `dtype` (a torch dtype or an IR element name) when given."""
    if isinstance(dtype, str):
        dtype = DTYPES[dtype]
    device = default_device(device)
    return [
        torch.from_numpy(np.require(np.asarray(a), requirements="C")).to(device=device, dtype=dtype)
        for a in arrays
    ]
