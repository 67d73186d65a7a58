"""Lowering/execution layer: IR -> PyTorch callables (eager + CUDA kernels)."""

from .executor import CompiledModule

__all__ = ["CompiledModule"]
