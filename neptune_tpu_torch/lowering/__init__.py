"""Lowering/execution layer: IR -> PyTorch callables (eager + CUDA kernels)."""

from .executor import CompiledModule, compile_module

__all__ = ["CompiledModule", "compile_module"]
