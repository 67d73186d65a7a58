"""Global tracing context: one module under construction plus a cached
compiled snapshot for eager execution.

The port of `neptune_tpu/frontend/core.py`. Dual-mode execution, as there:
  * **traced mode**: a function is being traced (`current_function` set,
    e.g. inside `@jit_class` method tracing) -- DSL calls append IR ops;
  * **eager mode**: no active function -- DSL calls run at once against the
    compiled snapshot, the port's `CompiledModule`, on torch tensors.
"""

from __future__ import annotations

from typing import Optional

from ..ir.core import Function, Module
from ..ir.ops import NeptuneBuilder
from ..ir.printer import print_module


class GlobalContext:
    def __init__(self):
        self.builder = NeptuneBuilder(Module("main"))
        self.current_function: Optional[Function] = None
        self._version = 0
        self._compiled = None
        self._compiled_version = -1

    # reference parity: ctx.compiler is the IR builder
    @property
    def compiler(self) -> NeptuneBuilder:
        return self.builder

    @property
    def module(self) -> Module:
        return self.builder.module

    @property
    def tracing(self) -> bool:
        return self.current_function is not None

    def bump(self):
        """Invalidate the compiled snapshot (module changed)."""
        self._version += 1

    def compiled(self):
        """Pipeline-compiled snapshot of the current module (cached)."""
        if self._compiled_version != self._version:
            from ..passes import run_pipeline

            self._compiled = run_pipeline(self.module, collect_dumps=False).compiled()
            self._compiled_version = self._version
        return self._compiled

    def dump(self) -> str:
        """Textual IR of the module (reference `Compiler.dump`)."""
        return print_module(self.module)

    def reset(self):
        self.builder = NeptuneBuilder(Module("main"))
        self.current_function = None
        self._compiled = None
        self._compiled_version = -1
        self._version = 0


_default_ctx = GlobalContext()


def get_context() -> GlobalContext:
    return _default_ctx


def get_compiler() -> GlobalContext:
    """Reference-parity accessor (`core.get_compiler`)."""
    return _default_ctx


def reset_context():
    """Clear all traced state (tests)."""
    _default_ctx.reset()


Context = GlobalContext
