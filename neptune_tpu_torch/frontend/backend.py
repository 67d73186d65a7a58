"""jit_compile -- whole-module compilation.

The port of `neptune_tpu/frontend/backend.py`: run the lowering pipeline
and return a library object whose attributes are the module's functions.
PyTorch runs eagerly, so a function is the port's `CompiledModule.function`
itself, with no `jax.jit` around it. The JAX package's `jit_compile` points
XLA's persistent compilation cache at `config.cache_dir`; the port compiles
nothing here, and routing its two build caches is the whole counterpart:
with `config.cache_dir` (NEPTUNE_TORCH_CACHE_DIR) set, the CUDA kernels
build into `cache_dir/kernels` (`kernels/build.py`) and the native runtime
into `cache_dir` (`runtime/aot.py`), each read when a build happens;
unset, they go to `neptune_tpu_torch/_build/` and
`~/.neptune_tpu_torch/cache`.
"""

from __future__ import annotations

from .core import GlobalContext, get_context


class CompiledLibrary:
    """Attribute-access facade over a pipeline-compiled module (the
    reference's `ctypes.CDLL` stand-in)."""

    def __init__(self, compiled_module):
        self._cm = compiled_module
        self._fns: dict[str, object] = {}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._fns:
            try:
                self._fns[name] = self._cm.function(name)
            except KeyError:
                raise AttributeError(f"no compiled function @{name}")
        return self._fns[name]

    def function_names(self):
        return [f.name for f in self._cm.module.funcs()]

    @property
    def module(self):
        return self._cm.module


def jit_compile(compiler_instance: GlobalContext | None = None) -> CompiledLibrary:
    """Compile the context's module; returns a library of its functions.
    Its kernels build at first use, into `config.cache_dir`/kernels when
    that is set (the native runtime into `config.cache_dir`), else into
    `neptune_tpu_torch/_build/`."""
    ctx = compiler_instance or get_context()
    return CompiledLibrary(ctx.compiled())
