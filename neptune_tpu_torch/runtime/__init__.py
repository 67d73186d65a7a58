"""Native host runtime: C++ codegen + AOT cache + ctypes loading.

The port of `neptune_tpu/runtime/`. The native analog of the reference's
compiled-kernel + PETSc-runtime path (`lib/Compiler/NeptuneCompiler.cpp`
AOT backend + `lib/Runtime/PETSc/`): stencil applies compile to C++ loop
nests, solver ops call the libneptune_rt Krylov/Newton implementations,
modules cache as shared objects keyed by source hash and load through
ctypes. It is the f64 host oracle, independent of both packages' array
code, and runs on the CPU whatever `config.device` says.
"""

from .aot import NativeCompiledModule, compile_native
from .cgen import CodegenError, generate_cpp

__all__ = [
    "NativeCompiledModule",
    "compile_native",
    "CodegenError",
    "generate_cpp",
]
