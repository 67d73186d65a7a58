"""Neptune-TPU stencil IR: types, ops, builder, printer, verifier.

Python-traced re-design of the reference's NeptuneIR MLIR dialect
(`include/Dialect/NeptuneIR/`): same type/attribute/op vocabulary, carried by
lightweight Python dataclasses instead of TableGen-generated C++.
"""

from .core import Block, Builder, Function, Module, Operation, Value, build_in
from .ops import (
    IRError,
    LINEAR_SOLVERS,
    NONLINEAR_METHODS,
    NeptuneBuilder,
    REDUCE_KINDS,
)
from .printer import print_function, print_module
from .types import (
    BF16,
    BOOL,
    F32,
    F64,
    I32,
    INDEX,
    Bounds,
    FieldType,
    FunctionType,
    Location,
    MatrixType,
    ScalarType,
    StencilShape,
    TempType,
    TensorType,
    TimeMethod,
)
from .verify import verify_and_annotate

__all__ = [
    "Block",
    "Builder",
    "Function",
    "Module",
    "Operation",
    "Value",
    "build_in",
    "IRError",
    "LINEAR_SOLVERS",
    "NONLINEAR_METHODS",
    "NeptuneBuilder",
    "REDUCE_KINDS",
    "print_function",
    "print_module",
    "BF16",
    "BOOL",
    "F32",
    "F64",
    "I32",
    "INDEX",
    "Bounds",
    "FieldType",
    "FunctionType",
    "Location",
    "MatrixType",
    "ScalarType",
    "StencilShape",
    "TempType",
    "TensorType",
    "TimeMethod",
    "verify_and_annotate",
]
