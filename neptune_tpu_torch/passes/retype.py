"""Module retyping: swap the element dtype of every float grid type.

The port of `neptune_tpu/passes/retype.py`. The iterative-refinement solver
(`solvers.refine`) runs the *same operator* at float32 for the inner Krylov
solves and at float64 for the residuals; this pass makes the low-precision
twin of a module. Constants keep their values (an f64 literal rounds to f32
at execution); index and bool scalars are untouched.
"""

from __future__ import annotations

from ..ir.core import Module
from ..ir.types import FieldType, FunctionType, MatrixType, ScalarType, TempType, TensorType

_FLOATS = {"float64", "float32", "bfloat16"}


def _swap(t, elem: str):
    if isinstance(t, TempType) and t.element in _FLOATS:
        return TempType(elem, t.bounds, t.location)
    if isinstance(t, FieldType) and t.element in _FLOATS:
        return FieldType(elem, t.bounds, t.location)
    if isinstance(t, TensorType) and t.element in _FLOATS:
        return TensorType(elem, t.shape)
    if isinstance(t, MatrixType) and t.element in _FLOATS:
        return MatrixType(elem, t.n)
    if isinstance(t, ScalarType) and t.name in _FLOATS:
        return ScalarType(elem)
    return t


def retype_module(module: Module, elem: str = "float32") -> Module:
    """Deep-copied module with every float grid/scalar type set to `elem`."""
    m = module.clone()
    for fn in m.functions.values():
        fn.ftype = FunctionType(
            tuple(_swap(t, elem) for t in fn.ftype.inputs),
            tuple(_swap(t, elem) for t in fn.ftype.results),
        )
        # op attrs (bounds, shapes) are dtype-free; only value types change
        for op in fn.walk():
            for r in op.results:
                r.type = _swap(r.type, elem)
        for a in _all_block_args(fn):
            a.type = _swap(a.type, elem)
    return m


def _all_block_args(fn):
    yield from fn.body.args
    for op in fn.walk():
        for region in op.regions:
            yield from region.args
