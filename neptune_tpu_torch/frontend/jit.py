"""@jit_class -- lazy trace-and-compile solver classes.

The port of `neptune_tpu/frontend/jit.py`. `__init__` runs eagerly
(`assemble_matrix` yields a live, lazy MatrixHandle). Each method is traced
once per argument signature into an IR function `<Cls>_<method>`, lowered
through the pipeline, and later calls go straight to the port's compiled
function -- PyTorch runs eagerly, so there is no `jax.jit` around it.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from ..ir.types import Bounds, FunctionType, ScalarType, TempType
from ..utils.profiling import span
from . import expr as E
from .core import get_context
from .dsl import Expr, MatrixExpr, _dtype_name


def _arg_spec(a):
    """The IR type of a sample argument."""
    if isinstance(a, Expr) and isinstance(a.node, E.TempLeaf):
        return a.node.ttype
    if isinstance(a, (torch.Tensor, np.ndarray)):
        return TempType(_dtype_name(a.dtype), Bounds.of((0,) * a.ndim, tuple(a.shape)))
    if isinstance(a, float):
        return ScalarType("float64")
    if isinstance(a, int):
        return ScalarType("int32")
    raise TypeError(f"cannot trace argument of type {type(a)}")


def trace_method(ctx, name: str, bound_method: Callable, sample_args):
    """Trace one call of `bound_method` into an IR function named `name`."""
    arg_types = [_arg_spec(a) for a in sample_args]
    b = ctx.builder
    fn = b.make_function(name, "func", arg_types, [])
    ctx.current_function = fn
    b.push_block(fn.body)
    ok = False
    try:
        exprs = []
        for v in fn.body.args:
            if isinstance(v.type, TempType):
                exprs.append(Expr(E.TempLeaf(v.type, ir_value=v)))
            else:
                exprs.append(Expr(E.ScalarRef(ir_value=v, stype=v.type)))
        result = bound_method(*exprs)
        outs = result if isinstance(result, (tuple, list)) else (result,)
        out_vals = []
        for o in outs:
            if isinstance(o, Expr) and getattr(o.node, "ir_value", None) is not None:
                out_vals.append(o.node.ir_value)
            elif isinstance(o, MatrixExpr):
                out_vals.append(o.ir_value)
            else:
                raise TypeError(f"method {name} must return traced Exprs, got {type(o)}")
        b.return_(out_vals)
        fn.ftype = FunctionType(tuple(arg_types), tuple(v.type for v in out_vals))
        ok = True
    finally:
        b.pop_block()
        ctx.current_function = None
        if not ok:
            # don't leave a half-traced, terminator-less symbol behind
            ctx.module.functions.pop(name, None)
    ctx.bump()
    return fn


def _signature(a):
    if isinstance(a, (torch.Tensor, np.ndarray)):
        return tuple(a.shape), str(a.dtype)
    if isinstance(a, (int, float)):
        return (), type(a).__name__
    return type(a).__name__


class JITClassWrapper:
    def __init__(self, cls, *args, **kwargs):
        self._cls = cls
        self._ctx = get_context()
        # run eagerly: state members like assemble_matrix handles come out
        # live and lazy
        self._instance = cls(*args, **kwargs)
        self._compiled_methods: dict[tuple, Callable] = {}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        inst_attr = getattr(self._instance, name)
        if not callable(inst_attr):
            return inst_attr
        symbol = f"{self._cls.__name__}.{name}"

        def method_proxy(*args):
            # cache per (method, arg signature): a call with other shapes or
            # dtypes traces a fresh IR function instead of failing the first
            # trace's shape check
            with span("nt.call", symbol=symbol):
                key = (name, tuple(_signature(a) for a in args))
                if key not in self._compiled_methods:
                    fn_name = f"{self._cls.__name__}_{name}"
                    if fn_name in self._ctx.module.functions:
                        fn_name = f"{fn_name}_{len(self._compiled_methods)}_{id(self):x}"
                    trace_method(self._ctx, fn_name, inst_attr, args)
                    self._compiled_methods[key] = self._ctx.compiled().function(fn_name)
                return self._compiled_methods[key](*args)

        return method_proxy


def jit_class(cls):
    """Class decorator: methods are traced into IR functions on first call."""

    @functools.wraps(cls)
    def wrapper(*args, **kwargs):
        return JITClassWrapper(cls, *args, **kwargs)

    return wrapper
