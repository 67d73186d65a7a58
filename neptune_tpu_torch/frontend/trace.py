"""Materialization of symbolic Expr DAGs into Neptune-TPU IR.

The reference traces Python kernels straight into MLIR through C++ callbacks
(`createApply` calling back into Python to fill the body,
`lib/Compiler/NeptuneCompiler.cpp:109-158`). Here the kernel runs first over
symbolic `Expr`s, and the finished DAG is emitted into an apply region in one
pass — which is what makes capture lifting and pointwise temp algebra
possible (see frontend.expr).
"""

from __future__ import annotations

import itertools
from typing import Callable, Sequence

from ..ir.core import Function
from ..ir.ops import NeptuneBuilder
from ..ir.types import Bounds, ScalarType, TempType
from . import expr as E

_kernel_counter = itertools.count()

_FLOATS = ("float64", "float32", "bfloat16")


def _emit_scalar(b: NeptuneBuilder, node: E.Node, binding: dict, memo: dict):
    key = id(node)
    if key in memo:
        return memo[key]

    if isinstance(node, E.Access):
        src = binding.get(id(node.temp))
        if src is None:
            raise TypeError(
                f"temp '{node.temp.name or node.temp.uid}' is not bound in this "
                "kernel (a concrete array used inside a traced function must be "
                "passed as an argument or capture)"
            )
        v = b.access(src, node.offset)
    elif isinstance(node, E.Const):
        v = b.constant(node.value, node.stype)
    elif isinstance(node, E.Index):
        try:
            v = binding[("index", node.dim)]
        except KeyError:
            raise TypeError(f"index({node.dim}) exceeds the kernel's grid rank")
    elif isinstance(node, E.ScalarRef):
        v = binding.get(id(node))
        if v is None:
            raise TypeError("scalar reference is not bound in this kernel")
    elif isinstance(node, E.Bin):
        a = _emit_scalar(b, node.a, binding, memo)
        c = _emit_scalar(b, node.b, binding, memo)
        a = b.cast(a, node.stype) if a.type != node.stype else a
        c = b.cast(c, node.stype) if c.type != node.stype else c
        v = b.create(node.opname, [a, c], result_types=[node.stype]).result
    elif isinstance(node, E.Un):
        a = _emit_scalar(b, node.a, binding, memo)
        v = b.create(node.opname, [a], result_types=[node.stype]).result
    elif isinstance(node, E.Cmp):
        a = _emit_scalar(b, node.a, binding, memo)
        c = _emit_scalar(b, node.b, binding, memo)
        if a.type != c.type:
            target = a.type if isinstance(c.type, ScalarType) else c.type
            c = b.cast(c, target)
        v = b.cmp(node.pred, a, c)
    elif isinstance(node, E.Select):
        cond = _emit_scalar(b, node.cond, binding, memo)
        a = _emit_scalar(b, node.a, binding, memo)
        c = _emit_scalar(b, node.b, binding, memo)
        # cast BOTH branches to the node's promoted stype — casting the
        # second to the first's type would make where(c, index_expr,
        # float_expr) an index-typed select that truncates the float
        # branch on the native backend
        if a.type != node.stype:
            a = b.cast(a, node.stype)
        if c.type != node.stype:
            c = b.cast(c, node.stype)
        v = b.select(cond, a, c)
    elif isinstance(node, E.Cast):
        a = _emit_scalar(b, node.a, binding, memo)
        v = b.cast(a, node.stype)
    else:
        raise TypeError(f"cannot emit node {type(node).__name__} as a scalar")
    memo[key] = v
    return v


def normalize_kernel_outputs(outs) -> list[E.Node]:
    """Kernel return value -> list of scalar nodes (temps materialize at 0)."""
    if isinstance(outs, E.Expr):
        outs = (outs,)
    if not isinstance(outs, (tuple, list)) or not all(
        isinstance(o, E.Expr) for o in outs
    ):
        raise TypeError(
            f"kernel must return a neptune Expr (or tuple of), got {type(outs)}"
        )
    nodes = []
    for o in outs:
        n = o.node
        if n.is_temp:
            n = E.shift(n, (0,) * n.ttype.bounds.rank)
        nodes.append(n)
    return nodes


def trace_kernel_into_opdef(
    builder: NeptuneBuilder,
    name: str,
    kind: str,
    kernel: Callable,
    arg_ttypes: Sequence[TempType],
    apply_bounds: Bounds,
    arg_names: Sequence[str] = (),
    periodic: bool = False,
) -> tuple[Function, list[E.TempLeaf], list[E.ScalarRef]]:
    """Run `kernel` over fresh symbolic args and emit a complete opdef.

    Returns (opdef function, temp captures, scalar captures) — captures are
    values the kernel closed over lexically; temps and then scalars are
    appended to the opdef's signature (generalizing the reference's fixed
    0..2-capture nonlinear ABI, `RuntimeLowering.cpp:217-378`).
    """
    arg_leaves = [
        E.TempLeaf(tt, name=arg_names[i] if i < len(arg_names) else f"arg{i}")
        for i, tt in enumerate(arg_ttypes)
    ]
    outs = kernel(*[E.Expr(l) for l in arg_leaves])
    out_nodes = normalize_kernel_outputs(outs)

    leaves: list[E.TempLeaf] = []
    for n in out_nodes:
        E.collect_leaves(n, leaves)
    arg_ids = {id(l) for l in arg_leaves}
    captures = [l for l in leaves if id(l) not in arg_ids]

    # lexically captured scalars (e.g. a traced dt arg) become trailing scalar
    # opdef args, wired through the apply's scalar_params machinery — an
    # extension of the reference's (Temp...)->(Temp...) signature contract
    scalar_caps: list[E.ScalarRef] = []
    for n in out_nodes:
        E.collect_scalar_refs(n, scalar_caps)

    full_bounds = arg_ttypes[0].bounds if arg_ttypes else captures[0].ttype.bounds
    elem = arg_ttypes[0].element if arg_ttypes else captures[0].ttype.element
    loc = arg_ttypes[0].location if arg_ttypes else captures[0].ttype.location
    result_types = [TempType(elem, full_bounds, loc) for _ in out_nodes]

    all_in_types = (
        list(arg_ttypes)
        + [l.ttype for l in captures]
        + [s.stype for s in scalar_caps]
    )
    fn = builder.make_opdef(name, kind, all_in_types, result_types)
    builder.push_block(fn.body)
    temp_ordered = arg_leaves + captures
    n_temps = len(temp_ordered)
    op, body = builder.start_apply(
        list(fn.body.args[:n_temps]),
        apply_bounds,
        result_types=result_types,
        scalar_params=list(fn.body.args[n_temps:]),
        periodic=periodic,
    )
    builder.push_block(body)
    rank = full_bounds.rank
    binding: dict = {("index", d): body.args[d] for d in range(rank)}
    for k, leaf in enumerate(temp_ordered):
        binding[id(leaf)] = body.args[rank + k]
    for k, sref in enumerate(scalar_caps):
        binding[id(sref)] = body.args[rank + n_temps + k]
    memo: dict = {}
    yields = [_emit_scalar(builder, n, binding, memo) for n in out_nodes]
    # element-type coercion on yields
    yields = [
        builder.cast(y, result_types[j].element_scalar)
        if y.type != result_types[j].element_scalar
        else y
        for j, y in enumerate(yields)
    ]
    builder.yield_(yields)
    builder.pop_block()
    results = builder.finish_apply(op)
    if not isinstance(results, tuple):
        results = (results,)
    builder.return_(list(results))
    builder.pop_block()
    return fn, captures, scalar_caps


def emit_apply_inline(
    builder: NeptuneBuilder,
    kernel: Callable,
    input_exprs: Sequence[E.Expr],
    apply_bounds: Bounds,
) -> E.Expr | tuple[E.Expr, ...]:
    """Emit an apply op inline in the current (traced) function.

    The reference `@apply` decorator path (`python_frontend/neptune/dsl.py:
    5-26`): inputs are Exprs bound to IR temps in the function being traced.
    """
    leaves_in = []
    ir_inputs = []
    for x in input_exprs:
        n = x.node
        if not isinstance(n, E.TempLeaf) or n.ir_value is None:
            raise TypeError(
                "@apply inputs must be traced temps (function args or results "
                "of other ops)"
            )
        leaves_in.append(n)
        ir_inputs.append(n.ir_value)

    outs = kernel(*[E.Expr(l) for l in leaves_in])
    out_nodes = normalize_kernel_outputs(outs)

    leaves: list[E.TempLeaf] = []
    for n in out_nodes:
        E.collect_leaves(n, leaves)
    extra = [l for l in leaves if id(l) not in {id(q) for q in leaves_in}]
    for l in extra:
        if l.ir_value is None:
            raise TypeError(
                f"kernel captured unbound temp '{l.name or l.uid}'; pass it in "
                "inputs=[...]"
            )
        leaves_in.append(l)
        ir_inputs.append(l.ir_value)

    tt0 = leaves_in[0].ttype
    result_types = [TempType(tt0.element, tt0.bounds, tt0.location) for _ in out_nodes]
    op, body = builder.start_apply(ir_inputs, apply_bounds, result_types=result_types)
    builder.push_block(body)
    rank = tt0.bounds.rank
    binding: dict = {("index", d): body.args[d] for d in range(rank)}
    for k, leaf in enumerate(leaves_in):
        binding[id(leaf)] = body.args[rank + k]
    memo: dict = {}
    yields = [_emit_scalar(builder, n, binding, memo) for n in out_nodes]
    builder.yield_(yields)
    builder.pop_block()
    results = builder.finish_apply(op)
    if isinstance(results, tuple):
        return tuple(
            E.Expr(E.TempLeaf(r.type, ir_value=r)) for r in results
        )
    return E.Expr(E.TempLeaf(results.type, ir_value=results))


def fresh_kernel_name(prefix: str) -> str:
    return f"{prefix}_{next(_kernel_counter)}"
