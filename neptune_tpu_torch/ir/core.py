"""Core SSA IR infrastructure for the Neptune-TPU stencil IR.

Lightweight, pure-Python analog of the MLIR infrastructure the reference builds
on (an `Operation` with operands/attributes/results/regions, single-block
regions, a symbol-owning `Module`). The reference realizes this with MLIR C++
(`lib/Dialect/NeptuneIR/*`); we only need the subset the NeptuneIR dialect
actually uses:

  * all regions are single-block (reference ApplyOp is SingleBlock,
    `include/Dialect/NeptuneIR/NeptuneIROps.td:164-197`);
  * functions are flat lists of ops (no CFG — the reference's only control flow
    inside kernels is `scf.if`, which we model as a functional `select`/`cond`
    op, matching how it must look for XLA anyway);
  * symbols (opdef names) live in a module-level table, as in MLIR's
    SymbolTable (used by `VerifyAndAnnotate.cpp:375-384` symbol resolution).
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator, Optional, Sequence

from .types import FunctionType

_value_counter = itertools.count()


class Value:
    """An SSA value: result of an op or a block argument."""

    __slots__ = ("type", "defining_op", "block_arg_of", "index", "uid", "name_hint")

    def __init__(self, type: Any, name_hint: str = ""):
        self.type = type
        self.defining_op: Optional[Operation] = None
        self.block_arg_of: Optional[Block] = None
        self.index: int = -1  # result index or block-arg index
        self.uid = next(_value_counter)
        self.name_hint = name_hint

    def __repr__(self):
        return f"<Value %{self.uid}:{self.type}>"


class Operation:
    """A generic operation: name, operands, attributes, results, regions."""

    __slots__ = ("name", "operands", "attrs", "results", "regions", "parent")

    def __init__(
        self,
        name: str,
        operands: Sequence[Value] = (),
        attrs: Optional[dict] = None,
        result_types: Sequence[Any] = (),
        regions: Sequence["Block"] = (),
    ):
        self.name = name
        self.operands: list[Value] = list(operands)
        self.attrs: dict = dict(attrs or {})
        self.results: list[Value] = []
        for i, rt in enumerate(result_types):
            v = Value(rt)
            v.defining_op = self
            v.index = i
            self.results.append(v)
        self.regions: list[Block] = list(regions)
        for r in self.regions:
            r.parent_op = self
        self.parent: Optional[Block] = None

    @property
    def result(self) -> Value:
        assert len(self.results) == 1, f"{self.name} has {len(self.results)} results"
        return self.results[0]

    def region(self, i: int = 0) -> "Block":
        return self.regions[i]

    def walk(self) -> Iterator["Operation"]:
        """Pre-order walk of this op and all nested ops."""
        yield self
        for r in self.regions:
            for op in r.ops:
                yield from op.walk()

    def __repr__(self):
        return f"<Op {self.name} ({len(self.operands)} operands)>"


class Block:
    """A single basic block: typed arguments plus an ordered op list."""

    __slots__ = ("args", "ops", "parent_op")

    def __init__(self, arg_types: Sequence[Any] = (), arg_names: Sequence[str] = ()):
        self.args: list[Value] = []
        for i, t in enumerate(arg_types):
            v = Value(t, arg_names[i] if i < len(arg_names) else "")
            v.block_arg_of = self
            v.index = i
            self.args.append(v)
        self.ops: list[Operation] = []
        self.parent_op: Optional[Operation] = None

    def append(self, op: Operation) -> Operation:
        op.parent = self
        self.ops.append(op)
        return op

    def add_arg(self, type: Any, name: str = "") -> Value:
        v = Value(type, name)
        v.block_arg_of = self
        v.index = len(self.args)
        self.args.append(v)
        return v

    @property
    def terminator(self) -> Optional[Operation]:
        return self.ops[-1] if self.ops else None


class Function:
    """A module-level callable symbol.

    ``kind`` distinguishes plain functions from operator definitions:
      * "func"             — reference `func.func`
      * "linear_opdef"     — reference `neptune_ir.linear_opdef`
                             (`NeptuneIROps.td:318-382`)
      * "nonlinear_opdef"  — reference `neptune_ir.nonlinear_opdef`
                             (`NeptuneIROps.td:385-449`)
    """

    __slots__ = ("name", "kind", "ftype", "body", "attrs")

    def __init__(self, name: str, kind: str, ftype: FunctionType, body: Block):
        assert kind in ("func", "linear_opdef", "nonlinear_opdef"), kind
        self.name = name
        self.kind = kind
        self.ftype = ftype
        self.body = body
        self.attrs: dict = {}

    def walk(self) -> Iterator[Operation]:
        for op in self.body.ops:
            yield from op.walk()

    @property
    def is_opdef(self) -> bool:
        return self.kind in ("linear_opdef", "nonlinear_opdef")


class Module:
    """Top-level container: an ordered symbol table of functions."""

    def __init__(self, name: str = "module"):
        self.name = name
        self.functions: dict[str, Function] = {}
        self.attrs: dict = {}

    def add(self, fn: Function) -> Function:
        if fn.name in self.functions:
            raise ValueError(f"symbol redefinition: @{fn.name}")
        self.functions[fn.name] = fn
        return fn

    def lookup(self, name: str) -> Function:
        if name not in self.functions:
            raise KeyError(f"unresolved symbol @{name}")
        return self.functions[name]

    def opdefs(self) -> list[Function]:
        return [f for f in self.functions.values() if f.is_opdef]

    def funcs(self) -> list[Function]:
        return [f for f in self.functions.values() if f.kind == "func"]

    def walk(self) -> Iterator[Operation]:
        for f in self.functions.values():
            yield from f.walk()

    def clone(self) -> "Module":
        """Deep-copy the module (passes clone before destructive rewrites so
        stage dumps stay inspectable, like per-pass `neptune-opt` runs)."""
        from .printer import print_module  # noqa: F401  (cheap sanity import)

        mapping: dict[int, Value] = {}

        def clone_block(b: Block) -> Block:
            nb = Block()
            for a in b.args:
                na = nb.add_arg(a.type, a.name_hint)
                mapping[a.uid] = na
            for op in b.ops:
                nb.append(clone_op(op))
            return nb

        def clone_op(op: Operation) -> Operation:
            nop = Operation(
                op.name,
                operands=[mapping[o.uid] for o in op.operands],
                attrs=dict(op.attrs),
                result_types=[r.type for r in op.results],
                regions=[clone_block(r) for r in op.regions],
            )
            for old, new in zip(op.results, nop.results):
                mapping[old.uid] = new
            return nop

        m = Module(self.name)
        m.attrs = dict(self.attrs)
        for f in self.functions.values():
            nf = Function(f.name, f.kind, f.ftype, clone_block(f.body))
            nf.attrs = dict(f.attrs)
            m.add(nf)
        return m


class Builder:
    """Insertion-point-tracking op builder (analog of mlir::OpBuilder as used
    by the reference's NeptuneCompiler, `lib/Compiler/NeptuneCompiler.cpp:44-56`)."""

    def __init__(self, module: Optional[Module] = None):
        self.module = module or Module()
        self._block_stack: list[Block] = []

    # -- insertion points -------------------------------------------------

    @property
    def block(self) -> Block:
        if not self._block_stack:
            raise RuntimeError("no insertion point set")
        return self._block_stack[-1]

    def push_block(self, block: Block) -> Block:
        self._block_stack.append(block)
        return block

    def pop_block(self) -> Block:
        return self._block_stack.pop()

    # -- generic op creation ---------------------------------------------

    def create(
        self,
        name: str,
        operands: Sequence[Value] = (),
        attrs: Optional[dict] = None,
        result_types: Sequence[Any] = (),
        regions: Sequence[Block] = (),
    ) -> Operation:
        op = Operation(name, operands, attrs, result_types, regions)
        self.block.append(op)
        return op

    # -- functions --------------------------------------------------------

    def make_function(
        self,
        name: str,
        kind: str,
        input_types: Sequence[Any],
        result_types: Sequence[Any],
        arg_names: Sequence[str] = (),
    ) -> Function:
        body = Block(input_types, arg_names)
        fn = Function(
            name, kind, FunctionType(tuple(input_types), tuple(result_types)), body
        )
        self.module.add(fn)
        return fn


def build_in(builder: Builder, block: Block, fn: Callable[[], Any]) -> Any:
    """Run `fn` with `block` as the builder's insertion point."""
    builder.push_block(block)
    try:
        return fn()
    finally:
        builder.pop_block()
