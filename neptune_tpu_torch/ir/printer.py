"""Textual IR printer — the pass-inspection surface.

Produces an MLIR-flavored dump of Neptune-TPU IR modules. This is the analog
of the reference's `Compiler.dump` (`lib/Compiler/NeptuneCompiler.cpp:284-289`)
and the per-pass `neptune-opt` inspection workflow (`README.md:46-55`).
The dump is deterministic (stable value numbering) so it doubles as:
  * the golden-test surface (lit/FileCheck-style tests on dumps, mirroring
    `test/mlir_tests/`), and
  * the cache key text that structure-key hashing consumes (the reference
    hashes canonical structure strings, `VerifyAndAnnotate.cpp:228-294`).
"""

from __future__ import annotations

from io import StringIO

from .core import Block, Function, Module, Operation, Value
from .types import Bounds, StencilShape


def _fmt_attr(v) -> str:
    if isinstance(v, Bounds):
        return str(v)
    if isinstance(v, StencilShape):
        return str(v)
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str):
        return f'"{v}"'
    if v is None:
        return "none"
    if isinstance(v, tuple):
        return "[" + ", ".join(_fmt_attr(x) for x in v) + "]"
    if isinstance(v, dict):
        return (
            "{"
            + ", ".join(f"{k} = {_fmt_attr(x)}" for k, x in sorted(v.items()))
            + "}"
        )
    return str(v)


class _Printer:
    def __init__(self):
        self.out = StringIO()
        self.names: dict[int, str] = {}
        self.counter = 0
        self.indent = 0

    def name(self, v: Value) -> str:
        if v.uid not in self.names:
            self.names[v.uid] = f"%{self.counter}"
            self.counter += 1
        return self.names[v.uid]

    def line(self, s: str):
        self.out.write("  " * self.indent + s + "\n")

    # ------------------------------------------------------------------

    def print_module(self, m: Module):
        attrs = ""
        if m.attrs:
            attrs = (
                " attributes {"
                + ", ".join(f"{k} = {_fmt_attr(v)}" for k, v in sorted(m.attrs.items()))
                + "}"
            )
        self.line(f"module @{m.name}{attrs} {{")
        self.indent += 1
        for fn in m.functions.values():
            self.print_function(fn)
        self.indent -= 1
        self.line("}")

    def print_function(self, fn: Function):
        kind = {
            "func": "func",
            "linear_opdef": "neptune.linear_opdef",
            "nonlinear_opdef": "neptune.nonlinear_opdef",
        }[fn.kind]
        attrs = ""
        if fn.attrs:
            attrs = (
                " attributes {"
                + ", ".join(
                    f"{k} = {_fmt_attr(v)}" for k, v in sorted(fn.attrs.items())
                )
                + "}"
            )
        self.line(f"{kind} @{fn.name} : {fn.ftype}{attrs} {{")
        self.indent += 1
        self.print_block(fn.body)
        self.indent -= 1
        self.line("}")

    def print_block(self, b: Block):
        if b.args:
            args = ", ".join(f"{self.name(a)}: {a.type}" for a in b.args)
            self.line(f"^({args}):")
        for op in b.ops:
            self.print_op(op)

    def print_op(self, op: Operation):
        parts = []
        if op.results:
            parts.append(", ".join(self.name(r) for r in op.results))
            parts.append("= ")
        head = "".join(p if p.endswith(" ") else p + " " for p in parts)

        operands = ", ".join(self.name(o) for o in op.operands)

        # special-cases for readability
        if op.name == "neptune.access":
            off = list(op.attrs["offset"])
            self.line(
                f"{head}neptune.access {operands}{off} : {op.results[0].type}"
            )
            return
        if op.name == "arith.constant":
            self.line(
                f"{head}arith.constant {_fmt_attr(op.attrs['value'])} : "
                f"{op.results[0].type}"
            )
            return

        attrs = {k: v for k, v in op.attrs.items() if v is not None}
        attr_s = ""
        if attrs:
            attr_s = (
                " {"
                + ", ".join(f"{k} = {_fmt_attr(v)}" for k, v in sorted(attrs.items()))
                + "}"
            )
        res_types = ", ".join(str(r.type) for r in op.results)
        type_s = f" : {res_types}" if res_types else ""
        sym = ""
        if "symbol" in op.attrs:
            sym = f" @{op.attrs['symbol']}"
            attrs.pop("symbol", None)
            attr_s = (
                " {"
                + ", ".join(f"{k} = {_fmt_attr(v)}" for k, v in sorted(attrs.items()))
                + "}"
                if attrs
                else ""
            )
        paren = f"({operands})" if operands else ""
        self.line(f"{head}{op.name}{sym}{paren}{attr_s}{type_s}")
        for r in op.regions:
            self.indent += 1
            self.line("{")
            self.indent += 1
            self.print_block(r)
            self.indent -= 1
            self.line("}")
            self.indent -= 1


def print_module(m: Module) -> str:
    p = _Printer()
    p.print_module(m)
    return p.out.getvalue()


def print_function(fn: Function) -> str:
    p = _Printer()
    p.print_function(fn)
    return p.out.getvalue()
