"""Textual IR parser — round-trips the printer format.

Together with `printer`, this gives the file-based tooling workflow of the
reference's `neptune-opt` (an mlir-opt clone, `src/neptuneOpt.cpp:38-47`):
IR can be dumped at any stage, saved, re-parsed, and run through passes —
the surface the reference's lit/FileCheck tests build on (`test/mlir_tests/`).
"""

from __future__ import annotations

import re
from typing import Optional

from .core import Block, Function, Module, Operation, Value
from .ops import IRError
from .types import (
    BOOL,
    F32,
    F64,
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
)

_SCALARS = {
    "f64": F64,
    "f32": F32,
    "bf16": ScalarType("bfloat16"),
    "index": INDEX,
    "bool": BOOL,
    "int32": ScalarType("int32"),
    "i32": ScalarType("int32"),
}

_ELEMENTS = {"f64": "float64", "f32": "float32", "bf16": "bfloat16", "i32": "int32"}

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<arrow>->)
  | (?P<dims>\d+x[0-9a-z_x]*)
  | (?P<special>-?inf|nan)
  | (?P<num>-?\d+\.\d+(e[+-]?\d+)?|-?\d+e[+-]?\d+|-?\d+\.?(?![\w.]))
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
  | (?P<sym>@[A-Za-z0-9_.]+)
  | (?P<val>%\d+)
  | (?P<str>"[^"]*")
  | (?P<punct>[(){}\[\]<>:,=^])
    """,
    re.VERBOSE,
)


class ParseError(IRError):
    pass


class _Lexer:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.toks: list[tuple[str, str, int]] = []
        while self.pos < len(text):
            m = _TOKEN_RE.match(text, self.pos)
            if not m:
                line = text.count("\n", 0, self.pos) + 1
                raise ParseError(f"lex error at line {line}: {text[self.pos:self.pos+20]!r}")
            self.pos = m.end()
            kind = m.lastgroup
            if kind == "ws":
                continue
            self.toks.append((kind, m.group(), m.start()))
        self.i = 0

    def peek(self, k=0) -> Optional[tuple[str, str, int]]:
        if self.i + k < len(self.toks):
            return self.toks[self.i + k]
        return None

    def next(self) -> tuple[str, str, int]:
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of input")
        self.i += 1
        return t

    def expect(self, text_or_kind: str) -> str:
        t = self.next()
        if t[1] != text_or_kind and t[0] != text_or_kind:
            line = self.text.count("\n", 0, t[2]) + 1
            raise ParseError(f"line {line}: expected {text_or_kind!r}, got {t[1]!r}")
        return t[1]

    def accept(self, text: str) -> bool:
        t = self.peek()
        if t is not None and t[1] == text:
            self.i += 1
            return True
        return False


class Parser:
    def __init__(self, text: str):
        self.lx = _Lexer(text)
        self.values: dict[str, Value] = {}

    # ------------------------------------------------------------------
    # types
    # ------------------------------------------------------------------

    def parse_bounds(self) -> Bounds:
        """One or more `[a,b)` groups separated by commas."""
        lbs, ubs = [], []
        while True:
            self.lx.expect("[")
            lbs.append(int(self.lx.next()[1]))
            self.lx.expect(",")
            ubs.append(int(self.lx.next()[1]))
            self.lx.expect(")")
            nxt = self.lx.peek()
            if nxt is not None and nxt[1] == "," and (
                self.lx.peek(1) is not None and self.lx.peek(1)[1] == "["
            ):
                self.lx.next()
                continue
            break
        return Bounds.of(lbs, ubs)

    def parse_type(self):
        t = self.lx.next()
        name = t[1]
        if name in _SCALARS and not (self.lx.peek() and self.lx.peek()[1] == "<"):
            return _SCALARS[name]
        if name in ("temp", "field"):
            self.lx.expect("<")
            elem = _ELEMENTS[self.lx.next()[1]]
            self.lx.expect(",")
            bounds = self.parse_bounds()
            self.lx.expect(",")
            loc = Location(self.lx.next()[1])
            self.lx.expect(">")
            cls = TempType if name == "temp" else FieldType
            return cls(elem, bounds, loc)
        if name == "tensor":
            self.lx.expect("<")
            raw = self.lx.next()[1]  # dims token like "16xf64" / "8x16xf32"
            self.lx.expect(">")
            m = re.fullmatch(r"((\d+x)*)([a-z][a-z0-9]*)", raw)
            if not m:
                raise ParseError(f"bad tensor type tensor<{raw}>")
            elem = _ELEMENTS[m.group(3)]
            dims = [int(d) for d in raw.split("x")[:-1]]
            return TensorType(elem, tuple(dims))
        if name == "matrix":
            self.lx.expect("<")
            elem = _ELEMENTS[self.lx.next()[1]]
            self.lx.expect(",")
            raw = self.lx.next()[1]  # "64x64"
            self.lx.expect(">")
            n = int(re.match(r"(\d+)x", raw).group(1))
            return MatrixType(elem, n)
        raise ParseError(f"unknown type {name!r}")

    def parse_type_list_parened(self) -> tuple:
        self.lx.expect("(")
        out = []
        if not self.lx.accept(")"):
            while True:
                out.append(self.parse_type())
                if self.lx.accept(")"):
                    break
                self.lx.expect(",")
        return tuple(out)

    # ------------------------------------------------------------------
    # attributes
    # ------------------------------------------------------------------

    def _peek_req(self, k=0):
        t = self.lx.peek(k)
        if t is None:
            raise ParseError("unexpected end of input")
        return t

    def parse_attr_value(self):
        t = self._peek_req()
        if t[1] == "[":
            # Bounds (`[a,b)` groups) or a plain nested list (`[[1, 1]]`)
            if self._peek_req(1)[1] == "[":
                return self.parse_list()
            save = self.lx.i
            try:
                return self.parse_bounds()
            except ParseError:
                self.lx.i = save
                return self.parse_list()
        if t[1] == "{":
            # `{ident = ...}` is a nested attr dict (e.g. solver options);
            # `{[o, ...], ...}` is a StencilShape
            nxt = self.lx.peek(1)
            if nxt is not None and nxt[0] == "ident" and nxt[1] not in ("true", "false", "none"):
                return self.parse_attr_dict()
            return self.parse_stencil_shape()
        if t[0] == "str":
            return self.lx.next()[1][1:-1]
        if t[0] == "num":
            raw = self.lx.next()[1]
            return float(raw) if ("." in raw or "e" in raw) else int(raw)
        if t[0] == "ident":
            w = self.lx.next()[1]
            if w == "true":
                return True
            if w == "false":
                return False
            if w == "none":
                return None
            return w
        raise ParseError(f"bad attribute value {t[1]!r}")

    def parse_list(self):
        self.lx.expect("[")
        out = []
        if not self.lx.accept("]"):
            while True:
                out.append(self.parse_attr_value())
                if self.lx.accept("]"):
                    break
                self.lx.expect(",")
        return tuple(out)

    def parse_stencil_shape(self) -> StencilShape:
        self.lx.expect("{")
        offs = []
        if not self.lx.accept("}"):
            while True:
                offs.append(tuple(int(x) for x in self.parse_list()))
                if self.lx.accept("}"):
                    break
                self.lx.expect(",")
        return StencilShape(tuple(offs))

    def parse_attr_dict(self) -> dict:
        self.lx.expect("{")
        attrs = {}
        if not self.lx.accept("}"):
            while True:
                key = self.lx.next()[1]
                self.lx.expect("=")
                attrs[key] = self.parse_attr_value()
                if self.lx.accept("}"):
                    break
                self.lx.expect(",")
        return attrs


    # ------------------------------------------------------------------
    # ops / blocks / functions / module
    # ------------------------------------------------------------------

    def parse_block_into(self, block: Block, end_tok: str = "}"):
        # optional block header ^(%0: type, ...):
        if self.lx.peek() and self.lx.peek()[1] == "^":
            self.lx.next()
            self.lx.expect("(")
            if not self.lx.accept(")"):
                while True:
                    vname = self.lx.next()[1]
                    self.lx.expect(":")
                    vtype = self.parse_type()
                    self.values[vname] = block.add_arg(vtype)
                    if self.lx.accept(")"):
                        break
                    self.lx.expect(",")
            self.lx.expect(":")
        while self.lx.peek() is not None and self.lx.peek()[1] != end_tok:
            block.append(self.parse_op())
        self.lx.expect(end_tok)

    def parse_op(self) -> Operation:
        result_names = []
        while self._peek_req()[0] == "val":
            result_names.append(self.lx.next()[1])
            if not self.lx.accept(","):
                break
        if result_names:
            self.lx.expect("=")

        opname = self.lx.next()[1]

        # special forms
        if opname == "arith.constant":
            raw = self.lx.next()
            if raw[0] == "num":
                val = float(raw[1]) if ("." in raw[1] or "e" in raw[1]) else int(raw[1])
            elif raw[0] == "special":
                val = float(raw[1])
            elif raw[1] in ("true", "false"):
                val = raw[1] == "true"
            else:
                raise ParseError(f"bad constant literal {raw[1]!r}")
            self.lx.expect(":")
            rtype = self.parse_type()
            op = Operation("arith.constant", [], {"value": val}, [rtype])
            self.values[result_names[0]] = op.results[0]
            return op
        if opname == "neptune.access":
            src = self.values[self.lx.next()[1]]
            off = [int(x) for x in self.parse_list()]
            self.lx.expect(":")
            rtype = self.parse_type()
            op = Operation(
                "neptune.access", [src], {"offset": tuple(off)}, [rtype]
            )
            self.values[result_names[0]] = op.results[0]
            return op

        attrs = {}
        operands = []
        sym = None
        t = self.lx.peek()
        if t is not None and t[0] == "sym":
            sym = self.lx.next()[1][1:]
        if self.lx.accept("("):
            if not self.lx.accept(")"):
                while True:
                    operands.append(self.values[self.lx.next()[1]])
                    if self.lx.accept(")"):
                        break
                    self.lx.expect(",")
        if self.lx.peek() is not None and self.lx.peek()[1] == "{" and result_names:
            # could be attrs or (for typed ops) a region — attrs always come
            # before ':' so a '{' here is attrs iff a ':' or another '{'
            # follows its matching close... simpler: ops with regions always
            # have types; attrs-dict-first is the printed order.
            attrs = self.parse_attr_dict()
        elif self.lx.peek() is not None and self.lx.peek()[1] == "{" and not result_names:
            attrs = self.parse_attr_dict()
        if sym is not None:
            attrs["symbol"] = sym

        result_types = []
        if self.lx.accept(":"):
            while True:
                result_types.append(self.parse_type())
                if not self.lx.accept(","):
                    break

        regions = []
        while self.lx.peek() is not None and self.lx.peek()[1] == "{":
            self.lx.next()
            blk = Block()
            self.parse_block_into(blk, "}")
            regions.append(blk)

        op = Operation(opname, operands, attrs, result_types, regions)
        for name, res in zip(result_names, op.results):
            self.values[name] = res
        return op

    def parse_function(self) -> Function:
        t = self.lx.next()
        kind = {
            "func": "func",
            "neptune.linear_opdef": "linear_opdef",
            "neptune.nonlinear_opdef": "nonlinear_opdef",
        }.get(t[1])
        if kind is None:
            line = self.lx.text.count("\n", 0, t[2]) + 1
            raise ParseError(
                f"line {line}: expected func/opdef keyword, got {t[1]!r}"
            )
        name = self.lx.next()[1][1:]  # @name
        self.lx.expect(":")
        inputs = self.parse_type_list_parened()
        self.lx.expect("->")
        results = self.parse_type_list_parened()
        attrs = {}
        if self._peek_req()[1] == "attributes":
            self.lx.next()
            attrs = self.parse_attr_dict()
        self.lx.expect("{")
        body = Block()
        self.parse_block_into(body, "}")
        # reconcile: printed functions carry arg types in the block header;
        # a function with no block header (no args) keeps the empty block
        fn = Function(name, kind, FunctionType(tuple(inputs), tuple(results)), body)
        fn.attrs = attrs
        return fn

    def parse_module(self) -> Module:
        self.lx.expect("module")
        name = self.lx.next()[1][1:]
        attrs = {}
        if self._peek_req()[1] == "attributes":
            self.lx.next()
            attrs = self.parse_attr_dict()
        self.lx.expect("{")
        m = Module(name)
        m.attrs = attrs
        while not self.lx.accept("}"):
            m.add(self.parse_function())
        return m


def parse_module(text: str) -> Module:
    """Parse a printed module back into IR.

    Every malformed/truncated input surfaces as ParseError: interior
    lookups (type names, enum values) can fail with KeyError/ValueError
    on cut-off tokens, which would otherwise escape as raw exceptions
    without the line diagnostics the lexer provides."""
    p = Parser(text)
    try:
        return p.parse_module()
    except ParseError:
        raise
    except (KeyError, ValueError, TypeError, IndexError) as e:
        t = p.lx.peek() or (p.lx.toks[-1] if p.lx.toks else None)
        line = text.count("\n", 0, t[2]) + 1 if t else 1
        raise ParseError(
            f"line {line}: malformed or truncated input "
            f"({type(e).__name__}: {e})"
        ) from e
