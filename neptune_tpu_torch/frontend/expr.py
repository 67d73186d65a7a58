"""Symbolic expression tracer — the user-facing `Expr`.

Rebuild of the reference's operator-overloading tracer
(`python_frontend/neptune/expr.py`): `u[-1]`/`u[0,1]` build stencil accesses,
`+ - * /` build arithmetic (with int/float auto-promotion), and kernels are
plain Python functions over `Expr`s.

Design difference: the reference's Expr wraps an MLIR SSA handle and mutates
global compiler state per operation. Here Expr wraps a pure symbolic DAG that
is *materialized* into IR (or executed eagerly) later. That enables two
upgrades the reference only aspires to (`test/python_tests/
test_swe_implicit.py`):

  * **pointwise temp algebra** — `q*q/h + 0.5*g*h*h` on whole temps builds a
    deferred pointwise expression; stencil-indexing it (`f[1]`) distributes
    the shift onto the leaves (`q[1]*q[1]/h[1] + ...`);
  * **closure capture** — kernels may reference temps from an enclosing scope
    (e.g. `h_curr` inside a residual closure); materialization lifts them to
    extra operator inputs automatically.

Node kinds:
  temp-valued:   TempLeaf, Pointwise
  scalar-valued: Access, Const, Index, ScalarRef, Bin, Un, Cmp, Select, Cast
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

from ..ir.types import BOOL, INDEX, ScalarType, TempType

_leaf_counter = itertools.count()


class Node:
    """Base class for symbolic DAG nodes."""

    __slots__ = ()

    @property
    def is_temp(self) -> bool:
        return isinstance(self, (TempLeaf, Pointwise))


@dataclass(eq=False)
class TempLeaf(Node):
    """A grid-valued source: an IR temp value, or a concrete array (eager)."""

    ttype: TempType
    ir_value: Any = None  # ir.Value when bound to a traced function
    concrete: Any = None  # tensor or np array when eager
    name: str = ""
    uid: int = field(default_factory=lambda: next(_leaf_counter))
    _shift_cache: dict = field(default_factory=dict)


@dataclass(eq=False)
class Pointwise(Node):
    """Elementwise combination of temps (and shift-invariant scalars)."""

    opname: str  # arith.*/math.* name
    args: tuple  # Node children (temp-kind or shift-invariant scalar-kind)
    ttype: TempType
    _shift_cache: dict = field(default_factory=dict)


@dataclass(eq=False)
class Access(Node):
    temp: TempLeaf
    offset: tuple
    stype: ScalarType


@dataclass(eq=False)
class Const(Node):
    value: Any
    stype: ScalarType


@dataclass(eq=False)
class Index(Node):
    dim: int
    stype: ScalarType = INDEX


@dataclass(eq=False)
class ScalarRef(Node):
    """A scalar SSA value from the enclosing traced function (e.g. dt arg) or
    a concrete scalar in eager mode."""

    ir_value: Any = None
    concrete: Any = None
    stype: ScalarType = ScalarType("float64")
    uid: int = field(default_factory=lambda: next(_leaf_counter))


@dataclass(eq=False)
class Bin(Node):
    opname: str
    a: Node
    b: Node
    stype: ScalarType


@dataclass(eq=False)
class Un(Node):
    opname: str
    a: Node
    stype: ScalarType


@dataclass(eq=False)
class Cmp(Node):
    pred: str
    a: Node
    b: Node
    stype: ScalarType = BOOL


@dataclass(eq=False)
class Select(Node):
    cond: Node
    a: Node
    b: Node
    stype: ScalarType = ScalarType("float64")


@dataclass(eq=False)
class Cast(Node):
    a: Node
    stype: ScalarType


# ---------------------------------------------------------------------------
# shift machinery
# ---------------------------------------------------------------------------


def is_shift_invariant(n: Node) -> bool:
    if isinstance(n, (Const, ScalarRef)):
        return True
    if isinstance(n, (Index, Access)):
        return False
    if isinstance(n, Bin):
        return is_shift_invariant(n.a) and is_shift_invariant(n.b)
    if isinstance(n, (Un, Cast)):
        return is_shift_invariant(n.a)
    if isinstance(n, Cmp):
        return is_shift_invariant(n.a) and is_shift_invariant(n.b)
    if isinstance(n, Select):
        return all(is_shift_invariant(x) for x in (n.cond, n.a, n.b))
    return False


def shift(n: Node, offset: tuple) -> Node:
    """Materialize a temp-valued node at a stencil offset -> scalar node."""
    if isinstance(n, TempLeaf):
        key = tuple(offset)
        if key not in n._shift_cache:
            n._shift_cache[key] = Access(n, key, n.ttype.element_scalar)
        return n._shift_cache[key]
    if isinstance(n, Pointwise):
        key = tuple(offset)
        if key not in n._shift_cache:
            children = []
            for c in n.args:
                if c.is_temp:
                    children.append(shift(c, key))
                else:
                    # shift-invariant scalar (enforced at construction)
                    children.append(c)
            st = n.ttype.element_scalar
            if len(children) == 2:
                node = Bin(n.opname, children[0], children[1], st)
            else:
                node = Un(n.opname, children[0], st)
            n._shift_cache[key] = node
        return n._shift_cache[key]
    raise TypeError(f"cannot shift non-temp node {type(n).__name__}")


def collect_leaves(n: Node, out: Optional[list] = None) -> list[TempLeaf]:
    """All TempLeafs referenced by a DAG, in deterministic encounter order."""
    if out is None:
        out = []

    seen = {id(l) for l in out}

    def walk(x: Node):
        if isinstance(x, TempLeaf):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, Pointwise):
            for c in x.args:
                walk(c)
        elif isinstance(x, Access):
            walk(x.temp)
        elif isinstance(x, Bin):
            walk(x.a)
            walk(x.b)
        elif isinstance(x, (Un, Cast)):
            walk(x.a)
        elif isinstance(x, Cmp):
            walk(x.a)
            walk(x.b)
        elif isinstance(x, Select):
            walk(x.cond)
            walk(x.a)
            walk(x.b)

    walk(n)
    return out


def collect_scalar_refs(n: Node, out: Optional[list] = None) -> list[ScalarRef]:
    if out is None:
        out = []
    seen = {id(s) for s in out}

    def walk(x: Node):
        if isinstance(x, ScalarRef):
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, Pointwise):
            for c in x.args:
                walk(c)
        elif isinstance(x, Access):
            pass
        elif isinstance(x, Bin):
            walk(x.a)
            walk(x.b)
        elif isinstance(x, (Un, Cast)):
            walk(x.a)
        elif isinstance(x, Cmp):
            walk(x.a)
            walk(x.b)
        elif isinstance(x, Select):
            walk(x.cond)
            walk(x.a)
            walk(x.b)

    walk(n)
    return out


# ---------------------------------------------------------------------------
# Expr: the user-facing wrapper
# ---------------------------------------------------------------------------


def _result_stype(a: ScalarType, b: ScalarType) -> ScalarType:
    if a == b:
        return a
    order = {"bool": 0, "index": 1, "int32": 1, "bfloat16": 2, "float32": 3, "float64": 4}
    return a if order.get(a.name, 0) >= order.get(b.name, 0) else b


class Expr:
    """User-visible expression: wraps a temp-valued or scalar-valued node.

    Mirrors the reference Expr's surface (`python_frontend/neptune/expr.py`):
    indexing builds accesses, arithmetic builds ops, numbers auto-promote.
    """

    __slots__ = ("node",)

    def __init__(self, node: Node):
        self.node = node

    # -- helpers ----------------------------------------------------------

    @property
    def is_temp(self) -> bool:
        return self.node.is_temp

    @property
    def dtype_scalar(self) -> ScalarType:
        n = self.node
        if n.is_temp:
            return n.ttype.element_scalar
        return n.stype

    def _as_node(self, other, like: ScalarType) -> Node:
        if isinstance(other, Expr):
            return other.node
        if isinstance(other, (int, float)):
            st = like if like.name in ("float64", "float32", "bfloat16") else ScalarType(
                "float64"
            )
            if isinstance(other, int) and like.name in ("index", "int32"):
                st = like
            return Const(other, st)
        raise TypeError(f"unsupported operand type: {type(other)}")

    def _scalarize(self, n: Node) -> Node:
        """Temp used where a scalar is needed: materialize at offset 0."""
        if n.is_temp:
            rank = n.ttype.bounds.rank
            return shift(n, (0,) * rank)
        return n

    def _binary(self, opname: str, other, reverse=False) -> "Expr":
        o = self._as_node(other, self.dtype_scalar)
        a, b = (o, self.node) if reverse else (self.node, o)

        a_temp, b_temp = a.is_temp, b.is_temp
        if a_temp or b_temp:
            # pointwise path if the scalar side is shift-invariant
            other_side = b if a_temp else a
            if (not other_side.is_temp) and not is_shift_invariant(other_side):
                a = self._scalarize(a)
                b = self._scalarize(b)
            else:
                if a_temp and b_temp:
                    if a.ttype != b.ttype:
                        raise TypeError(
                            f"pointwise op on mismatched temps {a.ttype} vs {b.ttype}"
                        )
                    tt = a.ttype
                else:
                    tt = a.ttype if a_temp else b.ttype
                return Expr(Pointwise(opname, (a, b), tt))
        st = _result_stype(
            a.stype if not a.is_temp else a.ttype.element_scalar,
            b.stype if not b.is_temp else b.ttype.element_scalar,
        )
        return Expr(Bin(opname, a, b, st))

    # -- stencil access ---------------------------------------------------

    def __getitem__(self, index) -> "Expr":
        if not self.node.is_temp:
            raise TypeError("stencil indexing requires a grid-valued expression")
        if isinstance(index, int):
            offsets = (index,)
        elif isinstance(index, (tuple, list)):
            offsets = tuple(int(i) for i in index)
        else:
            raise TypeError(f"indices must be ints or tuples, got {type(index)}")
        rank = self.node.ttype.bounds.rank
        if len(offsets) != rank:
            raise TypeError(
                f"offset rank {len(offsets)} != grid rank {rank} "
                f"(use u[{','.join('0' * rank)}]-style offsets)"
            )
        return Expr(shift(self.node, offsets))

    # -- arithmetic -------------------------------------------------------

    def __add__(self, o):
        return self._binary("arith.add", o)

    def __radd__(self, o):
        return self._binary("arith.add", o, reverse=True)

    def __sub__(self, o):
        return self._binary("arith.sub", o)

    def __rsub__(self, o):
        return self._binary("arith.sub", o, reverse=True)

    def __mul__(self, o):
        return self._binary("arith.mul", o)

    def __rmul__(self, o):
        return self._binary("arith.mul", o, reverse=True)

    def __truediv__(self, o):
        return self._binary("arith.div", o)

    def __rtruediv__(self, o):
        return self._binary("arith.div", o, reverse=True)

    def __pow__(self, o):
        if isinstance(o, int) and o >= 1:
            # integer powers unroll to multiplies (keeps linear-op bodies
            # within the mul-by-constant whitelist when o == 1)
            r = self
            for _ in range(o - 1):
                r = r * self
            return r
        return self._binary("arith.pow", o)

    def __neg__(self):
        n = self.node
        if n.is_temp:
            return Expr(Pointwise("arith.neg", (n,), n.ttype))
        return Expr(Un("arith.neg", n, n.stype))

    # -- comparisons (scalar only) ---------------------------------------

    def _compare(self, pred, other):
        a = self._scalarize(self.node)
        b = self._scalarize(self._as_node(other, self.dtype_scalar))
        return Expr(Cmp(pred, a, b))

    def __eq__(self, o):  # noqa: A003 - DSL semantics over hashability
        return self._compare("eq", o)

    def __ne__(self, o):
        return self._compare("ne", o)

    def __lt__(self, o):
        return self._compare("lt", o)

    def __le__(self, o):
        return self._compare("le", o)

    def __gt__(self, o):
        return self._compare("gt", o)

    def __ge__(self, o):
        return self._compare("ge", o)

    # -- boolean combinators (for boundary predicates) --------------------

    def _bool_binary(self, opname, other):
        if not isinstance(other, Expr):
            raise TypeError(f"{opname} expects Expr operands")
        a, b = self.node, other.node
        if a.is_temp or b.is_temp:
            raise TypeError(f"{opname} operates on scalar boolean Exprs")
        node = Bin(opname, a, b, BOOL)
        return Expr(node)

    def __or__(self, other):
        return self._bool_binary("arith.or", other)

    def __and__(self, other):
        return self._bool_binary("arith.and", other)

    def __invert__(self):
        if self.node.is_temp:
            raise TypeError("~ operates on scalar boolean Exprs")
        return Expr(Un("arith.not", self.node, BOOL))

    def __bool__(self):
        raise TypeError(
            "neptune Expr has no truth value: use |, &, ~ for boolean logic "
            "and neptune.where(...) for conditionals (Python's and/or/if "
            "would silently drop operands)"
        )

    def __hash__(self):
        return id(self.node)

    def __repr__(self):
        kind = "temp" if self.node.is_temp else "scalar"
        return f"<neptune Expr {kind}:{type(self.node).__name__}>"


# ---------------------------------------------------------------------------
# free functions (math + select), usable on scalars and pointwise on temps
# ---------------------------------------------------------------------------


def _unary_math(opname: str, x) -> Expr:
    if not isinstance(x, Expr):
        raise TypeError(f"{opname} expects a neptune Expr")
    n = x.node
    if n.is_temp:
        return Expr(Pointwise(opname, (n,), n.ttype))
    return Expr(Un(opname, n, n.stype))


def exp(x):
    return _unary_math("math.exp", x)


def log(x):
    return _unary_math("math.log", x)


def sqrt(x):
    return _unary_math("math.sqrt", x)


def sin(x):
    return _unary_math("math.sin", x)


def cos(x):
    return _unary_math("math.cos", x)


def tanh(x):
    return _unary_math("math.tanh", x)


def abs(x):  # noqa: A001 - DSL namespace
    return _unary_math("math.abs", x)


def erf(x):
    return _unary_math("math.erf", x)


def minimum(a: Expr, b) -> Expr:
    return a._binary("arith.min", b)


def maximum(a: Expr, b) -> Expr:
    return a._binary("arith.max", b)


def where(cond: Expr, a, b) -> Expr:
    """Functional conditional — the DSL surface for the reference kernels'
    `scf.if` boundary handling (smoke_time_advance_nonlinear.mlir:37-80)."""
    if not isinstance(cond, Expr) or cond.node.is_temp:
        raise TypeError("where() condition must be a scalar boolean Expr")
    proto = a if isinstance(a, Expr) else b
    if not isinstance(proto, Expr):
        raise TypeError("where() needs at least one Expr branch")
    an = proto._as_node(a, proto.dtype_scalar)
    bn = proto._as_node(b, proto.dtype_scalar)
    an = proto._scalarize(an)
    bn = proto._scalarize(bn)
    # promote across BOTH branches: taking the first branch's stype alone
    # would type where(c, index(0), u[0]) as index, truncating the float
    # branch on the native backend
    sa = an.stype if hasattr(an, "stype") else bn.stype
    sb = bn.stype if hasattr(bn, "stype") else sa
    st = _result_stype(sa, sb)
    node = Select(cond.node, an, bn)
    node.stype = st
    return Expr(node)


def index(dim: int = 0) -> Expr:
    """The logical grid index along `dim` (the apply region's IV)."""
    return Expr(Index(dim))


def on_boundary(u: Expr, width: int = 1) -> Expr:
    """Boolean predicate: true within `width` cells of u's domain edge.

    The DSL shorthand for the index-comparison boundary guards the reference
    writes by hand with scf.if (smoke_time_advance_nonlinear.mlir:30-36):

        return where(on_boundary(u), u[0] - u_prev[0], interior_residual)
    """
    if not isinstance(u, Expr) or not u.node.is_temp:
        raise TypeError("on_boundary expects a grid-valued Expr")
    bounds = u.node.ttype.bounds
    pred = None
    for d in range(bounds.rank):
        iv = Expr(Index(d))
        lo = iv < (bounds.lb[d] + width)
        hi = iv >= (bounds.ub[d] - width)
        p = lo | hi
        pred = p if pred is None else (pred | p)
    return pred


def interior(u: Expr, width: int = 1) -> Expr:
    """Boolean predicate: true strictly inside u's domain (complement of
    on_boundary)."""
    return ~on_boundary(u, width)
