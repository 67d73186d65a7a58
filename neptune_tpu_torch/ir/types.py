"""Type system and attributes for the Neptune-TPU stencil IR.

TPU-native re-design of the NeptuneIR MLIR dialect's types and attributes:

  * ``Bounds``        — reference `#neptune_ir.bounds<lb=[..], ub=[..]>`
                        (`include/Dialect/NeptuneIR/NeptuneIRAttrs.td:9-26`):
                        per-dimension half-open logical domain ``[lb, ub)``.
  * ``Location``      — reference `#neptune_ir.location<"cell">`
                        (`NeptuneIRAttrs.td:29-49`): FDM/FVM grid staggering.
  * ``StencilShape``  — reference `#neptune_ir.stencil_shape`
                        (`NeptuneIRAttrs.td:53-76`): the set of neighbor offsets
                        a stencil touches. Here it additionally drives halo
                        widths for sharded execution and Pallas block halos.
  * ``FieldType``     — reference `!neptune_ir.field` (`NeptuneIRTypes.td:12-34`):
                        storage-backed field (buffer semantics).
  * ``TempType``      — reference `!neptune_ir.temp` (`NeptuneIRTypes.td:38-59`):
                        value-semantics field.
  * ``TimeMethod``    — reference TimeMethod I32 enum (`NeptuneIRAttrs.td:78-85`).

Storage normalization: the logical domain ``[lb, ub)`` maps to a 0-based
physical array of shape ``ub - lb`` (the type-conversion rule in the reference's
DataflowLowering, `lib/Passes/DataflowLowering.cpp:41-104`). All executors in
this package use that same rule: physical index = logical index − lb.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Iterable, Sequence


# --------------------------------------------------------------------------
# Attributes
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Bounds:
    """Per-dimension half-open logical domain [lb, ub)."""

    lb: tuple[int, ...]
    ub: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "lb", tuple(int(x) for x in self.lb))
        object.__setattr__(self, "ub", tuple(int(x) for x in self.ub))
        if len(self.lb) != len(self.ub):
            raise ValueError(f"bounds rank mismatch: lb={self.lb} ub={self.ub}")
        for l, u in zip(self.lb, self.ub):
            if u < l:
                raise ValueError(f"empty/negative bounds: lb={self.lb} ub={self.ub}")

    @property
    def rank(self) -> int:
        return len(self.lb)

    @property
    def shape(self) -> tuple[int, ...]:
        """Physical (0-based) array shape: ub - lb per dim."""
        return tuple(u - l for l, u in zip(self.lb, self.ub))

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def contains(self, other: "Bounds") -> bool:
        """True if `other` is a (non-strict) sub-domain of self."""
        return (
            other.rank == self.rank
            and all(ol >= sl for ol, sl in zip(other.lb, self.lb))
            and all(ou <= su for ou, su in zip(other.ub, self.ub))
        )

    def shifted_within(self, offset: Sequence[int], outer: "Bounds") -> bool:
        """True if every point i in self has i+offset inside `outer`."""
        return all(
            l + o >= ol and u - 1 + o <= ou - 1
            for l, u, o, ol, ou in zip(self.lb, self.ub, offset, outer.lb, outer.ub)
        )

    def rel_slices(self, outer: "Bounds") -> tuple[slice, ...]:
        """Slices selecting this sub-domain inside `outer`'s physical array."""
        return tuple(
            slice(l - ol, u - ol)
            for l, u, ol in zip(self.lb, self.ub, outer.lb)
        )

    def __str__(self) -> str:
        dims = ",".join(f"[{l},{u})" for l, u in zip(self.lb, self.ub))
        return dims

    @staticmethod
    def of(lb: Sequence[int], ub: Sequence[int]) -> "Bounds":
        return Bounds(tuple(lb), tuple(ub))


class LocationKind(str, enum.Enum):
    CELL = "cell"
    VERTEX = "vertex"
    FACE_X = "face_x"
    FACE_Y = "face_y"
    FACE_Z = "face_z"


@dataclass(frozen=True)
class Location:
    """Grid staggering of a field: where values live on the FDM/FVM grid."""

    kind: str = "cell"

    def __post_init__(self):
        LocationKind(self.kind)  # validates

    def __str__(self) -> str:
        return self.kind


@dataclass(frozen=True)
class StencilShape:
    """Set of neighbor offsets a stencil kernel accesses.

    The reference collects these in VerifyAndAnnotate
    (`lib/Passes/VerifyAndAnnotate.cpp:252-266`) to build structure keys; here
    they additionally drive halo widths for sharding and Pallas blocking.
    """

    offsets: tuple[tuple[int, ...], ...]

    def __post_init__(self):
        object.__setattr__(
            self, "offsets", tuple(tuple(int(x) for x in o) for o in self.offsets)
        )
        ranks = {len(o) for o in self.offsets}
        if len(ranks) > 1:
            raise ValueError(f"mixed-rank stencil offsets: {self.offsets}")

    @property
    def rank(self) -> int:
        return len(self.offsets[0]) if self.offsets else 0

    def halo(self) -> tuple[tuple[int, int], ...]:
        """Per-dim (lo, hi) halo widths: lo = max(-min offset,0), hi = max(max offset,0)."""
        if not self.offsets:
            return ()
        r = self.rank
        lo = [0] * r
        hi = [0] * r
        for o in self.offsets:
            for d in range(r):
                lo[d] = max(lo[d], -o[d])
                hi[d] = max(hi[d], o[d])
        return tuple(zip(lo, hi))

    def union(self, other: "StencilShape") -> "StencilShape":
        return StencilShape(tuple(sorted(set(self.offsets) | set(other.offsets))))

    def compose(self, other: "StencilShape") -> "StencilShape":
        """Minkowski sum: offsets reachable by applying `other` then `self`."""
        if not self.offsets:
            return other
        if not other.offsets:
            return self
        out = {
            tuple(a + b for a, b in zip(o1, o2))
            for o1 in self.offsets
            for o2 in other.offsets
        }
        return StencilShape(tuple(sorted(out)))

    @staticmethod
    def of(offsets: Iterable[Sequence[int]]) -> "StencilShape":
        return StencilShape(tuple(sorted(tuple(o) for o in set(map(tuple, offsets)))))

    def __str__(self) -> str:
        return "{" + ", ".join(str(list(o)) for o in self.offsets) + "}"


class TimeMethod(enum.IntEnum):
    """Reference TimeMethod enum values (`NeptuneIRAttrs.td:78-85`)."""

    EXPLICIT = 0
    IMPLICIT_NONLINEAR = 1
    IMPLICIT_LINEAR = 2
    RUNTIME = 3


# --------------------------------------------------------------------------
# Types
# --------------------------------------------------------------------------


_VALID_ELEMENTS = ("float64", "float32", "bfloat16", "int32")


@dataclass(frozen=True)
class ScalarType:
    """Scalar SSA value type inside apply bodies (f64/f32/index/bool)."""

    name: str  # "float64" | "float32" | "bfloat16" | "index" | "bool" | "int32"

    def __str__(self) -> str:
        return {"float64": "f64", "float32": "f32", "bfloat16": "bf16"}.get(
            self.name, self.name
        )


F64 = ScalarType("float64")
F32 = ScalarType("float32")
BF16 = ScalarType("bfloat16")
INDEX = ScalarType("index")
BOOL = ScalarType("bool")
I32 = ScalarType("int32")


@dataclass(frozen=True)
class _GridType:
    element: str  # numpy dtype name
    bounds: Bounds
    location: Location = Location("cell")

    def __post_init__(self):
        if self.element not in _VALID_ELEMENTS:
            raise ValueError(f"unsupported element type: {self.element}")

    @property
    def rank(self) -> int:
        return self.bounds.rank

    @property
    def shape(self) -> tuple[int, ...]:
        return self.bounds.shape

    @property
    def element_scalar(self) -> ScalarType:
        return ScalarType(self.element)

    def _render(self, kw: str) -> str:
        return f"{kw}<{ScalarType(self.element)}, {self.bounds}, {self.location}>"


@dataclass(frozen=True)
class FieldType(_GridType):
    """Storage-backed field (reference `!neptune_ir.field`)."""

    def __str__(self) -> str:
        return self._render("field")

    def temp(self) -> "TempType":
        return TempType(self.element, self.bounds, self.location)


@dataclass(frozen=True)
class TempType(_GridType):
    """Value-semantics field (reference `!neptune_ir.temp`)."""

    def __str__(self) -> str:
        return self._render("temp")

    def field(self) -> FieldType:
        return FieldType(self.element, self.bounds, self.location)


@dataclass(frozen=True)
class TensorType:
    """A plain dense array type (host/device buffer).

    Plays two reference roles: the `memref<?x..xf64>` buffers that `wrap`/
    `unwrap` bridge to fields (`NeptuneIROps.td:20-60`) and the `tensor`
    interop type of `as_tensor`/`from_tensor` (`NeptuneIROps.td:539-596`).
    """

    element: str
    shape: tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    @property
    def rank(self) -> int:
        return len(self.shape)

    def __str__(self) -> str:
        dims = "x".join(str(s) for s in self.shape)
        return f"tensor<{dims}x{ScalarType(self.element)}>"


@dataclass(frozen=True)
class MatrixType:
    """Assembled-or-lazy linear-operator handle type.

    The reference's `assemble_matrix` returns `memref<?x?xf64>` that actually
    carries an opaque handle (`NeptunePETScRuntime.cpp:614-631`); here the type
    is honest about being an operator handle of logical size n×n.
    """

    element: str
    n: int  # flattened operator dimension

    def __str__(self) -> str:
        return f"matrix<{ScalarType(self.element)}, {self.n}x{self.n}>"


@dataclass(frozen=True)
class FunctionType:
    inputs: tuple[object, ...]
    results: tuple[object, ...]

    def __str__(self) -> str:
        ins = ", ".join(str(t) for t in self.inputs)
        outs = ", ".join(str(t) for t in self.results)
        return f"({ins}) -> ({outs})"
