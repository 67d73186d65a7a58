"""Geometric 2:1 coarsening of stencil opdefs: the rediscretization step
behind `solve_linear(..., precond="mg")`.

The port of `neptune_tpu/passes/coarsen.py`, against the port's own copy of
the IR. The apply DAG of an opdef (offsets and scalar constants) does not
depend on the grid size, so cloning every referenced opdef with

  * outer bounds  [lb, ub)        ->  [lb, lb + (ub-lb)/2)
  * apply/store bounds            ->  same lb/ub margins on the new outer
  * stencil shapes / constants    ->  unchanged

gives the same discretization on the coarse grid. Unchanged constants keep
the fine grid's implicit 1/h^k scaling, so for second-order (1/h²)
operators the caller damps each level's matvec by 1/4 per coarsening
(`lowering/executor.py::auto_mg_preconditioner`), unless it asks for the
operator unscaled (HPCG's coarse levels).

That is cell-centred coarsening (`mode="cell"`): the whole grid halves.
`mode="vertex"` keeps each opdef's ring and halves its interior box
instead: outer [lb, ub) with the apply bounds [lo, hi) becomes
[lb, lb + (lo - lb) + (hi - lo)/2 + (ub - hi)), so the ring of absent
neighbours stays one cell wide on every level (322 -> 162 -> 82 -> 42
for HPCG's 320 -> 160 -> 80 -> 40 unknowns), and coarse unknown i sits
on fine unknown 2i (injection, `solvers.multigrid`).
"""

from __future__ import annotations

from ..ir.core import Module
from ..ir.types import Bounds, FieldType, FunctionType, TempType
from ..ir.verify import verify_and_annotate

_ALLOWED_PREFIXES = ("arith.",)
_ALLOWED = {
    "neptune.apply",
    "neptune.access",
    "neptune.yield",
    "neptune.return",
    "neptune.apply_linear",
    "neptune.apply_nonlinear",
    "neptune.load",
    "neptune.store",
    "neptune.wrap",
    "neptune.unwrap",
    "neptune.reduce",
}


def _halve(b: Bounds, factor: int = 2) -> Bounds:
    shape = b.shape
    for s in shape:
        if s % factor:
            raise ValueError(f"bounds {b} not {factor}:1-coarsenable (extent {s})")
    return Bounds(b.lb, tuple(l + s // factor for l, s in zip(b.lb, shape)))


def _margin_preserve(attr_b: Bounds, old_outer: Bounds, new_outer: Bounds) -> Bounds:
    """Apply/store sub-bounds keep their lb/ub margins on the new outer
    domain (a [1, n-1) interior of [0, n) becomes [1, n/2-1) of [0, n/2):
    the rediscretized boundary ring)."""
    lb = tuple(nl + (al - ol) for al, ol, nl in zip(attr_b.lb, old_outer.lb, new_outer.lb))
    ub = tuple(nu - (ou - au) for au, ou, nu in zip(attr_b.ub, old_outer.ub, new_outer.ub))
    return Bounds(lb, ub)


def _vertex(b: Bounds, box: Bounds, factor: int = 2) -> Bounds:
    """`b` with the interior `box`'s extent divided by `factor` and its
    margins outside the box kept."""
    ub = []
    for l, u, bl, bu in zip(b.lb, b.ub, box.lb, box.ub):
        if (bu - bl) % factor:
            raise ValueError(
                f"interior {box} not {factor}:1-coarsenable (extent {bu - bl})")
        ub.append(bl + (bu - bl) // factor + (u - bu))
    return Bounds(b.lb, tuple(ub))


def _box(fn) -> Bounds:
    """The one interior box of an opdef's applies and stores (vertex
    coarsening keeps the ring outside it)."""
    boxes = {op.attrs["bounds"] for op in fn.walk() if op.attrs.get("bounds") is not None}
    if len(boxes) != 1:
        raise NotImplementedError(
            f"vertex coarsening needs one interior box in @{fn.name} (found {len(boxes)})")
    return boxes.pop()


def _swap_type(t, shrink):
    if isinstance(t, TempType):
        return TempType(t.element, shrink(t.bounds), t.location)
    if isinstance(t, FieldType):
        return FieldType(t.element, shrink(t.bounds), t.location)
    return t


def _reachable_syms(module: Module, sym: str) -> list[str]:
    seen: list[str] = []

    def visit(s: str):
        if s in seen:
            return
        seen.append(s)
        for op in module.lookup(s).walk():
            callee = op.attrs.get("symbol")
            if callee is not None and op.name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
                visit(callee)

    visit(sym)
    return seen


def coarsen_opdef(module: Module, sym: str, factor: int = 2, mode: str = "cell") -> Module:
    """A fresh module holding @sym (and the opdefs it calls) re-instantiated
    at `factor`:1-coarsened bounds, verified and re-keyed. mode: "cell"
    (the whole grid halves) or "vertex" (the interior box halves, the ring
    stays; see the module docstring).

    Raises ValueError when a grid extent is not divisible by `factor` and
    NotImplementedError when an opdef's body holds ops whose coarsening is
    not purely geometric (solver and time ops).
    """
    syms = _reachable_syms(module, sym)
    sub = Module(f"{module.name}__coarse{factor}")
    src = module.clone()
    for s in syms:
        sub.add(src.functions.pop(s))

    for fn in sub.functions.values():
        if not fn.is_opdef:
            raise NotImplementedError(f"coarsen_opdef: @{fn.name} is not an opdef")
        for op in fn.walk():
            if op.name not in _ALLOWED and not op.name.startswith(_ALLOWED_PREFIXES):
                raise NotImplementedError(
                    f"coarsen_opdef: @{fn.name} contains {op.name}, whose "
                    "coarsening is not purely geometric — provide explicit "
                    "coarse operators instead (solvers.multigrid.build_levels)"
                )
        if mode == "vertex":
            box = _box(fn)

            def shrink(b, box=box):
                return _vertex(b, box, factor)
        elif mode == "cell":

            def shrink(b):
                return _halve(b, factor)
        else:
            raise ValueError(f"coarsen_opdef mode must be 'cell' or 'vertex' (got {mode!r})")
        fn.ftype = FunctionType(
            tuple(_swap_type(t, shrink) for t in fn.ftype.inputs),
            tuple(_swap_type(t, shrink) for t in fn.ftype.results),
        )
        # stale annotations: verify_and_annotate derives them again below
        for k in ("structure_key", "structure_key_hash", "halo"):
            fn.attrs.pop(k, None)
        # pass 1: the new sub-bounds, from the outer types before the swap
        new_attr_bounds = {}
        for op in fn.walk():
            attr_b = op.attrs.get("bounds")
            if attr_b is not None:
                if op.name == "neptune.store":
                    old_outer = op.operands[1].type.bounds
                else:
                    old_outer = op.results[0].type.bounds
                new_attr_bounds[id(op)] = _margin_preserve(
                    attr_b, old_outer, shrink(old_outer)
                )
        # pass 2: swap every value type, then install the new bounds
        for a in fn.body.args:
            a.type = _swap_type(a.type, shrink)
        for op in fn.walk():
            if id(op) in new_attr_bounds:
                op.attrs["bounds"] = new_attr_bounds[id(op)]
            for r in op.results:
                r.type = _swap_type(r.type, shrink)
            for region in op.regions:
                for a in region.args:
                    a.type = _swap_type(a.type, shrink)

    return verify_and_annotate(sub)
