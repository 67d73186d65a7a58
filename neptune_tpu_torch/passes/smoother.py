"""The multicolour Gauss-Seidel pass of a stencil opdef: the apply behind
`mg_smoother="symgs"` (`solvers.multigrid`).

Colour a cell by the parity of its unknown's index along each dim (the
index counted from the apply's lower bound): 2^rank colours, (i mod 2,
j mod 2, k mod 2) read as a binary number with dim 0 highest. Under a
stencil whose reach is 1 in every dim (the 27-point operator, and every
star or box stencil inside it) no two cells of one colour are coupled, so
updating one colour at a time in order is Gauss-Seidel in that order.

`colour_pass(module, sym)` builds, from @sym's single apply, the opdef

    @{sym}__colour(x, b, d, c) = where(colour(index) == c, x + d * (b - A x), x)

over @sym's bounds (`d` the inverse diagonal on the grid, `c` the colour
as a float64 scalar), cells outside the bounds copied through from x. On
the card each colour pass is then one kernel-A launch, whose body is
@sym's own body followed by the update.

The apply carries the mark `colour = "parity"` (`MARK`, `PARITY`): its
cells are coloured by the rule above, its first input is x, its other
inputs are read at the cell alone and its last scalar is the colour. Kernel
A reads the mark to offer the apply's colour form (`cuda_backend.
apply_colour`), which updates x's cells of one colour in place; calling the
opdef stays the out-of-place pass.
"""

from __future__ import annotations

from ..ir.core import Module
from ..ir.ops import NeptuneBuilder
from ..ir.types import F64, INDEX
from ..ir.verify import verify_and_annotate

SUFFIX = "__colour"
MARK, PARITY = "colour", "parity"


def the_apply(fn):
    """The one `neptune.apply` of a single-apply opdef whose input is the
    opdef's argument, or ValueError."""
    applies = [op for op in fn.body.ops if op.name == "neptune.apply"]
    if (
        len(applies) != 1 or len(fn.body.args) != 1 or len(applies[0].results) != 1
        or applies[0].operands[:1] != fn.body.args[:1]
        or applies[0].attrs.get("num_inputs", len(applies[0].operands)) != 1
    ):
        raise ValueError(
            f"the multicolour smoother needs an opdef of one argument and one apply of it "
            f"(@{fn.name} is not)"
        )
    return applies[0]


def colour_pass(module: Module, sym: str) -> Module:
    """A fresh module holding @{sym}__colour (see the module docstring),
    verified."""
    fn = module.lookup(sym)
    ap = the_apply(fn)
    # parity colours decouple only reads within one cell along every dim
    if any(abs(o) > 1 for a in ap.walk() if a.name == "neptune.access"
           for o in a.attrs["offset"]):
        raise ValueError(
            f"@{sym} reads beyond its neighbours: parity colours do not decouple it"
        )
    tt = ap.results[0].type
    rank = tt.bounds.rank
    bounds = ap.attrs["bounds"]
    out = Module(f"{module.name}{SUFFIX}")
    b = NeptuneBuilder(out)
    new = b.make_opdef(sym + SUFFIX, "nonlinear_opdef", [tt, tt, tt, F64], [tt])
    x, rhs, dinv, c = new.body.args
    b.push_block(new.body)
    nap, body = b.start_apply([x, rhs, dinv], bounds, scalar_params=[c],
                              periodic=bool(ap.attrs.get("periodic")))
    nap.attrs[MARK] = PARITY
    old = ap.region(0)
    # the operator's body, read from x: index args and its input map over
    mapping = {a.uid: v for a, v in zip(old.args[:rank + 1], body.args[:rank + 1])}
    b.push_block(body)
    ax = None
    for op in old.ops:
        if op.name == "neptune.yield":
            ax = mapping[op.operands[0].uid]
            continue
        nop = b.create(op.name, [mapping[o.uid] for o in op.operands], dict(op.attrs),
                       [r.type for r in op.results])
        for r, nr in zip(op.results, nop.results):
            mapping[r.uid] = nr
    idx, xa, ba, da, ca = body.args[:rank], *body.args[rank:rank + 3], body.args[rank + 3]
    xv = b.access(xa, (0,) * rank)
    upd = b.add(xv, b.mul(b.access(da, (0,) * rank), b.sub(b.access(ba, (0,) * rank), ax)))
    two = b.constant(2, INDEX)
    colour = None
    for d in range(rank):
        t = b.sub(idx[d], b.constant(bounds.lb[d], INDEX))
        bit = b.sub(t, b.mul(b.div(t, two), two))
        colour = bit if colour is None else b.add(b.mul(colour, two), bit)
    b.yield_(b.select(b.cmp("eq", b.cast(colour, F64), ca), upd, xv))
    b.pop_block()
    b.finish_apply(nap)
    b.return_([nap.results[0]])
    b.pop_block()
    return verify_and_annotate(out)

