"""Generate the CUDA sources of the Hopper kernels from the IR.

Only the per-operator scalar body is generated: `COps` is an op table for
`torch_backend.eval_scalar_dag` whose values are C expressions, so the body
is folded, rounded and ordered exactly as the eager PyTorch path evaluates
it. Constants are emitted as hex-float literals of the value the eager path
rounds them to. A body reads its inputs through an accessor argument
(`a.ld(k, o0, o1, o2)`, and `a.c0 .. a.c2` for index() values), so one body
serves global memory (kernel A) and shared-memory tiles (kernels B, C
and D). Everything else -- indexing, neighbour reads, copy-through, tiles,
reductions, grid syncs, the CG loop -- is fixed code in `csrc/*.cuh`.
"""

from __future__ import annotations

import math

from ..ir.core import Operation
from ..ir.types import TempType
from ..lowering.torch_backend import eval_scalar_dag, round_to

_CTYPE = {
    "float32": "float",
    "bfloat16": "float",  # bf16 values are carried in f32 registers
    "float64": "double",
    "index": "int",
    "int32": "int",
    "bool": "bool",
}
_F32ISH = ("float32", "bfloat16")

_INFIX = {
    "arith.add": "+", "arith.sub": "-", "arith.mul": "*", "arith.div": "/",
    "arith.and": "&&", "arith.or": "||",
}
_CMP = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">", "ge": ">="}
_MATH = {
    "math.exp": "exp", "math.log": "log", "math.sqrt": "sqrt", "math.sin": "sin",
    "math.cos": "cos", "math.tan": "tan", "math.tanh": "tanh", "math.abs": "fabs",
    "math.erf": "erf",
}


def c_literal(value, tname: str) -> str:
    """`value` rounded into scalar type `tname`, as an exact C literal."""
    v = round_to(value, tname)
    if tname == "bool":
        return "true" if v else "false"
    if tname in ("index", "int32"):
        return f"({v})"
    if math.isnan(v):
        return "__int_as_float(0x7fc00000)" if tname in _F32ISH else "__longlong_as_double(0x7ff8000000000000ll)"
    if math.isinf(v):
        if tname in _F32ISH:
            return "__int_as_float(0x7f800000)" if v > 0 else "__int_as_float(0xff800000)"
        return "__longlong_as_double(0x7ff0000000000000ll)" if v > 0 else "__longlong_as_double(0xfff0000000000000ll)"
    suffix = "f" if tname in _F32ISH else ""
    return f"({float(v).hex()}{suffix})"


class COps:
    """Op table for `eval_scalar_dag` that emits one C statement per
    operation. Every bf16 result is rounded to bf16 (`nt_bf`), as each eager
    bf16 operation rounds its f32 result."""

    def __init__(self):
        self.lines: list[str] = []
        self._n = 0

    def emit(self, expr: str, tname: str) -> str:
        if tname == "bfloat16":
            expr = f"nt_bf({expr})"
        name = f"v{self._n}"
        self._n += 1
        self.lines.append(f"const {_CTYPE[tname]} {name} = {expr};")
        return name

    def constant(self, value, tname):
        return c_literal(value, tname)

    def binop(self, name, a, b, tname):
        if name in ("arith.min", "arith.max"):
            return self.emit(f"nt_{name[6:]}({a}, {b})", tname)
        if name == "arith.pow":
            fn = "powf" if tname in _F32ISH else "pow"
            return self.emit(f"{fn}({a}, {b})", tname)
        return self.emit(f"({a} {_INFIX[name]} {b})", tname)

    def unary(self, name, a, tname):
        if name == "arith.neg":
            return self.emit(f"(-{a})", tname)
        if name == "arith.not":
            return self.emit(f"(!{a})", tname)
        if name == "math.abs" and tname in ("index", "int32"):
            return self.emit(f"abs({a})", tname)
        fn = _MATH[name] + ("f" if tname in _F32ISH else "")
        return self.emit(f"{fn}({a})", tname)

    def cmp(self, pred, a, b, tname):
        return self.emit(f"({a} {_CMP[pred]} {b})", "bool")

    def select(self, c, a, b, tname):
        return self.emit(f"({c} ? {a} : {b})", tname)

    def cast(self, v, tname):
        return self.emit(f"static_cast<{_CTYPE[tname]}>({v})", tname)

    def fence(self, v, tname):
        """Pinned mode's product fence, as `TorchOps.fence`."""
        return self.emit(f"(isfinite({v}) ? {v} : {c_literal(math.nan, tname)})", tname)

    def add(self, a, b, tname):
        return self.binop("arith.add", a, b, tname)

    def neg(self, a, tname):
        return self.unary("arith.neg", a, tname)

    def scale(self, a, c, tname):
        return self.binop("arith.mul", a, c_literal(c, tname), tname)

    def add_const(self, a, c, tname):
        return self.binop("arith.add", a, c_literal(c, tname), tname)


def body_struct(op: Operation, name: str, scalar_exprs=None, pinned=None) -> str:
    """A C++ struct holding one apply's generated body (see csrc/nt_apply.cuh).

    `eval(a, s, y)` reads input k at an offset through the accessor `a`
    (rank-3 padded: a rank-2 grid is (1, n0, n1)) and the scalars through
    `s`. scalar_exprs: C expressions for the apply's scalar operands; by
    default they are fields of the struct's `Scalars`, passed by value at
    launch. An input whose logical lower bound differs from the output's
    reads at a shifted position. pinned: as `eval_scalar_dag`'s (None
    follows `config.pinned_arithmetic`).
    """
    out_type: TempType = op.results[0].type
    rank = out_type.bounds.rank
    n_in = op.attrs.get("num_inputs", len(op.operands))
    body = op.region(0)
    lb = out_type.bounds.lb
    input_lbs = [v.type.bounds.lb for v in op.operands[:n_in]]
    scalar_types = [a.type.name for a in body.args[rank + n_in:]]
    if scalar_exprs is None:
        scalar_exprs = [f"s.s{k}" for k in range(len(scalar_types))]
    pad = 3 - rank

    ops = COps()

    def access_fn(k, offset):
        adj = [o + (lo - li) for o, lo, li in zip(offset, lb, input_lbs[k])]
        return ops.emit(f"a.ld({k}, {', '.join(str(o) for o in [0] * pad + adj)})", "float32")

    def index_fn(d):
        return ops.emit(f"a.c{d + pad}", "index")

    yields = eval_scalar_dag(body, rank, n_in, access_fn, index_fn, scalar_exprs, ops, pinned)

    stmts = "\n".join(f"    {line}" for line in ops.lines)
    outs = "\n".join(
        f"    y[{j}] = static_cast<float>({y});" for j, y in enumerate(yields)
    )
    return f"""struct {name} {{
  using T = {"__nv_bfloat16" if out_type.element == "bfloat16" else "float"};
  static constexpr int kIn = {n_in};
  static constexpr int kOut = {len(op.results)};
  static constexpr bool kPeriodic = {'true' if op.attrs.get('periodic') else 'false'};
{scalars_struct(scalar_types)}
  template <class A, class S>
  static __device__ __forceinline__ void eval(const A& a, const S& s, float* y) {{
    (void)a; (void)s;
{stmts}
{outs}
  }}
}};
"""


def body_ops(op: Operation) -> int:
    """Arithmetic operations per cell of one apply's generated body, as
    folded and emitted (neighbour loads and index reads not counted): the
    operation count of a kernel's bound."""
    out_type: TempType = op.results[0].type
    rank = out_type.bounds.rank
    n_in = op.attrs.get("num_inputs", len(op.operands))
    n_sc = len(op.region(0).args) - rank - n_in
    ops = COps()
    eval_scalar_dag(
        op.region(0), rank, n_in,
        lambda k, o: ops.emit("a.ld()", "float32"), lambda d: ops.emit("a.c()", "index"),
        [f"s.s{k}" for k in range(n_sc)], ops,
    )
    return sum(1 for line in ops.lines if "a.ld(" not in line and "a.c(" not in line)


def scalars_struct(types) -> str:
    """`struct Scalars` with one field per scalar type name, and `load`
    from the launch's f64 values (a bool travels as an int)."""
    ctype = [_CTYPE[t] if t != "bool" else "int" for t in types]
    fields = "".join(f" {c} s{k};" for k, c in enumerate(ctype))
    loads = "".join(f" s.s{k} = static_cast<{c}>(v[{k}]);" for k, c in enumerate(ctype))
    return (
        f"  struct Scalars {{{fields} }};\n"
        f"  static Scalars load(const double* v) {{ Scalars s;{loads} (void)v; return s; }}"
    )


def body_reach(op: Operation) -> tuple[int, int, int]:
    """The largest |offset| per dim of the reads of one apply's generated
    body, rank-3 padded: the halo its tile needs."""
    out_type: TempType = op.results[0].type
    rank = out_type.bounds.rank
    n_in = op.attrs.get("num_inputs", len(op.operands))
    lb = out_type.bounds.lb
    input_lbs = [v.type.bounds.lb for v in op.operands[:n_in]]
    n_sc = len(op.region(0).args) - rank - n_in
    reach = [0] * rank
    ops = COps()

    def access_fn(k, offset):
        for d, (o, lo, li) in enumerate(zip(offset, lb, input_lbs[k])):
            reach[d] = max(reach[d], abs(o + lo - li))
        return ops.emit("a.ld()", "float32")

    eval_scalar_dag(
        op.region(0), rank, n_in, access_fn, lambda d: ops.emit("a.c()", "index"),
        [f"s.s{k}" for k in range(n_sc)], ops,
    )
    return tuple([0] * (3 - rank) + reach)


def apply_source(op: Operation, plan=None) -> str:
    """The complete source of kernel A for one apply: the tiled design under
    `plan` (a `cuda_backend.ApplyPlan`), or the first design when the plan
    is None."""
    head = '#include "nt_apply.cuh"\n\n' + body_struct(op, "NtBody")
    if plan is None:
        return head + "\nNT_DEFINE_APPLY(NtBody)\n"
    (t1, t2), (h0, h1, h2) = plan.tile, plan.halo
    return head + f"""
struct NtApplyPlan {{
  static constexpr int kT1 = {t1}, kT2 = {t2}, kR = {plan.strip}, kD = {plan.planes};
  static constexpr int kH0 = {h0}, kH1 = {h1}, kH2 = {h2};
}};

NT_DEFINE_APPLY_TILED(NtBody, NtApplyPlan)
"""


def grid_literal(shape, lb, blo, bhi) -> str:
    """An NtGrid initializer for a rank-2 grid, (1, n0, n1) in the kernels."""
    def three(v, fill):
        return "{" + ", ".join(str(x) for x in [fill] + list(v)) + "}"
    return (
        f"{{{three(shape, 1)}, {three(lb, 0)}, {three(blo, 0)}, {three(bhi, 1)}}}"
    )


def fused_cg_source(plan) -> str:
    """The complete source of kernel B for a `solvers.fused.CgPlan`: one
    generated body per stage, the tiling as constants, and the matvec that
    runs the stages over the tile's shrinking regions in shared memory, the
    last one over the tile itself into `put`. Along a dim that stores no
    halo every stage runs over the tile."""
    structs, calls = [], []
    last = len(plan.stages) - 1
    for i, st in enumerate(plan.stages):
        scalars = [c_literal(v, "float32") for v in st.scalars]
        # kernel B keeps default arithmetic in pinned mode, as the JAX
        # package's fused CG does
        structs.append(body_struct(st.op, f"NtStage{i}", scalar_exprs=scalars, pinned=False))
        sl = st.op.attrs["bounds"].rel_slices(st.op.results[0].type.bounds)
        box = (
            f"NtBox{{{{{_ints([0] + [s.start for s in sl])}}}, "
            f"{{{_ints([1] + [s.stop for s in sl])}}}}}"
        )
        ins = ", ".join("p" if r == "x" else f"buf[{plan.buffer[r]}]" for r in st.inputs)
        head = f"Tile, NtStage{i}, kWrap, {len(st.inputs)}"
        if i == last:
            call = f"nt_cg_apply<{head}, Tile::H1, Tile::H2>(g, org, tab, {box}, in, put);"
        else:
            c = [cr if h else 0 for cr, h in zip(plan.creep[i], plan.halo)]
            call = (
                f"nt_cg_stage<{head}, {c[0]}, {c[1]}>(g, org, tab, {box}, in, "
                f"buf[{plan.buffer[i]}]);"
            )
        calls.append(
            f"    {{\n      const float* const in[] = {{{ins or 'nullptr'}}};\n      {call}\n    }}"
        )
    stages = "\n".join(calls)
    (t0, t1), (h0, h1), (e0, e1) = plan.tile, plan.halo, plan.edge
    grid = grid_literal(plan.shape, plan.lb, (0, 0), (1, 1))
    return (
        '#include "nt_fused_cg.cuh"\n\n'
        + "\n".join(structs)
        + f"""
struct NtCgPlan {{
  using Tile = NtTile<1, {t0}, {t1}, 0, {h0}, {h1}>;
  static constexpr bool kWrap = {'true' if plan.periodic else 'false'};
  static constexpr int kN1 = {plan.shape[0]}, kN2 = {plan.shape[1]};
  static constexpr int kTiles2 = {plan.tiles[1]}, kBlocks = {plan.blocks};
  static constexpr int kEdge1 = {e0}, kEdge2 = {e1};
  static constexpr int kBuffers = {plan.n_buffers};
  static constexpr int kSmem = {plan.smem_bytes};
  static __device__ __forceinline__ NtGrid grid() {{ return NtGrid{grid}; }}
  template <class Put>
  static __device__ __forceinline__ void matvec(const NtGrid& g, const int (&org)[3],
                                                const int* tab, const float* p,
                                                float* const* buf, Put&& put) {{
    (void)buf;
{stages}
  }}
}};

NT_DEFINE_FUSED_CG(NtCgPlan)
"""
    )


def _ints(v) -> str:
    return ", ".join(str(x) for x in v)


def sweeps_source(plan) -> str:
    """The complete source of kernel C for a `lowering.sweeps.SweepPlan`:
    `plan.depth` sweeps of one apply per launch, the tile and the strips as
    constants (rank-3 padded)."""
    pad = 3 - len(plan.tile)
    t0, t1, t2 = (1,) * pad + tuple(plan.tile)
    h0, h1, h2 = (0,) * pad + tuple(plan.halo)
    return (
        '#include "nt_sweeps.cuh"\n\n'
        + body_struct(plan.op, "NtBody")
        + f"""
struct NtSweepPlan {{
  using Body = NtBody;
  static constexpr int kDepth = {plan.depth};
  static constexpr int kH0 = {h0}, kH1 = {h1}, kH2 = {h2};
  static constexpr int kT0 = {t0}, kT1 = {t1}, kT2 = {t2}, kP2 = {plan.pad};
  static constexpr int kC = {plan.cols}, kR = {plan.strip}, kL = {plan.run};
  static constexpr int kWarps = {plan.warps};
  static constexpr int kRows = {plan.rows};
}};

NT_DEFINE_SWEEPS(NtSweepPlan)
"""
    )


def chain_source(plan) -> str:
    """The complete source of kernel D for a `lowering.chain.ChainPlan`:
    one generated body per stage, each stage's box, and the chain that
    runs them in DAG order over their regions with their strips."""
    pad = 3 - plan.rank
    structs, boxes, sides, calls = [], [], [], []
    last = len(plan.stages) - 1
    for i, st in enumerate(plan.stages):
        exprs = [
            f"s.s{b[1]}" if b[0] == "arg" else c_literal(b[1], b[2].name) for b in st.scalars
        ]
        structs.append(body_struct(st.op, f"NtStage{i}", scalar_exprs=exprs))
        # a block's plan: the stage's bounds in logical coordinates, mapped
        # onto the block at run time, so one build serves every block; the
        # whole grid's: a constant box of the grid's cells
        bnd = st.op.attrs["bounds"]
        if plan.origin:
            box = (
                f"nt_box_at(g, NtBox{{{{{_ints([0] * pad + list(bnd.lb))}}}, "
                f"{{{_ints([1] * pad + list(bnd.ub))}}}}})"
            )
        else:
            sl = bnd.rel_slices(plan.outer)
            box = (
                f"NtBox{{{{{_ints([0] * pad + [x.start for x in sl])}}}, "
                f"{{{_ints([1] * pad + [x.stop for x in sl])}}}}}"
            )
        boxes.append(
            f"  static __device__ __forceinline__ NtBox box{i}(const NtGrid& g) {{\n"
            f"    (void)g;\n    return {box};\n  }}"
        )
        sides.append(
            f"nt_chain_side<Tile, {_ints(plan.regions[i])}>(org, box{i}(g), copy, {1 << i}u)"
        )
        ins = ", ".join(f"buf[{plan.buffer[s]}]" for s in st.in_slots)
        head = f"NtChain, NtStage{i}, CHECKED, {len(st.in_slots)}"
        cp = f"(copy & {1 << i}u) != 0u"
        if i == last:
            call = (
                f"nt_chain_last<{head}, {plan.strips[i]}>(g, org, tab, box{i}(g), {cp}, in, "
                f"out, s);"
            )
        else:
            call = (
                f"nt_chain_stage<{head}, {_ints(plan.regions[i])}, {plan.strips[i]}>(g, org, tab, "
                f"box{i}(g), {cp}, in, buf[{plan.buffer[st.out_slot]}], s);"
            )
        calls.append(f"    {{\n      const float* const in[] = {{{ins}}};\n      {call}\n    }}")
    side_expr = " &&\n           ".join(sides)
    return (
        '#include "nt_chain.cuh"\n\n'
        + "\n".join(structs)
        + f"""
struct NtChain {{
  using Tile = NtTile<{_ints(plan.tile3)}, {_ints(plan.halo)}>;
  static constexpr bool kWrap = {'true' if plan.periodic else 'false'};
  static constexpr int kFields = {plan.n_fields};
  static constexpr int kBuffers = {plan.n_buffers};
  static constexpr int kStages = {len(plan.stages)};
  static constexpr int kThreads = {plan.threads}, kMinBlocks = {plan.min_blocks};
  static constexpr int kAhead = {plan.ahead};
{scalars_struct(plan.scalar_types)}
{chr(10).join(boxes)}
  static __device__ __forceinline__ bool sides(const NtGrid& g, const int (&org)[3],
                                               unsigned& copy) {{
    return {side_expr};
  }}
  template <bool CHECKED>
  static __device__ __forceinline__ void run(const NtGrid& g, const int (&org)[3],
                                             const int* tab, float* const* buf, float* out,
                                             const Scalars& s, unsigned copy) {{
    (void)tab; (void)copy;
{chr(10).join(calls)}
  }}
}};

NT_DEFINE_CHAIN(NtChain)
"""
    )
