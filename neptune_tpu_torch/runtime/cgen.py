"""C++ code generation — the native AOT kernel path.

The port of `neptune_tpu/runtime/cgen.py`, kept line for line against this
package's copy of the IR: for the same IR text, `generate_cpp` gives the
same C++ source as the JAX package's, character for character (its
prelude's first comment names the module it came from).

Emits a self-contained C++ translation unit from a lowered module: stencil
applies become rank-deep for-loop nests (the exact loop structure the
reference's `ApplyToSCFForLowering` emits as scf.for,
`lib/Passes/DataflowLowering.cpp:258-448`, including storage normalization
`iv + offset − lb` and copy-through seeding `:281-287`), and solver ops call
into libneptune_rt (the PETSc-runtime replacement in
`runtime/native/neptune_rt.cpp`) through direct function-pointer thunks — the
static-linking equivalent of the reference's dlsym callback protocol
(`NeptunePETScRuntime.cpp:182-230`).

The native path is float64-only (as is the reference's entire runtime) and
serves as the host oracle; `runtime.aot` compiles and loads it.
"""

from __future__ import annotations

import math
from io import StringIO
from typing import Optional

from ..ir.core import Function, Module, Operation, Value
from ..ir.types import (
    Bounds,
    FieldType,
    ScalarType,
    TempType,
    TensorType,
)

_BIN_CPP = {
    "arith.add": "({a} + {b})",
    "arith.sub": "({a} - {b})",
    "arith.mul": "({a} * {b})",
    "arith.div": "({a} / {b})",
    "arith.pow": "std::pow({a}, {b})",
    "arith.min": "std::min({a}, {b})",
    "arith.max": "std::max({a}, {b})",
    "arith.and": "({a} && {b})",
    "arith.or": "({a} || {b})",
}

_UN_CPP = {
    "arith.neg": "(-{a})",
    "arith.not": "(!{a})",
    "math.exp": "std::exp({a})",
    "math.log": "std::log({a})",
    "math.sqrt": "std::sqrt({a})",
    "math.sin": "std::sin({a})",
    "math.cos": "std::cos({a})",
    "math.tan": "std::tan({a})",
    "math.tanh": "std::tanh({a})",
    "math.abs": "std::fabs({a})",
    "math.erf": "std::erf({a})",
}

_CMP_CPP = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">", "ge": ">="}

_PRELUDE = r"""// generated by neptune_tpu.runtime.cgen — do not edit
#include <cmath>
#include <cstring>
#include <algorithm>
#include <vector>

extern "C" {
typedef struct { long iters; double resnorm; int converged; } neptune_solve_stats;
typedef void (*neptune_matvec_fn)(const double*, double*, void*);
typedef void (*neptune_residual_fn)(const double*, double*, void*);
void neptune_rt_cg(neptune_matvec_fn, void*, const double*, double*, long,
                   double, long, const double*, neptune_solve_stats*);
void neptune_rt_bicgstab(neptune_matvec_fn, void*, const double*, double*,
                         long, double, long, neptune_solve_stats*);
void neptune_rt_gmres(neptune_matvec_fn, void*, const double*, double*, long,
                      double, long, long, neptune_solve_stats*);
void neptune_rt_newton(neptune_residual_fn, void*, double*, long, double,
                       long, double, long, neptune_solve_stats*);
}

static inline long nt_clamp(long v, long lo, long hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
"""


class CodegenError(RuntimeError):
    pass


def _scalar_cpp_type(t: ScalarType) -> str:
    return {
        "float64": "double",
        "index": "long",
        "int32": "int",
        "bool": "bool",
    }.get(t.name) or _unsupported(t)


def _unsupported(t):
    raise CodegenError(
        f"native backend supports float64 modules only (got {t}); "
        "use the torch or cuda backends for other dtypes"
    )


class _FnEmitter:
    """Emits one IR function as a static C++ function over double* buffers."""

    def __init__(self, gen: "ModuleCodegen", fn: Function):
        self.g = gen
        self.fn = fn
        self.out = StringIO()
        self.names: dict[int, str] = {}  # value uid -> C identifier
        self.counter = 0
        self.indent = 1
        self.cells: dict[int, str] = {}  # field value uid -> buffer ident

    def w(self, s: str):
        self.out.write("  " * self.indent + s + "\n")

    def name(self, v: Value) -> str:
        if v.uid not in self.names:
            self.names[v.uid] = f"v{self.counter}"
            self.counter += 1
        return self.names[v.uid]

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def linear_index(bounds: Bounds, idx_exprs: list[str]) -> str:
        """Row-major physical offset for logical indices (storage
        normalization: physical = logical − lb)."""
        shape = bounds.shape
        terms = []
        stride = 1
        for d in reversed(range(bounds.rank)):
            e = f"({idx_exprs[d]} - {bounds.lb[d]}L)"
            terms.append(e if stride == 1 else f"{e} * {stride}L")
            stride *= shape[d]
        return " + ".join(reversed(terms)) if terms else "0"

    @staticmethod
    def size_of(t) -> int:
        if isinstance(t, TempType) or isinstance(t, FieldType):
            return t.bounds.size
        if isinstance(t, TensorType):
            return math.prod(t.shape)
        raise CodegenError(f"no buffer size for type {t}")

    def declare_buffer(self, v: Value) -> str:
        n = self.name(v)
        size = self.size_of(v.type)
        self.w(f"std::vector<double> {n}_store({size});")
        self.w(f"double* {n} = {n}_store.data();")
        return n

    # -- function signature ----------------------------------------------

    def signature(self) -> str:
        parts = []
        for i, a in enumerate(self.fn.body.args):
            t = a.type
            if isinstance(t, (TempType, FieldType, TensorType)):
                if getattr(t, "element", "float64") != "float64":
                    _unsupported(t)
                # all buffer args are mutable: tensor args may be wrapped into
                # fields and stored to (the Python wrapper passes copies, so
                # caller arrays are never mutated)
                parts.append(f"double* {self.name(a)}")
            elif isinstance(t, ScalarType):
                parts.append(f"{_scalar_cpp_type(t)} {self.name(a)}")
            else:
                raise CodegenError(f"unsupported arg type {t}")
        term = self.fn.body.terminator
        n_out = len(term.operands) if term and term.name == "neptune.return" else 0
        for j in range(n_out):
            parts.append(f"double* ret{j}")
        return f"static void fn_{self.fn.name}({', '.join(parts)})"

    # -- op emission ------------------------------------------------------

    def emit(self):
        self.out.write(self.signature() + " {\n")
        for a in self.fn.body.args:
            if isinstance(a.type, FieldType):
                self.cells[a.uid] = self.name(a)
        for op in self.fn.body.ops:
            self.emit_op(op)
        self.out.write("}\n")
        return self.out.getvalue()

    def emit_op(self, op: Operation):
        nm = op.name
        if nm == "neptune.wrap":
            buf = self.name(op.operands[0])
            self.names[op.results[0].uid] = buf
            self.cells[op.results[0].uid] = buf
        elif nm in ("neptune.load", "neptune.unwrap"):
            src = self.cells.get(op.operands[0].uid, self.name(op.operands[0]))
            # load copies (temp is value-semantics; later stores to the field
            # must not alias the loaded temp)
            n = self.declare_buffer(op.results[0])
            self.w(
                f"std::memcpy({n}, {src}, sizeof(double) * "
                f"{self.size_of(op.results[0].type)});"
            )
        elif nm == "neptune.store":
            tgt = self.cells.get(op.operands[1].uid, self.name(op.operands[1]))
            src = self.name(op.operands[0])
            tt: TempType = op.operands[0].type
            ft = op.operands[1].type
            bounds: Optional[Bounds] = op.attrs.get("bounds")
            if bounds is None:
                self.w(f"std::memcpy({tgt}, {src}, sizeof(double) * {tt.bounds.size});")
            else:
                self._emit_subcopy(tgt, ft.bounds, src, tt.bounds, bounds)
        elif nm == "neptune.as_tensor" or nm == "neptune.from_tensor":
            self.names[op.results[0].uid] = self.name(op.operands[0])
        elif nm == "neptune.apply":
            self.emit_apply(op)
        elif nm == "neptune.reduce":
            self.emit_reduce(op)
        elif nm in ("neptune.apply_linear", "neptune.apply_nonlinear"):
            callee = self.g.module.lookup(op.attrs["symbol"])
            outs = [self.declare_buffer(r) for r in op.results]
            args = [self.name(o) for o in op.operands]
            self.w(f"fn_{callee.name}({', '.join(args + outs)});")
        elif nm == "neptune.assemble_matrix":
            # lazy handle: record the symbol on the result value
            self.g.matrix_symbols[op.results[0].uid] = op.attrs["symbol"]
        elif nm == "neptune.solve_linear":
            self.emit_solve_linear(op)
        elif nm == "neptune.solve_nonlinear":
            self.emit_solve_nonlinear(op)
        elif nm == "neptune.return":
            for j, o in enumerate(op.operands):
                t = o.type
                if isinstance(t, (TempType, FieldType, TensorType)):
                    size = (
                        math.prod(t.shape)
                        if isinstance(t, TensorType)
                        else t.bounds.size
                    )
                    src = self.cells.get(o.uid, self.name(o))
                    self.w(f"std::memcpy(ret{j}, {src}, sizeof(double) * {size});")
                else:
                    self.w(f"ret{j}[0] = (double){self.name(o)};")
        elif nm == "arith.constant":
            t = op.results[0].type
            self.w(
                f"{_scalar_cpp_type(t)} {self.name(op.results[0])} = "
                f"{self._const_literal(op.attrs['value'], t)};"
            )
        elif nm in _BIN_CPP:
            a, b = (self.name(o) for o in op.operands)
            t = op.results[0].type
            self.w(
                f"{_scalar_cpp_type(t)} {self.name(op.results[0])} = "
                + _BIN_CPP[nm].format(a=a, b=b) + ";"
            )
        elif nm in _UN_CPP:
            t = op.results[0].type
            self.w(
                f"{_scalar_cpp_type(t)} {self.name(op.results[0])} = "
                + _UN_CPP[nm].format(a=self.name(op.operands[0])) + ";"
            )
        elif nm == "arith.cmp":
            a, b = (self.name(o) for o in op.operands)
            self.w(
                f"bool {self.name(op.results[0])} = ({a} {_CMP_CPP[op.attrs['pred']]} {b});"
            )
        elif nm == "arith.select":
            c, a, b = (self.name(o) for o in op.operands)
            t = op.results[0].type
            self.w(
                f"{_scalar_cpp_type(t)} {self.name(op.results[0])} = {c} ? {a} : {b};"
            )
        elif nm == "arith.cast":
            t = op.results[0].type
            self.w(
                f"{_scalar_cpp_type(t)} {self.name(op.results[0])} = "
                f"({_scalar_cpp_type(t)}){self.name(op.operands[0])};"
            )
        else:
            raise CodegenError(f"native codegen: unhandled op {nm}")

    @staticmethod
    def _const_literal(v, t: ScalarType) -> str:
        if t.name == "bool":
            return "true" if v else "false"
        if t.name in ("index", "int32"):
            return f"{int(v)}L" if t.name == "index" else str(int(v))
        return repr(float(v))

    def _emit_subcopy(self, tgt, tgt_bounds, src, src_bounds, bounds: Bounds):
        idx = [f"i{d}" for d in range(bounds.rank)]
        for d in range(bounds.rank):
            self.w(
                f"for (long i{d} = {bounds.lb[d]}L; i{d} < {bounds.ub[d]}L; ++i{d})"
            )
            self.indent += 1
        t_ix = self.linear_index(tgt_bounds, idx)
        s_ix = self.linear_index(src_bounds, idx)
        self.w(f"{tgt}[{t_ix}] = {src}[{s_ix}];")
        self.indent -= bounds.rank

    # -- apply -----------------------------------------------------------

    def emit_apply(self, op: Operation):
        out_type: TempType = op.results[0].type
        outer = out_type.bounds
        bounds: Bounds = op.attrs["bounds"]
        n_in = op.attrs.get("num_inputs", len(op.operands))
        body = op.region(0)
        rank = outer.rank

        outs = [self.declare_buffer(r) for r in op.results]
        # copy-through seed (DataflowLowering.cpp:281-287): output j from
        # input j when present, zeros otherwise
        for j, o in enumerate(outs):
            if bounds == outer:
                continue
            if j < n_in:
                self.w(
                    f"std::memcpy({o}, {self.name(op.operands[j])}, "
                    f"sizeof(double) * {outer.size});"
                )
            else:
                self.w(f"std::memset({o}, 0, sizeof(double) * {outer.size});")

        self.w("{")
        self.indent += 1
        for d in range(rank):
            if d == 0 and bounds.ub[0] - bounds.lb[0] >= 64:
                # disjoint writes per iteration: safe to parallelize the
                # outermost loop across host cores
                self.w("#pragma omp parallel for schedule(static)")
            self.w(
                f"for (long i{d} = {bounds.lb[d]}L; i{d} < {bounds.ub[d]}L; ++i{d}) {{"
            )
            self.indent += 1

        # scalar body
        local: dict[int, str] = {}
        for d in range(rank):
            local[body.args[d].uid] = f"i{d}"
        input_arg_index: dict[int, int] = {}
        for k in range(len(op.operands)):
            a = body.args[rank + k]
            if k < n_in:
                input_arg_index[a.uid] = k
            else:
                local[a.uid] = self.name(op.operands[k])  # scalar param

        lcount = 0

        def fresh():
            nonlocal lcount
            lcount += 1
            return f"s{lcount}"

        yields: list[str] = []
        for inner in body.ops:
            inm = inner.name
            if inm == "neptune.access":
                k = input_arg_index[inner.operands[0].uid]
                tt: TempType = op.operands[k].type
                off = inner.attrs["offset"]
                periodic = bool(op.attrs.get("periodic"))
                idx_exprs = []
                for d in range(rank):
                    e = f"(i{d} + {off[d]}L)"
                    in_range = bounds.shifted_within(
                        tuple(off[dd] if dd == d else 0 for dd in range(rank)),
                        tt.bounds,
                    )
                    if periodic and not in_range:
                        # torus domain: wrap (specified semantics)
                        ext = tt.bounds.ub[d] - tt.bounds.lb[d]
                        e = (
                            f"((({e} - {tt.bounds.lb[d]}L) % {ext}L + {ext}L) "
                            f"% {ext}L + {tt.bounds.lb[d]}L)"
                        )
                    elif not in_range:
                        # unspecified zone: clamp to stay in memory
                        e = f"nt_clamp({e}, {tt.bounds.lb[d]}L, {tt.bounds.ub[d] - 1}L)"
                    idx_exprs.append(e)
                nm2 = fresh()
                self.w(
                    f"double {nm2} = {self.name(op.operands[k])}"
                    f"[{self.linear_index(tt.bounds, idx_exprs)}];"
                )
                local[inner.results[0].uid] = nm2
            elif inm == "arith.constant":
                t = inner.results[0].type
                nm2 = fresh()
                self.w(
                    f"{_scalar_cpp_type(t)} {nm2} = "
                    f"{self._const_literal(inner.attrs['value'], t)};"
                )
                local[inner.results[0].uid] = nm2
            elif inm in _BIN_CPP:
                a, b = (local[o.uid] for o in inner.operands)
                t = inner.results[0].type
                nm2 = fresh()
                self.w(
                    f"{_scalar_cpp_type(t)} {nm2} = "
                    + _BIN_CPP[inm].format(a=a, b=b) + ";"
                )
                local[inner.results[0].uid] = nm2
            elif inm in _UN_CPP:
                t = inner.results[0].type
                nm2 = fresh()
                self.w(
                    f"{_scalar_cpp_type(t)} {nm2} = "
                    + _UN_CPP[inm].format(a=local[inner.operands[0].uid]) + ";"
                )
                local[inner.results[0].uid] = nm2
            elif inm == "arith.cmp":
                a, b = (local[o.uid] for o in inner.operands)
                nm2 = fresh()
                self.w(f"bool {nm2} = ({a} {_CMP_CPP[inner.attrs['pred']]} {b});")
                local[inner.results[0].uid] = nm2
            elif inm == "arith.select":
                c, a, b = (local[o.uid] for o in inner.operands)
                t = inner.results[0].type
                nm2 = fresh()
                self.w(f"{_scalar_cpp_type(t)} {nm2} = {c} ? {a} : {b};")
                local[inner.results[0].uid] = nm2
            elif inm == "arith.cast":
                t = inner.results[0].type
                nm2 = fresh()
                self.w(
                    f"{_scalar_cpp_type(t)} {nm2} = "
                    f"({_scalar_cpp_type(t)}){local[inner.operands[0].uid]};"
                )
                local[inner.results[0].uid] = nm2
            elif inm == "neptune.yield":
                yields = [local[o.uid] for o in inner.operands]
            else:
                raise CodegenError(f"native codegen: scalar op {inm}")

        out_ix = self.linear_index(outer, [f"i{d}" for d in range(rank)])
        for j, y in enumerate(yields):
            self.w(f"{outs[j]}[{out_ix}] = (double){y};")
        for _ in range(rank):
            self.indent -= 1
            self.w("}")
        self.indent -= 1
        self.w("}")

    # -- reduce ----------------------------------------------------------

    def emit_reduce(self, op: Operation):
        tt: TempType = op.operands[0].type
        bounds: Bounds = op.attrs.get("bounds") or tt.bounds
        kind = op.attrs["kind"]
        src = self.name(op.operands[0])
        acc = self.name(op.results[0])
        init = {
            "sum": "0.0",
            "l1": "0.0",
            "l2": "0.0",
            "max": "-1.7976931348623157e308",
            "min": "1.7976931348623157e308",
        }[kind]
        self.w(f"double {acc} = {init};")
        for d in range(bounds.rank):
            self.w(
                f"for (long i{d} = {bounds.lb[d]}L; i{d} < {bounds.ub[d]}L; ++i{d}) {{"
            )
            self.indent += 1
        ix = self.linear_index(tt.bounds, [f"i{d}" for d in range(bounds.rank)])
        expr = {
            "sum": f"{acc} += {src}[{ix}];",
            "l1": f"{acc} += std::fabs({src}[{ix}]);",
            "l2": f"{acc} += {src}[{ix}] * {src}[{ix}];",
            "max": f"{acc} = std::max({acc}, {src}[{ix}]);",
            "min": f"{acc} = std::min({acc}, {src}[{ix}]);",
        }[kind]
        self.w(expr)
        for _ in range(bounds.rank):
            self.indent -= 1
            self.w("}")
        if kind == "l2":
            self.w(f"{acc} = std::sqrt({acc});")

    # -- solvers ----------------------------------------------------------

    def emit_solve_linear(self, op: Operation):
        sym = self.g.matrix_symbols.get(op.operands[0].uid)
        if sym is None:
            raise CodegenError(
                "native solve_linear requires the matrix operand to come from "
                "assemble_matrix in the same function"
            )
        thunk = self.g.matvec_thunk(sym)
        b = self.name(op.operands[1])
        x = self.declare_buffer(op.results[0])
        n = op.results[0].type.bounds.size
        tol = op.attrs["tol"]
        iters = op.attrs["max_iters"]
        solver = op.attrs["solver"]
        precond = op.attrs.get("precond", "none")
        if precond not in (None, "none") and not (
            precond == "jacobi" and solver == "cg"
        ):
            raise CodegenError(
                f"native runtime supports precond='jacobi' with solver='cg' "
                f"only (got precond={precond!r}, solver={solver!r})"
            )
        if solver in ("chebyshev", "direct"):
            raise CodegenError(
                f"native runtime does not implement solver={solver!r}; "
                "use cg/bicgstab/gmres for the native oracle"
            )
        opts = dict(op.attrs.get("options") or {})
        restart = int(opts.pop("restart", 30)) if solver == "gmres" else 30
        if opts:
            # silently dropping validated options would make the native
            # oracle solve a DIFFERENT problem than the torch executor
            raise CodegenError(
                f"native runtime does not implement solve options "
                f"{sorted(opts)} (solver={solver!r})"
            )
        self.w("{ neptune_solve_stats st;")
        self.indent += 1
        inv = "nullptr"
        if precond == "jacobi" and solver == "cg":
            inv = self._emit_jacobi_inv_diag(sym, n)
        if solver == "cg":
            self.w(
                f"neptune_rt_cg({thunk}, nullptr, {b}, {x}, {n}L, {tol!r}, "
                f"{iters}L, {inv}, &st);"
            )
        elif solver == "bicgstab":
            self.w(
                f"neptune_rt_bicgstab({thunk}, nullptr, {b}, {x}, {n}L, "
                f"{tol!r}, {iters}L, &st);"
            )
        else:  # gmres
            self.w(
                f"neptune_rt_gmres({thunk}, nullptr, {b}, {x}, {n}L, {tol!r}, "
                f"{iters}L, {restart}L, &st);"
            )
        self.indent -= 1
        self.w("}")

    def _emit_jacobi_inv_diag(self, sym: str, n: int) -> str:
        """Generate exact-diagonal extraction by stencil-period probing
        (mirrors solvers/precond.extract_diagonal) and return the C
        expression for the inverse-diagonal pointer."""
        fn = self.g.module.lookup(sym)
        halo = fn.attrs.get("halo") or ()
        tt: TempType = fn.ftype.inputs[0]
        bounds = tt.bounds
        if not halo:
            raise CodegenError(
                f"@{sym} has no halo annotation (module not verified); "
                "cannot build a native Jacobi preconditioner"
            )
        periods = [max(lo, hi) + 1 for lo, hi in halo]
        rank = bounds.rank
        self.w(f"std::vector<double> jp_probe({n}), jp_Ap({n}), jp_diag({n}, 0.0);")
        self.w(f"std::vector<double> jp_inv({n});")
        for d, p in enumerate(periods):
            self.w(f"for (long c{d} = 0; c{d} < {p}L; ++c{d}) {{")
            self.indent += 1
        # fill the probe
        for d in range(rank):
            self.w(
                f"for (long i{d} = {bounds.lb[d]}L; i{d} < {bounds.ub[d]}L; ++i{d})"
            )
            self.indent += 1
        ix = self.linear_index(bounds, [f"i{d}" for d in range(rank)])
        cond = " && ".join(
            f"((i{d} - {bounds.lb[d]}L) % {periods[d]}L == c{d})"
            for d in range(rank)
        )
        self.w(f"jp_probe[{ix}] = ({cond}) ? 1.0 : 0.0;")
        self.indent -= rank
        self.w(f"fn_{sym}(jp_probe.data(), jp_Ap.data());")
        self.w(
            f"for (long i = 0; i < {n}L; ++i) jp_diag[i] += jp_probe[i] * jp_Ap[i];"
        )
        for _ in periods:
            self.indent -= 1
            self.w("}")
        self.w(
            f"for (long i = 0; i < {n}L; ++i) "
            "jp_inv[i] = jp_diag[i] == 0.0 ? 1.0 : 1.0 / jp_diag[i];"
        )
        return "jp_inv.data()"

    def emit_solve_nonlinear(self, op: Operation):
        n_state = op.attrs["num_states"]
        if n_state != 1:
            raise CodegenError(
                "native solve_nonlinear supports a single state field "
                "(multi-field states run on the torch executor)"
            )
        sym = op.attrs["residual"]
        captures = op.operands[1:]
        thunk, ctx_decl = self.g.residual_thunk(sym, len(captures))
        x = self.declare_buffer(op.results[0])
        state = self.name(op.operands[0])
        n = op.results[0].type.bounds.size
        self.w(f"std::memcpy({x}, {state}, sizeof(double) * {n});")
        cap_inits = ", ".join(f"(double*){self.name(c)}" for c in captures)
        self.w(f"{{ {ctx_decl} ctx = {{{{ {cap_inits} }}}};" if captures else f"{{ {ctx_decl} ctx = {{}};")
        self.w("  neptune_solve_stats st;")
        self.w(
            f"  neptune_rt_newton({thunk}, &ctx, {x}, {n}L, "
            f"{op.attrs['tol']!r}, {op.attrs['max_iters']}L, "
            f"{op.attrs.get('krylov_tol', 1e-6)!r}, "
            f"{op.attrs.get('krylov_iters', 200)}L, &st); }}"
        )


class ModuleCodegen:
    """Generates the full C++ translation unit for a lowered module."""

    def __init__(self, module: Module):
        self.module = module
        self.matrix_symbols: dict[int, str] = {}
        self._thunks: dict[str, str] = {}
        self._thunk_src = StringIO()
        self._thunk_count = 0

    def matvec_thunk(self, sym: str) -> str:
        key = f"mv_{sym}"
        if key not in self._thunks:
            fn = self.module.lookup(sym)
            if len(fn.ftype.inputs) != 1 or len(fn.ftype.results) != 1:
                raise CodegenError("native matvec thunk requires a unary opdef")
            self._thunk_src.write(
                f"static void {key}(const double* x, double* y, void*) "
                f"{{ fn_{sym}((double*)x, y); }}\n"
            )
            self._thunks[key] = key
        return key

    def residual_thunk(self, sym: str, n_caps: int) -> tuple[str, str]:
        key = f"res_{sym}_{n_caps}"
        ctx_t = f"res_ctx_{self._thunk_count}"
        if key not in self._thunks:
            self._thunk_count += 1
            caps = max(n_caps, 1)
            self._thunk_src.write(
                f"struct {ctx_t} {{ double* caps[{caps}]; }};\n"
            )
            cap_args = "".join(
                f", ((({ctx_t}*)ctx)->caps[{i}])" for i in range(n_caps)
            )
            self._thunk_src.write(
                f"static void {key}(const double* u, double* r, void* ctx) "
                f"{{ (void)ctx; fn_{sym}((double*)u{cap_args}, r); }}\n"
            )
            self._thunks[key] = (key, ctx_t)
        return self._thunks[key]

    def generate(self) -> str:
        # order: opdefs first (callees), then funcs — emit bodies, gathering
        # thunks, then splice thunks between prototypes and bodies
        bodies = []
        protos = []
        for fn in list(self.module.opdefs()) + list(self.module.funcs()):
            em = _FnEmitter(self, fn)
            body = em.emit()
            protos.append(body.split(" {\n", 1)[0] + ";")
            bodies.append(body)

        exports = []
        for fn in self.module.funcs():
            exports.append(self._export_wrapper(fn))

        return (
            _PRELUDE
            + "\n"
            + "\n".join(protos)
            + "\n\n"
            + self._thunk_src.getvalue()
            + "\n"
            + "\n".join(bodies)
            + "\n"
            + "\n".join(exports)
        )

    def _export_wrapper(self, fn: Function) -> str:
        """extern "C" entry: nt_<name>(const double** ins, double** outs)."""
        args = []
        for i, a in enumerate(fn.body.args):
            t = a.type
            if isinstance(t, (TempType, FieldType, TensorType)):
                args.append(f"(double*)ins[{i}]")
            elif isinstance(t, ScalarType):
                args.append(f"({_scalar_cpp_type(t)})ins[{i}][0]")
        term = fn.body.terminator
        n_out = len(term.operands) if term and term.name == "neptune.return" else 0
        args += [f"outs[{j}]" for j in range(n_out)]
        return (
            f'extern "C" void nt_{fn.name}(const double** ins, double** outs) '
            f"{{ fn_{fn.name}({', '.join(args)}); }}\n"
        )


def generate_cpp(module: Module) -> str:
    return ModuleCodegen(module).generate()
