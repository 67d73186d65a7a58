"""Eager PyTorch apply/reduce execution — the reference dataflow lowering.

The port of `neptune_tpu/lowering/jnp_backend.py`. Each `access` becomes a
whole-tensor shift of its input and the scalar body is evaluated vectorized
over the full logical domain, on whatever device the tensors live on.

Semantics reproduced exactly:
  * storage normalization — logical `[lb, ub)` to 0-based physical tensors;
  * copy-through boundary contract — the apply result is seeded with input j
    (zeros when there is none) and only the `bounds` sub-domain is overwritten;
  * out-of-domain `access` reads are *unspecified*: they zero-fill here (wrap
    on periodic applies), and programs must mask them with `select`.

The scalar-DAG walker `eval_scalar_dag` takes an op table. `TorchOps` is the
eager one; `kernels/codegen.py` hands it a table that emits C expressions, so
the generated CUDA kernels fold, round and order the arithmetic exactly as
this eager path does.
"""

from __future__ import annotations

import operator
from typing import Sequence

import torch

from ..config import config
from ..ir.core import Block, Operation
from ..ir.types import Bounds, ScalarType, TempType

DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "index": torch.int32,
    "int32": torch.int32,
    "bool": torch.bool,
}

_FLOATS = ("float64", "float32", "bfloat16")
_INTS = ("index", "int32")


def scalar_dtype(t: ScalarType) -> torch.dtype:
    return DTYPES[t.name]


def scalar_tensor(a, t: ScalarType) -> torch.Tensor:
    """A scalar argument as the executor binds it: a 0-dim tensor of type t.
    A tensor keeps its device; a host number becomes a CPU tensor, which
    kernels read without a sync."""
    dt = scalar_dtype(t)
    return a.to(dt) if isinstance(a, torch.Tensor) else torch.tensor(a, dtype=dt)


def round_to(value, tname: str):
    """`value` as the nearest number of scalar type `tname`, as a Python
    number (a constant is rounded once into the array dtype, like a
    weakly-typed constant in the JAX package)."""
    if tname in _FLOATS:
        return torch.tensor(float(value), dtype=torch.float64).to(DTYPES[tname]).item()
    if tname in _INTS:
        return int(value)
    if tname == "bool":
        return bool(value)
    raise ValueError(f"unknown scalar type {tname!r}")


def shift_read(arr: torch.Tensor, offset: Sequence[int], periodic=False) -> torch.Tensor:
    """view[i] = arr[i + offset].

    periodic (bool or per-dim sequence of bool): wrapped dims use a torus
    `torch.roll`; the others zero-fill the out-of-range edge. Those cells are
    unspecified by the apply contract and the copy-through mask drops them.
    """
    if all(o == 0 for o in offset):
        return arr
    flags = (periodic,) * len(offset) if isinstance(periodic, bool) else tuple(periodic)
    roll = tuple(-o if f else 0 for o, f in zip(offset, flags))
    if any(roll):
        arr = torch.roll(arr, shifts=roll, dims=tuple(range(len(offset))))
    if all(f or o == 0 for o, f in zip(offset, flags)):
        return arr
    out = torch.zeros_like(arr)
    src, dst = [], []
    for d, (o, f) in enumerate(zip(offset, flags)):
        size = arr.shape[d]
        o = 0 if f else max(-size, min(o, size))
        if o >= 0:
            src.append(slice(o, size))
            dst.append(slice(0, size - o))
        else:
            src.append(slice(0, size + o))
            dst.append(slice(-o, size))
    out[tuple(dst)] = arr[tuple(src)]
    return out


# ---------------------------------------------------------------------------
# op tables
# ---------------------------------------------------------------------------

# Python operators take a Python-number operand on either side
_BINOPS = {
    "arith.add": operator.add,
    "arith.sub": operator.sub,
    "arith.mul": operator.mul,
    "arith.div": operator.truediv,
    "arith.pow": operator.pow,
    "arith.min": torch.minimum,
    "arith.max": torch.maximum,
    "arith.and": torch.logical_and,
    "arith.or": torch.logical_or,
}
_TENSOR_ONLY = ("arith.min", "arith.max", "arith.and", "arith.or")

_UNARY = {
    "arith.neg": torch.neg,
    "arith.not": torch.logical_not,
    "math.exp": torch.exp,
    "math.log": torch.log,
    "math.sqrt": torch.sqrt,
    "math.sin": torch.sin,
    "math.cos": torch.cos,
    "math.tan": torch.tan,
    "math.tanh": torch.tanh,
    "math.abs": torch.abs,
    "math.erf": torch.erf,
}

_CMPS = {
    "eq": operator.eq,
    "ne": operator.ne,
    "lt": operator.lt,
    "le": operator.le,
    "gt": operator.gt,
    "ge": operator.ge,
}


class TorchOps:
    """Eager op table for `eval_scalar_dag`. Values are tensors, or Python
    numbers already rounded into their scalar type; `device` is where the
    apply's tensors live."""

    def __init__(self, device):
        self.device = device

    def _t(self, v, tname):
        if isinstance(v, torch.Tensor):
            return v
        return torch.tensor(v, dtype=DTYPES[tname], device=self.device)

    def constant(self, value, tname):
        return round_to(value, tname)

    def binop(self, name, a, b, tname):
        if name == "arith.div":
            # both operands as tensors on the device: PyTorch computes
            # `number / t` as reciprocal(t) * number, and on CUDA `t / number`
            # (or a CPU scalar tensor) as t * (1 / number), each a rounding
            # away from the IEEE quotient that the kernels and the reference
            # compute
            a, b = (self._t(v, tname).to(self.device) for v in (a, b))
            if tname in _INTS:
                # integer division truncates toward zero (C / MLIR arith.divsi)
                return torch.div(a, b, rounding_mode="trunc")
            return torch.div(a, b)
        if name in _TENSOR_ONLY:
            # torch.minimum and friends take no Python number on either side
            a, b = self._t(a, tname), self._t(b, tname)
        elif not isinstance(b, torch.Tensor):
            a = self._t(a, tname)
        return _BINOPS[name](a, b)

    def unary(self, name, a, tname):
        return _UNARY[name](self._t(a, tname))

    def cmp(self, pred, a, b, tname):
        if not isinstance(b, torch.Tensor):
            a = self._t(a, tname)
        return _CMPS[pred](a, b)

    def select(self, c, a, b, tname):
        return torch.where(self._t(c, "bool"), self._t(a, tname), self._t(b, tname))

    def cast(self, v, tname):
        return v.to(DTYPES[tname]) if isinstance(v, torch.Tensor) else round_to(v, tname)

    def fence(self, v, tname):
        """Pinned mode's product fence: NaN where not finite."""
        v = self._t(v, tname)
        return torch.where(torch.isfinite(v), v, float("nan"))

    # affine materialization: coefficients arrive as exact Python floats
    def add(self, a, b, tname):
        return self.binop("arith.add", a, b, tname)

    def neg(self, a, tname):
        return self.unary("arith.neg", a, tname)

    def scale(self, a, c, tname):
        """a * c, with c rounded once into the array dtype."""
        return self.binop("arith.mul", a, round_to(c, tname), tname)

    def add_const(self, a, c, tname):
        return self.binop("arith.add", a, round_to(c, tname), tname)


# ---------------------------------------------------------------------------
# the scalar-DAG walker
# ---------------------------------------------------------------------------


class _Aff:
    """Symbolic affine form `const + Σ coef_i · atom_i` built during DAG
    evaluation (affine folding, `config.fold_affine`). Coefficients and the
    constant are Python floats: the coefficient arithmetic is exact f64 and
    rounds into the array dtype once, at materialization. Atoms are opaque
    values (stencil accesses, scalar args, non-affine subgraph results)."""

    __slots__ = ("const", "terms", "tname")

    def __init__(self, const, terms, tname):
        self.const = const
        self.terms = terms  # dict: atom key -> Python-float coefficient
        self.tname = tname  # ScalarType name


_AFF_OPS = (
    "neptune.access", "arith.constant", "arith.neg",
    "arith.add", "arith.sub", "arith.mul", "arith.div",
)


def _aff_scale(a: _Aff, c: float, tname) -> _Aff:
    return _Aff(a.const * c, {k: v * c for k, v in a.terms.items()}, tname)


def _aff_addsub(a: _Aff, b: _Aff, sign: float, tname) -> _Aff:
    terms = dict(a.terms)
    for k, v in b.terms.items():
        terms[k] = terms.get(k, 0.0) + sign * v
    return _Aff(a.const + sign * b.const, terms, tname)


def eval_scalar_dag(
    body: Block,
    rank: int,
    num_inputs: int,
    access_fn,
    index_fn,
    scalar_args: Sequence,
    ops,
    pinned: bool | None = None,
) -> list:
    """Evaluate an apply region's scalar DAG through the op table `ops`.

    access_fn(input_index, offset) -> the accessed neighbour values
    index_fn(dim) -> logical coordinates along `dim`
    ops: `TorchOps` for eager tensors, or the C-emitting table of the kernel
    generator — both see the same folding, rounding and operation order.
    pinned: the reproducibility mode (`config.pinned_arithmetic`): no
    folding, the traced op order is the contract, and every float
    `arith.mul` passes `ops.fence`. None follows the config, as the eager
    path and kernels A, C and D do; kernel B and its plain version pass
    False (a whole-grid performance path, exempt as in the JAX package).
    """
    if pinned is None:
        pinned = config.pinned_arithmetic
    fold = config.fold_affine and not pinned
    env: dict[int, object] = {}
    arg_of_input: dict[int, int] = {}

    for k in range(num_inputs):
        arg_of_input[body.args[rank + k].uid] = k
    for k, s in enumerate(scalar_args):
        env[body.args[rank + num_inputs + k].uid] = s

    index_cache: dict[int, object] = {}

    def index_value(d):
        if d not in index_cache:
            index_cache[d] = index_fn(d)
        return index_cache[d]

    atoms: dict[object, object] = {}  # atom key -> opaque value

    def materialize(a: _Aff):
        coefs = list(a.terms.values())
        tname = a.tname
        acc = None
        if len(coefs) > 1 and all(c == coefs[0] for c in coefs):
            # common-coefficient factoring: Σ c·x_i = c·Σ x_i keeps e.g. the
            # 5-pt Jacobi at its hand-written 4-op form
            for k in a.terms:
                v = atoms[k]
                acc = v if acc is None else ops.add(acc, v, tname)
            c = coefs[0]
            if c == -1.0:
                acc = ops.neg(acc, tname)
            elif c != 1.0:
                acc = ops.scale(acc, c, tname)
        else:
            for k, c in a.terms.items():
                v = atoms[k]
                t = v if c == 1.0 else (ops.neg(v, tname) if c == -1.0 else ops.scale(v, c, tname))
                acc = t if acc is None else ops.add(acc, t, tname)
        if acc is None:
            return ops.constant(a.const, tname)
        if a.const != 0.0:
            acc = ops.add_const(acc, a.const, tname)
        return acc

    def as_aff(o):
        """The operand's affine view: an existing _Aff, or its opaque value
        wrapped as a single atom. None for lazily-resolved index args."""
        if o.block_arg_of is body and o.index < rank:
            return None
        val = env[o.uid]
        if isinstance(val, _Aff):
            return val
        key = ("v", o.uid)
        if key not in atoms:
            atoms[key] = val
        return _Aff(0.0, {key: 1.0}, None)

    def try_fold(op) -> bool:
        """Fold one affine op symbolically; False -> take the eager path."""
        tname = op.results[0].type.name
        if tname not in _FLOATS:
            return False
        name = op.name
        if name == "neptune.access":
            k = arg_of_input[op.operands[0].uid]
            key = ("a", k, tuple(op.attrs["offset"]))
            if key not in atoms:  # dedups repeated accesses as a side effect
                atoms[key] = access_fn(k, op.attrs["offset"])
            env[op.results[0].uid] = _Aff(0.0, {key: 1.0}, tname)
            return True
        if name == "arith.constant":
            env[op.results[0].uid] = _Aff(float(op.attrs["value"]), {}, tname)
            return True
        if name == "arith.neg":
            a = as_aff(op.operands[0])
            if a is None:
                return False
            env[op.results[0].uid] = _aff_scale(a, -1.0, tname)
            return True
        a, b = (as_aff(o) for o in op.operands)
        if a is None or b is None:
            return False
        if name == "arith.add" or name == "arith.sub":
            sign = 1.0 if name == "arith.add" else -1.0
            env[op.results[0].uid] = _aff_addsub(a, b, sign, tname)
            return True
        if name == "arith.mul":
            if not a.terms:
                env[op.results[0].uid] = _aff_scale(b, a.const, tname)
                return True
            if not b.terms:
                env[op.results[0].uid] = _aff_scale(a, b.const, tname)
                return True
            return False  # field*field: materialize both, evaluate eagerly
        if name == "arith.div":
            if not b.terms and b.const != 0.0:
                env[op.results[0].uid] = _aff_scale(a, 1.0 / b.const, tname)
                return True
            return False
        return False

    def lookup(v):
        if v.block_arg_of is body and v.index < rank:
            return index_value(v.index)
        val = env[v.uid]
        if isinstance(val, _Aff):
            val = materialize(val)
            env[v.uid] = val
        return val

    yielded = None
    for op in body.ops:
        if fold and op.name in _AFF_OPS and op.results and try_fold(op):
            continue
        tname = op.results[0].type.name if op.results else None
        if op.name == "neptune.access":
            k = arg_of_input[op.operands[0].uid]
            env[op.results[0].uid] = access_fn(k, op.attrs["offset"])
        elif op.name == "arith.constant":
            env[op.results[0].uid] = ops.constant(op.attrs["value"], tname)
        elif op.name in _BINOPS:
            a, b = (lookup(o) for o in op.operands)
            r = ops.binop(op.name, a, b, tname)
            if pinned and op.name == "arith.mul" and tname in _FLOATS:
                r = ops.fence(r, tname)
            env[op.results[0].uid] = r
        elif op.name in _UNARY:
            env[op.results[0].uid] = ops.unary(op.name, lookup(op.operands[0]), tname)
        elif op.name == "arith.cmp":
            a, b = (lookup(o) for o in op.operands)
            env[op.results[0].uid] = ops.cmp(
                op.attrs["pred"], a, b, op.operands[0].type.name
            )
        elif op.name == "arith.select":
            c, a, b = (lookup(o) for o in op.operands)
            env[op.results[0].uid] = ops.select(c, a, b, tname)
        elif op.name == "arith.cast":
            env[op.results[0].uid] = ops.cast(lookup(op.operands[0]), tname)
        elif op.name == "neptune.yield":
            yielded = [lookup(o) for o in op.operands]
        else:
            raise NotImplementedError(f"scalar op {op.name} in apply body")

    if yielded is None:
        raise ValueError("apply body did not yield")
    return yielded


# ---------------------------------------------------------------------------
# whole-domain evaluation
# ---------------------------------------------------------------------------


def eval_apply_body(
    body: Block,
    rank: int,
    num_inputs: int,
    out_type: TempType,
    input_arrays: Sequence[torch.Tensor],
    scalar_args: Sequence,
    input_lbs: Sequence[tuple] = (),
    periodic: bool = False,
    device=None,
    pinned: bool | None = None,
) -> list[torch.Tensor]:
    """Vectorized whole-domain evaluation.

    input_lbs: logical lower bound per input temp; an input whose lb differs
    from the output's reads at a shifted physical position. pinned: as
    `eval_scalar_dag`'s.
    """
    shape = out_type.bounds.shape
    lb = out_type.bounds.lb
    if device is None:
        device = input_arrays[0].device if input_arrays else torch.device("cpu")

    def access_fn(k, offset):
        in_lb = input_lbs[k] if k < len(input_lbs) else lb
        adj = tuple(o + (lo - li) for o, lo, li in zip(offset, lb, in_lb))
        return shift_read(input_arrays[k], adj, periodic)

    def index_fn(d):
        view = [1] * rank
        view[d] = shape[d]
        return (torch.arange(shape[d], dtype=torch.int32, device=device) + lb[d]).view(view)

    yielded = eval_scalar_dag(
        body, rank, num_inputs, access_fn, index_fn, scalar_args, TorchOps(device), pinned
    )
    out_dtype = DTYPES[out_type.element]
    return [
        y.to(device=device, dtype=out_dtype).expand(shape)
        if isinstance(y, torch.Tensor)
        else torch.full(shape, y, dtype=out_dtype, device=device)
        for y in yielded
    ]


def interior_mask(bounds: Bounds, outer: Bounds, device) -> torch.Tensor:
    """Boolean mask selecting `bounds` inside `outer`'s physical tensor."""
    mask = None
    for d, sl in enumerate(bounds.rel_slices(outer)):
        view = [1] * outer.rank
        view[d] = outer.shape[d]
        iv = torch.arange(outer.shape[d], device=device).view(view)
        m = (iv >= sl.start) & (iv < sl.stop)
        mask = m if mask is None else mask & m
    return mask.expand(outer.shape)


def execute_apply(op: Operation, operand_arrays: Sequence, device=None, pinned=None):
    """Full apply semantics: seed + interior overwrite. Returns one tensor,
    or a tuple for multi-result applies (output j seeds copy-through from
    input j when it exists, zeros otherwise). `device` places an apply that
    has no tensor inputs; pinned: as `eval_scalar_dag`'s."""
    out_type: TempType = op.results[0].type
    n_in = op.attrs.get("num_inputs", len(op.operands))
    inputs = operand_arrays[:n_in]
    scalars = operand_arrays[n_in:]
    bounds: Bounds = op.attrs["bounds"]
    rank = out_type.bounds.rank
    if inputs:
        device = inputs[0].device
    elif device is None:
        device = torch.device("cpu")

    input_lbs = [v.type.bounds.lb for v in op.operands[:n_in]]
    computed = eval_apply_body(
        op.region(0),
        rank,
        n_in,
        out_type,
        inputs,
        scalars,
        input_lbs,
        periodic=bool(op.attrs.get("periodic")),
        device=device,
        pinned=pinned,
    )

    out_dtype = DTYPES[out_type.element]
    outs = []
    for j, c in enumerate(computed):
        if bounds == out_type.bounds:
            outs.append(c.contiguous())
            continue
        seed = (
            inputs[j].to(out_dtype)
            if j < n_in
            else torch.zeros(out_type.bounds.shape, dtype=out_dtype, device=device)
        )
        outs.append(torch.where(interior_mask(bounds, out_type.bounds, device), c, seed))
    return outs[0] if len(outs) == 1 else tuple(outs)


def _block_index(shape, d: int, start: int, device) -> torch.Tensor:
    """Logical coordinates along dim d of a block whose cell 0 sits at
    `start`, shaped to broadcast over the block (int32, as `index()`)."""
    view = [1] * len(shape)
    view[d] = shape[d]
    return (torch.arange(shape[d], dtype=torch.int32, device=device) + int(start)).view(view)


def execute_apply_window(
    op: Operation,
    arrays: Sequence[torch.Tensor],
    scalars: Sequence,
    global_start: Sequence[int],
    wrap=None,
    carve=None,
    shape=None,
    device=None,
):
    """One apply over a local block of a sharded grid: the plain version of
    kernel A's window form, and the port of `_eval_apply_local`
    (`neptune_tpu/parallel/sharded_apply.py`).

    arrays: the apply's tensor inputs, each the block (all of one shape);
    scalars: its scalar operands. global_start[d]: the global logical
    coordinate of block cell 0 (a host int). Index values are the block's
    coordinates plus global_start; the copy-through mask compares them with
    the op's bounds; output j seeds from input j (zeros when there is none).
    Reads that leave the block read 0, or wrap around the block in the dims
    where `wrap` (a bool per dim; default: the op's periodic flag) holds --
    kernel A's rule. Those cells lie in the edge zone that the sharded
    caller recomputes or carves off.

    carve: per dim the (lo, hi) ghost widths of the block around a core;
    the results are then core-shaped, every access a slice of the block.
    Where an input's shifted slice would leave the block, the ext-shaped
    form runs instead (callers tell the two apart by shape). shape and
    device: the block's, for an apply with no inputs.
    """
    out_type: TempType = op.results[0].type
    n_in = op.attrs.get("num_inputs", len(op.operands))
    bounds: Bounds = op.attrs["bounds"]
    outer = out_type.bounds
    rank = outer.rank
    input_lbs = [v.type.bounds.lb for v in op.operands[:n_in]]
    if arrays:
        shape, device = tuple(arrays[0].shape), arrays[0].device
    else:
        shape, device = tuple(shape), torch.device(device)
    dtype = DTYPES[out_type.element]
    if wrap is None:
        wrap = bool(op.attrs.get("periodic"))

    def adj_of(k, offset):
        return tuple(o + (lb_o - lb_i) for o, lb_o, lb_i in zip(offset, outer.lb, input_lbs[k]))

    lo = core = None
    if carve is not None:
        lo = tuple(h[0] for h in carve)
        core = tuple(e - h[0] - h[1] for e, h in zip(shape, carve))
        sshape = op.attrs.get("shape")
        offs = list(sshape.offsets) if sshape and sshape.offsets else [(0,) * rank]
        if any(
            lo[d] + adj_of(k, o)[d] < 0 or lo[d] + adj_of(k, o)[d] + core[d] > shape[d]
            for k in range(n_in)
            for o in offs
            for d in range(rank)
        ):
            carve = None

    if carve is not None:
        res_shape = core
        starts = [int(g) + l for g, l in zip(global_start, lo)]

        def access_fn(k, offset):
            adj = adj_of(k, offset)
            return arrays[k][tuple(slice(l + a, l + a + c) for l, a, c in zip(lo, adj, core))]

        def seed_of(j):
            return arrays[j][tuple(slice(l, l + c) for l, c in zip(lo, core))]

    else:
        res_shape = shape
        starts = [int(g) for g in global_start]

        def access_fn(k, offset):
            return shift_read(arrays[k], adj_of(k, offset), wrap)

        def seed_of(j):
            return arrays[j]

    def index_fn(d):
        return _block_index(res_shape, d, starts[d], device)

    ys = eval_scalar_dag(op.region(0), rank, n_in, access_fn, index_fn, scalars, TorchOps(device))
    mask = None
    if bounds != outer:
        for d in range(rank):
            iv = index_fn(d)
            m = (iv >= bounds.lb[d]) & (iv < bounds.ub[d])
            mask = m if mask is None else mask & m
    outs = []
    for j, y in enumerate(ys):
        if isinstance(y, torch.Tensor):
            y = y.to(device=device, dtype=dtype).expand(res_shape)
        else:
            y = torch.full(res_shape, y, dtype=dtype, device=device)
        if mask is None:
            outs.append(y.contiguous())
            continue
        seed = (
            seed_of(j).to(dtype)
            if j < n_in
            else torch.zeros(res_shape, dtype=dtype, device=device)
        )
        outs.append(torch.where(mask, y, seed))
    return outs[0] if len(outs) == 1 else tuple(outs)


def execute_reduce(op: Operation, arr: torch.Tensor) -> torch.Tensor:
    """All five reduce kinds."""
    tt: TempType = op.operands[0].type
    bounds = op.attrs.get("bounds")
    if bounds is not None:
        arr = arr[bounds.rel_slices(tt.bounds)]
    kind = op.attrs["kind"]
    if kind == "sum":
        return torch.sum(arr)
    if kind == "max":
        return torch.max(arr)
    if kind == "min":
        return torch.min(arr)
    if kind == "l1":
        return torch.sum(torch.abs(arr))
    if kind == "l2":
        return torch.sqrt(torch.sum(arr * arr))
    raise ValueError(f"unknown reduce kind {kind!r}")
