"""Explicit-communication sharded execution of compiled operators.

The port of `neptune_tpu/parallel/sharded_apply.py`. Each process runs the
operator on its own block (SPMD over the mesh's processes, where the JAX
package runs `shard_map`): thin ghost strips come from the neighbours
through `GridMesh.ring_shift`, and boundary masks compare global
coordinates, which here are host ints computed from the mesh coordinates.

The routes and their choice are the JAX package's (`plan_opdef`):

  * fused-strip: a single-apply opdef whose reach fits one block runs its
    main sweep zero-ghost on the block, then recomputes the edge bands whose
    stencils cross a block edge from strip-stitched bands;
  * fused-composite: a bounded multi-stage opdef runs its whole chain
    zero-ghost on the block, then replays the chain on the composed-reach
    bands;
  * extended-block: everything else pads each block with a composed-reach
    ghost exchange (`halo_pad_local`) and runs the opdef on it.

What the JAX package sends to a Pallas kernel goes to a Hopper kernel in
its local form -- kernel A's window form (`cuda_backend.apply_window`),
kernel C's local form (`sweeps.sweeps_local`), kernel D's origin form
(`chain.run_chain(global_start=...)`) -- and what it sends to jnp goes to
the eager PyTorch version on the same device. Every route is decided
before any launch; the kernel wrappers run their plain versions for CPU
tensors and launch, or raise, for CUDA ones. The band replays are always
eager, as in the JAX package.

backend: "auto" (default) and "cuda" choose the routes as the JAX package's
"jnp" and "pallas" do and send the main sweeps to the kernels; "torch"
chooses as "jnp" does and runs everything eagerly (the kernels off).

Every callable returned here takes this process's block of each field
argument (and the trailing scalars, the same on every process) and returns
this process's block of each result.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..ir.core import Module, Operation
from ..ir.types import ScalarType, TempType
from ..lowering import chain, cuda_backend, sweeps, torch_backend
from .halo import halo_pad_local, halo_pad_local_transpose
from .mesh import GridMesh

_BACKENDS = ("auto", "torch", "cuda")


def _check_backend(backend: str, allowed=_BACKENDS) -> None:
    if backend not in allowed:
        raise ValueError(f"unknown sharded backend {backend!r}; options: {allowed}")


def _kernels(backend: str) -> bool:
    """Whether the main sweeps go to the kernels' local forms."""
    return backend in ("auto", "cuda")


class _ScalarArg(NamedTuple):
    """Marker in a plan's scalar_vals: the scalar comes from opdef arg
    `index` at call time (the same on every process), not from a body
    constant."""

    index: int


def _resolve_scalars(scalar_vals, locs):
    """Replace _ScalarArg markers with the caller-supplied values."""
    return [locs[sv.index] if isinstance(sv, _ScalarArg) else sv for sv in scalar_vals]


def _scalar_args_trailing(fn):
    """Index where field args end and ScalarType args begin, or None if the
    signature interleaves them (every sharded path requires fields first,
    scalars trailing)."""
    kinds = [isinstance(t, ScalarType) for t in fn.ftype.inputs]
    n_fields = kinds.index(True) if any(kinds) else len(kinds)
    if any(not k for k in kinds[n_fields:]) or n_fields == 0:
        return None
    return n_fields


def _bind(fn, args, gmesh: GridMesh) -> list:
    """The call's args as the executor binds them: field blocks as tensors
    of their element type (NumPy blocks go to the mesh's device), scalars
    as 0-dim tensors of their type."""
    if len(args) != len(fn.ftype.inputs):
        raise TypeError(f"@{fn.name} expects {len(fn.ftype.inputs)} args, got {len(args)}")
    out = []
    for a, t in zip(args, fn.ftype.inputs):
        if isinstance(t, ScalarType):
            out.append(torch_backend.scalar_tensor(a, t))
        else:
            if not isinstance(a, torch.Tensor):
                a = torch.as_tensor(np.asarray(a), device=gmesh.device)
            out.append(a.to(torch_backend.DTYPES[t.element]))
    return out


def _owned(t: torch.Tensor, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """t, or a copy of it where the band fixups' writes would reach a
    caller's tensor (an apply that returns its input) or an expanded one."""
    if t.is_contiguous() and all(
        t.untyped_storage().data_ptr() != a.untyped_storage().data_ptr() for a in inputs
    ):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _eval_apply_local(op: Operation, ext_arrays, scalars, global_start, backend, carve_halo=None):
    """One apply over a block (`torch_backend.execute_apply_window`; kernel
    A's window form under the "cuda" backend, as the JAX package sends it
    to `execute_apply_window` under "pallas")."""
    if backend == "cuda" and carve_halo is None and cuda_backend.supported(op):
        return cuda_backend.apply_window(op, ext_arrays, scalars, global_start)
    return torch_backend.execute_apply_window(op, ext_arrays, scalars, global_start, carve=carve_halo)


def _eval_opdef_local(module: Module, name: str, ext_args, ext_shape, start, backend, carve_halo=None):
    """Run an opdef body on halo-extended blocks. Intermediate results keep
    the extended domain; their margins grow garbage, which the final
    interior never reads because the exchange depth is the composed reach.

    carve_halo: the RETURNED values are core-shaped (ghost margins
    stripped). Applies whose results feed only the return are computed
    core-shaped directly; anything still consumed downstream stays
    ext-shaped and is sliced at the return. Nested opdef calls always run
    ext-shaped."""
    fn = module.lookup(name)
    env = {a.uid: v for a, v in zip(fn.body.args, ext_args)}
    core_uids: set = set()
    consumed: set = set()
    returned: set = set()
    if carve_halo is not None:
        for op in fn.body.ops:
            tgt = consumed if op.name != "neptune.return" else returned
            for o in op.operands:
                tgt.add(o.uid)

    def _carve(y):
        return y[tuple(slice(h[0], e - h[1]) for h, e in zip(carve_halo, ext_shape))]

    out = None
    for op in fn.body.ops:
        if op.name == "neptune.apply":
            n_in = op.attrs.get("num_inputs", len(op.operands))
            ins = [env[o.uid] for o in op.operands[:n_in]]
            scs = [env[o.uid] for o in op.operands[n_in:]]
            final = (
                carve_halo is not None
                and backend != "cuda"
                and all(r.uid not in consumed for r in op.results)
                and any(r.uid in returned for r in op.results)
            )
            res = _eval_apply_local(
                op, ins, scs, start, backend, carve_halo=carve_halo if final else None
            )
            vals = res if isinstance(res, tuple) else (res,)
            for r, v in zip(op.results, vals):
                env[r.uid] = v
                # an lb-shifted input may decline the core-shaped form and
                # hand back ext-shaped values: classify by the actual shape
                if final and tuple(v.shape) != tuple(ext_shape):
                    core_uids.add(r.uid)
        elif op.name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
            sub = _eval_opdef_local(
                module, op.attrs["symbol"], [env[o.uid] for o in op.operands],
                ext_shape, start, backend,
            )
            subs = sub if isinstance(sub, tuple) else (sub,)
            for r, v in zip(op.results, subs):
                env[r.uid] = v
        elif op.name == "arith.constant":
            env[op.results[0].uid] = torch.tensor(
                op.attrs["value"], dtype=torch_backend.scalar_dtype(op.results[0].type)
            )
        elif op.name == "neptune.return":
            vals = []
            for o in op.operands:
                v = env[o.uid]
                if carve_halo is not None and o.uid not in core_uids:
                    v = _carve(v)
                vals.append(v)
            out = vals[0] if len(vals) == 1 else tuple(vals)
        else:
            raise NotImplementedError(f"sharded opdef execution: unsupported op {op.name}")
    return out


def _opdef_periodic(module: Module, name: str) -> bool:
    """Whether the opdef's applies are periodic (torus). Mixed periodic and
    bounded applies in one operator have no single exchange semantics."""
    flags = set()

    def scan(sym):
        fn = module.lookup(sym)
        for op in fn.body.ops:
            if op.name == "neptune.apply":
                flags.add(bool(op.attrs.get("periodic")))
            elif op.name in ("neptune.apply_linear", "neptune.apply_nonlinear"):
                scan(op.attrs["symbol"])

    scan(name)
    if len(flags) > 1:
        raise NotImplementedError(
            f"@{name} mixes periodic and bounded applies; sharded execution "
            "needs a single exchange semantics"
        )
    return bool(flags) and flags.pop()


def _single_apply(fn):
    """The opdef's single apply op, if the body is exactly {constants, one
    apply, return-of-that-apply's-results}; else None."""
    apply_op = None
    for op in fn.body.ops:
        if op.name == "neptune.apply":
            if apply_op is not None:
                return None
            apply_op = op
        elif op.name in ("arith.constant", "neptune.return"):
            continue
        else:
            return None
    if apply_op is None or fn.body.ops[-1].name != "neptune.return":
        return None
    res_uids = {r.uid: i for i, r in enumerate(apply_op.results)}
    if not all(o.uid in res_uids for o in fn.body.ops[-1].operands):
        return None
    return apply_op


def apply_reach(op) -> list:
    """Per dim the (lo, hi) cells one apply reads below and above each
    output cell, from its access offsets and its inputs' lb shifts."""
    rank = op.results[0].type.bounds.rank
    n_in = op.attrs.get("num_inputs", len(op.operands))
    outer = op.results[0].type.bounds
    input_lbs = [v.type.bounds.lb for v in op.operands[:n_in]]
    sshape = op.attrs.get("shape")
    offs = list(sshape.offsets) if sshape and sshape.offsets else [(0,) * rank]
    need = []
    for d in range(rank):
        lo_n = hi_n = 0
        for k in range(n_in):
            shift = outer.lb[d] - input_lbs[k][d]
            for o in offs:
                adj = o[d] + shift
                lo_n = max(lo_n, -adj)
                hi_n = max(hi_n, adj)
        need.append((lo_n, hi_n))
    return need


def _reach_fits(need, outer, gmesh: GridMesh, names, sweeps_k: int = 1) -> bool:
    """Strips come from immediate neighbours only: the grid must split
    evenly and the K-deep reach must fit one block (band stitching slices
    sweeps_k*(lo+hi) core rows)."""
    for d in range(outer.rank):
        nm = names[d]
        ax = gmesh.shape[gmesh.axis_names.index(nm)] if nm else 1
        if outer.shape[d] % max(ax, 1) != 0:
            return False
        if sweeps_k * (need[d][0] + need[d][1]) > outer.shape[d] // max(ax, 1):
            return False
    return True


def _fused_plan(fn, op, gmesh: GridMesh, names, sweeps_k: int = 1):
    """Eligibility and geometry of the fused strip-exchange path: (need,
    scalar_vals, ret_index, arg_order) or None. need[d] is the (lo, hi)
    per-sweep reach in dim d; the strips carry sweeps_k times that."""
    n_in = op.attrs.get("num_inputs", len(op.operands))
    outer = op.results[0].type.bounds
    arg_uids = {a.uid: i for i, a in enumerate(fn.body.args)}
    for o in op.operands[:n_in]:  # apply inputs must be opdef args directly
        if o.uid not in arg_uids:
            return None
    const_env = {}
    for cop in fn.body.ops:
        if cop.name == "arith.constant":
            const_env[cop.results[0].uid] = torch.tensor(
                cop.attrs["value"], dtype=torch_backend.scalar_dtype(cop.results[0].type)
            )
    scalar_vals = []
    for o in op.operands[n_in:]:
        if o.uid in const_env:
            scalar_vals.append(const_env[o.uid])
        elif o.uid in arg_uids and isinstance(o.type, ScalarType):
            scalar_vals.append(_ScalarArg(arg_uids[o.uid]))
        else:
            return None

    need = apply_reach(op)
    if not _reach_fits(need, outer, gmesh, names, sweeps_k):
        return None
    ret = fn.body.ops[-1]
    res_uids = {r.uid: i for i, r in enumerate(op.results)}
    ret_index = [res_uids[o.uid] for o in ret.operands]
    arg_order = [arg_uids[o.uid] for o in op.operands[:n_in]]
    return need, scalar_vals, ret_index, arg_order


def _strip_exchange(inputs_loc, nloc, rank, names, need_k, periodic, gmesh: GridMesh):
    """Ring-shift (lo, hi) ghost strips per input per sharded dim, in dim
    order, so that a later dim's strips are cut from the earlier dims'
    extended edges (strips of strips: the two-step corner exchange).

    need_k[d] = (lo, hi) ghost depth to exchange in dim d. Bounded strips
    are zeroed at the global domain edge; periodic ones keep the wrapped
    data (torus ghosts). Returns (strips, ext_slice, sharded_dims):
    strips[k][d] = (s_lo, s_hi), and ext_slice(k, d, start, stop) cuts input
    k to [start, stop) along d, extended along every exchanged dim e < d.
    """
    strips = [dict() for _ in inputs_loc]

    def ext_slice(k, d, start, stop):
        out = inputs_loc[k].narrow(d, start, stop - start)
        for e in range(d):
            if e in strips[k]:
                s_lo, s_hi = strips[k][e]
                parts = [out]
                if s_lo is not None:
                    parts.insert(0, s_lo.narrow(d, start, stop - start))
                if s_hi is not None:
                    parts.append(s_hi.narrow(d, start, stop - start))
                if len(parts) > 1:
                    out = torch.cat(parts, dim=e)
        return out

    sharded_dims = []
    for d in range(rank):
        lo_n, hi_n = need_k[d]
        nm = names[d]
        if not nm or (lo_n == 0 and hi_n == 0):
            continue
        sharded_dims.append(d)
        idx, npart = gmesh.axis_index(nm), gmesh.axis_size(nm)
        for k in range(len(inputs_loc)):
            s_lo = s_hi = None
            if lo_n:
                s_lo = gmesh.ring_shift(ext_slice(k, d, nloc[d] - lo_n, nloc[d]), nm, 1)
                if not periodic and idx == 0:
                    s_lo = torch.zeros_like(s_lo)
            if hi_n:
                s_hi = gmesh.ring_shift(ext_slice(k, d, 0, hi_n), nm, -1)
                if not periodic and idx == npart - 1:
                    s_hi = torch.zeros_like(s_hi)
            strips[k][d] = (s_lo, s_hi)
    return strips, ext_slice, sharded_dims


def _gstart(nloc, rank, names, outer, gmesh: GridMesh) -> list:
    """Global logical coordinate of local cell (0, ..., 0) per dim."""
    return [
        (gmesh.axis_index(names[d]) * nloc[d] if names[d] else 0) + outer.lb[d]
        for d in range(rank)
    ]


def _block_apply(op, names, scalar_vals):
    """One zero-ghost masked apply of a unary single-apply opdef over an
    arbitrary block: `apply_block(u, bases, shape)`, bases[d] the global
    coordinate of block cell 0 in dim d. Out-of-bounds cells copy u
    through. Torus ops wrap in their whole (unsharded) dims."""
    periodic = bool(op.attrs.get("periodic"))
    wrap = tuple(periodic and not nm for nm in names[: op.results[0].type.bounds.rank])

    def apply_block(u, bases, shape):
        return torch_backend.execute_apply_window(op, [u], scalar_vals, bases, wrap=wrap)

    return apply_block


def _stitch_band(ext_slice, strips, k, d, side, lo_n, hi_n, nloc):
    """The strip-stitched band of input k along dim d: ghost strip + the
    adjacent core rows (extended along dims < d), covering the edge zone
    plus every row its recomputation reads."""
    s_lo, s_hi = strips[k][d]
    if side == "lo":
        parts = [s_lo, ext_slice(k, d, 0, lo_n + hi_n)]
    else:
        parts = [ext_slice(k, d, nloc[d] - (lo_n + hi_n), nloc[d]), s_hi]
    parts = [p for p in parts if p is not None]
    return torch.cat(parts, dim=d) if len(parts) > 1 else parts[0]


class _BandZone(NamedTuple):
    """Geometry of one trapezoid band fixup (dim d, one side).

    bases[d2]: the global logical coordinate of band row 0 in dim d2;
    out_slice extracts the zone to write back from a band-shaped result
    (along d: rows [lo_n, lo_n + out_w); along earlier sharded dims: the
    core extent); pos is the zone's position in the core block."""

    d: int
    side: str
    out_w: int
    lo_n: int
    hi_n: int
    bases: tuple
    out_slice: tuple
    pos: tuple


def _band_zones(strips, sharded_dims, need_k, nloc, rank, gstart):
    """Enumerate the trapezoid band-fixup zones."""
    zones = []
    for d in sharded_dims:
        lo_n, hi_n = need_k[d]
        for side in ("lo", "hi"):
            out_w = lo_n if side == "lo" else hi_n
            if out_w == 0:
                continue
            if side == "lo":
                base_d = gstart[d] - lo_n
                d0_core = 0
            else:
                base_d = gstart[d] + nloc[d] - (lo_n + hi_n)
                d0_core = nloc[d] - out_w
            bases = []
            for d2 in range(rank):
                if d2 == d:
                    bases.append(base_d)
                elif d2 < d and d2 in strips[0]:
                    bases.append(gstart[d2] - need_k[d2][0])
                else:
                    bases.append(gstart[d2])
            sl = [slice(None)] * rank
            sl[d] = slice(lo_n, lo_n + out_w)
            for e in range(d):
                if e in strips[0]:
                    sl[e] = slice(need_k[e][0], need_k[e][0] + nloc[e])
            pos = tuple(d0_core if e == d else 0 for e in range(rank))
            zones.append(_BandZone(d, side, out_w, lo_n, hi_n, tuple(bases), tuple(sl), pos))
    return zones


def _run_band_fixups(outs, n_fields, strips, ext_slice, sharded_dims, need_k, nloc, rank, gstart, replay):
    """Recompute every block-edge zone from strip-stitched bands.

    replay(bands, zone) -> one band result per out; bands[fi] is field fi's
    stitched band. A result is band-shaped (the zone is sliced out of it)
    or already out_w thin along zone.d. Each zone overwrites outs in place
    (the caller owns them: `_owned`)."""
    for zone in _band_zones(strips, sharded_dims, need_k, nloc, rank, gstart):
        bands = [
            _stitch_band(ext_slice, strips, fi, zone.d, zone.side, zone.lo_n, zone.hi_n, nloc)
            for fi in range(n_fields)
        ]
        bouts = replay(bands, zone)
        for j in range(len(outs)):
            sl = list(zone.out_slice)
            if bouts[j].shape[zone.d] == zone.out_w:
                sl[zone.d] = slice(None)
            piece = bouts[j][tuple(sl)]
            outs[j][tuple(slice(p, p + s) for p, s in zip(zone.pos, piece.shape))] = piece
    return outs


def _shardmap_fused(fn, op, gmesh: GridMesh, names, plan, backend) -> Callable:
    """Fused sharded single-apply execution: a zero-ghost main sweep on the
    block plus thin band fixups.

    The main sweep reads zeros (or wraps, in the whole dims of a torus op)
    beyond the block; every cell whose stencil crossed a block edge is then
    recomputed from a thin (O(n h)) band stitched from the exchanged strips
    and written over the result. Corners ride the two-step exchange: dim-d
    strips are cut from the dims<d-extended edges. The JAX package replays
    only the zone's rows of each band; here the replay is one eager apply
    over the whole band, whose zone rows read the same cells.
    """
    need, scalar_vals, ret_index, arg_order = plan

    def local_fn(*locs):
        locs = _bind(fn, locs, gmesh)
        inputs_loc = [locs[i] for i in arg_order]
        outs = fused_apply(
            op, inputs_loc, _resolve_scalars(scalar_vals, locs), need, names, gmesh, backend
        )
        vals = [outs[i] for i in ret_index]
        return vals[0] if len(vals) == 1 else tuple(vals)

    return local_fn


def window_route(op, backend: str) -> bool:
    """Whether a block's main sweep of `op` goes to kernel A's window form:
    where the JAX package takes its window kernel, bounded ops that
    `supported` takes, on the kernel backends."""
    return _kernels(backend) and not op.attrs.get("periodic") and cuda_backend.supported(op)


def fused_apply(op, inputs_loc, scalars, need, names, gmesh: GridMesh, backend) -> list:
    """One apply over this process's blocks on the fused-strip route: its
    results (a list), every cell exact. need[d]: the apply's (lo, hi)
    reach, which fits one block."""
    rank = op.results[0].type.bounds.rank
    n_in = op.attrs.get("num_inputs", len(op.operands))
    outer = op.results[0].type.bounds
    periodic = bool(op.attrs.get("periodic"))
    # torus ops: whole dims wrap locally (their local extent is global);
    # sharded dims zero-fill, and the bands (whose ring wraps at the mesh
    # edge) recompute those edge zones
    wrap = tuple(periodic and not names[d] for d in range(rank))
    nloc = tuple(inputs_loc[0].shape)
    gstart = _gstart(nloc, rank, names, outer, gmesh)

    if window_route(op, backend):
        res = cuda_backend.apply_window(op, inputs_loc, scalars, gstart)
    else:
        res = torch_backend.execute_apply_window(op, inputs_loc, scalars, gstart, wrap=wrap)
    outs = [_owned(o, inputs_loc) for o in (res if isinstance(res, tuple) else (res,))]

    strips, ext_slice, sharded_dims = _strip_exchange(
        inputs_loc, nloc, rank, names, need, periodic, gmesh
    )

    def replay(bands, zone):
        res = torch_backend.execute_apply_window(op, bands, scalars, zone.bases, wrap=wrap)
        return list(res) if isinstance(res, tuple) else [res]

    return _run_band_fixups(
        outs, n_in, strips, ext_slice, sharded_dims, need, nloc, rank, gstart, replay
    )


def far_apply(op, inputs_loc, scalars, need, names, gmesh: GridMesh, backend) -> list:
    """One apply whose reach exceeds a block, over this process's blocks:
    its results (a list). Each input is padded with `need` ghost cells per
    dim over as many hops as the reach takes (`halo_pad_local`), and the
    apply runs on the extended blocks, kernel A's window form where
    `window_route` takes the op, and the core is kept."""
    rank = op.results[0].type.bounds.rank
    outer = op.results[0].type.bounds
    periodic = bool(op.attrs.get("periodic"))
    nloc = tuple(inputs_loc[0].shape)
    ext = [halo_pad_local(x, need, names, gmesh, periodic=periodic) for x in inputs_loc]
    start = [g - lo for g, (lo, _) in zip(_gstart(nloc, rank, names, outer, gmesh), need)]
    if window_route(op, backend):
        res = cuda_backend.apply_window(op, ext, scalars, start)
        res = res if isinstance(res, tuple) else (res,)
        core = tuple(slice(lo, lo + n) for (lo, _), n in zip(need, nloc))
        return [r[core].contiguous() for r in res]
    res = torch_backend.execute_apply_window(op, ext, scalars, start, carve=need)
    return list(res) if isinstance(res, tuple) else [res]


def _composite_fused_ok(cm, fn, gmesh: GridMesh, names, tt, halo) -> bool:
    """Eligibility of a composite (multi-stage) opdef for the fused
    strip-exchange path: every field arg on the same bounds (trailing
    scalar args allowed), uniform non-periodic applies, composed reach
    fitting one block."""
    rank = tt.bounds.rank
    n_fields = _scalar_args_trailing(fn)
    if n_fields is None:
        return False
    for t in fn.ftype.inputs[:n_fields]:
        b = getattr(t, "bounds", None)
        if b is None or b.shape != tt.bounds.shape:
            return False
    try:
        if _opdef_periodic(cm.module, fn.name):
            return False
    except NotImplementedError:
        return False
    for d in range(rank):
        nm = names[d]
        ax = gmesh.shape[gmesh.axis_names.index(nm)] if nm else 1
        if tt.bounds.shape[d] % max(ax, 1) != 0:
            return False
        if halo[d][0] + halo[d][1] > tt.bounds.shape[d] // max(ax, 1):
            return False
    return True


def _shardmap_fused_composite(cm, fn, gmesh: GridMesh, names, tt, halo, backend) -> Callable:
    """Fused strip-exchange execution of a composite (multi-stage) opdef.

    The whole chain runs zero-ghost on the block -- one launch of kernel
    D's origin form where `chain.chain_plan` takes the block, else stage at
    a time (kernel A's window form per stage) -- after which the wrong zone
    is exactly the composed reach, the opdef's verified `halo`. The
    composed-reach edge bands are then recomputed by running the same chain
    eagerly on thin strip-stitched bands of every field argument. Trailing
    scalar args flow through both evaluations.
    """
    rank = tt.bounds.rank
    n_fields = _scalar_args_trailing(fn)
    outer = tt.bounds
    plans: dict = {}  # block shape -> kernel D's plan (None: stage at a time)

    def local_fn(*locs):
        locs = _bind(fn, locs, gmesh)
        flocs, slocs = list(locs[:n_fields]), list(locs[n_fields:])
        nloc = tuple(flocs[0].shape)
        gstart = _gstart(nloc, rank, names, outer, gmesh)

        cplan = None
        if _kernels(backend):
            if nloc not in plans:
                plans[nloc] = chain.chain_plan(cm.module, fn.name, nloc)
            cplan = plans[nloc]
        if cplan is not None:
            out = chain.run_chain(cplan, flocs, slocs, global_start=gstart)
        else:
            main = "cuda" if _kernels(backend) else "torch"
            out = _eval_opdef_local(cm.module, fn.name, list(locs), nloc, gstart, main)
        outs = [_owned(o, flocs) for o in (out if isinstance(out, tuple) else (out,))]

        strips, ext_slice, sharded_dims = _strip_exchange(
            flocs, nloc, rank, names, halo, False, gmesh
        )

        def replay(band_args, zone):
            bout = _eval_opdef_local(
                cm.module, fn.name, band_args + slocs, tuple(band_args[0].shape),
                list(zone.bases), "torch",
            )
            return list(bout) if isinstance(bout, tuple) else [bout]

        outs = _run_band_fixups(
            outs, n_fields, strips, ext_slice, sharded_dims, halo, nloc, rank, gstart, replay
        )
        return outs[0] if len(outs) == 1 else tuple(outs)

    return local_fn


class RoutePlan(NamedTuple):
    """The sharded execution route chosen for one opdef: what
    `shardmap_opdef` dispatches on and `plan_report` renders."""

    kind: str  # "fused-strip" | "fused-composite" | "extended-block"
    fn: object
    halo: tuple
    names: list
    spec: tuple
    tt: TempType
    n_fields: int
    periodic: object  # bool for extended-block; None when not consulted
    apply_op: object  # the single apply op (fused-strip only)
    fused: object  # (need, scalar_vals, ret_index, arg_order) or None


def plan_opdef(cm, name: str, gmesh: GridMesh, backend: str = "auto") -> RoutePlan:
    """Select the sharded execution route for opdef @name on gmesh, as the
    JAX package does: single-apply opdefs whose reach fits one block take
    the fused strip-exchange path (not torus ops under "cuda", as not under
    the JAX package's "pallas"); eligible composite chains take the
    composite fused path (not under "cuda"); everything else the
    ghost-extended-block path."""
    _check_backend(backend)
    fn = cm.module.lookup(name)
    halo = fn.attrs.get("halo")
    if halo is None:
        raise ValueError(
            f"@{name} has no halo annotation; compile the module through the "
            "pipeline (verify_and_annotate) first"
        )
    n_fields = _scalar_args_trailing(fn)
    if n_fields is None:
        raise ValueError(
            f"@{name}: sharded execution requires field args first and "
            "scalar args trailing (fn(x, ..., *scalars))"
        )
    tt: TempType = fn.ftype.inputs[0]
    rank = tt.bounds.rank
    if not halo:
        halo = tuple((0, 0) for _ in range(rank))
    names = list(gmesh.axis_names[:rank]) + [None] * (rank - len(gmesh.axis_names))
    spec = gmesh.pspec(rank)

    apply_op = _single_apply(fn)
    if apply_op is not None:
        plan = _fused_plan(fn, apply_op, gmesh, names)
        if plan is not None and not (backend == "cuda" and _opdef_periodic(cm.module, name)):
            return RoutePlan(
                "fused-strip", fn, halo, names, spec, tt, n_fields, None, apply_op, plan
            )
    elif backend != "cuda" and _composite_fused_ok(cm, fn, gmesh, names, tt, halo):
        return RoutePlan(
            "fused-composite", fn, halo, names, spec, tt, n_fields, False, None, None
        )

    periodic = _opdef_periodic(cm.module, name)
    return RoutePlan(
        "extended-block", fn, halo, names, spec, tt, n_fields, periodic, None, None
    )


def plan_report(cm, name: str, gmesh: GridMesh, backend: str = "auto") -> str:
    """Deterministic text of the sharded execution plan; the JAX package's
    text byte for byte (`tests/golden/sharded_*_plan.txt`)."""
    rp = plan_opdef(cm, name, gmesh, backend)
    tt, rank = rp.tt, rp.tt.bounds.rank
    grid = "x".join(str(s) for s in tt.bounds.shape)
    mesh = " ".join(f"{n}={s}" for n, s in zip(gmesh.axis_names, gmesh.shape))
    local = "x".join(
        str(
            tt.bounds.shape[d]
            // (gmesh.shape[gmesh.axis_names.index(rp.names[d])] if rp.names[d] else 1)
        )
        for d in range(rank)
    )
    lines = [
        f"opdef @{name}  rank={rank}  grid={grid}  dtype={tt.element}",
        f"mesh: {mesh} ({gmesh.n_devices} devices)  local block={local}",
        f"route: {rp.kind}",
        "halo (verified reach): "
        + " ".join(f"d{d}=({lo},{hi})" for d, (lo, hi) in enumerate(rp.halo)),
    ]
    if rp.kind == "fused-strip":
        need, scalar_vals, _, arg_order = rp.fused
        ex = [
            f"d{d}=({lo},{hi})" if rp.names[d] else f"d{d}=unsharded"
            for d, (lo, hi) in enumerate(need)
        ]
        lines.append("exchange: per-sweep ghost strips " + " ".join(ex))
        lines.append(
            f"apply: {len(arg_order)} field input(s), "
            f"{len(scalar_vals)} scalar operand(s) "
            f"({sum(1 for s in scalar_vals if isinstance(s, _ScalarArg))} "
            "from trailing opdef args)"
        )
    else:
        lines.append("exchange: one composed-reach ghost exchange per application")
        lines.append(
            f"fields: {rp.n_fields} leading, "
            f"{len(rp.fn.ftype.inputs) - rp.n_fields} trailing scalar(s)"
        )
    if rp.periodic is not None:
        lines.append(f"periodic: {'yes' if rp.periodic else 'no'}")
    lines.append(f"outputs: {len(rp.fn.ftype.results)}")
    return "\n".join(lines) + "\n"


class _MeshRule:
    """What `executor._OpdefRule` needs of a sharded opdef: its route over
    the blocks, and the tangent and cotangent of that route.

    `torch.func` cannot see through `GridMesh.ring_shift`, so both exchange
    outside AD: the blocks are padded with their neighbours' composed-reach
    ghosts (`halo_pad_local`, the extended-block route's exchange), and the
    opdef's eager evaluation on the extended blocks, carved to the core, is
    differentiated there. The tangent pads the tangent's blocks the same
    way. The cotangent of the extended blocks goes back through the
    exchange's adjoint (`halo_pad_local_transpose`): each ghost zone's
    cotangent returns to its owner and is added to its edge cells. Every
    process differentiates its own part of the output, so a field
    argument's cotangent is that block of the whole cotangent; a scalar
    argument, the same on every process, gets this process's part of its
    cotangent (the whole is their sum over the mesh)."""

    def __init__(self, cm, rp: "RoutePlan", gmesh: GridMesh, route: Callable):
        self.module, self.rp, self.gm, self.route = cm.module, rp, gmesh, route
        self.periodic = _opdef_periodic(cm.module, rp.fn.name)

    def _extended(self, args: list):
        """(bound args, the field blocks padded with their ghosts plus the
        scalars, the eager evaluation of the opdef on extended blocks)."""
        rp, gm = self.rp, self.gm
        args = _bind(rp.fn, args, gm)
        ext = [self._pad(a) for a in args[: rp.n_fields]] + args[rp.n_fields:]
        start = _ext_start(rp, tuple(args[0].shape), gm)

        def local(*vals):
            return _eval_opdef_local(
                self.module, rp.fn.name, list(vals), tuple(ext[0].shape), start, "torch",
                carve_halo=rp.halo,
            )

        return args, ext, local

    def _pad(self, x):
        return halo_pad_local(x, self.rp.halo, self.rp.names, self.gm, periodic=self.periodic)

    def jvp(self, args: list, tangents):
        args, ext, local = self._extended(args)
        nf = self.rp.n_fields
        tans = [
            (a.new_zeros(a.shape) if t is None else t.to(a.dtype)) for a, t in zip(args, tangents)
        ]
        ext_t = [self._pad(t) for t in tans[:nf]] + tans[nf:]
        return torch.func.jvp(local, tuple(ext), tuple(ext_t))[1]

    def vjp(self, args: list, slots: list, cotangent):
        from ..lowering.executor import _OpdefRule

        rp = self.rp
        dtypes = [args[i].dtype for i in slots]
        _, ext, local = self._extended(args)
        f = _OpdefRule._partial(local, ext, slots)
        _, pull = torch.func.vjp(f, *(ext[i] for i in slots))
        cots = pull(cotangent)
        return tuple(
            (halo_pad_local_transpose(c, rp.halo, rp.names, self.gm, periodic=self.periodic)
             if i < rp.n_fields else c).to(dt)
            for i, c, dt in zip(slots, cots, dtypes)
        )


def shardmap_opdef(cm, name: str, gmesh: GridMesh, backend: str = "auto") -> Callable:
    """Explicit-communication sharded matvec for opdef @name: a function of
    this process's blocks (and the trailing scalars) returning its blocks
    of the results, on the route `plan_opdef` chooses.

    cm: a CompiledModule over a verified module (halo annotations present).
    backend: "auto" sends each route's main sweep to the kernels' local
    forms; "cuda" also sends every apply of the extended-block route to
    kernel A's window form (and keeps torus ops and composites off the
    fused routes, as the JAX package's "pallas"); "torch" runs eagerly.

    The callable carries `gmesh` and the opdef's verified `halo` (what the
    solvers need to find the mesh and probe the diagonal exactly), and a
    derivative rule (`_MeshRule`): forward mode for `torch.func.jvp`, which
    Newton's J·v over a sharded residual takes, and reverse mode for
    `torch.autograd.grad` and `torch.func.vjp`, which the transposed solves
    of `differentiable_solve` and `differentiable_root` take.
    """
    from ..lowering.executor import rule_callable

    rp = plan_opdef(cm, name, gmesh, backend)
    f = rule_callable(
        _MeshRule(cm, rp, gmesh, _route(cm, name, gmesh, rp, backend)), f"neptune_sharded_{name}"
    )
    f.gmesh, f.halo = gmesh, rp.fn.attrs.get("halo")
    return f


def _ext_start(rp: "RoutePlan", local_shape, gmesh: GridMesh) -> list:
    """Global logical coordinate of cell 0 of a block extended by the
    opdef's composed-reach ghosts (`halo_pad_local`), per dim."""
    return [
        (gmesh.axis_index(rp.names[d]) * local_shape[d] if rp.names[d] else 0)
        - rp.halo[d][0] + rp.tt.bounds.lb[d]
        for d in range(rp.tt.bounds.rank)
    ]


def _route(cm, name: str, gmesh: GridMesh, rp: "RoutePlan", backend: str) -> Callable:
    """The callable of `rp`'s route for opdef @name (see `shardmap_opdef`)."""
    fn, halo, names, tt = rp.fn, rp.halo, rp.names, rp.tt
    n_fields = rp.n_fields
    if rp.kind == "fused-strip":
        return _shardmap_fused(fn, rp.apply_op, gmesh, names, rp.fused, backend)
    if rp.kind == "fused-composite":
        return _shardmap_fused_composite(cm, fn, gmesh, names, tt, halo, backend)

    periodic = rp.periodic
    ext_backend = "cuda" if backend == "cuda" else "torch"

    def local_fn(*locs):
        locs = _bind(fn, locs, gmesh)
        local_shape = tuple(locs[0].shape)
        exts = [
            halo_pad_local(x, halo, names, gmesh, periodic=periodic) for x in locs[:n_fields]
        ] + list(locs[n_fields:])
        start = _ext_start(rp, local_shape, gmesh)
        return _eval_opdef_local(
            cm.module, name, exts, tuple(exts[0].shape), start, ext_backend, carve_halo=halo
        )

    return local_fn


def shardmap_sweeps(cm, name: str, gmesh: GridMesh, k: int, backend: str = "auto") -> Callable:
    """K relaxation sweeps per halo exchange (communication-avoiding): a
    function of this process's block (and the trailing scalars).

    backend: "auto" (default) runs the main sweeps through kernel C's local
    form where `sweeps.local_sweep_plan` takes the block (the sweeps left
    over, and blocks it refuses, through kernel A's window form), as the
    JAX package prefers its K-sweep window kernel, then its window kernel;
    "torch" runs them eagerly.

    Each call exchanges K-deep ghost strips once and runs K sweeps locally:
    K zero-ghost sweeps on the block (each sweep's wrong zone grows by the
    stencil reach, to K·reach), then per sharded dim the K·reach edge zone
    is recomputed exactly from a thin strip-stitched band; corners ride the
    strips of strips. Equivalent to K applications of
    `shardmap_opdef(...)`. Eligibility: unary single-result single-apply
    opdefs (bounded or torus) with K·reach fitting one block; anything else
    raises ValueError.
    """
    if k < 1:
        raise ValueError("k must be >= 1")
    _check_backend(backend, ("auto", "torch"))
    fn = cm.module.lookup(name)
    halo = fn.attrs.get("halo")
    if halo is None:
        raise ValueError(
            f"@{name} has no halo annotation; compile the module through the "
            "pipeline (verify_and_annotate) first"
        )
    tt: TempType = fn.ftype.inputs[0]
    rank = tt.bounds.rank
    if _scalar_args_trailing(fn) != 1 or len(fn.ftype.results) != 1:
        raise ValueError(
            "shardmap_sweeps requires a single-result opdef with one field "
            "arg (trailing scalar args allowed)"
        )
    op = _single_apply(fn)
    if op is None:
        raise ValueError(
            "shardmap_sweeps requires a single-apply opdef body "
            "(composite operators cannot be time-skewed as one trapezoid)"
        )
    names = list(gmesh.axis_names[:rank]) + [None] * (rank - len(gmesh.axis_names))
    plan = _fused_plan(fn, op, gmesh, names, sweeps_k=k)
    if plan is None:
        raise ValueError(
            f"@{name} is not eligible for fused sharded sweeps at k={k} "
            "(non-constant scalars, or K*reach exceeds a shard)"
        )
    need, scalar_vals, _, _ = plan
    outer = op.results[0].type.bounds
    dtype = torch_backend.DTYPES[op.results[0].type.element]
    periodic = bool(op.attrs.get("periodic"))
    need_k = [(k * lo, k * hi) for lo, hi in need]

    def local_fn(*args):
        xl, *sl = _bind(fn, args, gmesh)
        scalars_rt = _resolve_scalars(scalar_vals, [xl, *sl])
        nloc = tuple(xl.shape)
        gstart = _gstart(nloc, rank, names, outer, gmesh)
        apply_block = _block_apply(op, names, scalars_rt)

        # main: K zero-ghost sweeps on the block; kernel C's local form, the
        # leftover sweeps through kernel A's window form; eager for torus
        # ops, refused blocks and the "torch" backend
        y = None
        if backend == "auto" and not periodic:
            y = sweeps.sweeps_local(op, xl, scalars_rt, k, gstart)
        if y is None:
            y = xl
            for _ in range(k):
                y = apply_block(y, gstart, nloc)
        y = _owned(y, [xl])

        strips, ext_slice, sharded_dims = _strip_exchange(
            [xl], nloc, rank, names, need_k, periodic, gmesh
        )

        def replay(bands, zone):
            band = bands[0].to(dtype)
            for _ in range(k):
                band = apply_block(band, zone.bases, tuple(band.shape))
            return [band]

        (y,) = _run_band_fixups(
            [y], 1, strips, ext_slice, sharded_dims, need_k, nloc, rank, gstart, replay
        )
        return y

    return local_fn
