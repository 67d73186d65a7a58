"""CG's vector work, four launches an iteration.

The generic CG loop on one tensor (`krylov.cg`, see `engages`) runs its
updates, dot products and scalar steps as four steps, in the loop's order:

  dot_alpha  p.Ap; alpha = rz / safe(p.Ap)
  update     x += alpha p; r -= alpha Ap; ||r|| and the loop's flag
  dot_beta   r.z; beta = r.z / safe(rz); rz = r.z   (after z = M(r))
  direction  p = z + beta p

On a CUDA tensor each step is one launch of a hand-written kernel
(`csrc/nt_cg_vectors.cuh`, which replaces no TPU kernel: the JAX package's
CG body is fused by XLA inside `lax.while_loop`). Each reads and writes
each grid once: 13 passes over a grid an iteration against the eager
steps' 26, 4 launches against ~25. The scalars stay on the device, in the
slots of `Scalars.buf`, and the host reads only the flag that `update`
wrote. On a CPU tensor each step runs its plain version: today's eager
arithmetic op for op (`utils.tree.tdot_f64`, `y + alpha * x`), its scalars
in the same slots, so a CPU solve is bitwise the tuple loop's.

Without a preconditioner z is r: `update` then also takes `dot_beta`'s
scalar steps, with r.r as r.z, and `dot_beta` is not called.

Every launch counts in `counter` (`cg_vectors`), whose span
`nt.launch.cg_vectors` carries the `step`.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import config
from ..kernels.build import LaunchCounter, builder, check
from ..utils.tree import safe, tdot_f64

SOURCE = '#include "nt_cg_vectors.cuh"\n'

counter = LaunchCounter("cg_vectors")

# the slots of Scalars.buf (csrc/nt_cg_vectors.cuh's kNtVec*)
RZ, ALPHA, BETA, RNORM, TARGET, DIVBOUND, PAP, RR = range(8)
# the steps' entries in nt_cg_vec_setup's blocks
_DOT_ALPHA, _UPDATE, _UPDATE_PLAIN, _DOT_BETA, _DIRECTION = range(5)
# the kernels' threads a block, packs a thread and group (16 B each)
_THREADS, _UNROLL = 256, 4


def engages(b, x0, group) -> bool:
    """Whether `krylov.cg` takes this module's loop: b one float32 or float64
    tensor on the CPU or a card (x0, if given, alike), no mesh group, no
    pinned arithmetic, and nothing for autograd to record (the kernels and
    the in-place updates are not differentiable). Tuples, groups and
    pinned mode keep the tuple loop."""
    if not isinstance(b, torch.Tensor) or group is not None or config.pinned_arithmetic:
        return False
    if b.dtype not in (torch.float32, torch.float64) or b.device.type not in ("cpu", "cuda"):
        return False
    if x0 is not None and not (
        isinstance(x0, torch.Tensor) and x0.dtype == b.dtype and x0.shape == b.shape
        and x0.device == b.device
    ):
        return False
    grads = b.requires_grad or (x0 is not None and x0.requires_grad)
    return not (torch.is_grad_enabled() and grads)


class _Library:
    """The kernels on one device: their C entries and the blocks each step
    launches at most, per dtype (as many as are resident on every SM)."""

    def __init__(self, device: torch.device):
        self.index = device.index
        lib = builder.load(SOURCE, "cg_vectors")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sigs = {
            "nt_cg_vec_setup": [i, i, p],
            "nt_cg_vec_dot_alpha": [i, i, p, p, ll, p, p, p, i, p],
            "nt_cg_vec_update": [i, i, i, p, p, p, p, ll, p, p, p, i, p],
            "nt_cg_vec_dot_beta": [i, i, p, p, ll, p, p, p, i, p],
            "nt_cg_vec_direction": [i, i, p, p, ll, p, i, p],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            setattr(self, name[len("nt_cg_vec_"):], fn)
        self.blocks = {}
        for dtype in (torch.float32, torch.float64):
            got = (ctypes.c_int * 5)()
            check(self.setup(self.index, int(dtype == torch.float64), ctypes.addressof(got)),
                  "cg_vectors setup")
            self.blocks[dtype] = tuple(got)


_libraries: dict = {}


def _library(device: torch.device) -> _Library:
    hit = _libraries.get(device.index)
    if hit is None:
        hit = _libraries[device.index] = _Library(device)
    return hit


class Scalars:
    """The scalars of one solve, on b's device: `buf`, the slots RZ ... RR
    in b's dtype, and `ctl`, int32 (the kernels' ticket, the loop's flag).
    On a card also the kernels' workspace: one float64 partial sum a block."""

    def __init__(self, b: torch.Tensor, rz, rnorm, target, divbound):
        zero = torch.zeros((), dtype=b.dtype, device=b.device)
        slots = [rz, zero, zero, rnorm, target, divbound, zero, zero]
        self.buf = torch.stack([v.to(b.dtype) for v in slots])
        self.ctl = torch.zeros(2, dtype=torch.int32, device=b.device)
        self.ctl[1] = (rnorm > target) & (rnorm <= divbound)
        self.n = b.numel()
        self.lib = self.part = None
        if b.device.type == "cuda":
            self.lib = _library(b.device)
            self.blocks = self.lib.blocks[b.dtype]
            self.part = torch.empty(max(self.blocks), dtype=torch.float64, device=b.device)

    def running(self) -> bool:
        """The loop's flag, read on the host (one sync)."""
        return bool(self.ctl[1].item())

    def grid(self, step: int) -> int:
        """The blocks of `step`'s launch: the resident ones, or fewer on a
        small grid."""
        packs = self.n * self.buf.element_size() // 16
        return max(1, min(self.blocks[step], -(-packs // (_THREADS * _UNROLL))))


def _owned(t: torch.Tensor, sc: Scalars, what: str) -> int:
    """A vector the loop owns and a kernel writes: its pointer, once checked."""
    if (t.dtype != sc.buf.dtype or t.numel() != sc.n or not t.is_contiguous()
            or t.data_ptr() % 16 or t.device != sc.buf.device):
        raise ValueError(f"cg_vectors: {what} must be a contiguous, 16-byte aligned "
                         f"{sc.buf.dtype} tensor of {sc.n} elements on {sc.buf.device}")
    return t.data_ptr()


def _operand(t: torch.Tensor, sc: Scalars) -> torch.Tensor:
    """A vector a kernel only reads (A p, z), as the kernels take it: of b's
    dtype and size on b's card, contiguous and 16-byte aligned."""
    if t.numel() != sc.n or t.device != sc.buf.device:
        raise ValueError(f"cg_vectors: operand {tuple(t.shape)} on {t.device}, expected "
                         f"{sc.n} elements on {sc.buf.device}")
    t = t.to(sc.buf.dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(step: str, sc: Scalars, fn, *args) -> None:
    stream = torch.cuda.current_stream(sc.buf.device).cuda_stream
    check(fn(sc.lib.index, int(sc.buf.dtype == torch.float64), *args, stream),
          f"cg_vectors {step} launch")


def dot_alpha(p, Ap, sc: Scalars) -> None:
    """p.Ap into PAP, alpha = rz / safe(p.Ap) into ALPHA."""
    if sc.lib is None:
        return dot_alpha_plain(p, Ap, sc)
    with counter.launch() as s:
        if s is not counter:
            s.set(step="dot_alpha")
        ap = _operand(Ap, sc)
        _launch("dot_alpha", sc, sc.lib.dot_alpha, _owned(p, sc, "p"), ap.data_ptr(), sc.n,
                sc.buf.data_ptr(), sc.part.data_ptr(), sc.ctl.data_ptr(), sc.grid(_DOT_ALPHA))


def update(x, p, r, Ap, sc: Scalars, plain: bool) -> None:
    """x += alpha p and r -= alpha Ap in place; r.r into RR, ||r|| into
    RNORM and the flag (target < ||r|| <= divbound) into ctl[1]. `plain`
    (no preconditioner, z = r): also dot_beta's scalar steps, r.r as r.z."""
    if sc.lib is None:
        return update_plain(x, p, r, Ap, sc, plain)
    with counter.launch() as s:
        if s is not counter:
            s.set(step="update")
        ap = _operand(Ap, sc)
        _launch("update", sc, sc.lib.update, int(plain), _owned(x, sc, "x"), _owned(p, sc, "p"),
                _owned(r, sc, "r"), ap.data_ptr(), sc.n, sc.buf.data_ptr(), sc.part.data_ptr(),
                sc.ctl.data_ptr(), sc.grid(_UPDATE_PLAIN if plain else _UPDATE))


def dot_beta(r, z, sc: Scalars) -> None:
    """r.z; beta = r.z / safe(rz) into BETA, then r.z into RZ."""
    if sc.lib is None:
        return dot_beta_plain(r, z, sc)
    with counter.launch() as s:
        if s is not counter:
            s.set(step="dot_beta")
        zz = _operand(z, sc)
        _launch("dot_beta", sc, sc.lib.dot_beta, _owned(r, sc, "r"), zz.data_ptr(), sc.n,
                sc.buf.data_ptr(), sc.part.data_ptr(), sc.ctl.data_ptr(), sc.grid(_DOT_BETA))


def direction(p, z, sc: Scalars) -> None:
    """p = z + beta p in place."""
    if sc.lib is None:
        return direction_plain(p, z, sc)
    with counter.launch() as s:
        if s is not counter:
            s.set(step="direction")
        zz = _operand(z, sc)
        _launch("direction", sc, sc.lib.direction, _owned(p, sc, "p"), zz.data_ptr(), sc.n,
                sc.buf.data_ptr(), sc.grid(_DIRECTION))


# ---- the plain versions: the tuple loop's eager arithmetic, op for op -------


def dot_alpha_plain(p, Ap, sc: Scalars) -> None:
    pap = tdot_f64(p, Ap)
    sc.buf[PAP] = pap
    sc.buf[ALPHA] = sc.buf[RZ] / safe(pap)


def update_plain(x, p, r, Ap, sc: Scalars, plain: bool) -> None:
    alpha = sc.buf[ALPHA]
    x.add_(alpha * p)
    r.add_(-alpha * Ap)
    rr = tdot_f64(r, r)
    rnorm = torch.sqrt(rr)
    sc.buf[RR] = rr
    sc.buf[RNORM] = rnorm
    sc.ctl[1] = (rnorm > sc.buf[TARGET]) & (rnorm <= sc.buf[DIVBOUND])
    if plain:
        _beta_plain(rr, sc)


def dot_beta_plain(r, z, sc: Scalars) -> None:
    _beta_plain(tdot_f64(r, z), sc)


def _beta_plain(rz_new, sc: Scalars) -> None:
    sc.buf[BETA] = rz_new / safe(sc.buf[RZ])
    sc.buf[RZ] = rz_new


def direction_plain(p, z, sc: Scalars) -> None:
    torch.add(z, sc.buf[BETA] * p, out=p)
