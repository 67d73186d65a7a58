"""Vector-space algebra over a tensor or a tuple of tensors.

The port of the `tdot`/`tnorm`/`taxpy`/`tscale`/`tsub`/`tzeros_like` subset of
`neptune_tpu/utils/tree.py`. States are grid-shaped tensors or tuples of them
(multi-field states); leaf reductions are summed in fixed tuple order.

On a sharded grid each process holds one block of every state. The
reductions then take `group=`: a `torch.distributed` group, or a
`MeshGroup` (`GridMesh.mesh_group`), which also carries where the block
lies in the global grid. They all-reduce the block's partial sum over the
group, as the JAX package's `tdot` becomes a `psum` under sharding.
Without a group nothing is communicated.

Under `config.pinned_arithmetic` the reductions go further, as the JAX
package's do: a fixed pairwise-halving tree over the flat GLOBAL vector
makes them bitwise identical across mesh shapes, and the products feeding
the tree (and `taxpy`'s `alpha*x`) pass `_fma_fence`. The tree needs each
element's global position, so on a mesh it takes a `MeshGroup` (a bare
process group raises): the fenced products are gathered whole
(`GridMesh.gather`, counted in `gathers`) and every process runs the same
tree, so every process holds the same scalar and nothing is all-reduced.
"""

from __future__ import annotations

import torch

from ..config import config


def _leaves(a) -> tuple:
    return tuple(a) if isinstance(a, (tuple, list)) else (a,)


def _map(f, *trees):
    if isinstance(trees[0], (tuple, list)):
        return tuple(f(*xs) for xs in zip(*trees))
    return f(*trees)


def tsub(a, b):
    return _map(torch.sub, a, b)


def tscale(alpha, a):
    return _map(lambda x: alpha * x, a)


def _fma_fence(v):
    """`v` where finite, NaN elsewhere. Eager PyTorch contracts no multiply
    into a later add across ops, so this is not needed to stop an FMA as it
    is under XLA; it is kept so that pinned mode gives the JAX package's
    values, whose fence maps a non-finite product to NaN (a documented
    deviation there: +-inf products yield NaN under the pinned flag)."""
    if not isinstance(v, torch.Tensor) or not v.is_floating_point():
        return v
    return torch.where(torch.isfinite(v), v, float("nan"))


def taxpy(alpha, x, y):
    """y + alpha * x, leaf-wise (the product fenced in pinned mode)."""
    if config.pinned_arithmetic:
        return _map(lambda xi, yi: yi + _fma_fence(alpha * xi), x, y)
    return _map(lambda xi, yi: yi + alpha * xi, x, y)


def tzeros_like(a):
    return _map(torch.zeros_like, a)


def safe(d):
    """d, with 0 replaced by 1 (the reference's division guards)."""
    return torch.where(d == 0, torch.ones_like(d), d)


class MeshGroup:
    """What `group=` takes on a mesh: the processes that shard a field of
    `grid_rank` dims on `gm` (a `parallel.GridMesh`), with the layout that
    pinned reductions need to put each element at its global position."""

    def __init__(self, gm, grid_rank: int):
        self.gm = gm
        self.grid_rank = grid_rank

    @property
    def group(self):
        """The process group (None: every process holds the field whole)."""
        return self.gm.sum_group(self.grid_rank)


def _process_group(group):
    return group.group if isinstance(group, MeshGroup) else group


def allreduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """t summed over the processes of `group` (t itself without one). A
    group whose backend has no collectives for CUDA tensors (gloo) gets
    the value through host memory."""
    group = _process_group(group)
    if group is None:
        return t
    import torch.distributed as dist

    staged = t.is_cuda and "nccl" not in str(dist.get_backend(group))
    buf = t.detach().to("cpu", copy=True) if staged else t.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device) if staged else buf


def _pairwise_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum a flat vector through a fixed pairwise-halving tree: pad to a
    power of two, then log2(N) rounds of v[:m] + v[m:], the JAX package's
    tree. The association is a function of the element order alone, and
    each round is an elementwise IEEE add, so the sum does not depend on
    where the vector was computed. One launch per round on the card."""
    n = v.numel()
    if n == 0:
        return v.new_zeros(())
    m = 1 << (n - 1).bit_length()
    if m != n:
        v = torch.nn.functional.pad(v, (0, m - n))
    while m > 1:
        m //= 2
        v = v[:m] + v[m:]
    return v[0]


def _pinned_tdot(a, b, group):
    if group is not None and not isinstance(group, MeshGroup):
        raise ValueError(
            "pinned arithmetic sums over the global vector: on a mesh pass "
            "group=GridMesh.mesh_group(rank), not a bare process group"
        )
    acc = None
    for x, y in zip(_leaves(a), _leaves(b)):
        p = _fma_fence(x * y)
        if group is not None:
            p = group.gm.gather(p)  # the whole array of products, on every process
        d = _pairwise_sum(p.reshape(-1))
        acc = d if acc is None else acc + d
    return acc


def tdot(a, b, group=None) -> torch.Tensor:
    """Sum of leaf-wise real inner products, leaves summed in order, then
    over the processes of `group` when one is given. Under pinned
    arithmetic each leaf sums through the global pairwise tree."""
    if config.pinned_arithmetic:
        return _pinned_tdot(a, b, group)
    acc = None
    for x, y in zip(_leaves(a), _leaves(b)):
        d = torch.sum(x * y)
        acc = d if acc is None else acc + d
    return allreduce(acc, group)


def tdot_f64(a, b, group=None) -> torch.Tensor:
    """`tdot` with the products summed in float64 and the total, over
    `group` too, rounded once to the leaves' dtype, as kernel B sums its
    dot products (f64 leaves sum as in `tdot`). A block's partial sum
    keeps no low-precision rounding of its own, so CG over a mesh takes
    the whole grid's scalars, but for f64 rounding ties, whatever the
    mesh. Pinned arithmetic gives way to its `tdot`, which has no ties."""
    if config.pinned_arithmetic:
        return _pinned_tdot(a, b, group)
    acc, dtype = None, None
    for x, y in zip(_leaves(a), _leaves(b)):
        d = torch.sum(x * y, dtype=torch.float64)
        acc = d if acc is None else acc + d
        dtype = x.dtype if dtype is None else torch.promote_types(dtype, x.dtype)
    return allreduce(acc, group).to(dtype)


def tnorm(a, group=None) -> torch.Tensor:
    return torch.sqrt(tdot(a, a, group))


def vdot(x: torch.Tensor, y: torch.Tensor, group=None) -> torch.Tensor:
    """Inner product of two flat vectors (`torch.dot`), over `group`."""
    return allreduce(torch.dot(x, y), group)


def vnorm(x: torch.Tensor, group=None) -> torch.Tensor:
    """2-norm of a flat vector: `vector_norm` of the whole vector, or the
    root of its inner product over `group` when the vector is sharded."""
    if _process_group(group) is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(vdot(x, x, group))
