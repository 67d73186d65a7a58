"""Vector-space algebra over a tensor or a tuple of tensors.

The port of the `tdot`/`tnorm`/`taxpy`/`tscale`/`tsub`/`tzeros_like` subset of
`neptune_tpu/utils/tree.py`. States are grid-shaped tensors or tuples of them
(multi-field states); leaf reductions are summed in fixed tuple order.

On a sharded grid each process holds one block of every state. The
reductions then take the process group of the mesh (`group=`, a
`torch.distributed` group) and all-reduce the block's partial sum over it,
as the JAX package's `tdot` becomes a `psum` under sharding. Without a
group nothing is communicated.
"""

from __future__ import annotations

import torch


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


def taxpy(alpha, x, y):
    """y + alpha * x, leaf-wise."""
    return _map(lambda xi, yi: yi + alpha * xi, x, y)


def tzeros_like(a):
    return _map(torch.zeros_like, a)


def allreduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """t summed over the processes of `group` (t itself without one). A
    group whose backend has no collectives for CUDA tensors (gloo) gets
    the value through host memory."""
    if group is None:
        return t
    import torch.distributed as dist

    staged = t.is_cuda and "nccl" not in str(dist.get_backend(group))
    buf = t.detach().to("cpu", copy=True) if staged else t.detach().clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device) if staged else buf


def tdot(a, b, group=None) -> torch.Tensor:
    """Sum of leaf-wise real inner products, leaves summed in order, then
    over the processes of `group` when one is given."""
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
    mesh."""
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
    if group is None:
        return torch.linalg.vector_norm(x)
    return torch.sqrt(vdot(x, x, group))
