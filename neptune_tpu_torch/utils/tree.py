"""Vector-space algebra over a tensor or a tuple of tensors.

The port of the `tdot`/`tnorm`/`taxpy`/`tscale`/`tsub`/`tzeros_like` subset of
`neptune_tpu/utils/tree.py`. States are grid-shaped tensors or tuples of them
(multi-field states); leaf reductions are summed in fixed tuple order.
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


def tdot(a, b) -> torch.Tensor:
    """Sum of leaf-wise real inner products, leaves summed in order."""
    acc = None
    for x, y in zip(_leaves(a), _leaves(b)):
        d = torch.sum(x * y)
        acc = d if acc is None else acc + d
    return acc


def tnorm(a) -> torch.Tensor:
    return torch.sqrt(tdot(a, a))
