"""Gradient accumulation over microbatches: the mean loss and grads.

Twin of ``repro/training/microbatch.py``.  Splitting the global batch
into ``n_micro`` microbatches divides the peak activation memory by
``n_micro`` at the cost of ``n_micro`` passes.  The reference scans; the
port runs a Python loop over the axis-0 splits in order, summing each
microbatch's float32 grads into one buffer (``0 + g`` first, as the
scan's carry starts from zeros), then scales the sums by ``1 / n_micro``.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import torch

from repro_torch.training import tree as tree_lib

PyTree = Any


def value_and_grad(loss_fn: Callable[..., torch.Tensor]) -> Callable:
    """``jax.value_and_grad(loss_fn)`` for trees of tensors: ``(params,
    *args) -> (loss, grads)``, the loss detached and the grads a tree of
    ``params``' structure (zeros where the loss does not reach a leaf).
    ``params``' leaves keep their ``requires_grad`` flags; their ``.grad``
    is not touched."""

    def fn(params: PyTree, *args) -> Tuple[torch.Tensor, PyTree]:
        leaves = tree_lib.leaves(params)
        flags = [p.requires_grad for p in leaves]
        try:
            for p in leaves:
                p.requires_grad_(True)
            with torch.enable_grad():
                loss = loss_fn(params, *args)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        finally:
            for p, f in zip(leaves, flags):
                p.requires_grad_(f)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        return loss.detach(), tree_lib.unflatten(params, grads)

    return fn


def accumulated_grads(
    loss_fn: Callable[..., torch.Tensor],
    params: PyTree,
    batch: PyTree,
    n_micro: int,
) -> Tuple[torch.Tensor, PyTree]:
    """Mean loss and grads over ``n_micro`` microbatches (axis-0 split).

    Every leaf of ``batch`` must have a leading dim divisible by
    ``n_micro``.
    """
    grad_fn = value_and_grad(loss_fn)
    if n_micro <= 1:
        return grad_fn(params, batch)
    for x in tree_lib.leaves(batch):
        if x.shape[0] % n_micro:
            raise ValueError(f"a batch leaf of {x.shape[0]} rows does not split "
                             f"into {n_micro} microbatches")
    p_leaves = tree_lib.leaves(params)
    dev = p_leaves[0].device
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    grad_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in p_leaves]
    for i in range(n_micro):
        mb = tree_lib.tree_map(
            lambda x: x[i * (x.shape[0] // n_micro):(i + 1) * (x.shape[0] // n_micro)],
            batch)
        loss, grads = grad_fn(params, mb)
        for acc, g in zip(grad_sum, tree_lib.leaves(grads)):
            acc.add_(g.float())
        del grads
        loss_sum = loss_sum + loss
    inv = 1.0 / n_micro
    return loss_sum * inv, tree_lib.unflatten(params, [g.mul_(inv) for g in grad_sum])
