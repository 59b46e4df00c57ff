"""AdamW, LR schedules, global-norm clipping and rowwise AdaGrad.

Twin of ``repro/training/optim.py``: the same ``AdamWConfig`` and its
defaults, ``OptState(m, v, step)`` mirroring the parameter tree (``m`` and
``v`` float32, ``step`` a 0-d int32 tensor), and the reference's
arithmetic in its order: grads to float32, clip by the global norm,
``step + 1``, the bias corrections, ``m``, ``v``, then ``p - lr * (mh /
(sqrt(vh) + eps) + wd * p)``, every operation in float32.

``apply_updates`` updates ``params``, ``m``, ``v`` and ``step`` in place
and returns the same tensors: the counterpart of the reference's donated
buffers (``jit(..., donate_argnums=0)``), so a full-width step holds one
copy of its state.  ``rowwise_adagrad_update`` returns new tensors, as the
reference's does.  ``state_logical`` mirrors the parameters' logical
axes for the sharding rules; ``abstract_state`` gives the state as meta
tensors for the dry run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import abstract
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.training import tree as tree_lib

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"     # 'cosine' | 'linear' | 'constant'
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    m: PyTree
    v: PyTree
    step: torch.Tensor


def init(params: PyTree) -> OptState:
    """Zero moments in float32 on each parameter's device, step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = tree_lib.leaves(params)[0].device
    return OptState(m=tree_lib.tree_map(zeros, params),
                    v=tree_lib.tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32, device=dev))


def abstract_state(params: PyTree) -> OptState:
    """``init(params)`` as meta tensors: ``m`` and ``v`` float32 like the
    parameters, ``step`` a 0-d int32 (``params`` may be meta tensors)."""
    f32 = lambda p: abstract.meta(p.shape, torch.float32)
    return OptState(m=tree_lib.tree_map(f32, params), v=tree_lib.tree_map(f32, params),
                    step=abstract.meta((), torch.int32))


def state_logical(param_logical_tree: PyTree) -> OptState:
    """Logical axes for the optimizer state: the params' for ``m`` and
    ``v``; ``step`` a scalar, replicated (the reference's ``((),)``)."""
    return OptState(m=param_logical_tree, v=param_logical_tree, step=((),))


def state_from_reference(state, device: DeviceLike = None) -> OptState:
    """The reference's ``OptState`` (its leaves as numpy arrays or jax
    arrays) as the port's tensors on ``device``, so that both packages
    step from the same state."""
    dev = resolve_device(device)
    conv = lambda a: torch.as_tensor(np.require(np.asarray(a), requirements="W"),
                                     device=dev)
    m, v, step = state
    return OptState(tree_lib.tree_map(conv, m), tree_lib.tree_map(conv, v), conv(step))


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine, linear or constant decay to
    ``min_lr_frac``; float32, on ``step``'s device."""
    step_f = step.float()
    warm = torch.clamp(step_f / _f32(max(cfg.warmup_steps, 1), step_f), max=1.0)
    frac = torch.clamp(
        (step_f - cfg.warmup_steps)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step_f),
        0.0, 1.0,
    )
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac)
        )
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    else:
        decay = _f32(1.0, step_f)
    return cfg.lr * warm * decay


SumsReduce = Callable[[List[torch.Tensor]], List[torch.Tensor]]


def global_norm(tree: PyTree, reduce: Optional[SumsReduce] = None) -> torch.Tensor:
    """The square root of every leaf's sum of squares, added in leaf
    order.  ``reduce`` makes it a norm over blocks (each leaf this rank's
    block of a sharded whole): it takes the per-leaf sums and returns each
    summed over the mesh axes its leaf is split over, so a leaf replicated
    over an axis is counted once (``train_loop.jit_train_step`` with
    ``tp``)."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_lib.leaves(tree)]
    if reduce is not None:
        sums = reduce(sums)
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads: PyTree, max_norm: float,
                        reduce: Optional[SumsReduce] = None) -> Tuple[PyTree, torch.Tensor]:
    norm = global_norm(grads, reduce)
    # a 0-d tensor over a tensor: torch's float / tensor is a reciprocal
    # times the float, not a division
    scale = torch.clamp(_f32(max_norm, norm) / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_lib.tree_map(lambda g: g * scale, grads), norm


def rowwise_adagrad_init(table: torch.Tensor) -> torch.Tensor:
    """One float32 accumulator per embedding row."""
    return torch.zeros((table.shape[0],), dtype=torch.float32, device=table.device)


def rowwise_adagrad_update(
    table: torch.Tensor, grad: torch.Tensor, accum: torch.Tensor, lr: float,
    eps: float = 1e-8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(table', accum')``: the row's mean squared gradient added to its
    accumulator, then ``table - lr * g / sqrt(accum + eps)``."""
    g = grad.float()
    accum = accum + torch.mean(g * g, dim=-1)
    step = lr * g / torch.sqrt(accum + eps)[:, None]
    return (table.float() - step).to(table.dtype), accum


@torch.no_grad()
def apply_updates(
    params: PyTree,
    grads: PyTree,
    state: OptState,
    cfg: AdamWConfig,
) -> Tuple[PyTree, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns ``(params, state, metrics)``:
    the same tensors, updated, and ``{"grad_norm", "lr"}`` as 0-d
    tensors."""
    grads, hyper = prepare_step(grads, state.step, cfg)
    for p, m, v, g in zip(tree_lib.leaves(params), tree_lib.leaves(state.m),
                          tree_lib.leaves(state.v), tree_lib.leaves(grads)):
        adamw_leaf(p, m, v, g, hyper, cfg)
    return params, state, {"grad_norm": hyper["grad_norm"], "lr": hyper["lr"]}


def prepare_step(grads: PyTree, step: torch.Tensor, cfg: AdamWConfig,
                 norm_reduce: Optional[SumsReduce] = None):
    """The step's shared half: the grads in float32, clipped by their
    global norm (over blocks with ``norm_reduce``: ``global_norm``);
    ``step + 1`` in place; the learning rate and the bias corrections.
    Returns ``(grads, hyper)``."""
    grads = tree_lib.tree_map(lambda g: g.float(), grads)
    if cfg.grad_clip > 0:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, norm_reduce)
    else:
        gnorm = global_norm(grads, norm_reduce)
    step.add_(1)
    step_f = step.float()
    return grads, dict(
        grad_norm=gnorm, lr=schedule_lr(cfg, step),
        bc1=1 - torch.pow(_f32(cfg.beta1, step_f), step_f),
        bc2=1 - torch.pow(_f32(cfg.beta2, step_f), step_f))


def adamw_leaf(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
               hyper: Dict[str, torch.Tensor], cfg: AdamWConfig) -> None:
    """One leaf's AdamW update, in place (``p`` may be a block of a
    larger tensor: every operation is elementwise)."""
    b1, b2 = cfg.beta1, cfg.beta2
    # b1 * m + (1 - b1) * g and b2 * v + (1 - b2) * g * g, each rounded
    # as the reference rounds them
    m.copy_(b1 * m + (1 - b1) * g)
    v.copy_(b2 * v + (1 - b2) * g * g)
    p32 = p.float()
    upd = (m / hyper["bc1"]) / (torch.sqrt(v / hyper["bc2"]) + cfg.eps) \
        + cfg.weight_decay * p32
    p.copy_((p32 - hyper["lr"] * upd).to(p.dtype))
