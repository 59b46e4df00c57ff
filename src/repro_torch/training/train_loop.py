"""Train-step factory: loss -> microbatched grads -> AdamW -> metrics.

Twin of ``repro/training/train_loop.py`` on one device.  ``make_train_step``
packages the reference's step: ``microbatch.accumulated_grads``, then
``optim.apply_updates`` (in place, the counterpart of the reference's
donated state), with the mean loss added to the metrics.  The step runs
eagerly on the device of the parameters.  ``TrainStepConfig`` keeps the
reference's fields; ``zero1`` and ``donate`` are read by the mesh
functions (``state_shardings``, ``jit_train_step``, ``batch_shardings``),
which wait for the port's distribution layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.training import microbatch, optim

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    adamw: optim.AdamWConfig = optim.AdamWConfig()
    n_micro: int = 1
    zero1: bool = False          # shard m/v over the data axis too (mesh only)
    donate: bool = True


def make_train_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    cfg: TrainStepConfig,
) -> Callable:
    """Returns ``train_step((params, opt_state), batch) -> (state',
    metrics)``; ``state'`` holds the same tensors, updated in place, and
    ``metrics`` is ``{"grad_norm", "lr", "loss"}`` as 0-d tensors on the
    device (reading one synchronises)."""

    def train_step(state, batch):
        params, opt_state = state
        loss, grads = microbatch.accumulated_grads(
            loss_fn, params, batch, cfg.n_micro
        )
        new_params, new_opt, metrics = optim.apply_updates(
            params, grads, opt_state, cfg.adamw
        )
        metrics["loss"] = loss
        return (new_params, new_opt), metrics

    return train_step
