"""Fault-tolerant training loop: auto-restore, failure injection and a
straggler watchdog.

Twin of ``repro/training/resilience.py``'s host loop (which the port
keeps as its own copy):

  * **checkpoint cadence**: an atomic save every ``ckpt_every`` steps
    (``training/checkpoint.py``), keep-last-k, one before the first step
    and one after the last;
  * **auto-restore**: an ``InjectedFailure`` from a step rolls back to the
    last checkpoint and replays; the data pipeline is step-indexed and
    stateless (``batch = f(step, seed)``), so replayed steps see the same
    data;
  * **straggler watchdog**: each step's wall time against the rolling
    median of the last ``straggler_window``; a step slower than
    ``straggler_factor`` times that median is recorded and handed to the
    hook.

The step's metrics are read to the host where the reference calls
``np.asarray``, so each step's wall time ends when the device is done.

Replay is bit-exact on the card too, because a training step of the port
gives the same bits every run.  The scatters with repeated destinations
in its backward pass are the gathers' backward passes: ``take_rows`` on
token and item ids, the MoE dispatch's ``x[st]`` and combine's
``y_flat[dest]``, GIN's ``take_rows(h, edge_src)``.  Each goes through
``embedding.gather_rows``, whose backward adds each row's gradients in an
order fixed by the ids (``index_put_(accumulate=True)`` on CUDA, which
sorts the ids; ``index_add_`` on the CPU), where autograd's own backward
adds with atomics.  GQA's ``index_select``, whose backward is an atomic
``index_add_`` on the card, became a broadcast
(``transformer._expand_kv``).  The forward ``index_add_`` calls left (the
MoE buffer, the load-balance density) add one float into each kept
destination, or integers.  No process-wide switch
(``torch.use_deterministic_algorithms``) is set, so serving paths are
unchanged.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike
from repro_torch.training import checkpoint

PyTree = Any


class InjectedFailure(RuntimeError):
    """Simulated node failure (tests / chaos drills)."""


@dataclasses.dataclass
class ResilienceConfig:
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ckpt_every: int = 50
    keep_last: int = 3
    max_restores: int = 10
    straggler_factor: float = 3.0
    straggler_window: int = 20


@dataclasses.dataclass
class RunReport:
    steps_run: int = 0
    restores: int = 0
    stragglers: List[int] = dataclasses.field(default_factory=list)
    final_metrics: Optional[Dict[str, float]] = None
    step_times: List[float] = dataclasses.field(default_factory=list)


def _to_host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def run_resilient(
    step_fn: Callable[[PyTree, PyTree], tuple],
    batch_fn: Callable[[int], PyTree],
    state: PyTree,
    n_steps: int,
    cfg: ResilienceConfig,
    start_step: int = 0,
    failure_hook: Optional[Callable[[int], None]] = None,
    straggler_hook: Optional[Callable[[int, float], None]] = None,
    state_shardings: Optional[PyTree] = None,
    device: DeviceLike = None,
) -> tuple:
    """Drive ``step_fn`` for ``n_steps`` with checkpoint / restore.  Returns
    ``(final_state, RunReport)``.  A restore places the state by
    ``state_shardings`` (a mesh's ``NamedSharding`` tree), or puts it on
    ``device``, or on each leaf's own device."""
    report = RunReport()
    step = start_step

    # initial checkpoint so step 0 failures can restore
    checkpoint.save(cfg.ckpt_dir, step, state, cfg.keep_last)

    while step < n_steps:
        try:
            if failure_hook is not None:
                failure_hook(step)  # may raise InjectedFailure
            t0 = time.perf_counter()
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            # read to the host: the wall time is real (and failures surface here)
            metrics = {k: _to_host(v) for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            report.step_times.append(dt)

            # straggler detection on a rolling median
            window = report.step_times[-cfg.straggler_window:]
            if len(window) >= 5:
                med = float(np.median(window))
                if dt > cfg.straggler_factor * med:
                    report.stragglers.append(step)
                    if straggler_hook is not None:
                        straggler_hook(step, dt / med)

            step += 1
            report.steps_run += 1
            report.final_metrics = {k: float(v) for k, v in metrics.items()}
            if step % cfg.ckpt_every == 0:
                checkpoint.save(cfg.ckpt_dir, step, state, cfg.keep_last)
        except InjectedFailure:
            if report.restores >= cfg.max_restores:
                raise
            report.restores += 1
            state, step = checkpoint.restore(cfg.ckpt_dir, state, device=device,
                                             shardings=state_shardings)
    checkpoint.save(cfg.ckpt_dir, step, state, cfg.keep_last)
    return state, report


def make_scheduled_failures(fail_at: Dict[int, int]) -> Callable[[int], None]:
    """failure_hook that raises the first ``count`` times step hits ``fail_at``."""
    remaining = dict(fail_at)

    def hook(step: int) -> None:
        if remaining.get(step, 0) > 0:
            remaining[step] -= 1
            raise InjectedFailure(f"injected failure at step {step}")

    return hook
