"""The general traffic generator: a mix is a JSON file of parameters under
``pixiebench/traffic/``, read here and nowhere else.

Keys of a mix:

  * ``loop``: ``"open"`` (independent users on a schedule, ``rate_qps``)
    or ``"closed"`` (``callers`` that each send their next request as
    soon as their reply arrives, no think time);
  * ``arrivals`` (open loop): ``"poisson"``, exponential gaps drawn as
    ``serving/traffic.poisson_requests`` draws them,
    ``default_rng(schedule_seed).exponential(1 / rate_qps)``, then scaled
    to fill the window exactly.  The run's seed only rotates that fixed
    cycle of gaps, so every seed offers the same gaps at the same rate in
    another order;
  * ``pins_per_query``, ``pin_law`` (``"uniform"``: distinct pins drawn
    uniformly from the pins with an edge), ``weights`` (``[lo, hi]``,
    uniform, float32), the user language uniform over the graph's
    languages;
  * ``pool`` (closed loop): payloads drawn up front and reused in turn,
    each reuse under a new request id (so a new stream);
  * ``check_requests``: how many answered requests the reference redoes;
  * ``drain_s`` (open loop): how long past the window the run waits for
    answers to requests due in it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

LOOPS = ("open", "closed")
ARRIVALS = ("poisson",)
PIN_LAWS = ("uniform",)


class Payloads(NamedTuple):
    pins: np.ndarray      # (n, pins_per_query) int32, distinct in a row
    weights: np.ndarray   # (n, pins_per_query) float32
    feats: np.ndarray     # (n,) int32 user language


def validate(mix: dict) -> None:
    if mix["loop"] not in LOOPS:
        raise ValueError(f"unknown loop {mix['loop']!r}; use one of {LOOPS}")
    if mix["pin_law"] not in PIN_LAWS:
        raise ValueError(f"unknown pin law {mix['pin_law']!r}; use one of {PIN_LAWS}")
    if mix["loop"] == "open" and mix["arrivals"] not in ARRIVALS:
        raise ValueError(f"unknown arrivals {mix['arrivals']!r}; use one of {ARRIVALS}")


def arrivals(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """An open loop's arrival times in ``[0, seconds)``, ascending."""
    n = max(1, int(round(mix["rate_qps"] * seconds)))
    gaps = np.random.default_rng(mix["schedule_seed"]).exponential(
        1.0 / mix["rate_qps"], size=n)
    gaps *= seconds / gaps.sum()
    gaps = np.roll(gaps, -(int(seed) % n))
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


def payloads(mix: dict, n: int, has_edge: torch.Tensor, n_langs: int,
             seed: int) -> Payloads:
    """``n`` query payloads from ``seed``: distinct pins with an edge."""
    rng = np.random.default_rng([int(seed) % 2**63, 1])
    k = mix["pins_per_query"]
    lo, hi = mix["weights"]
    weights = rng.uniform(lo, hi, size=(n, k)).astype(np.float32)
    feats = rng.integers(0, n_langs, size=n).astype(np.int32)
    n_pins = int(has_edge.shape[0])
    pins = np.full((n, k), -1, np.int64)
    filled = np.zeros(n, np.int64)
    while (filled < k).any():
        rows = np.flatnonzero(filled < k)
        cand = rng.integers(0, n_pins, size=(rows.size, 2 * k))
        ok = has_edge[torch.from_numpy(cand).to(has_edge.device)].cpu().numpy()
        for j, r in enumerate(rows):
            for p in cand[j][ok[j]]:
                if filled[r] == k:
                    break
                if p not in pins[r, :filled[r]]:
                    pins[r, filled[r]] = p
                    filled[r] += 1
    return Payloads(pins.astype(np.int32), weights, feats)
