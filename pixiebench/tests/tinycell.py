"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in a second:
the same files, a 3,000-pin graph and a 256-walker walk."""

from __future__ import annotations

import copy
import time

import torch

from pixiebench import harness, manifest


def tiny(name: str) -> manifest.Cell:
    cell = manifest.cell(name)
    config = copy.deepcopy(cell.config)
    config.update(n_pins=3000, n_boards=800, n_edges=30000)
    config["walk"].update(n_steps=4096, n_walkers=256, top_k=50)
    mix = dict(cell.traffic, check_requests=6)
    if mix["loop"] == "open":
        mix.update(rate_qps=8.0, drain_s=5)
    else:
        mix.update(pool=64)
    return cell._replace(config=config, traffic=mix)


def run(name: str, seed: int = 4_000_000_007, seconds: float = 0.6, trace: bool = False,
        device: str = "cpu") -> dict:
    return harness.run_cell(tiny(name), seed, seconds, trace, torch.device(device),
                            time.perf_counter())
