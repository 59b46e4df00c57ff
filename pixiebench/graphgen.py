"""The benchmark's graph, drawn on the device from the run's seed.

A frozen copy of ``chip_smoke.full_width_graph``'s draws: uniform random
(pin, board) edges and one language of four a node, int8, all from one
``torch.Generator`` on the device in a few large calls.  The same seed on
the same device gives the same edge list, so the program's graph compile
and the reference's are handed the same input; the reference draws it
again after the window rather than keep 12 GB of edges through it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

GENERATORS = ("uniform",)


class Edges(NamedTuple):
    pins: torch.Tensor        # (n_edges,) int32 pin ids
    boards: torch.Tensor      # (n_edges,) int32 board ids in [0, n_boards)
    pin_lang: torch.Tensor    # (n_pins,) int8
    board_lang: torch.Tensor  # (n_boards,) int8


def draw(config: dict, seed: int, device) -> Edges:
    """The configuration's edge list and languages from ``seed``."""
    if config["generator"] not in GENERATORS:
        raise ValueError(f"unknown graph generator {config['generator']!r}; "
                         f"use one of {GENERATORS}")
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)

    def randint(hi, n, dtype):
        return torch.randint(0, hi, (n,), generator=gen, dtype=dtype, device=device)

    n_pins, n_boards, n_edges = config["n_pins"], config["n_boards"], config["n_edges"]
    pins = randint(n_pins, n_edges, torch.int32)
    boards = randint(n_boards, n_edges, torch.int32)
    pin_lang = randint(config["n_langs"], n_pins, torch.int8)
    board_lang = randint(config["n_langs"], n_boards, torch.int8)
    return Edges(pins, boards, pin_lang, board_lang)


def pins_with_edges(edges: Edges, n_pins: int) -> torch.Tensor:
    """``(n_pins,)`` bool: the pins a query may name (degree > 0)."""
    seen = torch.zeros(n_pins, dtype=torch.bool, device=edges.pins.device)
    for part in edges.pins.split(2**27):
        seen[part.long()] = True
    return seen
