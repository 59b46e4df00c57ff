"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Union

import torch

from repro_torch import abstract

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` unless the caller names another device.

    With no card and no explicit device this raises: an entry point never
    carries on quietly on the CPU.  Pass ``device="cpu"`` to run the plain
    PyTorch twins (the CPU tests do).
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path"
        )
    return dev


def on_card(t: torch.Tensor) -> bool:
    """``t`` takes the card's route: a CUDA tensor, or a fake tensor of a
    dry run, which reckons the card's path on any host
    (``abstract.reckon_card``)."""
    return t.device.type == "cuda" or abstract.reckons_card(t)

