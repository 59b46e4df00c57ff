"""int8 gradient quantisation for error-feedback compression.

Twin of ``repro/training/compression.py``'s device-local half: per-tensor
symmetric int8 (``scale = max(max|g|, 1e-12) / 127``, values rounded half
to even and clipped to ``[-127, 127]``), ``dequantize`` and the float32
error-feedback residual.  The int8 values and the float32 scale equal the
reference's bit for bit: every division is a true float32 division (a 0-d
tensor divisor; torch on the card would multiply by the reciprocal of a
Python float).  ``compressed_psum`` needs a collective and waits for the
port's distribution layer.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.training import tree as tree_lib

PyTree = Any


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    div = torch.tensor(127.0, dtype=g.dtype, device=g.device)
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / div
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_residual(params: PyTree) -> PyTree:
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
