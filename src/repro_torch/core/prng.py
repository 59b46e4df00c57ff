"""threefry2x32 and the jax.random key chain, in torch.

The reference draws every random number of the walk from ``jax.random``
with the default threefry2x32 implementation in its *partitionable* mode
(``jax_threefry_partitionable=True``, the default since jax 0.5).  The
port reproduces those bits exactly, so a query walked by the port visits
the same pins as in the reference for the same key:

  * ``key(seed)``       -> ``(0, seed & 0xFFFFFFFF)`` (64-bit types off);
  * ``fold_in(k, d)``   -> ``threefry2x32(k, (0, d))``;
  * ``split(k, n)[i]``  -> ``threefry2x32(k, (0, i))`` (partitionable
    split is a fold-in of the index);
  * ``bits(k, shape)``  -> ``y0 ^ y1`` of ``threefry2x32(k, (hi, lo))``
    over the row-major flat index ``(hi, lo)`` of each element;
  * ``uniform`` and ``gumbel`` -> ``jax.random.uniform`` / ``gumbel``
    (mode "low") from those bits.

A key is an int64 tensor whose last axis holds the two 32-bit words;
``(2,)`` is one key, ``(n, 2)`` a batch of keys.  Every uint32 value is
held in int64 masked to 32 bits: torch's CPU ``uint32`` has no add, shift
or compare, and random bits are never compared as signed int32.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from repro_torch.device import DeviceLike, resolve_device

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(
    k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
):
    """The 20-round threefry2x32 block function on broadcastable int64
    tensors holding uint32 values; returns ``(y0, y1)``."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1


def key(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.key(seed)`` as a ``(2,)`` int64 word pair.

    With 64-bit types off (the reference's mode) the seed is held in 32
    bits, whose logical shift by 32 is 0: the high word is always 0 and
    the low word is the seed's low 32 bits, negative seeds and seeds past
    2**32 included.
    """
    return torch.tensor(
        [0, int(seed) & MASK32],
        dtype=torch.int64,
        device=resolve_device(device),
    )


def _as_u32(data: IntLike, device: torch.device) -> torch.Tensor:
    """``jnp.uint32(data)``: an int, or an int tensor, wrapped to 32 bits."""
    t = torch.as_tensor(data, device=device)
    return t.to(torch.int64) & MASK32


def fold_in(k: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``jax.random.fold_in``: keys ``(..., 2)`` and data broadcast to
    ``(..., 2)`` keys."""
    d = _as_u32(data, k.device)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(k: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split`` of one ``(2,)`` key into ``(num, 2)`` keys."""
    if k.shape != (2,):
        raise ValueError(f"split takes one (2,) key, got shape {tuple(k.shape)}")
    return fold_in(k, torch.arange(num, device=k.device))


def bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32) as int64 values in
    ``[0, 2**32)``; keys ``(..., 2)`` give ``(..., *shape)``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    k0 = k[..., 0].reshape(*lead, 1)
    k1 = k[..., 1].reshape(*lead, 1)
    y0, y1 = threefry2x32(k0, k1, idx >> 32, idx & MASK32)
    return (y0 ^ y1).reshape(*lead, *shape)


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same 32-bit patterns as int32
    (what the CUDA kernel reads as ``uint32``)."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def from_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> their uint32 values held in int64."""
    return x.to(torch.int64) & MASK32


F32_TINY = 2.0**-126    # float32's smallest normal (jnp.finfo(float32).tiny)


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)`` bit for bit.

    jax sets the exponent of a word's top 23 bits to make a float32 in
    [1, 2), subtracts 1, then scales: ``max(min, f * (max - min) + min)``,
    the multiply-add fused (XLA contracts it into an FMA; ``_fma_f32``
    makes the same single rounding on any device).  ``minval`` and
    ``maxval`` are rounded to float32 first, as jax converts them.
    """
    from repro_torch.core.sampling import _fma_f32

    words = bits(k, shape)
    f = ((words >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=k.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=k.device)
    return torch.maximum(lo, _fma_f32(f, hi - lo, lo))


def gumbel(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(k, shape, float32)`` in its default mode
    ("low") bit for bit: ``-log(-log(u))`` for ``u`` uniform in
    [tiny, 1), each ``log`` XLA's CPU float32 ``log`` (``log_f32``)."""
    from repro_torch.core.sampling import log_f32

    return -log_f32(-log_f32(uniform(k, shape, F32_TINY, 1.0)))
