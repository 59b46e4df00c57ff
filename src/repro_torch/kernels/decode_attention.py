"""Decode-attention kernel (``csrc/decode_attention.cu``) and its plain twin.

Twin of ``repro/kernels/decode_attention.py``'s ``decode_attention``:
single-token GQA attention of ``q (b, h, dh)`` over a KV cache ``k, v (b,
s, kh, dh)`` with a length mask, -> ``(b, h, dh)`` float32.  Query head
``i`` attends to kv head ``i // (h // kh)``; batch row ``r`` attends to
positions ``[0, lengths[r])``.  ``q`` may be float32 or bf16 (the compute
dtype), ``k``/``v`` float32 or bf16 (the cache dtype); everything is
computed in float32.

``lengths`` is a ``(b,)`` int32 tensor, or one Python int for every row
(the decode step's ``pos + 1``: checked on the host, no device sync).
Every length must lie in ``[1, s]``: at length 0 the reference's twin
returns NaN where its Pallas kernel averages v, and neither is a contract
to copy, so both functions here refuse it.  A tensor of lengths is checked
with one device-to-host read.

``decode_attention_plain`` is the two-pass form of the reference's
``_decode_attention_ref`` / ``ref.decode_attention_ref``: the scores, the
mask at -1e30, ``softmax``, then the weighted sum of v.  The CUDA kernel
runs an online softmax instead, so the two agree to float32 rounding
(held within 2e-6 on the card and in the tests), not bit for bit.  The
kernel wrapper takes CUDA tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Tuple, Union

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
SMEM_LIMIT = 232_448   # bytes of shared memory one H100 block can use

Lengths = Union[int, torch.Tensor]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [
    ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           lengths: Lengths) -> Tuple[int, int, int, int, int]:
    """Validate shapes, dtypes and lengths -> ``(b, h, dh, s, kh)``."""
    if q.dim() != 3:
        raise ValueError(f"q must be (b, h, dh), got {tuple(q.shape)}")
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"k and v must both be (b, s, kh, dh), got {tuple(k.shape)} and "
            f"{tuple(v.shape)}"
        )
    b, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != dh:
        raise ValueError(
            f"k/v shape {tuple(k.shape)} does not fit q shape {tuple(q.shape)}"
        )
    if kh < 1 or h % kh != 0:
        raise ValueError(f"query heads {h} must be a multiple of kv heads {kh}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in DTYPES:
            raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if k.dtype != v.dtype:
        raise TypeError(f"k is {k.dtype} but v is {v.dtype}")
    if isinstance(lengths, torch.Tensor):
        if lengths.shape != (b,) or lengths.dtype != torch.int32:
            raise ValueError(
                f"lengths must be ({b},) int32, got {tuple(lengths.shape)} "
                f"{lengths.dtype}"
            )
        bad = bool(((lengths < 1) | (lengths > s)).any()) if b else False
    else:
        bad = not 1 <= int(lengths) <= s
    if bad:
        raise ValueError(
            f"every length must lie in [1, {s}]: a length-0 row has no "
            "position to attend to"
        )
    return b, h, dh, s, kh


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: Lengths) -> torch.Tensor:
    """Decode attention on the card: one launch, ``(b, h, dh)`` float32."""
    b, h, dh, s, kh = _check(q, k, v, lengths)
    dev = k.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on CUDA tensors, got {dev}")
    for name, t in (("q", q), ("v", v)) + (
            (("lengths", lengths),) if isinstance(lengths, torch.Tensor) else ()):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k and v must be contiguous (b, s, kh, dh) caches")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} > {MAX_HEAD_DIM}")
    lib = _build.library("decode_attention")
    smem = lib.decode_attention_smem_bytes
    if smem.argtypes is None:
        smem.argtypes = [ctypes.c_int, ctypes.c_int]
        smem.restype = ctypes.c_longlong
    if smem(h // kh, dh) > SMEM_LIMIT:
        raise ValueError(
            f"a group of {h // kh} heads of dim {dh} needs more shared "
            f"memory than one block has ({SMEM_LIMIT} bytes)"
        )
    q = q.contiguous()
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    if isinstance(lengths, torch.Tensor):
        len_ptr, uniform = lengths.contiguous().data_ptr(), 0
    else:
        len_ptr, uniform = None, int(lengths)
    fn = lib.decode_attention_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, uniform,
        out.data_ptr(), b, s, h, kh, dh, dh ** -0.5,
        int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "decode_attention")
    _build.launches["decode_attention"] += 1
    return out


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: Lengths) -> torch.Tensor:
    """Plain twin: the reference's two-pass softmax, ``(b, h, dh)`` float32."""
    b, h, dh, s, kh = _check(q, k, v, lengths)
    group = h // kh
    qg = q.reshape(b, kh, group, dh).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * dh ** -0.5
    pos = torch.arange(s, device=k.device)
    if isinstance(lengths, torch.Tensor):
        mask = pos[None, :] < lengths.to(k.device)[:, None]     # (b, s)
    else:
        mask = (pos < int(lengths))[None, :].expand(b, s)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", probs, v.float())
    return out.reshape(b, h, dh)
