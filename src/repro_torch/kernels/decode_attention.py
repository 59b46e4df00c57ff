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
splits the sequence across CTAs and merges their online softmaxes
(``plan`` says how for given shapes), so the two agree to float32
rounding (held within 2e-6 on the card and in the tests), not bit for
bit; the kernel gives the same bits from run to run.  The kernel wrapper
takes CUDA tensors only.  With more than one split it hands the kernel a
float32 workspace (``torch.empty``) and a per-device array of ticket
counters that every launch leaves zeroed, so launches that might overlap
on one device must share a stream.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Tuple, Union

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
SMEM_LIMIT = 232_448   # bytes of shared memory one H100 block can use

Lengths = Union[int, torch.Tensor]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
    ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]

_tickets: Dict[torch.device, torch.Tensor] = {}
_tickets_lock = threading.Lock()


class Plan(NamedTuple):
    """How the kernel splits one call (``csrc/decode_attention.cu``)."""

    n_splits: int        # CTAs along the sequence per (row, kv head, chunk)
    split_len: int       # positions per split, a multiple of the tile
    n_chunks: int        # head chunks per kv head
    heads_per_chunk: int
    tile: int            # positions per pipeline stage
    stages: int          # cp.async ring depth
    ctas: int            # the grid's size


def _fn(lib, name: str, argtypes, restype):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def plan(b: int, h: int, kh: int, dh: int, kv_dtype: torch.dtype,
         max_len: int) -> Plan:
    """The kernel's split plan for these shapes; ``max_len`` is the int
    length, or the cache's ``s`` for a tensor of lengths.  Builds the
    library (a CUDA host only)."""
    lib = _build.library("decode_attention")
    out = (ctypes.c_int * 7)()
    _fn(lib, "decode_attention_plan", [ctypes.c_int] * 6 + [ctypes.c_void_p],
        None)(b, h, kh, dh, int(kv_dtype == torch.bfloat16), max_len, out)
    return Plan(*out)


def _ticket_array(dev: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed int32 tickets on ``dev``, kept across calls
    (the kernel resets every ticket it takes)."""
    with _tickets_lock:
        t = _tickets.get(dev)
        if t is None or t.numel() < n:
            t = torch.zeros((max(n, 2 * (0 if t is None else t.numel())),),
                            dtype=torch.int32, device=dev)
            _tickets[dev] = t
        return t


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
    """Decode attention on the card: one launch (split-K with an in-kernel
    merge), ``(b, h, dh)`` float32.  Sync-free for an int length."""
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
    kv_bf16 = int(k.dtype == torch.bfloat16)
    smem = _fn(lib, "decode_attention_smem_bytes", [ctypes.c_int] * 2,
               ctypes.c_longlong)
    if smem(dh, kv_bf16) > SMEM_LIMIT:
        raise ValueError(
            f"head_dim {dh} needs more shared memory than one block has "
            f"({SMEM_LIMIT} bytes)"
        )
    q = q.contiguous()
    out = torch.empty((b, h, dh), dtype=torch.float32, device=dev)
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.contiguous()
        len_ptr, uniform, max_len = lengths.data_ptr(), 0, s
    else:
        len_ptr, uniform, max_len = None, int(lengths), int(lengths)
    p = plan(b, h, kh, dh, k.dtype, max_len)
    ws = tickets = None
    if p.n_splits > 1:
        rows = b * kh * p.n_chunks
        ws = torch.empty((rows * p.n_splits * p.heads_per_chunk * (dh + 2),),
                         dtype=torch.float32, device=dev)
        tickets = _ticket_array(dev, rows)
    fn = _fn(lib, "decode_attention_launch", _ARGTYPES, ctypes.c_int)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, uniform,
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), b, s, h, kh, dh,
        dh ** -0.5, int(q.dtype == torch.bfloat16), kv_bf16,
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
