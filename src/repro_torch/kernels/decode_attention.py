"""Decode-attention kernel (``csrc/decode_attention.cu``; its partial form
``csrc/decode_attention_partial.cu``, the same ``decode_attention.cuh`` built
as a library of its own) and its plain twins.

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

``decode_attention_partial`` is the same kernel over one block of a
sequence-split cache (a tensor-parallel decode step's ``kv_seq`` shard):
``k, v (b, s, kh, dh)`` hold positions ``[lo, lo + s)`` of a cache whose
valid length is ``lengths`` (any value >= 0), so row ``r`` attends to its
``clamp(lengths[r] - lo, 0, s)`` positions of the block.  It returns the
block's softmax state ``(o (b, h, dh), m (b, h), l (b, h))`` float32: ``m``
the block's largest score, ``l`` its sum of ``exp(score - m)`` and ``o``
its output ``acc / l`` (the kernel's merged ``acc`` carried divided by
``l``, so every output is of the size of ``v`` and one absolute bound
means the same on each).  A block wholly past the length still launches
and gives the kernel's empty-split sentinel, ``o = 0, m = -1e30, l = 0``:
never NaN or -inf.  ``merge_partials`` merges the blocks' states over the
shard axis (in torch: in the reference GSPMD merges them, no Pallas
kernel): at a global length >= 1 block 0 holds a valid position, so the
merged max is finite and an empty block's weight ``l * exp(m - M)`` is 0,
as the reference's -1e30 mask gives those positions exactly zero weight.
Over one block the merge gives the block's ``o`` bit for bit.

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
on one device must share a stream.  Given a dry run's fake tensors
(``repro_torch/abstract.py``) the wrapper validates as for the card, returns the
output's shape and dtype without a launch, and charges the kernel's
bytes and FLOPs (``_fake_form``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Tuple, Union

import torch

from repro_torch import abstract
from repro_torch.kernels import _build

NEG_INF = -1e30
DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_DIM = 256
SMEM_LIMIT = 232_448   # bytes of shared memory one H100 block can use

Lengths = Union[int, torch.Tensor]

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
    ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                         ctypes.c_void_p]
# the partial form: uniform length and lo, then out, m, l, ws, tickets
_PARTIAL_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
    ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int,
                                                 ctypes.c_int, ctypes.c_void_p]

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
           lengths: Lengths, lo=None) -> Tuple[int, int, int, int, int]:
    """Validate shapes, dtypes and lengths -> ``(b, h, dh, s, kh)``.  With
    ``lo`` (the partial form's block start, an int >= 0) a length may be
    any value >= 0; without it every length lies in ``[1, s]``."""
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
    if lo is not None:
        if s < 1:
            raise ValueError("a block must hold at least one position")
        if isinstance(lo, bool) or not isinstance(lo, int) or lo < 0:
            raise ValueError(f"lo must be an int >= 0, got {lo!r}")
        _check_lengths(lengths, b, 0, 2**31 - 1, "")
    else:
        _check_lengths(lengths, b, 1, s,
                       ": a length-0 row has no position to attend to")
    return b, h, dh, s, kh


def _check_lengths(lengths: Lengths, b: int, low: int, high: int, why: str) -> None:
    """A ``(b,)`` int32 tensor (one device-to-host read) or one int, every
    value in ``[low, high]``."""
    if isinstance(lengths, torch.Tensor):
        if lengths.shape != (b,) or lengths.dtype != torch.int32:
            raise ValueError(
                f"lengths must be ({b},) int32, got {tuple(lengths.shape)} "
                f"{lengths.dtype}"
            )
        bad = bool(((lengths < low) | (lengths > high)).any()) if b else False
    else:
        bad = not low <= int(lengths) <= high
    if bad:
        raise ValueError(f"every length must lie in [{low}, {high}]{why}")


def _card_checks(name: str, q, k, v, lengths, dh: int) -> bool:
    """The card's preconditions; True for a dry run's fake tensors (no
    launch)."""
    dev = k.device
    dry = abstract.reckons_card(k)
    if dev.type != "cuda" and not dry:
        raise ValueError(f"{name} runs on CUDA tensors, got {dev}")
    for n, t in (("q", q), ("v", v)) + (
            (("lengths", lengths),) if isinstance(lengths, torch.Tensor) else ()):
        if t.device != dev:
            raise ValueError(f"{n} is on {t.device}, expected {dev}")
    if not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError("k and v must be contiguous (b, s, kh, dh) caches")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {dh} > {MAX_HEAD_DIM}")
    return dry


def _launch(q, k, v, lengths, b, h, dh, s, kh, lo=None):
    """One launch of the whole-cache form (``lo`` None) or of the partial
    form over the block at ``lo``: ``out`` or ``(out, m, l)``."""
    dev = k.device
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
        len_ptr, uniform = None, int(lengths)
        # the block's own length, at least 1 (an empty block runs one split)
        max_len = uniform if lo is None else min(max(uniform - lo, 1), s)
    p = plan(b, h, kh, dh, k.dtype, max_len)
    ws = tickets = None
    if p.n_splits > 1:
        rows = b * kh * p.n_chunks
        ws = torch.empty((rows * p.n_splits * p.heads_per_chunk * (dh + 2),),
                         dtype=torch.float32, device=dev)
        tickets = _ticket_array(dev, rows)
    ptr = lambda t: None if t is None else t.data_ptr()
    tail = (b, s, h, kh, dh, dh ** -0.5, int(q.dtype == torch.bfloat16), kv_bf16,
            torch.cuda.current_stream(dev).cuda_stream)
    if lo is None:
        fn = _fn(lib, "decode_attention_launch", _ARGTYPES, ctypes.c_int)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, uniform,
                 out.data_ptr(), ptr(ws), ptr(tickets), *tail)
        _build.check(err, "decode_attention")
        _build.launches["decode_attention"] += 1
        return out
    m = torch.empty((b, h), dtype=torch.float32, device=dev)
    l = torch.empty((b, h), dtype=torch.float32, device=dev)
    fn = _fn(_build.library("decode_attention_partial"), "decode_attention_partial_launch",
             _PARTIAL_ARGTYPES, ctypes.c_int)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), len_ptr, uniform, lo,
             out.data_ptr(), m.data_ptr(), l.data_ptr(), ptr(ws), ptr(tickets), *tail)
    _build.check(err, "decode_attention_partial")
    _build.launches["decode_attention_partial"] += 1
    return out, m, l


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: Lengths) -> torch.Tensor:
    """Decode attention on the card: one launch (split-K with an in-kernel
    merge), ``(b, h, dh)`` float32.  Sync-free for an int length."""
    b, h, dh, s, kh = _check(q, k, v, lengths)
    if _card_checks("decode_attention", q, k, v, lengths, dh):
        return _fake_form(q, k, lengths, b, h, dh, s, kh)
    return _launch(q, k, v, lengths, b, h, dh, s, kh)


def decode_attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             lo: int, lengths: Lengths
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The partial form on the card (the module docstring): one launch over
    the block ``k, v`` that holds positions ``[lo, lo + s)``, ``(o, m, l)``
    float32.  Sync-free for an int length."""
    b, h, dh, s, kh = _check(q, k, v, lengths, lo=lo)
    if _card_checks("decode_attention_partial", q, k, v, lengths, dh):
        return _fake_partial(q, k, lo, lengths, b, h, dh, s, kh)
    return _launch(q, k, v, lengths, b, h, dh, s, kh, lo=lo)


def call_cost(q: torch.Tensor, k: torch.Tensor, n_pos: int, *, partial: bool,
              per_row: bool) -> Tuple[int, int]:
    """``(bytes, float32 FLOPs)`` of one call that reads ``n_pos`` (row,
    position) pairs of K and V: q and the output (the partial form's
    ``(o, m, l)``) once, per-row lengths once, K and V each read once at
    those pairs; scores and ``p @ V``, ``4 * h * dh`` FLOPs a pair."""
    b, h, dh = q.shape
    kh = k.shape[2]
    nbytes = (q.numel() * q.element_size() + 4 * b * h * (dh + (2 if partial else 0))
              + 2 * n_pos * kh * dh * k.element_size() + (4 * b if per_row else 0))
    return nbytes, 4 * h * dh * n_pos


def _fake_form(q, k, lengths, b, h, dh, s, kh) -> torch.Tensor:
    """A dry run's call (the fake form): the output's shape and dtype,
    no launch, charged ``call_cost`` with K and V read up to each row's
    length (all ``s`` for per-row lengths, whose values a dry run does
    not see)."""
    per_row = isinstance(lengths, torch.Tensor)
    nbytes, flops = call_cost(q, k, b * (s if per_row else int(lengths)),
                              partial=False, per_row=per_row)
    _build.charge("decode_attention", nbytes, {"float32": flops})
    return torch.empty((b, h, dh), dtype=torch.float32, device=k.device)


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


def _fake_partial(q, k, lo, lengths, b, h, dh, s, kh):
    """The partial form's fake form: its outputs' shapes, no launch,
    charged ``call_cost`` with the block's K and V read up to each row's
    own length (all ``s`` for per-row lengths)."""
    per_row = isinstance(lengths, torch.Tensor)
    n_pos = b * (s if per_row else min(max(int(lengths) - lo, 0), s))
    nbytes, flops = call_cost(q, k, n_pos, partial=True, per_row=per_row)
    _build.charge("decode_attention_partial", nbytes, {"float32": flops})
    dev = k.device
    return (torch.empty((b, h, dh), dtype=torch.float32, device=dev),
            torch.empty((b, h), dtype=torch.float32, device=dev),
            torch.empty((b, h), dtype=torch.float32, device=dev))


def decode_attention_partial_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   lo: int, lengths: Lengths
                                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of ``decode_attention_partial``: the block's scores at
    global positions ``lo + j``, masked at or past each row's length, then
    ``m``, ``l`` and ``o = (p @ V) / l`` in two passes; an empty row gives
    ``o = 0, m = -1e30, l = 0``."""
    b, h, dh, s, kh = _check(q, k, v, lengths, lo=lo)
    group = h // kh
    qg = q.reshape(b, kh, group, dh).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * dh ** -0.5
    pos = lo + torch.arange(s, device=k.device)
    if isinstance(lengths, torch.Tensor):
        mask = pos[None, :] < lengths.to(k.device)[:, None]     # (b, s)
    else:
        mask = (pos < int(lengths))[None, :].expand(b, s)
    mask = mask[:, None, None, :]
    m = scores.masked_fill(~mask, NEG_INF).amax(-1)             # (b, kh, group)
    p = torch.where(mask, torch.exp(scores - m[..., None]), 0.0)
    l = p.sum(-1)
    acc = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, h, dh), m.reshape(b, h), l.reshape(b, h)


def merge_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The blocks' partial softmaxes ``o (n, b, h, dh)``, ``m, l (n, b, h)``
    (blocks in sequence order) -> the whole cache's ``(b, h, dh)`` float32.
    ``M = max m``, a block's weight ``w = l * exp(m - M)`` (0 for an empty
    block), ``out = sum_i (w_i / sum w) o_i``, the sums chained in block
    order.  One block gives its ``o`` bit for bit (its weight over the sum
    is exactly 1)."""
    big = m.amax(0)
    w = l * torch.exp(m - big)
    total = w[0]
    for i in range(1, w.shape[0]):
        total = total + w[i]
    c = w / torch.clamp(total, min=1e-30)
    out = c[0][..., None] * o[0]
    for i in range(1, o.shape[0]):
        out = out + c[i][..., None] * o[i]
    return out
