"""The exact top-k's selection step on the card (``csrc/topk_select.cu``).

``counter._topk`` finds each row's k-th key with ``torch.topk``; the
selection then takes, for each row of ``keys``, exactly ``k`` indices in
ascending order: every index whose key is above the row's k-th key, and
the lowest-index ``need = k - above`` of those equal to it (``lax.top_k``'s
rule, ties to the lower index).  ``ops.topk_select`` is the entry point.

The twin is ``counter.topk_select_plain``, the selection ``counter._topk``
made before the kernel existed and still makes off the card: masks, a
``cumsum`` over the ties and a ``nonzero``, which waits on the host for its
size (the batch record's ``topk.nonzero`` site).  The kernel's output is
``(rows, k)`` whatever the data, so it makes no host wait.  Both give the
same indices on every row free of NaN; on a row holding NaN the kernel
ranks NaN above every number (``torch.topk``'s order) where the twin's
float comparisons fail.

The kernel takes a contiguous 2-D CUDA tensor of float32, float64,
float16, bfloat16 (compared as floats: ``-0.0`` ties ``+0.0``), int16,
int32 or int64 keys (``counter.order_keys``' keys); any other type raises:
there is no fallback.  Given a dry run's fake tensors
(``repro_torch/abstract.py``) it validates as for the card, launches
nothing and charges its bytes (``_charge``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import abstract
from repro_torch.kernels import _build

# key type -> the launcher's code
DTYPES = {torch.float32: 0, torch.float64: 1, torch.float16: 2,
          torch.bfloat16: 3, torch.int16: 4, torch.int32: 5, torch.int64: 6}


def _fn(name: str, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.library("topk_select"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = restype
    return fn


def _check(keys: torch.Tensor, kth: torch.Tensor, k: int, dry: bool) -> None:
    if keys.dtype not in DTYPES:
        raise TypeError(f"topk_select takes keys of {sorted(map(str, DTYPES))}, "
                        f"got {keys.dtype}")
    if keys.dim() != 2 or not keys.is_contiguous():
        raise ValueError("keys must be a contiguous 2-D tensor")
    rows, n = keys.shape
    if not 1 <= k <= n:
        raise ValueError(f"k={k} must lie in [1, {n}]")
    if (kth.shape != (rows, 1) or kth.dtype != keys.dtype
            or kth.device != keys.device):
        raise ValueError(f"kth must be ({rows}, 1) {keys.dtype} on {keys.device}, "
                         f"got {tuple(kth.shape)} {kth.dtype} on {kth.device}")
    if keys.device.type != "cuda" and not dry:
        raise ValueError(f"topk_select runs on CUDA tensors, got {keys.device}")


def topk_select(keys: torch.Tensor, kth: torch.Tensor, k: int) -> torch.Tensor:
    """``(rows, k)`` int64: each row's chosen indices, ascending, on the
    card; ``kth`` is ``(rows, 1)``, the row's k-th key (any row stride:
    ``torch.topk(...).values[:, -1:]``).  Three launches, no host wait."""
    dry = abstract.reckons_card(keys)
    _check(keys, kth, k, dry)
    rows, n = keys.shape
    out = torch.empty((rows, k), dtype=torch.int64, device=keys.device)
    if dry:
        _charge(rows, n, k, keys.element_size())
        return out
    words = _fn("topk_select_scratch_words", [ctypes.c_longlong] * 2,
                ctypes.c_longlong)(rows, n)
    scratch = torch.empty((words,), dtype=torch.int64, device=keys.device)
    fn = _fn("topk_select_launch",
             [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
             + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 3)
    err = fn(DTYPES[keys.dtype], keys.data_ptr(), kth.data_ptr(), kth.stride(0),
             rows, n, k, scratch.data_ptr(), out.data_ptr(),
             torch.cuda.current_stream(keys.device).cuda_stream)
    _build.check(err, "topk_select")
    _build.launches["topk_select"] += 1
    return out


def _charge(rows: int, n: int, k: int, size: int) -> None:
    """A dry run's call (the fake form): no launch.  Charged: the keys and
    the k-th keys read once, the indices written once (the data-free
    bound: the card's run also re-reads the units holding a chosen key)."""
    _build.charge("topk_select", rows * n * size + rows * size + rows * k * 8, {})

