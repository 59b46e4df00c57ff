"""Visit-counter kernels (``csrc/visit_counter.cu``) and their plain twins.

Twins of ``repro/kernels/visit_counter.py``'s ``visit_counter``,
``visit_counter_update_high`` and ``visit_counter_wide``.

``visit_counter`` is the flat histogram: a fresh ``(n_bins,)`` int32
buffer counting the int32 ids of one event lane that lie in ``[0,
n_bins)``; every other id, negatives included, is dropped, and no events
give zeros.  ``ops.visit_counts`` is its entry point.

The other two histogram wide int32 event lanes —
(slot, id), or (query, slot, id) in batch-native mode — over flat
query-major bins ``(query * n_slots + slot) * n_dim + id``, and both add
INTO the caller's running count buffer in place: the reference returns a
fresh buffer, but at production scale the buffer is 4.5 GB and a copy per
chunk would cost more than the chunk.  An event counts iff every lane is
in range (the walk's sentinels ``n_slots`` / ``n_queries`` drop out).

``visit_counter_update_high`` also counts, per row (``bin // n_pins``),
how many bins crossed from below ``n_v`` to ``>= n_v`` in this update:
the incremental early-stop tally of Algorithm 3.  Given the caller's
running ``(n_rows,)`` int32 tally as ``high``, it adds the crossings into
it in place and returns it: one launch per counting call, where a fresh
delta would cost a fill and an add besides.  Without ``high`` it returns
a fresh delta, the reference's shape: the in-place path applied to a
zeroed tally.  Any row count is taken, as the reference's kernel takes
any: a few rows are tallied per block in shared memory, more straight
into ``high`` with global atomics (``csrc/visit_counter.cu``).

Given a dry run's fake tensors (``repro_torch/abstract.py``),
``visit_counter_update_high`` validates as for the card, launches nothing
and charges its bytes (``_charge_update_high``).

The kernel wrappers take CUDA tensors only; the ``*_plain`` functions are
the plain PyTorch twins (ports of ``ref.visit_counter_ref``,
``ref.visit_counter_update_high_ref`` and ``ref.visit_counter_wide_ref``;
the crossing tally is found from the chunk's own touched bins, not a
full-buffer reduction).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import abstract
from repro_torch.kernels import _build

SECTOR = 32        # bytes of a DRAM sector an event touches at random
_LANES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]


def _fn(name: str, argtypes):
    fn = getattr(_build.library("visit_counter"), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def _n_rows(n_slots: int, n_queries: int, query_events) -> int:
    if query_events is not None and n_queries <= 0:
        raise ValueError("query_events given but n_queries not set (> 0)")
    return n_queries * n_slots if query_events is not None else n_slots


def require_dense_bins(n_bins: int) -> None:
    """Dense counting materializes an (n_bins,) buffer: must fit int32."""
    if n_bins + 1 >= 2**31:
        raise ValueError(
            f"dense counting needs n_rows * n_dim < 2**31, got {n_bins}; "
            "id spaces past int32 need event-mode (sort-based) counting"
        )


def _check(counts, lanes, n_bins: int, kernel: str,
           dry: bool = False) -> torch.device:
    dev = counts.device
    if dev.type != "cuda" and not dry:
        raise ValueError(f"{kernel} runs on CUDA tensors, got {dev}")
    m = None
    for name, t in [("counts", counts)] + lanes:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
        if name != "counts":
            if m is not None and t.shape[0] != m:
                raise ValueError("event lanes must have one length")
            m = t.shape[0]
    if counts.shape[0] != n_bins:
        raise ValueError(f"counts has {counts.shape[0]} bins, expected {n_bins}")
    return dev


def _tally(high, n_rows: int, dev) -> torch.Tensor:
    """The caller's running tally, checked, or a fresh zeroed one."""
    if high is None:
        return torch.zeros((n_rows,), dtype=torch.int32, device=dev)
    if high.shape != (n_rows,) or high.dtype != torch.int32:
        raise ValueError(
            f"high must be ({n_rows},) int32, got {tuple(high.shape)} {high.dtype}"
        )
    if high.device != dev or not high.is_contiguous():
        raise ValueError(f"high must be a contiguous tensor on {dev}")
    return high


def visit_counter_update_high(
    counts: torch.Tensor,
    slot_events: torch.Tensor,
    pin_events: torch.Tensor,
    query_events: Optional[torch.Tensor] = None,
    *,
    n_slots: int,
    n_pins: int,
    n_v: int,
    n_queries: int = 0,
    high: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``counts += hist(events)`` in place on the card, one launch; the
    per-row crossings are added into ``high`` in place (returned), or into
    a fresh zeroed ``(n_rows,)`` int32 delta.  Requires ``n_v >= 1``."""
    if n_v < 1:
        raise ValueError(f"n_v must be >= 1 for crossing tallies, got {n_v}")
    n_rows = _n_rows(n_slots, n_queries, query_events)
    require_dense_bins(n_rows * n_pins)
    lanes = [("query_events", query_events), ("slot_events", slot_events),
             ("pin_events", pin_events)]
    dry = abstract.reckons_card(counts)
    dev = _check(counts, lanes, n_rows * n_pins, "visit_counter_update_high", dry)
    high = _tally(high, n_rows, dev)
    if dry:
        _charge_update_high(slot_events.shape[0], len([t for _, t in lanes if t is not None]),
                            n_rows)
        return high
    fn = _fn(
        "visit_counter_update_high_launch",
        _LANES + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3,
    )
    err = fn(
        None if query_events is None else query_events.data_ptr(),
        slot_events.data_ptr(), pin_events.data_ptr(), slot_events.shape[0],
        n_slots, n_pins, n_queries if query_events is not None else 0,
        min(int(n_v), 2**31 - 1), counts.data_ptr(), high.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "visit_counter_update_high")
    _build.launches["visit_counter_update_high"] += 1
    return high


def _charge_update_high(m: int, n_lanes: int, n_rows: int) -> None:
    """A dry run's call (the fake form): no launch.  Charged: the
    event lanes read once; each event's count sector read and written (a
    32-byte sector an event: the data-free bound, where the card's run
    counts the distinct sectors); the tally read and written."""
    _build.charge("visit_counter_update_high",
                4 * n_lanes * m + 2 * SECTOR * m + 2 * 4 * n_rows, {})


def visit_counter_wide(
    counts: torch.Tensor,
    slot_events: torch.Tensor,
    id_events: torch.Tensor,
    query_events: Optional[torch.Tensor] = None,
    *,
    n_slots: int,
    n_dim: int,
    n_queries: int = 0,
) -> torch.Tensor:
    """``counts += hist(events)`` in place on the card, one launch (none
    for no events); returns ``counts``.  The kernel counts a tile of events
    into a shared-memory window where the tile's bins fit one, else with
    warp-combined global atomics (``csrc/visit_counter.cu``)."""
    n_rows = _n_rows(n_slots, n_queries, query_events)
    require_dense_bins(n_rows * n_dim)
    lanes = [("query_events", query_events), ("slot_events", slot_events),
             ("id_events", id_events)]
    dev = _check(counts, lanes, n_rows * n_dim, "visit_counter_wide")
    if slot_events.shape[0] == 0:
        return counts                     # no events: no launch
    fn = _fn(
        "visit_counter_wide_launch",
        _LANES + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
    )
    err = fn(
        None if query_events is None else query_events.data_ptr(),
        slot_events.data_ptr(), id_events.data_ptr(), slot_events.shape[0],
        n_slots, n_dim, n_queries if query_events is not None else 0,
        counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "visit_counter_wide")
    _build.launches["visit_counter_wide"] += 1
    return counts


def visit_counter(events: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Histogram of ``events`` over ``[0, n_bins)`` on the card: a fresh
    ``(n_bins,)`` int32 buffer.  ``events`` is a contiguous 1-D int32 CUDA
    tensor; ids outside the range are dropped."""
    if not 0 <= n_bins < 2**31:
        raise ValueError(f"n_bins must lie in [0, 2**31), got {n_bins}")
    dev = events.device
    counts = torch.zeros((n_bins,), dtype=torch.int32, device=dev)
    _check(counts, [("events", events)], n_bins, "visit_counter")
    m = events.shape[0]
    if m == 0 or n_bins == 0:
        return counts
    fn = _fn("visit_counter_launch",
             [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_void_p])
    err = fn(events.data_ptr(), m, n_bins, counts.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "visit_counter")
    _build.launches["visit_counter"] += 1
    return counts


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def visit_counter_plain(events: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Plain twin of ``visit_counter`` (``ref.visit_counter_ref``): the
    in-range ids scatter-added into zeros."""
    valid = (events >= 0) & (events < n_bins)
    ids = events[valid].long()
    counts = torch.zeros((n_bins,), dtype=torch.int32, device=events.device)
    return counts.scatter_add_(0, ids, torch.ones_like(ids, dtype=torch.int32))


def _valid_bins(slot_events, id_events, query_events, n_slots, n_dim, n_queries):
    """Flat query-major bin ids (int64) of the valid events."""
    s = slot_events.long()
    i = id_events.long()
    valid = (s >= 0) & (s < n_slots) & (i >= 0) & (i < n_dim)
    row = s
    if query_events is not None:
        q = query_events.long()
        valid &= (q >= 0) & (q < n_queries)
        row = q * n_slots + s
    return row[valid] * n_dim + i[valid]


def visit_counter_wide_plain(
    counts: torch.Tensor,
    slot_events: torch.Tensor,
    id_events: torch.Tensor,
    query_events: Optional[torch.Tensor] = None,
    *,
    n_slots: int,
    n_dim: int,
    n_queries: int = 0,
) -> torch.Tensor:
    """Plain twin of ``visit_counter_wide``: scatter-add in place."""
    n_rows = _n_rows(n_slots, n_queries, query_events)
    require_dense_bins(n_rows * n_dim)
    bins = _valid_bins(
        slot_events, id_events, query_events, n_slots, n_dim, n_queries
    )
    counts.index_put_(
        (bins,), torch.ones_like(bins, dtype=counts.dtype), accumulate=True
    )
    return counts


def visit_counter_update_high_plain(
    counts: torch.Tensor,
    slot_events: torch.Tensor,
    pin_events: torch.Tensor,
    query_events: Optional[torch.Tensor] = None,
    *,
    n_slots: int,
    n_pins: int,
    n_v: int,
    n_queries: int = 0,
    high: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain twin of ``visit_counter_update_high``: the chunk's touched
    bins are deduplicated with their event counts, their old and new
    counts compared against ``n_v``, and the counts written back in
    place.  The ``(n_rows,)`` int32 crossing tally is added into ``high``
    in place (returned), or returned fresh."""
    if n_v < 1:
        raise ValueError(f"n_v must be >= 1 for crossing tallies, got {n_v}")
    n_rows = _n_rows(n_slots, n_queries, query_events)
    require_dense_bins(n_rows * n_pins)
    bins = _valid_bins(
        slot_events, pin_events, query_events, n_slots, n_pins, n_queries
    )
    uniq, hits = torch.unique(bins, return_counts=True)
    old = counts[uniq]
    new = old + hits.to(counts.dtype)
    counts[uniq] = new
    crossed = uniq[(old < n_v) & (new >= n_v)]
    delta = torch.bincount(crossed // n_pins, minlength=n_rows).to(torch.int32)
    if high is None:
        return delta
    return _tally(high, n_rows, counts.device).add_(delta)
