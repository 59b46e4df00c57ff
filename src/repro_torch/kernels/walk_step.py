"""The fused walk kernel (``csrc/walk_steps_fused.cu``) and its plain twin.

Twin of ``repro/kernels/walk_step.py::walk_steps_fused``.  One launch runs
``chunk_steps`` supersteps for every walker and emits wide int32 event
lanes of shape ``(chunk_steps, w)``: slot (sentinel ``n_slots``), pin,
optionally board (local id) and, in batch-native ``qid`` mode, query
(sentinel ``n_queries``).  Invalid steps carry 0 in the value lanes.

Random bits arrive as ``(chunk_steps, w, 4)`` int32 tensors holding the
uint32 patterns of ``core/walk._chunk_rbits``: column 0 is the restart
draw (``< alpha_u32`` restarts), 1 the bias draw (``< beta_u32`` uses the
personalized subrange), 2 and 3 the board and pin picks.  Compares are
unsigned and the picks are masked with ``0x7FFFFFFF`` before use, in the
kernel and in the twin alike.

``walk_steps_fused`` launches the CUDA kernel and takes CUDA tensors only;
``walk_chunk_plain`` / ``walk_chunk_batched_plain`` are the plain PyTorch
twins (ports of ``ref.walk_chunk_ref`` / ``ref.walk_chunk_batched_ref``)
that the CPU runs and the card is checked against.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

RMASK = 0x7FFFFFFF
_U32 = 0xFFFFFFFF

_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int]
    + [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 4 + [ctypes.c_uint32, ctypes.c_uint32]
    + [ctypes.c_void_p] * 6
)


def _fn():
    fn = _build.library("walk_steps_fused").walk_steps_fused_launch
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_lane(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be int32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def walk_steps_fused(
    curr: torch.Tensor,
    query: torch.Tensor,
    feat: torch.Tensor,
    slot: torch.Tensor,
    rbits: torch.Tensor,
    p2b_offsets: torch.Tensor,
    p2b_targets: torch.Tensor,
    b2p_offsets: torch.Tensor,
    b2p_targets: torch.Tensor,
    p2b_feat_bounds: Optional[torch.Tensor] = None,
    b2p_feat_bounds: Optional[torch.Tensor] = None,
    qid: Optional[torch.Tensor] = None,
    *,
    n_pins: int,
    n_slots: int,
    n_boards: int,
    n_queries: int = 0,
    alpha_u32: int,
    beta_u32: int,
    count_boards: bool = False,
):
    """``chunk_steps`` fused walk supersteps in ONE kernel launch.

    Returns ``(next (w,), slot_events, pin_events, board_events | None)``,
    or with ``qid`` (``n_queries > 0``) ``(next, query_events, slot_events,
    pin_events, board_events | None)``, each event lane
    ``(chunk_steps, w)`` int32.  Every tensor must be a contiguous int32
    CUDA tensor on one device; feature ids must lie in ``[0, n_feats)``
    when both bound tables are given and ``beta_u32 > 0``.
    """
    dev = curr.device
    if dev.type != "cuda":
        raise ValueError(f"walk_steps_fused runs on CUDA tensors, got {dev}")
    if rbits.dim() != 3 or rbits.shape[2] != 4:
        raise ValueError(f"rbits must be (chunk_steps, w, 4), got {tuple(rbits.shape)}")
    chunk_steps, w = int(rbits.shape[0]), int(rbits.shape[1])
    with_query = qid is not None
    if with_query and n_queries <= 0:
        raise ValueError("qid given but n_queries not set (> 0 required)")
    walkers = [("curr", curr), ("query", query), ("feat", feat), ("slot", slot)]
    if with_query:
        walkers.append(("qid", qid))
    for name, t in walkers:
        _check_lane(name, t, (w,), dev)
    _check_lane("rbits", rbits, (chunk_steps, w, 4), dev)
    if rbits.data_ptr() % 16:
        raise ValueError("rbits must be 16-byte aligned (read as uint4)")
    _check_lane("p2b_offsets", p2b_offsets, (n_pins + 1,), dev)
    _check_lane("b2p_offsets", b2p_offsets, (n_boards + 1,), dev)
    _check_lane("p2b_targets", p2b_targets, p2b_targets.shape, dev)
    _check_lane("b2p_targets", b2p_targets, b2p_targets.shape, dev)
    use_bias = (
        p2b_feat_bounds is not None and b2p_feat_bounds is not None
        and beta_u32 > 0
    )
    fb_stride = 0
    if use_bias:
        fb_stride = int(p2b_feat_bounds.shape[1])
        _check_lane("p2b_feat_bounds", p2b_feat_bounds, (n_pins, fb_stride), dev)
        _check_lane("b2p_feat_bounds", b2p_feat_bounds, (n_boards, fb_stride), dev)
    if not (0 <= alpha_u32 <= _U32 and 0 <= beta_u32 <= _U32):
        raise ValueError("alpha_u32 and beta_u32 must be uint32 thresholds")

    lane = lambda: torch.empty((chunk_steps, w), dtype=torch.int32, device=dev)
    nxt = torch.empty((w,), dtype=torch.int32, device=dev)
    qev = lane() if with_query else None
    sev, pev = lane(), lane()
    bev = lane() if count_boards else None
    err = _fn()(
        curr.data_ptr(), query.data_ptr(), feat.data_ptr(), slot.data_ptr(),
        _ptr(qid), rbits.data_ptr(), chunk_steps, w,
        p2b_offsets.data_ptr(), p2b_targets.data_ptr(),
        b2p_offsets.data_ptr(), b2p_targets.data_ptr(),
        _ptr(p2b_feat_bounds if use_bias else None),
        _ptr(b2p_feat_bounds if use_bias else None), fb_stride,
        n_pins, n_slots, n_queries if with_query else 0,
        alpha_u32, beta_u32,
        nxt.data_ptr(), _ptr(qev), sev.data_ptr(), pev.data_ptr(), _ptr(bev),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "walk_steps_fused")
    _build.launches["walk_steps_fused"] += 1
    if with_query:
        return nxt, qev, sev, pev, bev
    return nxt, sev, pev, bev


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def _pick_edge(start, deg, r, use_b, fb, feat, rows):
    """Edge index of one hop (``_pick_edge``): the feature subrange when
    the bias draw fired and it is non-empty, else the whole slice."""
    base, span = start, torch.clamp(deg, min=1)
    if fb is not None:
        lo = fb[rows, feat]
        hi = fb[rows, feat + 1]
        sub_ok = use_b & (hi > lo)
        base = torch.where(sub_ok, start + lo, base)
        span = torch.where(sub_ok, hi - lo, span)
    return base + torch.remainder(r, span)


def walk_chunk_plain(
    curr: torch.Tensor,
    query: torch.Tensor,
    feat: torch.Tensor,
    slot: torch.Tensor,
    rbits: torch.Tensor,
    p2b_offsets: torch.Tensor,
    p2b_targets: torch.Tensor,
    b2p_offsets: torch.Tensor,
    b2p_targets: torch.Tensor,
    p2b_feat_bounds: Optional[torch.Tensor] = None,
    b2p_feat_bounds: Optional[torch.Tensor] = None,
    *,
    n_pins: int,
    n_slots: int,
    n_boards: int,
    alpha_u32: int,
    beta_u32: int,
    count_boards: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """Plain twin of the per-query kernel mode: ``(next, slot_events,
    pin_events, board_events | None)``, two-level vectorized gathers."""
    del n_boards  # shapes come from the CSR arrays
    chunk_steps, w = rbits.shape[0], rbits.shape[1]
    use_bias = (
        p2b_feat_bounds is not None and b2p_feat_bounds is not None
        and beta_u32 > 0
    )
    p2b_fb = p2b_feat_bounds if use_bias else None
    b2p_fb = b2p_feat_bounds if use_bias else None
    dev = curr.device
    rb = rbits.to(torch.int64) & _U32
    feat = feat.long()
    curr = curr.to(torch.int32)
    query = query.to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    sev = torch.full((chunk_steps, w), n_slots, dtype=torch.int32, device=dev)
    pev = torch.zeros((chunk_steps, w), dtype=torch.int32, device=dev)
    bev = torch.zeros_like(pev) if count_boards else None
    for s in range(chunk_steps):
        restart = rb[s, :, 0] < alpha_u32
        use_b = rb[s, :, 1] < beta_u32
        r_board = (rb[s, :, 2] & RMASK).to(torch.int32)
        r_pin = (rb[s, :, 3] & RMASK).to(torch.int32)
        pos = torch.where(restart, query, curr).long()

        start = p2b_offsets[pos]
        deg = p2b_offsets[pos + 1] - start
        board_ok = deg > 0
        eidx = _pick_edge(start, deg, r_board, use_b, p2b_fb, feat, pos)
        eidx = torch.where(board_ok, eidx, zero).long()
        board = p2b_targets[eidx] if p2b_targets.numel() else zero.expand(w)
        b_local = torch.where(board_ok, board - n_pins, zero).long()

        bstart = b2p_offsets[b_local]
        bdeg = b2p_offsets[b_local + 1] - bstart
        ok = board_ok & (bdeg > 0)
        bidx = _pick_edge(bstart, bdeg, r_pin, use_b, b2p_fb, feat, b_local)
        bidx = torch.where(ok, bidx, zero).long()
        pin = b2p_targets[bidx] if b2p_targets.numel() else zero.expand(w)

        curr = torch.where(ok, pin, query)
        sev[s] = torch.where(ok, slot.to(torch.int32), n_slots)
        pev[s] = torch.where(ok, pin, zero)
        if count_boards:
            bev[s] = torch.where(ok, b_local.to(torch.int32), zero)
    return curr, sev, pev, bev


def walk_chunk_batched_plain(
    curr: torch.Tensor,
    query: torch.Tensor,
    feat: torch.Tensor,
    slot: torch.Tensor,
    qid: torch.Tensor,
    rbits: torch.Tensor,
    p2b_offsets: torch.Tensor,
    p2b_targets: torch.Tensor,
    b2p_offsets: torch.Tensor,
    b2p_targets: torch.Tensor,
    p2b_feat_bounds: Optional[torch.Tensor] = None,
    b2p_feat_bounds: Optional[torch.Tensor] = None,
    *,
    n_pins: int,
    n_slots: int,
    n_queries: int,
    n_boards: int,
    alpha_u32: int,
    beta_u32: int,
    count_boards: bool = False,
):
    """Plain twin of the batch-native kernel mode: ``(next, query_events,
    slot_events, pin_events, board_events | None)``.  The walk is
    ``walk_chunk_plain``; the query lane shares the slot lane's validity."""
    nxt, sev, pev, bev = walk_chunk_plain(
        curr, query, feat, slot, rbits,
        p2b_offsets, p2b_targets, b2p_offsets, b2p_targets,
        p2b_feat_bounds, b2p_feat_bounds,
        n_pins=n_pins, n_slots=n_slots, n_boards=n_boards,
        alpha_u32=alpha_u32, beta_u32=beta_u32, count_boards=count_boards,
    )
    ok = sev != n_slots
    qev = torch.where(ok, qid.to(torch.int32)[None, :], n_queries).to(torch.int32)
    return nxt, qev, sev, pev, bev
