"""The walk kernels (``csrc/walk_steps_fused.cu``, ``csrc/walk_hop.cu``,
``csrc/walk_step.cu``, ``csrc/walk_bits.cu``) and their plain twins.

Twin of ``repro/kernels/walk_step.py::walk_steps_fused``.  One launch runs
``chunk_steps`` supersteps for every walker and emits wide int32 event
lanes of shape ``(chunk_steps, w)``: slot (sentinel ``n_slots``), pin,
optionally board (local id) and, in batch-native ``qid`` mode, query
(sentinel ``n_queries``).  Invalid steps carry 0 in the value lanes.

The walk's random words are four uint32 per walker and step: column 0 is
the restart draw (``< alpha_u32`` restarts), 1 the bias draw (``<
beta_u32`` uses the personalized subrange), 2 and 3 the board and pin
picks.  Compares are unsigned and the picks are masked with
``0x7FFFFFFF`` before use, in the kernels and in the twins alike.  Step
``s`` of walker element ``i`` under key ``k`` draws
``bits(fold_in(k, step_base + s), (w, 4))[i]`` (jax.random's threefry2x32,
partitionable): ``core/walk._chunk_rbits`` builds a chunk's
``(chunk_steps, n, 4)`` table of them in torch, ``walk_bits`` on the card
in one launch (``csrc/threefry.cuh``), and
``walk_steps_fused`` draws them in registers from the keys: it takes the
keys, never a table.  Keys are uint32 word pairs held as int32 bit
patterns on the kernel side: one ``(2,)`` key for every walker, or ``(Q,
2)`` per-query keys with the walkers laid out query-major (walker ``q * w
+ i`` draws element ``i`` under ``keys[q]``).

``walk_steps_fused`` launches the CUDA kernel and takes CUDA tensors only;
``walk_chunk_plain`` / ``walk_chunk_batched_plain`` are the plain PyTorch
twins (ports of ``ref.walk_chunk_ref`` / ``ref.walk_chunk_batched_ref``)
that the CPU runs and the card is checked against, fed the table of
``_chunk_rbits``.

``walk_hop_fused`` is the sharded engine's half step (twin of the
reference's ``walk_hop_fused``): one CSR hop for the routed walkers of
every co-located shard in ONE launch, the walker buffers stacked
``(n_shards, L)`` over ``(n_shards, rows + 1)`` / ``(n_shards, E_max)``
CSR slices.  It reads each hopping lane's word from the chunk's table by
the lane's walker id.  ``walk_hop_ref`` is its plain twin (port of
``ref.walk_hop_ref``), which takes the words pre-gathered.

``walk_step`` is the legacy unbiased one-superstep walk (twin of the
reference's ``walk_step``): for ``(w,)`` walkers and ``(w, 3)`` uint32
words (restart, board pick, pin pick) it returns ``(next, visited, ok)``;
a dead end gives ``next = query``, ``visited = 0``, ``ok = False``.
``walk_step_plain`` is its plain twin (port of ``ref.walk_step_ref``).
Unlike the reference, any walker count is accepted: its multiple-of-256
rule was the TPU kernel's block size.

All three walk kernels pick an edge with one piece of code
(``csrc/pick_edge.cuh``).

**Fake forms.**  Given a dry run's fake tensors (``repro_torch/abstract.py``),
``walk_bits``, ``walk_steps_fused`` and ``walk_hop_fused`` validate as
they do for the card, return outputs of the kernel's shapes and dtypes,
never call into the library, and charge the kernel's own work
(``_build.charge``, the terms of PERF.md §6): inputs and outputs once, one
32-byte sector per dependent random read, and ``THREEFRY_OPS`` 32-bit
operations per threefry block.  The formulas stand beside each wrapper.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import abstract
from repro_torch.kernels import _build

# the fake forms' terms: one threefry2x32 block is 20 rounds of add,
# rotate and xor, 10 key injections and 2 initial key adds (72 32-bit
# operations), and a word adds its y0 ^ y1; a random read touches one
# 32-byte DRAM sector
THREEFRY_OPS = 72
SECTOR = 32

RMASK = 0x7FFFFFFF
_U32 = 0xFFFFFFFF
_MAX_GRID_Y = 65535

_ARGTYPES = (
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_uint32, ctypes.c_int,
                             ctypes.c_int]
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


def _check_lane(name: str, t: torch.Tensor, shape, device,
                dtype=torch.int32) -> None:
    """Device, dtype, shape (unless None) and contiguity of one input."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _hop_fn():
    fn = _build.library("walk_hop").walk_hop_fused_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_int]
            + [ctypes.c_void_p] * 3
        )
        fn.restype = ctypes.c_int
    return fn


def _bits_fn():
    fn = _build.library("walk_bits").walk_bits_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _step_fn():
    fn = _build.library("walk_step").walk_step_launch
    if fn.argtypes is None:
        fn.argtypes = (
            [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_uint32]
            + [ctypes.c_void_p] * 4
        )
        fn.restype = ctypes.c_int
    return fn


def u32_bits_as_int32(r: torch.Tensor) -> torch.Tensor:
    """uint32 words as int32 bit patterns: int32 passes, int64 values in
    ``[0, 2**32)`` wrap, torch.uint32 is reinterpreted."""
    if r.dtype == torch.int64:
        return (r & _U32).to(torch.int32)
    if r.dtype == torch.uint32:
        return r.view(torch.int32)
    return r


def threefry_ops(n_keys: int, walkers: int, chunk_steps: int) -> int:
    """32-bit operations of a chunk's threefry words: a step key per key
    and step, then four words per walker and step (two blocks, each word
    one xor more)."""
    return chunk_steps * (n_keys * THREEFRY_OPS + 4 * walkers * (THREEFRY_OPS + 1))


def _check_keys(keys: torch.Tensor, dev) -> int:
    """A ``(2,)`` key or ``(Q, 2)`` per-query keys as int32 bit patterns,
    8-byte aligned (read as one uint2); returns Q (1 for one key)."""
    if keys.dim() not in (1, 2) or keys.shape[-1] != 2 or keys.numel() == 0:
        raise ValueError(f"keys must be (2,) or (Q, 2), got {tuple(keys.shape)}")
    _check_lane("keys", keys, keys.shape, dev)
    if not abstract.reckons_card(keys) and keys.data_ptr() % 8:
        raise ValueError("keys must be 8-byte aligned (read as uint2)")
    return 1 if keys.dim() == 1 else int(keys.shape[0])


def walk_bits(
    keys: torch.Tensor, step_base: int, chunk_steps: int, w: int
) -> torch.Tensor:
    """One chunk's word table in ONE kernel launch: ``core/walk._chunk_rbits``
    on the card.

    ``keys`` is one ``(2,)`` key -> ``(chunk_steps, w, 4)``, or ``(Q, 2)``
    per-query keys -> ``(chunk_steps, Q * w, 4)`` laid out query-major; the
    keys are contiguous int32 CUDA tensors holding the uint32 words' bit
    patterns, and the table holds the words' bit patterns as int32.
    """
    dev = keys.device
    if dev.type != "cuda" and not abstract.reckons_card(keys):
        raise ValueError(f"walk_bits runs on CUDA tensors, got {dev}")
    n_keys = _check_keys(keys, dev)
    if not 0 <= chunk_steps <= _MAX_GRID_Y or w < 0:
        raise ValueError(f"chunk_steps must lie in [0, {_MAX_GRID_Y}] and w >= 0")
    n = n_keys * w
    if 4 * n >= 2**31:
        raise ValueError(f"{n} walkers overflow the kernel's int32 walker index")
    out = torch.empty((chunk_steps, n, 4), dtype=torch.int32, device=dev)
    if out.numel() == 0:
        return out
    if abstract.reckons_card(keys):
        # the keys read, the table written; the table's threefry blocks
        _build.charge("walk_bits", 8 * n_keys + 4 * out.numel(),
                    {"int32": threefry_ops(n_keys, n, chunk_steps)})
        return out
    err = _bits_fn()(
        keys.data_ptr(), w, step_base & _U32, chunk_steps, n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "walk_bits")
    _build.launches["walk_bits"] += 1
    return out


def walk_steps_fused(
    curr: torch.Tensor,
    query: torch.Tensor,
    feat: torch.Tensor,
    slot: torch.Tensor,
    keys: torch.Tensor,
    p2b_offsets: torch.Tensor,
    p2b_targets: torch.Tensor,
    b2p_offsets: torch.Tensor,
    b2p_targets: torch.Tensor,
    p2b_feat_bounds: Optional[torch.Tensor] = None,
    b2p_feat_bounds: Optional[torch.Tensor] = None,
    qid: Optional[torch.Tensor] = None,
    *,
    step_base: int,
    chunk_steps: int,
    n_pins: int,
    n_slots: int,
    n_boards: int,
    n_queries: int = 0,
    alpha_u32: int,
    beta_u32: int,
    count_boards: bool = False,
):
    """``chunk_steps`` fused walk supersteps in ONE kernel launch, the
    walk's words drawn in the kernel from ``keys`` at steps ``step_base +
    s``: the lanes the twins give for ``core/walk._chunk_rbits(keys,
    step_base, chunk_steps, w // Q)``.

    ``keys`` is one ``(2,)`` key for every walker (per-query mode) or ``(Q,
    2)`` per-query keys over query-major walkers (``w`` a multiple of Q),
    as int32 bit patterns.  Returns ``(next (w,), slot_events, pin_events,
    board_events | None)``, or with ``qid`` (``n_queries > 0``) ``(next,
    query_events, slot_events, pin_events, board_events | None)``, each
    event lane ``(chunk_steps, w)`` int32.  Every tensor must be a
    contiguous int32 CUDA tensor on one device; feature ids must lie in
    ``[0, n_feats)`` when both bound tables are given and ``beta_u32 > 0``.
    """
    dev = curr.device
    if dev.type != "cuda" and not abstract.reckons_card(curr):
        raise ValueError(f"walk_steps_fused runs on CUDA tensors, got {dev}")
    w = int(curr.shape[0])
    n_keys = _check_keys(keys, dev)
    if w % n_keys:
        raise ValueError(f"{w} walkers do not split evenly over {n_keys} keys")
    if chunk_steps < 0:
        raise ValueError(f"chunk_steps must be >= 0, got {chunk_steps}")
    with_query = qid is not None
    if with_query and n_queries <= 0:
        raise ValueError("qid given but n_queries not set (> 0 required)")
    walkers = [("curr", curr), ("query", query), ("feat", feat), ("slot", slot)]
    if with_query:
        walkers.append(("qid", qid))
    for name, t in walkers:
        _check_lane(name, t, (w,), dev)
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
    if abstract.reckons_card(curr):
        # walker lanes read and the next pins written once, the event lanes
        # written once, the keys read; per walker and step four dependent
        # CSR reads (pin offsets, pin target, board offsets, board target)
        # and two bound reads when biased; four threefry words
        n_lanes = sum(x is not None for x in (qev, sev, pev, bev))
        reads = 4 + (2 if use_bias else 0)
        nbytes = (4 * (len(walkers) + 1) * w + 8 * n_keys
                  + 4 * n_lanes * chunk_steps * w + SECTOR * reads * chunk_steps * w)
        _build.charge("walk_steps_fused", nbytes,
                    {"int32": threefry_ops(n_keys, w, chunk_steps)})
        return (nxt, qev, sev, pev, bev) if with_query else (nxt, sev, pev, bev)
    err = _fn()(
        curr.data_ptr(), query.data_ptr(), feat.data_ptr(), slot.data_ptr(),
        _ptr(qid), keys.data_ptr(), w // n_keys, step_base & _U32,
        chunk_steps, w,
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


def walk_hop_fused(
    pos: torch.Tensor,
    gate: torch.Tensor,
    table: torch.Tensor,
    step: int,
    column: int,
    walker: torch.Tensor,
    row_base: torch.Tensor,
    offsets: torch.Tensor,
    targets: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ONE walk hop for every co-located shard in one kernel launch.

    ``pos`` (n_shards, L) int32 global node ids, ``gate`` (n_shards, L)
    bool (lanes allowed to hop), ``walker`` (n_shards, L) int32 walker ids,
    ``table`` the chunk's (chunk_steps, n, 4) int32 word table
    (``walk_bits``): a gated lane's edge-pick word is ``table[step,
    walker, column]``; ``row_base`` (n_shards,) int32 first global id each
    slice owns, ``offsets`` (n_shards, rows + 1) and ``targets``
    (n_shards, E_max) int32 shard-local CSR slices.  One shard may also
    come unstacked: ``pos``/``gate``/``walker`` (L,), ``offsets`` (rows +
    1,), ``targets`` (E,), ``row_base`` (1,).

    Returns ``(tgt, ok)`` shaped like ``pos``: the sampled neighbour where
    ``ok`` (= gate and the row has edges), 0 elsewhere.  Every tensor must
    be a contiguous CUDA tensor on one device; a gated lane's ``pos`` must
    lie in ``[row_base, row_base + rows)`` and its walker id in ``[0, n)``;
    a gated-off lane's may be anything.
    """
    dev = pos.device
    if dev.type != "cuda" and not abstract.reckons_card(pos):
        raise ValueError(f"walk_hop_fused runs on CUDA tensors, got {dev}")
    if pos.dim() not in (1, 2) or offsets.dim() != pos.dim() or (
            targets.dim() != pos.dim()):
        raise ValueError(
            "walk_hop_fused takes stacked (n_shards, L) lanes over (n_shards, "
            "rows + 1) / (n_shards, E) slices, or one unstacked shard"
        )
    shape = tuple(pos.shape)
    n_shards = shape[0] if pos.dim() == 2 else 1
    _check_lane("pos", pos, shape, dev)
    _check_lane("gate", gate, shape, dev, dtype=torch.bool)
    _check_lane("walker", walker, shape, dev)
    if table.dim() != 3 or table.shape[2] != 4:
        raise ValueError(f"table must be (chunk_steps, n, 4), got {tuple(table.shape)}")
    _check_lane("table", table, None, dev)
    if not (0 <= step < table.shape[0] and 0 <= column < 4):
        raise ValueError(
            f"step {step} / column {column} outside a {tuple(table.shape)} table")
    _check_lane("row_base", row_base, (n_shards,), dev)
    _check_lane("offsets", offsets, None, dev)
    _check_lane("targets", targets, None, dev)
    if pos.dim() == 2 and (offsets.shape[0] != n_shards
                           or targets.shape[0] != n_shards):
        raise ValueError(
            f"offsets and targets must stack {n_shards} shard slices, got "
            f"{tuple(offsets.shape)} and {tuple(targets.shape)}"
        )
    out = torch.empty(shape, dtype=torch.int32, device=dev)
    ok = torch.empty(shape, dtype=torch.bool, device=dev)
    if abstract.reckons_card(pos):
        # pos, gate and walker read, out and ok written once a lane, the
        # row bases read; every lane gated (the data-free bound): its word,
        # its offset pair and its target, three dependent random reads
        lanes = pos.numel()
        _build.charge("walk_hop_fused", lanes * (4 + 1 + 4 + 4 + 1) + 4 * n_shards
                    + SECTOR * 3 * lanes, {})
        return out, ok
    words = table[step, :, column]           # a view: its first word's address
    err = _hop_fn()(
        pos.data_ptr(), gate.data_ptr(), words.data_ptr(), walker.data_ptr(),
        row_base.data_ptr(), offsets.data_ptr(), offsets.shape[-1],
        targets.data_ptr(), targets.shape[-1], n_shards, shape[-1],
        out.data_ptr(), ok.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "walk_hop_fused")
    _build.launches["walk_hop_fused"] += 1
    return out, ok


def walk_step(
    curr: torch.Tensor,
    query: torch.Tensor,
    rbits: torch.Tensor,
    p2b_offsets: torch.Tensor,
    p2b_targets: torch.Tensor,
    b2p_offsets: torch.Tensor,
    b2p_targets: torch.Tensor,
    *,
    n_pins: int,
    alpha_u32: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One unbiased superstep for every walker in ONE kernel launch ->
    ``(next, visited, ok)``, int32, int32 and bool, each ``(w,)``.

    ``curr`` and ``query`` are ``(w,)`` int32 pins in ``[0, n_pins)``,
    ``rbits`` ``(w, 3)`` int32 holding the uint32 bit patterns of the
    restart, board and pin words; a walker restarts iff ``rbits[:, 0] <
    alpha_u32`` as uint32.  Every tensor must be a contiguous CUDA tensor
    on one device; board targets are global ids (``>= n_pins``).
    """
    dev = curr.device
    if dev.type != "cuda":
        raise ValueError(f"walk_step runs on CUDA tensors, got {dev}")
    w = int(curr.shape[0])
    _check_lane("curr", curr, (w,), dev)
    _check_lane("query", query, (w,), dev)
    _check_lane("rbits", rbits, (w, 3), dev)
    _check_lane("p2b_offsets", p2b_offsets, (n_pins + 1,), dev)
    _check_lane("p2b_targets", p2b_targets, None, dev)
    _check_lane("b2p_offsets", b2p_offsets, None, dev)
    _check_lane("b2p_targets", b2p_targets, None, dev)
    if not 0 <= alpha_u32 <= _U32:
        raise ValueError("alpha_u32 must be a uint32 threshold")
    nxt = torch.empty((w,), dtype=torch.int32, device=dev)
    visited = torch.empty((w,), dtype=torch.int32, device=dev)
    ok = torch.empty((w,), dtype=torch.bool, device=dev)
    if w == 0:
        return nxt, visited, ok
    err = _step_fn()(
        curr.data_ptr(), query.data_ptr(), rbits.data_ptr(),
        p2b_offsets.data_ptr(), p2b_targets.data_ptr(),
        b2p_offsets.data_ptr(), b2p_targets.data_ptr(), w, n_pins,
        alpha_u32, nxt.data_ptr(), visited.data_ptr(), ok.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "walk_step")
    _build.launches["walk_step"] += 1
    return nxt, visited, ok


# ---------------------------------------------------------------------------
# Plain PyTorch twins
# ---------------------------------------------------------------------------


def _take_clamped(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[idx]`` with ``idx`` clamped into range (0 for an empty ``a``):
    the reads the reference's gather makes at a dead end, whose values
    every caller masks."""
    if a.numel() == 0:
        return torch.zeros_like(idx, dtype=a.dtype)
    return a[idx.clamp(0, a.numel() - 1)]


def walk_step_plain(
    curr: torch.Tensor,
    query: torch.Tensor,
    rbits: torch.Tensor,
    p2b_offsets: torch.Tensor,
    p2b_targets: torch.Tensor,
    b2p_offsets: torch.Tensor,
    b2p_targets: torch.Tensor,
    *,
    n_pins: int,
    alpha_u32: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of ``walk_step`` (``ref.walk_step_ref``): ``(next,
    visited, ok)``.  ``rbits`` holds uint32 words as int32 bit patterns,
    int64 values or torch.uint32; the picks are masked with
    ``0x7FFFFFFF`` before use.  Reads at a dead end are clamped."""
    rb = u32_bits_as_int32(rbits).long() & _U32
    curr = curr.to(torch.int32)
    query = query.to(torch.int32)
    pos = torch.where(rb[:, 0] < alpha_u32, query, curr).long()
    r_board = rb[:, 1] & RMASK
    r_pin = rb[:, 2] & RMASK

    start = p2b_offsets[pos].long()
    deg = p2b_offsets[pos + 1].long() - start
    board = _take_clamped(p2b_targets, start + r_board % deg.clamp(min=1))
    board_ok = deg > 0
    b_local = torch.where(board_ok, board.long() - n_pins, 0)
    bstart = _take_clamped(b2p_offsets, b_local).long()
    bdeg = _take_clamped(b2p_offsets, b_local + 1).long() - bstart
    pin = _take_clamped(b2p_targets, bstart + r_pin % bdeg.clamp(min=1))
    ok = board_ok & (bdeg > 0)
    nxt = torch.where(ok, pin.to(torch.int32), query)
    visited = torch.where(ok, pin.to(torch.int32), 0).to(torch.int32)
    return nxt, visited, ok


def walk_hop_ref(
    pos: torch.Tensor,
    gate: torch.Tensor,
    r: torch.Tensor,
    offsets: torch.Tensor,
    targets: torch.Tensor,
    row_base,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``walk_hop_fused`` (``ref.walk_hop_ref``'s order of
    arguments): ``local = pos - row_base`` where ``gate`` (else 0), ``ok =
    gate & deg > 0``, ``tgt = targets[start + (r & 0x7FFFFFFF) % deg]``
    where ``ok``, else 0.  Leading shard axes ride along: ``pos`` (..., L)
    over ``offsets`` (..., rows + 1) and ``targets`` (..., E), one
    ``row_base`` per leading index.  ``r`` holds uint32 values, as int32
    bit patterns or int64."""
    gate = gate.to(torch.bool)
    base = torch.as_tensor(row_base, dtype=torch.int32, device=pos.device)
    base = base.reshape(*pos.shape[:-1], 1)
    local = torch.where(gate, pos.to(torch.int32) - base, 0).long()
    start = torch.gather(offsets, -1, local)
    deg = torch.gather(offsets, -1, local + 1) - start
    ok = gate & (deg > 0)
    pick = r.long() & RMASK
    eidx = torch.where(ok, start + pick % deg.clamp(min=1), 0)
    if targets.shape[-1] == 0:
        return torch.zeros_like(pos, dtype=torch.int32), ok
    tgt = torch.gather(targets, -1, eidx)
    return torch.where(ok, tgt, 0).to(torch.int32), ok


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
