"""The plain reference the benchmark holds the served results to.

Plain PyTorch, frozen here: it imports nothing of ``jax``, of the JAX
package or of the port, and takes nothing the program made.  It works the
graph out again from the edge list (a stable ``(source, language)`` sort,
where the program runs a chunked counting sort) and walks each sampled
request with the per-query engine, one key per request:

  * keys: ``jax.random`` threefry2x32 in its partitionable mode
    (``key``, ``fold_in``, ``bits``);
  * Eq. 1-2 budgets and the walker apportionment, in float32 with the
    Cephes ``logf`` the reference package's CPU backend emits;
  * the biased walk two hops a step with its restart, Algorithm 2's
    early stop over the per-slot tally of pins seen ``n_v`` times;
  * the query-pin debit, the Eq. 3 boost (``sqrt`` in float64 rounded to
    float32, slots summed left to right in float32) and the exact top-k,
    ties to the lower pin id.

``boost_dtype=torch.bfloat16`` is the control: the same reference with
its float32 boost one precision lower.  Each chunk also reports the
visit events it counted and the distinct bins they touched, the work the
counter's roofline charges.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Tuple

import torch

MASK32 = 0xFFFFFFFF
RMASK = 0x7FFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


# ---------------------------------------------------------------------------
# threefry2x32 and the key chain
# ---------------------------------------------------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """20 rounds on int64 tensors holding uint32 values -> ``(y0, y1)``."""
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


def key(seed: int, device) -> torch.Tensor:
    """``jax.random.key(seed)`` with 64-bit types off: ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64, device=device)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    d = torch.as_tensor(data, device=k.device).to(torch.int64) & MASK32
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def bits(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits`` (uint32 values in int64); keys ``(..., 2)``."""
    shape = tuple(int(s) for s in shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=k.device)
    lead = k.shape[:-1]
    y0, y1 = threefry2x32(k[..., 0].reshape(*lead, 1), k[..., 1].reshape(*lead, 1),
                          idx >> 32, idx & MASK32)
    return (y0 ^ y1).reshape(*lead, *shape)


def request_key(server_seed: int, req_id: int, device) -> torch.Tensor:
    """A served request's stream: ``fold_in(key(server_seed), req_id)``."""
    return fold_in(key(server_seed, device), req_id)


def chunk_words(k: torch.Tensor, step_base: int, chunk_steps: int, w: int):
    """One chunk's words ``(chunk_steps, w, 4)``: step ``s`` draws
    ``bits(fold_in(k, step_base + s), (w, 4))``."""
    steps = step_base + torch.arange(chunk_steps, dtype=torch.int64, device=k.device)
    return bits(fold_in(k[None, :], steps), (w, 4))


# ---------------------------------------------------------------------------
# Eq. 1-2 in float32
# ---------------------------------------------------------------------------

_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRTHF = 0.707106781186547524


def _f32(v: float) -> float:
    return torch.tensor(v, dtype=torch.float32).item()


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """Correctly rounded float32 ``a * b + c``: the float64 sum made
    round-to-odd from its exact two-sum error, then rounded once."""
    p = a.double() * (b.double() if torch.is_tensor(b) else float(b))
    cd = c.double() if torch.is_tensor(c) else torch.full_like(p, float(c))
    s = p + cd
    bv = s - p
    err = (p - (s - bv)) + (cd - bv)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def log_f32(x: torch.Tensor) -> torch.Tensor:
    """Cephes ``logf`` with fused multiply-adds (the CPU backend's ``log``)."""
    x = x.float()
    m, e = torch.frexp(x)
    e = e.float()
    below = m < _f32(_SQRTHF)
    e = e - below.float()
    m = (m - 1.0) + torch.where(below, m, 0.0)
    x2 = m * m
    x3 = x2 * m
    p = [_f32(c) for c in _LOG_P]
    y = fma_f32(m, p[0], p[1])
    y1 = fma_f32(m, p[3], p[4])
    y2 = fma_f32(m, p[6], p[7])
    y = fma_f32(y, m, p[2])
    y1 = fma_f32(y1, m, p[5])
    y2 = fma_f32(y2, m, p[8])
    y = fma_f32(y, x3, y1)
    y = fma_f32(y, x3, y2)
    y = fma_f32(y, x3, e * _f32(_LOG_Q1))
    out = (m - x2 * 0.5) + y
    out = out + e * _f32(_LOG_Q2)
    out = torch.where(x < 2.0**-126, float("-inf"), out)
    out = torch.where(x == float("inf"), float("inf"), out)
    return torch.where((x < 0) | torch.isnan(x), float("nan"), out)


def allocate_steps(weights, degrees, max_degree: int, n_total: int) -> torch.Tensor:
    """Eq. 1 with C the largest pin degree, then Eq. 2, in float32."""
    deg = degrees.float()
    c_lit = max(float(max_degree), 1.0)
    s = deg * (torch.tensor(c_lit, device=deg.device) - log_f32(torch.clamp(deg, min=1.0)))
    s = torch.where(degrees > 0, torch.clamp(s, min=0.0), 0.0)
    w = weights.float() * s
    acc = torch.zeros_like(w[..., 0])
    for i in range(w.shape[-1]):
        acc = acc + w[..., i]
    frac = w / torch.clamp(acc, min=1e-9)[..., None]
    total = torch.tensor(float(n_total), dtype=torch.float32, device=w.device)
    n_q = torch.floor(frac * total).to(torch.int32)
    return torch.where(w > 0, torch.clamp(n_q, min=1), 0).to(torch.int32)


def allocate_walkers(n_q: torch.Tensor, n_walkers: int) -> torch.Tensor:
    """Largest-remainder split of the walker pool over the slots ->
    ``slot_of_walker (n_walkers,)``."""
    n_slots = n_q.shape[-1]
    total = torch.clamp(n_q.sum(-1, dtype=torch.int32), min=1)
    ratio = torch.tensor(float(n_walkers), device=n_q.device) / total.float()
    ideal = n_q.float() * ratio[..., None]
    base = torch.floor(ideal).to(torch.int32)
    base = torch.where(n_q > 0, torch.clamp(base, min=1), 0)
    short = n_walkers - base.sum(-1, dtype=torch.int32)
    frac = ideal - torch.floor(ideal)
    order = torch.argsort(-frac, dim=-1, stable=True)
    rank_of_slot = torch.argsort(order, dim=-1, stable=True)
    per_slot = torch.clamp(base + (rank_of_slot < short[..., None]).to(torch.int32), min=0)
    overshoot = per_slot.sum(-1, dtype=torch.int32) - n_walkers
    trim_order = torch.argsort(-per_slot, dim=-1, stable=True)
    trim_rank = torch.argsort(trim_order, dim=-1, stable=True)
    per_slot = torch.where((trim_rank < overshoot[..., None]) & (per_slot > 0),
                           per_slot - 1, per_slot)
    bounds = torch.cumsum(per_slot, dim=-1, dtype=torch.int32)
    walker = torch.arange(n_walkers, dtype=torch.int32, device=n_q.device)
    walker = walker.expand(*bounds.shape[:-1], n_walkers).contiguous()
    slot = torch.searchsorted(bounds.contiguous(), walker, right=True)
    return torch.clamp(slot, 0, n_slots - 1).to(torch.int32)


# ---------------------------------------------------------------------------
# The graph, compiled again from the edge list
# ---------------------------------------------------------------------------


class Csr(NamedTuple):
    offsets: torch.Tensor       # (n_src + 1,) int32
    targets: torch.Tensor       # (n_edges,) int32
    feat_bounds: torch.Tensor   # (n_src, n_feats + 1) int32, relative


class Graph(NamedTuple):
    p2b: Csr
    b2p: Csr
    n_pins: int
    n_boards: int
    max_pin_degree: int


def csr(src, dst, n_src: int, feat, n_feats: int, dst_base: int = 0) -> Csr:
    """Edges grouped by ``(src, feat)``, input order kept within a group
    (``np.lexsort((feat, src))``): one stable sort of the whole key."""
    wide = n_src * n_feats >= 2**31
    k = src.to(torch.int64 if wide else torch.int32) * n_feats
    k += feat
    order = torch.sort(k, stable=True).indices
    targets = torch.index_select(dst, 0, order)
    del order
    if dst_base:
        targets += dst_base
    count = torch.bincount(k, minlength=n_src * n_feats)
    del k
    end = torch.cumsum(count, 0)
    start = (end - count).view(n_src, n_feats)
    del count
    offsets = torch.empty(n_src + 1, dtype=torch.int32, device=src.device)
    offsets[:n_src] = start[:, 0]
    offsets[n_src] = src.shape[0]
    bounds = torch.empty((n_src, n_feats + 1), dtype=torch.int32, device=src.device)
    bounds[:, :n_feats] = start - start[:, :1]
    bounds[:, n_feats] = end.view(n_src, n_feats)[:, -1] - start[:, 0]
    return Csr(offsets, targets, bounds)


def compile_graph(pins, boards, pin_lang, board_lang, n_pins: int, n_boards: int,
                  n_feats: int) -> Graph:
    """Both directions: pin -> global board id sorted by the board's
    language, board -> pin sorted by the pin's language."""
    p2b = csr(pins, boards, n_pins, torch.index_select(board_lang, 0, boards), n_feats,
              n_pins)
    b2p = csr(boards, pins, n_boards, torch.index_select(pin_lang, 0, pins), n_feats)
    deg = p2b.offsets[1:] - p2b.offsets[:-1]
    return Graph(p2b, b2p, int(n_pins), int(n_boards), int(deg.max()) if deg.numel() else 0)


# ---------------------------------------------------------------------------
# The walk, one query at a time
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Walk:
    n_steps: int
    n_walkers: int
    chunk_steps: int
    alpha: float
    n_p: int
    n_v: int
    bias_beta: float
    top_k: int

    def max_chunks(self) -> int:
        return max(1, -(-self.n_steps // (self.n_walkers * self.chunk_steps)))


def prob_u32(p: float) -> int:
    return max(0, min(int(round(p * 2.0**32)), 2**32 - 1))


def _pick(start, deg, r, use_b, fb, feat, rows):
    base, span = start, torch.clamp(deg, min=1)
    lo = fb[rows, feat]
    hi = fb[rows, feat + 1]
    sub = use_b & (hi > lo)
    base = torch.where(sub, start + lo, base)
    span = torch.where(sub, hi - lo, span)
    return base + torch.remainder(r, span)


def walk_chunk(g: Graph, curr, query, feat, slot, words, n_slots: int,
               alpha_u32: int, beta_u32: int):
    """``chunk_steps`` steps of ``w`` walkers -> ``(curr, slot_events,
    pin_events)``; a step that finds no edge records no visit (slot
    ``n_slots``) and restarts at the query pin."""
    chunk_steps, w = words.shape[0], words.shape[1]
    dev = curr.device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    feat = feat.long()
    sev = torch.full((chunk_steps, w), n_slots, dtype=torch.int32, device=dev)
    pev = torch.zeros((chunk_steps, w), dtype=torch.int32, device=dev)
    p2b, b2p = g.p2b, g.b2p
    for s in range(chunk_steps):
        restart = words[s, :, 0] < alpha_u32
        use_b = words[s, :, 1] < beta_u32
        r_board = (words[s, :, 2] & RMASK).to(torch.int32)
        r_pin = (words[s, :, 3] & RMASK).to(torch.int32)
        pos = torch.where(restart, query, curr).long()
        start = p2b.offsets[pos]
        deg = p2b.offsets[pos + 1] - start
        board_ok = deg > 0
        e = torch.where(board_ok, _pick(start, deg, r_board, use_b, p2b.feat_bounds, feat, pos),
                        zero).long()
        b_local = torch.where(board_ok, p2b.targets[e] - g.n_pins, zero).long()
        bstart = b2p.offsets[b_local]
        bdeg = b2p.offsets[b_local + 1] - bstart
        ok = board_ok & (bdeg > 0)
        e = torch.where(ok, _pick(bstart, bdeg, r_pin, use_b, b2p.feat_bounds, feat, b_local),
                        zero).long()
        pin = b2p.targets[e]
        curr = torch.where(ok, pin, query)
        sev[s] = torch.where(ok, slot, n_slots)
        pev[s] = torch.where(ok, pin, zero)
    return curr, sev, pev


def count_chunk(counts, high, sev, pev, n_slots: int, n_pins: int, n_v: int):
    """Fold one chunk's events into the flat ``(n_slots * n_pins,)`` counts
    and the per-slot tally of bins crossing ``n_v``, in place; returns
    ``(valid events, distinct bins)``."""
    s = sev.reshape(-1).long()
    p = pev.reshape(-1).long()
    valid = (s >= 0) & (s < n_slots) & (p >= 0) & (p < n_pins)
    bins = s[valid] * n_pins + p[valid]
    uniq, hits = torch.unique(bins, return_counts=True)
    old = counts[uniq]
    new = old + hits.to(counts.dtype)
    counts[uniq] = new
    crossed = uniq[(old < n_v) & (new >= n_v)]
    high += torch.bincount(crossed // n_pins, minlength=n_slots).to(torch.int32)
    return int(bins.numel()), int(uniq.numel())


class Answer(NamedTuple):
    scores: torch.Tensor      # (top_k,) float32
    ids: torch.Tensor         # (top_k,) int32
    steps_taken: torch.Tensor  # (n_slots,) int32
    n_high: torch.Tensor       # (n_slots,) int32
    chunks: List[Tuple[int, int]]  # per chunk run: (valid events, distinct bins)


def walk_counts(g: Graph, pins, weights, feat: int, k: torch.Tensor, cfg: Walk):
    """Algorithms 2-3 for one query -> ``(counts (n_slots, n_pins),
    steps_taken, n_high, chunks)``, the query pins' counts debited."""
    dev = g.p2b.offsets.device
    pins = torch.as_tensor(pins, device=dev).to(torch.int32)
    weights = torch.as_tensor(weights, device=dev).float()
    n_slots = int(pins.shape[0])
    valid_q = (pins >= 0) & (weights > 0)
    safe_q = torch.where(valid_q, pins, 0)
    degs = (g.p2b.offsets[safe_q.long() + 1] - g.p2b.offsets[safe_q.long()]) * valid_q
    n_q = allocate_steps(torch.where(valid_q, weights, 0.0), degs, g.max_pin_degree,
                         cfg.n_steps)
    slot_of_walker = allocate_walkers(n_q, cfg.n_walkers)
    query_of_walker = safe_q[slot_of_walker.long()]
    per_slot = torch.zeros_like(n_q).scatter_add_(0, slot_of_walker.long(),
                                                  torch.ones_like(slot_of_walker))
    feat_w = torch.full((cfg.n_walkers,), int(feat), dtype=torch.int32, device=dev)
    counts = torch.zeros(n_slots * g.n_pins, dtype=torch.int32, device=dev)
    high = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    steps = torch.zeros(n_slots, dtype=torch.int32, device=dev)
    active = valid_q.clone()
    curr = query_of_walker.clone()
    alpha_u32, beta_u32 = prob_u32(cfg.alpha), prob_u32(cfg.bias_beta)
    chunks = []
    it = 0
    while it < cfg.max_chunks() and bool(active.any()):
        walker_active = active[slot_of_walker.long()]
        words = chunk_words(k, it * cfg.chunk_steps, cfg.chunk_steps, cfg.n_walkers)
        curr2, sev, pev = walk_chunk(g, curr, query_of_walker, feat_w, slot_of_walker,
                                     words, n_slots, alpha_u32, beta_u32)
        curr = torch.where(walker_active, curr2, curr)
        sev = torch.where(walker_active[None, :], sev, n_slots)
        chunks.append(count_chunk(counts, high, sev, pev, n_slots, g.n_pins, cfg.n_v))
        steps += per_slot * active.to(torch.int32) * cfg.chunk_steps
        active = valid_q & (steps < n_q) & (high <= cfg.n_p)
        it += 1
    rows = counts.view(n_slots, g.n_pins)
    r = torch.arange(n_slots, device=dev)
    reached = (rows[r, safe_q.long()] >= cfg.n_v).to(torch.int32)
    rows[r, safe_q.long()] = 0
    return rows, steps, high - reached, chunks


def boost(rows: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Eq. 3, ``(sum_s sqrt(V_s))**2``: each root in float64 rounded to
    ``dtype``, the slots summed left to right and squared in ``dtype``."""
    acc = None
    for s in range(rows.shape[0]):
        root = torch.sqrt(rows[s].double()).to(dtype)
        acc = root if acc is None else acc + root
    return (acc * acc).float()


def topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of a row, descending, ties to the lower index."""
    rows = x.reshape(1, -1)
    kth = torch.topk(rows, k, dim=-1, sorted=True).values[:, -1:]
    above = rows > kth
    ties = rows == kth
    need = k - above.sum(-1, keepdim=True)
    take = above | (ties & (torch.cumsum(ties, dim=-1) <= need))
    idx = take.nonzero()[:, 1].reshape(-1, k)
    top, perm = torch.sort(torch.gather(rows, 1, idx), dim=-1, descending=True, stable=True)
    return top[0], torch.gather(idx, 1, perm)[0].to(torch.int32)


def recommend(g: Graph, pins, weights, feat: int, k: torch.Tensor, cfg: Walk,
              boost_dtype=torch.float32, rank: bool = True) -> Answer:
    """One request, walk to top-k.  ``rank=False`` stops after the walk
    (scores and ids empty): the work counts alone."""
    rows, steps, n_high, chunks = walk_counts(g, pins, weights, feat, k, cfg)
    if not rank:
        empty = torch.empty(0)
        return Answer(empty, empty, steps.cpu(), n_high.cpu(), chunks)
    scores, ids = topk(boost(rows, boost_dtype), cfg.top_k)
    return Answer(scores.cpu(), ids.cpu(), steps.cpu(), n_high.cpu(), chunks)


def walk_from(config: dict) -> Walk:
    w = config["walk"]
    return Walk(n_steps=w["n_steps"], n_walkers=w["n_walkers"],
                chunk_steps=w["chunk_steps"], alpha=w["alpha"], n_p=w["n_p"],
                n_v=w["n_v"], bias_beta=w["bias_beta"], top_k=w["top_k"])
