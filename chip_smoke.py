#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one GPU and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and reported ok):

 1. build    nvcc-compiles every kernel in src/repro_torch/kernels/csrc
             (one process per source, all at once) into build/.
 2. serve    the serve_200m_replicated graph (140M pins, 60M boards, 1.2B
             edges, 4 edge languages) drawn uniformly on the card from a
             seeded generator and compiled by the port's build_graph;
             requests answered by PixieServer(buckets=[(1, 8)]) under the
             full production walk (FULL_WALK); p50 latency and per-phase
             times printed.  Kernel launch counts are reset before and read
             after this run.  Then one more request under torch.profiler:
             the device's busy and idle share and its time by kernel (the
             trace goes to chiprun_out/chip_smoke_trace.json).
 3. parity   the same requests through serve_batch with backend="xla" (the
             plain PyTorch twins, on the card): ids, scores, steps_taken and
             n_high must be bit-identical to the kernel path.
 4. batched  synthetic.generate(20k pins, 2k boards, 16 topics, 4 langs,
             seed 7); 32 board-rec requests (count_boards on) through
             buckets [(16, 4), (8, 8)]: the batch-native qid lanes and the
             visit_counter_wide kernel; checked against the plain path.
 5. kernels  each kernel against its plain twin at the main path's shapes
             (exact match), timed with CUDA events beside its twin, its
             bandwidth bound and, for the counters, torch's index_add_;
             visit_counter_update_high timed as the path calls it (the
             crossings added into a running tally in place, one launch),
             its old three-launch sequence (zeroed delta, kernel, add)
             logged beside it.
             Each bound counts the distinct 32-byte sectors the run's own
             inputs touch (repeat reads of a row are L2 hits), plus the
             lanes and walker state read or written once.
 6. ranked   on the same graph, the reference's default ranker
             (RankerConfig(n_items=140M): d_model 32, 8 neighbors, 64
             candidates, final 16, two scenario heads), its 17.9 GB item
             table drawn on the card from a seeded generator after the
             graph build has freed its scratch; the 24 requests through
             PixieServer(ranker=...) with alternating scenarios, every
             result held against the plain path (walk twins plus the bag
             twin): ids, scores, steps_taken and n_high bit-identical.
             p50/max latency and one request's split (retrieval,
             neighborhoods, bags, heads, top-k).
 7. open     run_open_loop on that ranked replica: 200 Poisson requests
             offered at half of 1000 / p50 ms, admission-bounded
             (ResilienceConfig(elastic=False, max_queue_per_bucket=8));
             achieved QPS, p50/p99, the wait/compute split, drops and
             rejections.
 8. bag      the embedding-bag kernel against its twin, bit for bit, at the
             ranked path's shapes (a (1, 64, 8) neighbor bag and a (1, 1,
             64) query bag over the 140M x 32 table) and at edge shapes
             (bf16, d = 48, bag size 1, an all-padding bag, 37 bags, sum
             and mean); device ms beside the twin, the byte bound and
             torch's F.embedding_bag(mode="sum") on the same bags (which
             omits the mean's division).
 9. users    on the 20k graph: ranked buckets (16, 4) and (8, 8) with
             mixed scenarios, both walk backends identical and equal to
             the single-bucket flush oracle; submit_user users equal to
             per-cluster walks merged by merge_interest_topk, and
             recommend_multi_interest(rank=...) equal to those merged
             lanes ranked.
10. chaos    on the 20k retrieval replica with elastic resilience: one
             seeded ChaosConfig (latency spikes, traffic bursts) run twice
             must give identical results and budgets; a zero-fault
             schedule must equal the plain open-loop run bit for bit.

11. sharded the same full-width graph sliced on the card into 16 node-range
             shards (the serve_3b_sharded recipe's shard count), after the
             17.9 GB item table is freed; per-shard sizes, the sharded
             copy's GB, resident and peak memory, and the cuts (140M / 60M
             / 1.2B instead of 2B / 1B / 17B; 16 shards on one card).
12. sh-parity the 8 one- and two-pin requests through serve_batch on the
             sharded graph (FULL_WALK with bias_beta=0, LocalFabric(16),
             slack 32): no walker dropped, early stop fired, and ids,
             scores, steps_taken and n_high bit-identical to serve_batch on
             the replicated graph with the same keys.
13. recipe   pixie_walk_sharded with SHARDED_WALK (24 supersteps, 512
             walkers per shard, slack 2.0) for 8 requests: p50/max, drops
             and max occupancy; the batched engine's kernel path equals its
             plain path (counts, stats, drops, occupancy) and the entry
             point's top-k.
14. replica  PixieServer on the sharded graph: 24 requests (p50/max), then
             kill_shard(3, at_superstep=8) (killed > 0, results equal to
             serve_batch(shard_dead_at=...), overlap@k against the healthy
             run), then revive_shards() (equal to the healthy run), then
             one request under torch.profiler (the trace goes to
             chiprun_out/chip_smoke_sharded_trace.json); a seeded
             run_open_loop with two shard deaths replays identically
             twice.
15. hop      the walk_hop kernel against its twin on the exact routed
             buffers of superstep 8 of a recipe walk (both hops, 16 shards
             per launch) and on edge cases (all lanes gated off, degree-0
             rows, each shard's last row, row_base > 0, board rows); device
             ms, twin ms and the byte bound (lanes once plus the distinct
             CSR sectors the gated lanes read).
16. nccl     ProcessGroupFabric over NCCL on one rank (a TCP store on
             localhost) equals LocalFabric(1) on the 20k graph, and the
             4-way sharded walk's board counts equal the unsharded ones.

17. attn     after the Pixie state is freed: the decode-attention kernel
             against its twin (max abs difference <= 2e-6 on the float32
             output) at edge shapes: length 1, ragged lengths in one batch,
             a length that is not a multiple of the tile, dh 16, 20, 64 and
             128, groups 1, 3 and 8, float32 and bf16 caches, q in float32
             and in the cache's dtype.
18. lm_f32   Qwen2.5-3B at full width (36 layers, vocab 151,936, seeded
             init on the card) in float32 compute and cache: a seeded 4 x
             512 prompt, 32 greedy tokens through decode.generate on the
             kernel path and on the plain path (backend="xla"): tokens
             identical; then both decode paths side by side on the same
             tokens, the max logit difference per step.
19. lm_bf16  the same weights cast once to the config's own bf16 (the
             serving dtypes): generate on both paths (the share of tokens
             they agree on: bf16 rounding lets greedy paths part),
             prefill ms, decode ms per step (p50 of 32), tokens/s at batch
             4, decode-attention launches, one profiled step (device idle
             share), and the attention kernel on that step's layer-0
             inputs (the serving shape) beside SDPA and its bound.  Then the
             reference's decode_32k cell, cut: batch 16 instead of 128 (a
             bf16 cache of 128 x 32,768 tokens is 154.6 GB), the cache
             filled with seeded random bf16 values, one decode_step at
             position 32,767 timed (kernel path, plain path, one profiled);
             on that step's layer-0 inputs the kernel against its twin
             (<= 2e-6), its device ms beside the twin, torch's
             scaled_dot_product_attention(enable_gqa=True) and the byte
             bound.  Both timed attention calls log the kernel's split
             plan (splits, CTAs) and must give the same bits twice.
20. smollm   SmolLM-360M at full width in float32 (15 heads padded to 16):
             16 greedy tokens after a 4 x 128 prompt, kernel path == plain
             path, the per-step logit difference.

21. events  run after phase 5, while the full-width graph is resident: the
             reference's serve_200m_replicated cell as the reference serves
             it, in event mode (pixie_walk_events + recommend_from_events,
             FULL_WALK, 8 slots, count_boards off) on the 24 requests of
             phase 2: p50/max latency, the kernel path (walk_steps_fused)
             equal to the plain path bit for bit (both lanes, steps_taken,
             chunks_run, n_high, scores, ids); check_mode "incremental"
             equal to "full" at check_every 1, 2 and 4 on two requests;
             with early stopping off, equal to the dense engine's counts with
             every query pin masked, and to walk.recommend itself where no
             query pin was visited from another slot (the one place the two
             reference engines part); one request under torch.profiler
             (chiprun_out/chip_smoke_events_trace.json); peak memory.
22. wide     16 slots (the reference's PixieArchConfig.n_slots): 2.24e9
             packed (slot, pin) ids, which select_count_engine refuses for
             dense counting; 8 requests of up to 16 pins in event mode,
             kernel path == plain path.
23. legacy   ops.walk_step chained for 5 supersteps over 8192 walkers on the
             full-width graph (query pins of phase 2, seeded uint32 words),
             kernel == twin at every step; ops.visit_counts over one event
             request's pin lane (invalid events -1) into n_pins bins,
             kernel == twin, and per slot equal to events_to_counts' runs;
             both kernels at edge shapes (no events, negative and
             out-of-range ids, bin counts off the 32-multiple, dead-end pins
             and empty boards on each CSR's last row, high-bit words, alpha
             0 and 2**32 - 1, walker counts off the 256-multiple); their
             kernels-line rows (torch.bincount as visit_counter's library
             call).

Launch counts are reset just before and read just after each path that
is driven (phases 2, 4, 6, 7, 9, 10, 12, 13, 14, 18, 19 and 19b, 20, 21,
22, 23); the kernels line sums them, and every one of its eight kernels
must have launched.

Prints one ``{"kernels": [...]}`` line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line.  Exits
non-zero without a result when no CUDA device is visible or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
SECTOR = 32                        # bytes per DRAM sector touched at random
REQUEST_PINS = (8, 3, 1, 5, 8, 2) * 4  # pins per full-width request
OPEN_LOOP_REQUESTS = 200


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over ``n`` back-to-back calls, timed
    with CUDA events after one warm-up call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fn, n: int, sleep_cycles: int = 10**8) -> float:
    """Mean device milliseconds of ``fn()`` over ``n`` calls run back to
    back: the card is held in ``torch.cuda._sleep`` while the host enqueues
    every call, so the Python wrapper's launch cost leaves no gaps between
    kernels.  Retries with a longer sleep if the card caught up with the
    host (then the span would hold host gaps).  ``fn`` must not
    synchronise."""
    import torch

    fn()
    torch.cuda.synchronize()
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        caught_up = start.query()
        end.synchronize()
        if not caught_up:
            return start.elapsed_time(end) / n
        sleep_cycles *= 4
    raise RuntimeError("the host could not keep ahead of the card")


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


# ---------------------------------------------------------------------------
# Phase 2: the full-width graph and requests
# ---------------------------------------------------------------------------


def full_width_graph(shape, dev):
    """Uniform random edges with 4 edge languages, drawn on the card."""
    import torch
    from repro_torch.core.graph import build_graph

    gen = torch.Generator(device=dev).manual_seed(SEED)
    randint = lambda hi, n, dt: torch.randint(
        0, hi, (n,), generator=gen, dtype=dt, device=dev
    )
    pins = randint(shape.n_pins, shape.n_edges, torch.int32)
    boards = randint(shape.n_boards, shape.n_edges, torch.int32)
    pin_lang = randint(4, shape.n_pins, torch.int8)
    board_lang = randint(4, shape.n_boards, torch.int8)
    p2b_feat = torch.index_select(board_lang, 0, boards)
    b2p_feat = torch.index_select(pin_lang, 0, pins)
    del pin_lang, board_lang
    graph = build_graph(
        pins, boards, shape.n_pins, shape.n_boards,
        edge_feat=p2b_feat, n_feats=4, edge_feat_b2p=b2p_feat,
    )
    del pins, boards, p2b_feat, b2p_feat
    torch.cuda.empty_cache()
    return graph


def full_width_requests(graph, n_slots: int):
    """(pins, weights, feat) per request: random pins with edges."""
    import torch

    rng = np.random.default_rng(SEED)
    cand = torch.from_numpy(
        rng.integers(0, graph.n_pins, 256).astype(np.int32)
    ).to(graph.device)
    cand = cand[graph.pin_degree(cand) > 0].cpu().numpy()
    reqs, at = [], 0
    for k in REQUEST_PINS:
        k = min(k, n_slots)
        pins = [int(p) for p in cand[at:at + k]]
        at += k
        weights = [float(w) for w in rng.uniform(0.1, 1.0, k).astype(np.float32)]
        reqs.append((pins, weights, int(rng.integers(0, 4))))
    return reqs


def padded_batch(reqs, n_slots, dev):
    import torch

    pins = np.full((len(reqs), n_slots), -1, np.int32)
    weights = np.zeros((len(reqs), n_slots), np.float32)
    feats = np.zeros((len(reqs),), np.int32)
    for i, (p, w, f) in enumerate(reqs):
        pins[i, :len(p)] = p
        weights[i, :len(w)] = w
        feats[i] = f
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(pins), t(weights), t(feats)


def serve_with_stats(graph, reqs, req_ids, n_slots, cfg, backend):
    """serve_batch(with_stats=True) per request under the server's keys."""
    from repro_torch.core import prng, service

    server_key = prng.key(SEED, graph.device)
    out = []
    for rid, req in zip(req_ids, reqs):
        pins, weights, feats = padded_batch([req], n_slots, graph.device)
        keys = prng.fold_in(server_key, rid)[None, :]
        out.append(service.serve_batch(
            graph, pins, weights, feats, keys, cfg, backend=backend,
            with_stats=True,
        ))
    return out


def assert_same(a, b, what: str) -> None:
    import torch

    for name, x, y in zip(("scores", "ids", "steps_taken", "n_high"), a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differs between kernel and plain paths")


def check_result(scores, ids, k: int, n_pins: int, what: str) -> None:
    import torch

    if scores.shape[-1] != k or ids.shape[-1] != k:
        raise AssertionError(f"{what}: expected top {k}, got {tuple(scores.shape)}")
    if not bool(torch.isfinite(torch.as_tensor(scores)).all()):
        raise AssertionError(f"{what}: non-finite scores")
    ids = torch.as_tensor(ids)
    if int(ids.min()) < 0 or int(ids.max()) >= n_pins:
        raise AssertionError(f"{what}: ids outside [0, {n_pins})")
    if float(torch.as_tensor(scores).max()) <= 0:
        raise AssertionError(f"{what}: the walk visited nothing")


def profile_request(server, req, req_id: int, top: int = 14,
                    trace: str = "chip_smoke_trace.json") -> None:
    """One full-width request through ``server`` under torch.profiler
    (``profile_call``)."""
    def serve():
        server.submit(*req[:2], user_feat=req[2], req_id=req_id)
        server.pump()
        server.harvest()

    profile_call(serve, top, trace)


def profile_call(fn, top: int = 14, trace: str = "chip_smoke_trace.json") -> None:
    """``fn()`` under torch.profiler: the device's busy and idle share of
    its wall time, and where the device time goes by kernel.  The trace
    goes to chiprun_out/<trace>."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    log("profile", trace=trace, wall_ms=wall, device_busy_ms=busy,
        device_idle_share=max(0.0, 1 - busy / wall) if wall else None,
        kernel_launches=sum(e.count for e in kernels),
        top=[dict(kernel=e.key[:90], count=e.count,
                  ms=e.self_device_time_total / 1e3) for e in kernels[:top]])
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / trace))


# ---------------------------------------------------------------------------
# Phase 5: kernels against their twins
# ---------------------------------------------------------------------------


def walk_inputs(graph, reqs, n_slots, cfg):
    """The main path's first-chunk walk inputs for a padded batch."""
    import torch
    from repro_torch.core import prng, walk

    dev = graph.device
    pins, weights, feats = padded_batch(reqs, n_slots, dev)
    plan = walk._plan(graph, pins, weights, cfg, None)
    n_queries = len(reqs)
    w = cfg.n_walkers
    keys = prng.fold_in(prng.key(SEED, dev), torch.arange(n_queries, device=dev))
    p2b_fb, b2p_fb = walk._validated_bias_bounds(graph, cfg)
    return dict(
        curr=plan.query_of_walker.reshape(-1).contiguous(),
        query=plan.query_of_walker.reshape(-1).contiguous(),
        feat=feats.repeat_interleave(w),
        slot=plan.slot_of_walker.reshape(-1).contiguous(),
        qid=torch.arange(n_queries, dtype=torch.int32, device=dev).repeat_interleave(w),
        rbits=walk._chunk_rbits(keys, 0, cfg.chunk_steps, w),
        csr=(graph.p2b.offsets, graph.p2b.targets, graph.b2p.offsets,
             graph.b2p.targets, p2b_fb, b2p_fb),
        kw=dict(n_pins=graph.n_pins, n_slots=n_slots, n_queries=n_queries,
                n_boards=graph.n_boards, alpha_u32=walk._prob_u32(cfg.alpha),
                beta_u32=walk._prob_u32(cfg.bias_beta),
                count_boards=cfg.count_boards),
    )


def walk_sectors(inp, pin_events) -> int:
    """Distinct 32-byte sectors of the CSR and feature-bound arrays that
    this chunk's walk reads: the kernel's reads replayed step by step in
    plain PyTorch (sectors counted from each array's start).  The replay's
    pin lane must equal the kernel's, so the address model is the
    kernel's own."""
    import torch
    from repro_torch.core import prng
    from repro_torch.kernels.walk_step import RMASK

    p2b_off, p2b_tgt, b2p_off, b2p_tgt, p2b_fb, b2p_fb = inp["csr"]
    kw = inp["kw"]
    biased = p2b_fb is not None and kw["beta_u32"] > 0
    rb = prng.from_int32_bits(inp["rbits"])
    feat, query = inp["feat"].long(), inp["query"].long()
    cur = inp["curr"].long()
    touched = []

    def touch(array_id, idx, mask):
        touched.append((idx[mask] >> 3) | (array_id << 40))

    def pick(start, deg, r, use_b, fb, rows, mask, array_id):
        base, span = start, deg.clamp(min=1)
        if biased:
            m = use_b & mask
            at = rows * fb.shape[1] + feat
            touch(array_id, at, m)
            touch(array_id, at + 1, m)
            flat = fb.reshape(-1)
            lo, hi = flat[at].long(), flat[at + 1].long()
            sub = m & (hi > lo)
            base = torch.where(sub, start + lo, base)
            span = torch.where(sub, hi - lo, span)
        return torch.where(mask, base + r % span, 0)

    pins = []
    for s in range(rb.shape[0]):
        use_b = rb[s, :, 1] < kw["beta_u32"]
        pos = torch.where(rb[s, :, 0] < kw["alpha_u32"], query, cur)
        every = torch.ones_like(use_b)
        touch(0, pos, every)
        touch(0, pos + 1, every)
        start = p2b_off[pos].long()
        deg = p2b_off[pos + 1].long() - start
        ok1 = deg > 0
        eidx = pick(start, deg, rb[s, :, 2] & RMASK, use_b, p2b_fb, pos, ok1, 1)
        touch(2, eidx, ok1)
        board = torch.where(ok1, p2b_tgt[eidx].long() - kw["n_pins"], 0)
        touch(3, board, ok1)
        touch(3, board + 1, ok1)
        bstart = b2p_off[board].long()
        bdeg = b2p_off[board + 1].long() - bstart
        ok = ok1 & (bdeg > 0)
        bidx = pick(bstart, bdeg, rb[s, :, 3] & RMASK, use_b, b2p_fb, board, ok, 4)
        touch(5, bidx, ok)
        pin = b2p_tgt[bidx].long()
        cur = torch.where(ok, pin, query)
        pins.append(torch.where(ok, pin, 0))
    if not torch.equal(torch.stack(pins).int(), pin_events):
        raise AssertionError("walk sector replay disagrees with the kernel's pin lane")
    return int(torch.unique(torch.cat(touched)).numel())


def check_walk_kernel(inp):
    from repro_torch.kernels import walk_step as ws

    a = (inp["curr"], inp["query"], inp["feat"], inp["slot"])
    kern = lambda: ws.walk_steps_fused(*a, inp["rbits"], *inp["csr"], inp["qid"], **inp["kw"])
    plain = lambda: ws.walk_chunk_batched_plain(*a, inp["qid"], inp["rbits"], *inp["csr"], **inp["kw"])
    got, want = kern(), plain()
    err = 0
    for x, y in zip(got, want):
        if (x is None) != (y is None):
            raise AssertionError("walk_steps_fused: lanes differ in presence")
        if x is not None:
            err = max(err, int((x.long() - y.long()).abs().max()))
    if err:
        raise AssertionError(f"walk_steps_fused differs from its twin: max err {err}")
    ms = device_ms(kern, 50)
    call_ms = cuda_ms(kern, 50)
    plain_ms = cuda_ms(plain, 5)
    # bound: the distinct CSR and feature-bound sectors this chunk reads,
    # plus the random words and walker state read once and the lanes and
    # next pins written once
    c, w = inp["rbits"].shape[0], inp["rbits"].shape[1]
    _, _, sev, pev, _ = got
    n_ok = int((sev != inp["kw"]["n_slots"]).sum())
    sectors = walk_sectors(inp, pev)
    lanes = 3 + (1 if inp["kw"]["count_boards"] else 0)
    nbytes = SECTOR * sectors + 16 * c * w + 4 * lanes * c * w + 4 * 6 * w
    log("kernel", name="walk_steps_fused", device_ms=ms, call_ms=call_ms,
        walkers=w, chunk_steps=c, valid_events=n_ok, distinct_sectors=sectors,
        bound_bytes=nbytes)
    return dict(
        name="walk_steps_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/walk_steps_fused.cu",
        replaces="src/repro/kernels/walk_step.py:519",
        launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None,
    ), got


def check_counter_kernel(name, kernel, plain, n_bins, lanes, kw, replaces):
    """A counter kernel against its twin on a warm buffer, then timed.
    ``visit_counter_update_high`` runs as the main path calls it: the
    crossings added into a running tally in place, one launch; its old
    three-launch sequence (a zeroed delta, the kernel, an add) is timed
    beside it once, for the record."""
    import torch
    from repro_torch.kernels.visit_counter import _valid_bins

    dev = lanes[0].device
    high = name == "visit_counter_update_high"
    base = torch.zeros((n_bins,), dtype=torch.int32, device=dev)
    qev, sev, iev = lanes
    n_dim = kw.get("n_pins", kw.get("n_dim"))
    n_rows = n_bins // n_dim
    bins = _valid_bins(sev, iev, qev, kw["n_slots"], n_dim, kw["n_queries"])
    # a warm buffer: every other touched bin sits one below n_v, so the
    # checked round's first event there crosses it
    base[bins[::2]] = kw.get("n_v", 4) - 1
    ck, cp = base.clone(), base.clone()
    extra = {}
    if high:
        # a running tally that already holds counts: the kernel adds to it
        tally = torch.arange(7, 7 + n_rows, dtype=torch.int32, device=dev)
        extra = dict(high=tally.clone())
    got = kernel(ck, sev, iev, qev, **kw, **extra)
    want = plain(cp, sev, iev, qev, **kw)
    err = int((ck.long() - cp.long()).abs().max())
    if high:
        if int(want.sum()) == 0:
            raise AssertionError(f"{name}: the checked round crossed no bin")
        if got is not extra["high"]:
            raise AssertionError(f"{name}: the tally was not updated in place")
        err = max(err, int((got.long() - (tally + want).long()).abs().max()))
    if err:
        raise AssertionError(f"{name} differs from its twin: max err {err}")
    del cp
    run = lambda: kernel(ck, sev, iev, qev, **kw, **extra)
    ms = device_ms(run, 50)
    call_ms = cuda_ms(run, 50)
    plain_ms = cuda_ms(lambda: plain(ck, sev, iev, qev, **kw), 5)
    ones = torch.ones_like(bins, dtype=torch.int32)
    library_ms = device_ms(lambda: ck.index_add_(0, bins, ones), 50)
    three_ms = None
    if high:
        t = extra["high"]
        three_ms = device_ms(lambda: t.add_(kernel(ck, sev, iev, qev, **kw)), 50)
    m = sev.shape[0]
    # bound: the lanes read once, and each distinct 32-byte sector of the
    # count buffer the events touch read once and written once (a bin hit
    # again is an L2 hit: the buffer of the wide check fits in L2 whole)
    sectors = int(torch.unique(bins >> 3).numel())
    nbytes = 4 * 3 * m + 2 * SECTOR * sectors
    if high:
        nbytes += 2 * 4 * n_rows          # the tally read and written
    log("kernel", name=name, device_ms=ms, call_ms=call_ms, events=m,
        valid_events=int(bins.shape[0]), bins=n_bins,
        distinct_bins=int(torch.unique(bins).numel()),
        distinct_sectors=sectors, bound_bytes=nbytes,
        crossed=int(want.sum()) if high else None,
        index_add_ms=library_ms, three_launch_ms=three_ms,
        three_launch_is="torch.zeros delta, the kernel, tally + delta: the "
                        "sequence before the in-place tally" if high else None)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/visit_counter.cu",
        replaces=replaces, launches=None, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=library_ms,
    )


# ---------------------------------------------------------------------------
# Phases 6-8: ranked serving, the open loop, the bag kernel
# ---------------------------------------------------------------------------


def ranked_plain(graph, rank, pins, weights, feats, keys, cfg, scen):
    """The plain ranked path: the walk twins, then stage 2 with the bag
    twin (``use_kernel=False``)."""
    from repro_torch.core import service
    from repro_torch.serving import ranker

    retrieval = dataclasses.replace(cfg, top_k=rank.cfg.n_candidates)
    s, i, steps, n_high = service.serve_batch(
        graph, pins, weights, feats, keys, retrieval, backend="xla",
        with_stats=True)
    s, i = ranker.rank_candidates(rank.params, rank.cfg, graph, i, s, scen,
                                  use_kernel=False)
    return s, i, steps, n_high


def ranked_split_ms(graph, rank, pins, weights, feats, keys, cfg, scen):
    """One ranked request's phases, each timed alone with a synchronise:
    retrieval (the walk with top_k = n_candidates), the 2-hop
    neighborhoods, the bags (both bag launches and the self-row gather),
    the scenario heads and the final top-k."""
    import torch
    from repro_torch.core import counter as counter_lib
    from repro_torch.core import service
    from repro_torch.kernels import ops
    from repro_torch.serving import ranker

    rc = rank.cfg
    table = rank.params["items"]
    retrieval = dataclasses.replace(cfg, top_k=rc.n_candidates)
    out = {}
    ms = {"retrieval": wall_ms(lambda: out.setdefault("walk", service.serve_batch(
        graph, pins, weights, feats, keys, retrieval)))}
    s, i = out["walk"]
    valid = s > 0
    ms["neighborhoods"] = wall_ms(lambda: out.setdefault(
        "nbr", ranker.candidate_neighborhoods(graph, i, valid, rc.n_neighbors)))

    def bags():
        nbr_ids, nbr_w = out["nbr"]
        q_ids, q_w = ranker.query_bag(i, s)
        out["emb"] = (
            table[torch.where(valid, i, 0).long()] * valid[..., None].to(table.dtype),
            ops.embedding_bag_batched(table, nbr_ids, nbr_w, mode="mean"),
            ops.embedding_bag_batched(table, q_ids, q_w, mode="mean")[:, 0],
        )

    ms["bags"] = wall_ms(bags)
    ms["heads"] = wall_ms(lambda: out.setdefault("raw", ranker.score_heads(
        rank.params["heads"], torch.as_tensor(scen).long(), *out["emb"])))
    ms["topk"] = wall_ms(lambda: counter_lib.topk_dense(
        torch.where(valid, out["raw"], float("-inf")), rc.final_k))
    return ms


def check_ranked(scores, ids, k: int, n_pins: int, what: str) -> None:
    """A full-width ranked result: k real candidates, finite scores in
    descending order."""
    import torch

    scores, ids = torch.as_tensor(scores), torch.as_tensor(ids)
    if scores.shape[-1] != k or ids.shape[-1] != k:
        raise AssertionError(f"{what}: expected {k} ranked, got {tuple(ids.shape)}")
    if not bool(torch.isfinite(scores).all()):
        raise AssertionError(f"{what}: non-finite ranked scores")
    if int(ids.min()) < 0 or int(ids.max()) >= n_pins:
        raise AssertionError(f"{what}: ranked ids outside [0, {n_pins})")
    if bool((scores[..., 1:] > scores[..., :-1]).any()):
        raise AssertionError(f"{what}: ranked scores not descending")


def connected_pins(graph, n: int):
    """Up to ``n`` seeded random pins with at least one board."""
    import torch

    rng = np.random.default_rng(SEED + 3)
    cand = torch.from_numpy(
        rng.integers(0, graph.n_pins, n).astype(np.int32)).to(graph.device)
    return cand[graph.pin_degree(cand) > 0].cpu().numpy()


def bag_sector_bytes(table, ids) -> int:
    """Bytes of the distinct 32-byte sectors of table rows that the bags
    read (an invalid id reads row 0)."""
    import torch

    v, d = table.shape
    row_bytes = d * table.element_size()
    rows = torch.where((ids >= 0) & (ids < v), ids, 0).long().unique()
    first = rows * row_bytes // SECTOR
    last = ((rows + 1) * row_bytes - 1) // SECTOR
    span = torch.arange(int((last - first).max()) + 1, device=rows.device)
    sec = first[:, None] + span[None, :]
    return SECTOR * int(sec[sec <= last[:, None]].unique().numel())


def check_bag(table, ids, weights, mode: str, what: str):
    """The bag kernel against its twin on the same inputs, bit for bit."""
    import torch
    from repro_torch.kernels import embedding_bag as eb

    if ids.dim() == 3:
        got = eb.embedding_bag_batched(table, ids, weights, mode=mode)
        want = eb.embedding_bag_batched_plain(table, ids, weights, mode=mode)
    else:
        got = eb.embedding_bag(table, ids, weights, mode=mode)
        want = eb.embedding_bag_plain(table, ids, weights, mode=mode)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
        err = float((got.float() - want.float()).abs().max())
        raise AssertionError(f"embedding_bag {what}: differs from its twin, max err {err}")
    return got


def time_bag(table, ids, weights, mode: str, what: str) -> dict:
    """Device ms of the kernel (back to back), the twin's ms, torch's
    F.embedding_bag(mode="sum") on the same bags (no mean division) and
    the byte bound: ids, weights and output once plus the distinct table
    sectors the bags read."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import embedding_bag as eb

    out = check_bag(table, ids, weights, mode, what)
    l = ids.shape[-1]
    ids2, w2 = ids.reshape(-1, l), weights.reshape(-1, l)
    valid = (ids2 >= 0) & (ids2 < table.shape[0])
    lib_ids = torch.where(valid, ids2, 0).long()
    lib_w = w2 * valid
    nbytes = (4 * ids.numel() + 4 * weights.numel()
              + out.numel() * out.element_size() + bag_sector_bytes(table, ids))
    row = dict(
        ms=device_ms(lambda: eb.embedding_bag_batched(table, ids, weights, mode=mode), 50),
        plain_ms=cuda_ms(lambda: eb.embedding_bag_batched_plain(table, ids, weights, mode=mode), 5),
        library_ms=device_ms(lambda: F.embedding_bag(
            lib_ids, table, per_sample_weights=lib_w, mode="sum"), 50),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
    )
    log("bag", shape=list(ids.shape), table=list(table.shape), mode=mode,
        bound_bytes=nbytes, **row)
    return row


EDGE_BAGS = [  # (table dtype, d, ids shape): beside the main path's shapes
    ("bfloat16", 32, (4, 16, 8)),
    ("float32", 48, (3, 7, 5)),
    ("float32", 32, (37, 1)),
    ("bfloat16", 48, (13, 3)),
]


def check_edge_bags(dev) -> int:
    """The kernel against its twin at the edge shapes, in sum and mean
    mode, with weights and without, each with an all-padding bag."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    n = 0
    for dtype, d, shape in EDGE_BAGS:
        table = torch.randn((1000, d), generator=gen, device=dev).to(
            getattr(torch, dtype))
        ids = torch.randint(-1, 1000, shape, generator=gen, device=dev,
                            dtype=torch.int32)
        ids.reshape(-1, shape[-1])[0] = -1
        w = torch.rand(shape, generator=gen, device=dev) * 2
        for mode in ("sum", "mean"):
            for weights in (w, None):
                got = check_bag(table, ids, weights, mode, f"{dtype} d={d} {shape}")
                if got.reshape(-1, d)[0].any():
                    raise AssertionError("an all-padding bag pooled to non-zero")
                n += 1
    return n


# ---------------------------------------------------------------------------
# Phases 9-10: batched ranked serving, multi-interest users, chaos
# ---------------------------------------------------------------------------


def serve_requests(server, reqs, scenarios=None):
    """Submit every request at t=0, dispatch at t=1, results by id."""
    for rid, (p, w, f) in enumerate(reqs):
        kw = {} if scenarios is None else dict(scenario=scenarios[rid])
        server.submit(p, w, user_feat=f, now=0.0, req_id=rid, **kw)
    server.pump(now=1.0)
    return sorted(server.harvest(), key=lambda r: r.req_id)


def assert_results_equal(a, b, what: str) -> None:
    if [r.req_id for r in a] != [r.req_id for r in b]:
        raise AssertionError(f"{what}: different request ids")
    for x, y in zip(a, b):
        if not (np.array_equal(x.scores, y.scores) and np.array_equal(x.ids, y.ids)):
            raise AssertionError(f"{what}: request {x.req_id} differs")


def lane_oracle(graph, uq, user_id, cfg, dev):
    """One user's cluster lanes walked one query at a time with the
    server's per-(user, cluster) keys and budgets, then merged."""
    import torch
    from repro_torch.core import prng, service, walk

    server_key = prng.key(SEED, dev)
    budgets = service.cluster_step_budgets(uq.importance, cfg.n_steps)
    scores, ids = [], []
    for ci in range(uq.n_clusters):
        t = lambda a: torch.as_tensor(a, device=dev)
        key = prng.fold_in(prng.fold_in(server_key, user_id), ci)[None, :]
        s, i = service.serve_batch(
            graph, t(uq.cluster_pins[ci][None]), t(uq.cluster_weights[ci][None]),
            t(np.array([uq.user_feat], np.int32)), key, cfg,
            step_budgets=t(np.array([budgets[ci]], np.int32)))
        scores.append(s[0])
        ids.append(i[0])
    return walk.merge_interest_topk(torch.stack(scores), torch.stack(ids),
                                    torch.as_tensor(uq.importance, device=dev))


def multi_interest_users(sg, cfg, rank, dev, n_users: int = 8):
    """submit_user against the per-cluster oracle, then the same users
    ranked by recommend_multi_interest against the oracle's merged lanes
    ranked by rank_candidates.  Returns the submit_user run's launches."""
    import torch
    from repro_torch.core import prng, service
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import _build
    from repro_torch.serving import ranker
    from repro_torch.serving.recommend import recommend_multi_interest
    from repro_torch.serving.server import PixieServer

    hist = synthetic.sample_user_histories(sg, synthetic.UserHistoryConfig(
        n_users=n_users, n_interests=3, mean_actions=20, seed=SEED))
    srv = PixieServer(sg.graph, cfg, buckets=[(16, 4), (8, 8)], seed=SEED,
                      pin_topics=sg.pin_topics, n_clusters=3)
    _build.reset_launches()
    for u, h in enumerate(hist):
        srv.submit_user(h.actions, user_feat=u % 4, now=0.0, req_id=u)
    srv.pump(now=1.0)
    got = {r.req_id: r for r in srv.harvest()}
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    uqs = [service.build_user_query(h.actions, sg.pin_topics, n_slots=srv.max_slots,
                                    n_clusters=3, user_feat=u % 4)
           for u, h in enumerate(hist)]
    n_lanes = 0
    for u, uq in enumerate(uqs):
        ms, mi = lane_oracle(sg.graph, uq, u, cfg, dev)
        if not (np.array_equal(got[u].scores, ms.cpu().numpy())
                and np.array_equal(got[u].ids, mi.cpu().numpy())):
            raise AssertionError(f"user {u}: submit_user differs from the per-cluster oracle")
        n_lanes += uq.n_clusters

    retrieval = dataclasses.replace(cfg, top_k=rank.cfg.n_candidates)
    batch = service.batch_user_queries(uqs, cfg.n_steps, device=dev)
    server_key = prng.key(SEED, dev)
    keys = []
    for li, u in enumerate(batch.lane_user):
        ci = int(np.nonzero(batch.lane_of_user[u] == li)[0][0])
        keys.append(prng.fold_in(prng.fold_in(server_key, int(u)), ci))
    scen = torch.arange(len(uqs), device=dev, dtype=torch.int32) % 2
    rs, ri = recommend_multi_interest(sg.graph, batch, torch.stack(keys), cfg,
                                      rank=rank, scenario=scen)
    merged = [lane_oracle(sg.graph, uq, u, retrieval, dev) for u, uq in enumerate(uqs)]
    ws, wi = ranker.rank_candidates(
        rank.params, rank.cfg, sg.graph, torch.stack([m[1] for m in merged]),
        torch.stack([m[0] for m in merged]), scen)
    if not (torch.equal(rs, ws) and torch.equal(ri, wi)):
        raise AssertionError("recommend_multi_interest(rank=...) differs from the ranked oracle")
    log("users", users=len(uqs), lanes=n_lanes, batches=srv.stats.batches,
        identical=True, ranked_identical=True, launches=launches)
    return launches


def chaos_runs(sg, cfg, dev, n_requests: int = 64):
    """A seeded chaos schedule twice (identical results and budgets), and a
    zero-fault schedule against the plain run (bit-identical).  Returns
    the first chaos run's launches."""
    import torch
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import _build
    from repro_torch.serving import traffic
    from repro_torch.serving.resilience import ResilienceConfig
    from repro_torch.serving.server import PixieServer

    reqs = traffic.poisson_requests(
        synthetic.top_degree_pins(sg, 256),
        traffic.OpenLoopConfig(offered_qps=2000.0, n_requests=n_requests,
                               seed=SEED, max_pins=8, n_feats=4))
    faults = traffic.sample_fault_schedule(traffic.ChaosConfig(
        horizon_s=reqs[-1].t_arrival, seed=SEED, n_spikes=3,
        spike_duration_s=0.005, n_bursts=2, burst_duration_s=0.005))
    shed = ResilienceConfig(deadline_ms=20.0, shed_start_ms=2.0)

    def run(resilience, schedule):
        srv = PixieServer(sg.graph, cfg, buckets=[(16, 4), (8, 8)], seed=SEED,
                          resilience=resilience)
        return traffic.run_open_loop(srv, reqs, faults=schedule)

    _build.reset_launches()
    a = run(shed, faults)
    torch.cuda.synchronize()
    launches = dict(_build.launches)
    b = run(shed, faults)
    if a.budgets != b.budgets or sorted(a.results) != sorted(b.results):
        raise AssertionError("chaos replay: budgets or served requests differ")
    assert_results_equal([a.results[k] for k in sorted(a.results)],
                         [b.results[k] for k in sorted(b.results)], "chaos replay")
    if min(a.budgets.values()) >= cfg.n_steps:
        raise AssertionError("chaos run shed no budget: the schedule did not engage")
    plain = run(None, None)
    idle = run(ResilienceConfig(deadline_ms=1e6, shed_start_ms=1e5),
               traffic.FaultSchedule())
    assert_results_equal([plain.results[k] for k in sorted(plain.results)],
                         [idle.results[k] for k in sorted(idle.results)],
                         "zero-fault chaos vs plain")
    log("chaos", requests=n_requests, events=len(faults.events),
        served=a.n_served, shed_requests=sum(v < cfg.n_steps for v in a.budgets.values()),
        min_budget=min(a.budgets.values()), replay_identical=True,
        zero_fault_identical=True, launches=launches,
        chaos_p99_ms=a.percentile(99), plain_p99_ms=plain.percentile(99))
    return launches


# ---------------------------------------------------------------------------
# Phases 11-16: the node-range-sharded engine
# ---------------------------------------------------------------------------

# 2 * n_shards, the reference's drop-free parity slack
SHARDED_SLACK = 32.0
# the 1- and 2-pin requests: one or two slots share the whole step budget,
# so Algorithm 3's early stop fires on them at this graph's degrees
SHARDED_PARITY_REQUESTS = [i for i, k in enumerate(REQUEST_PINS) if k <= 2]
SHARD_CUTS = [
    "140M pins / 60M boards / 1.2B edges (serve_200m_replicated) instead of "
    "serve_3b_sharded's 2B / 1B / 17B: one card's 80 GB holds no more",
    "16 shards co-located on one card (LocalFabric) instead of 16 cards",
]


def shard_sizes(shg) -> dict:
    return dict(
        p2b_edges=shg.p2b_offsets[:, -1].tolist(),
        b2p_edges=shg.b2p_offsets[:, -1].tolist(),
        padded_edges=[shg.p2b_targets.shape[1], shg.b2p_targets.shape[1]],
    )


def hop_sectors(pos, gate, r, base, off, tgt, out) -> int:
    """Distinct 32-byte sectors the kernel reads from the arrays it touches
    only on some lanes: ``pos`` at the gated lanes, ``r`` at the lanes that
    hop, and the offsets and targets that the gated lanes read (offset
    pair, then target), replayed in plain PyTorch; the replayed targets
    must equal the kernel's, so the address model is the kernel's own."""
    import torch
    from repro_torch.kernels.walk_step import RMASK

    s_idx = torch.arange(pos.shape[0], device=pos.device)[:, None]
    local = torch.where(gate, pos - base[:, None], 0).long()
    at_o = s_idx * off.shape[1] + local
    flat_o = off.reshape(-1)
    start = flat_o[at_o].long()
    deg = flat_o[at_o + 1].long() - start
    ok = gate & (deg > 0)
    at_t = s_idx * tgt.shape[1] + torch.where(
        ok, start + (r.long() & RMASK) % deg.clamp(min=1), 0)
    if not torch.equal(torch.where(ok, tgt.reshape(-1)[at_t], 0), out):
        raise AssertionError("walk_hop sector replay disagrees with the kernel")
    sec_o = torch.unique(torch.cat([at_o[gate], at_o[gate] + 1]) >> 3).numel()
    sec_t = torch.unique(at_t[ok] >> 3).numel()
    lane = s_idx * pos.shape[1] + torch.arange(pos.shape[1], device=pos.device)
    sec_pos = torch.unique(lane[gate] >> 3).numel()
    sec_r = torch.unique(lane[ok] >> 3).numel()
    return int(sec_o + sec_t + sec_pos + sec_r)


def check_hop(pos, gate, r, base, off, tgt, what: str):
    """The hop kernel against its twin on the same inputs, exactly."""
    import torch
    from repro_torch.kernels import walk_step as ws

    got = ws.walk_hop_fused(pos, gate, r, base, off, tgt)
    want = ws.walk_hop_ref(pos, gate, r, off, tgt, base)
    torch.cuda.synchronize()
    err = int((got[0].long() - want[0].long()).abs().max()) if got[0].numel() else 0
    if err or not torch.equal(got[1], want[1]):
        raise AssertionError(f"walk_hop_fused {what}: differs from its twin (max err {err})")
    return got


def time_hop(hop, what: str) -> dict:
    """Device ms of one hop launch (back to back), its twin's ms and the
    byte bound: ``gate`` read and ``out``/``ok`` written once for every
    lane, ``row_base`` once, plus the distinct sectors of ``pos``, ``r``
    and the CSR slices that the gated or hopping lanes read."""
    from repro_torch.kernels import walk_step as ws

    pos, gate, r, base, off, tgt = hop
    out, ok = check_hop(*hop, what)
    lanes = pos.numel()
    sectors = hop_sectors(pos, gate, r, base, off, tgt, out)
    nbytes = lanes * (1 + 4 + 1) + 4 * base.numel() + SECTOR * sectors
    row = dict(
        ms=device_ms(lambda: ws.walk_hop_fused(pos, gate, r, base, off, tgt), 50),
        plain_ms=cuda_ms(lambda: ws.walk_hop_ref(pos, gate, r, off, tgt, base), 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
    )
    log("hop", hop=what, shape=list(pos.shape), gated=int(gate.sum()),
        hopped=int(ok.sum()), distinct_sectors=sectors, bound_bytes=nbytes,
        **row)
    return row


def hop_edge_cases(shg, dev) -> int:
    """All lanes gated off; degree-0 rows and each shard's last row at
    row_base > 0; garbage positions on gated-off lanes."""
    import torch

    s, pps = shg.n_shards, shg.pins_per_shard
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    off, tgt = shg.p2b_offsets, shg.p2b_targets
    base = (torch.arange(s, device=dev, dtype=torch.int32) * pps).contiguous()
    l = 256
    r = torch.randint(-2**31, 2**31 - 1, (s, l), generator=gen, device=dev,
                      dtype=torch.int32)
    local = torch.randint(0, pps, (s, l), generator=gen, device=dev)
    deg = off[:, 1:] - off[:, :-1]
    for i in range(s):
        zero = torch.nonzero(deg[i] == 0)[:64, 0]
        local[i, :zero.numel()] = zero
    local[:, -1] = pps - 1
    pos = (base[:, None] + local).to(torch.int32).contiguous()
    none = torch.zeros((s, l), dtype=torch.bool, device=dev)
    got = check_hop(pos, none, r, base, off, tgt, "all lanes gated off")
    if got[0].any() or got[1].any():
        raise AssertionError("walk_hop_fused: a gated-off lane hopped")
    every = torch.ones_like(none)
    got = check_hop(pos, every, r, base, off, tgt, "degree-0 and last rows")
    if bool(got[1][deg.gather(1, local) == 0].any()):
        raise AssertionError("walk_hop_fused: a degree-0 row hopped")
    half = torch.rand((s, l), generator=gen, device=dev) < 0.5
    garbage = torch.where(half, pos, torch.full_like(pos, -7))
    check_hop(garbage, half, r, base, off, tgt, "garbage on gated-off lanes")
    bo = shg.b2p_offsets
    bbase = (torch.arange(s, device=dev, dtype=torch.int32) * shg.boards_per_shard)
    blocal = torch.randint(0, shg.boards_per_shard, (s, l), generator=gen, device=dev)
    blocal[:, -1] = shg.boards_per_shard - 1
    check_hop((bbase[:, None] + blocal).to(torch.int32).contiguous(), every, r,
              bbase.contiguous(), bo, shg.b2p_targets, "board rows")
    return 4


def sharded_phases(graph, reqs, shape, dev):
    """Phases 11-15 on the full-width graph; returns the hop kernel's row
    and the launch counts of each sharded path."""
    import torch
    from repro_torch.configs.pixie import FULL_WALK, SERVE_3B_SHARDED, SHARDED_WALK
    from repro_torch.core import distributed as dist
    from repro_torch.core import prng, service
    from repro_torch.kernels import _build, ops
    from repro_torch.serving import traffic
    from repro_torch.serving.resilience import overlap_at_k
    from repro_torch.serving.server import PixieServer

    n_shards = SERVE_3B_SHARDED.n_shards
    # 11. the 16-way sharded copy, sliced on the card
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    shg = dist.shard_graph(graph, n_shards)
    torch.cuda.synchronize()
    log("sharded_graph", name=f"{shape.name} sharded {n_shards} ways",
        n_shards=n_shards, pins_per_shard=shg.pins_per_shard,
        boards_per_shard=shg.boards_per_shard, **shard_sizes(shg),
        sharded_gb=shg.nbytes() / 1e9, shard_s=time.perf_counter() - t,
        resident_gb=torch.cuda.memory_allocated() / 1e9,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, cuts=SHARD_CUTS)
    fabric = dist.LocalFabric(n_shards, device=dev)
    cfg0 = dataclasses.replace(FULL_WALK, bias_beta=0.0)
    server_key = prng.key(SEED, dev)

    # 12. full-width parity: 8 requests, sharded vs unsharded, bit for bit
    ids = SHARDED_PARITY_REQUESTS
    pins, weights, feats = padded_batch([reqs[i] for i in ids], shape.n_slots, dev)
    keys = prng.fold_in(server_key, torch.tensor(ids, device=dev))
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t = time.perf_counter()
    got = service.serve_batch(shg, pins, weights, feats, keys, cfg0,
                              with_stats=True, fabric=fabric, slack=SHARDED_SLACK)
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t) * 1e3
    parity_launches = dict(_build.launches)
    peak = torch.cuda.max_memory_allocated() / 1e9
    t = time.perf_counter()
    want = service.serve_batch(graph, pins, weights, feats, keys, cfg0,
                               with_stats=True)
    torch.cuda.synchronize()
    unsharded_ms = (time.perf_counter() - t) * 1e3
    if int(got[4]) != 0:
        raise AssertionError(f"sharded parity run dropped {int(got[4])} walkers")
    assert_same(got[:4], want, "16-way sharded vs unsharded")
    early = int((got[3] > cfg0.n_p).sum())
    if not early:
        raise AssertionError("sharded parity: early stop never fired")
    for i in range(len(ids)):
        check_result(got[0][i], got[1][i], cfg0.top_k, graph.n_pins, f"sharded {ids[i]}")
    for name in ("walk_hop_fused", "visit_counter_update_high"):
        if parity_launches[name] == 0:
            raise AssertionError(f"the sharded parity run never launched {name}")
    log("sharded_parity", requests=ids, identical=True, dropped=0,
        slack=SHARDED_SLACK, early_stopped_rows=early,
        steps_taken=got[2].sum(1).tolist(), n_high=got[3].sum(1).tolist(),
        sharded_batch_ms=sharded_ms, unsharded_per_query_ms=unsharded_ms,
        peak_gb=peak, launches=parity_launches)
    del got, want
    torch.cuda.empty_cache()

    # 13. the production recipe: kernel path == plain path, drops included
    wcfg = dist._wrapper_walk_config(SHARDED_WALK, n_shards)
    plain_cfg = dataclasses.replace(wcfg, backend="xla")
    lat, drops, occs, captured = [], [], [], {}
    real_hop = ops.walk_hop
    recipe_launches = dict.fromkeys(_build.launches, 0)
    for rid in range(8):
        qp, qw, _ = padded_batch([reqs[rid]], shape.n_slots, dev)
        key = prng.fold_in(server_key, rid)
        torch.cuda.synchronize()
        _build.reset_launches()
        t = time.perf_counter()
        top = dist.pixie_walk_sharded(shg, qp[0], qw[0], key, SHARDED_WALK, fabric)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
        for name, n in _build.launches.items():
            recipe_launches[name] += n
        calls = []

        def recording_hop(*args, **kw):
            # the routed buffers of superstep 8's two hops, as the engine
            # hands them over (none is written to after the call)
            if rid == 0 and len(calls) in (16, 17):
                captured[len(calls)] = args
            calls.append(None)
            return real_hop(*args, **kw)

        ops.walk_hop = recording_hop
        try:
            runs = [dist.pixie_walk_sharded_batched(
                shg, qp, qw, prng.split(key, 1), c, fabric,
                slack=SHARDED_WALK.slack) for c in (wcfg, plain_cfg)]
        finally:
            ops.walk_hop = real_hop
        a, b = runs
        for name, x in a._asdict().items():
            y = getattr(b, name)
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
                raise AssertionError(f"recipe request {rid}: {name} differs between kernel and plain paths")
        sc, ids_k = dist._hierarchical_topk(a.counts, n_shards, 1, shape.n_slots,
                                            shg.pins_per_shard, SHARDED_WALK.top_k, fabric)
        if not (torch.equal(sc[0], top.top_scores) and torch.equal(ids_k[0], top.top_pins)):
            raise AssertionError(f"recipe request {rid}: entry point differs from the engine")
        check_result(top.top_scores, top.top_pins, SHARDED_WALK.top_k, graph.n_pins,
                     f"recipe {rid}")
        drops.append(int(a.dropped))
        occs.append(int(a.max_occupancy))
        del runs, a, b
    if recipe_launches["walk_hop_fused"] == 0:
        raise AssertionError("the production recipe never launched walk_hop_fused")
    log("sharded_recipe", recipe=dataclasses.asdict(SHARDED_WALK), n_shards=n_shards,
        walkers=wcfg.n_walkers, capacity=SHARDED_WALK.capacity(n_shards),
        requests=8, p50_ms=float(np.percentile(lat, 50)), max_ms=float(np.max(lat)),
        latencies_ms=lat, dropped=drops, max_occupancy=occs,
        kernel_equals_plain=True, launches=recipe_launches)

    # 15. the hop kernel against its twin at the production shapes
    hops = []
    for i in (16, 17):
        pos, gate, r, off, tgt, base = captured[i]
        hops.append((pos, gate, r, base, off, tgt))
    timed = [time_hop(h, w) for h, w in zip(hops, ("pin->board", "board->pin"))]
    n_edge = hop_edge_cases(shg, dev)
    hop_row = dict(
        name="walk_hop_fused", route="cuda",
        source="src/repro_torch/kernels/csrc/walk_hop.cu",
        replaces="src/repro/kernels/walk_step.py:760",
        launches=None, max_abs_err=0,
        **{k: timed[0][k] + timed[1][k] for k in ("ms", "plain_ms", "bound_ms")},
        bound_by="bytes", library_ms=None,
    )
    log("hop_kernel", superstep=8, identical=True, edge_cases_identical=n_edge,
        row_is="the sum of one superstep's two hops, all 16 shards per launch",
        library="none: no single torch call computes the hop")

    # 14. the sharded replica: healthy, one shard killed, revived
    def serve_all(srv):
        out = []
        for rid, (p, w, f) in enumerate(reqs):
            srv.submit(p, w, user_feat=f, req_id=rid)
            srv.pump()
            out += srv.harvest()
        torch.cuda.synchronize()
        return sorted(out, key=lambda r: r.req_id)

    srv = PixieServer(shg, cfg0, buckets=[(1, shape.n_slots)], seed=SEED,
                      fabric=fabric, slack=SHARDED_SLACK)
    _build.reset_launches()
    healthy = serve_all(srv)
    server_launches = dict(_build.launches)
    hlat = [r.latency_ms for r in healthy]
    victim, at = 3, 8
    srv.kill_shard(victim, at_superstep=at)
    killed = serve_all(srv)
    n_killed = srv.stats.killed
    if n_killed <= 0:
        raise AssertionError("a shard died at superstep 8 and no walker was killed")
    dead = torch.full((n_shards,), dist.NEVER_DIES, dtype=torch.int32, device=dev)
    dead[victim] = at
    for r in killed:
        batch = padded_batch([reqs[r.req_id]], shape.n_slots, dev)
        s_o, i_o = service.serve_batch(
            shg, *batch, prng.fold_in(server_key, r.req_id)[None, :], cfg0,
            fabric=fabric, slack=SHARDED_SLACK, shard_dead_at=dead)
        if not (np.array_equal(s_o[0].cpu().numpy(), r.scores)
                and np.array_equal(i_o[0].cpu().numpy(), r.ids)):
            raise AssertionError(f"killed request {r.req_id}: replica differs from the shard_dead_at oracle")
    overlap = overlap_at_k(np.stack([r.ids for r in killed]),
                           np.stack([r.ids for r in healthy]))
    srv.revive_shards()
    revived = serve_all(srv)
    assert_results_equal(revived, healthy, "revived vs healthy")
    profile_request(srv, reqs[0], len(reqs), trace="chip_smoke_sharded_trace.json")
    log("sharded_server", requests=len(healthy), p50_ms=float(np.percentile(hlat, 50)),
        max_ms=float(np.max(hlat)), latencies_ms=hlat,
        killed_p50_ms=float(np.percentile([r.latency_ms for r in killed], 50)),
        victim=victim, at_superstep=at, killed=n_killed,
        route_dropped=srv.stats.route_dropped, overlap_at_k=overlap,
        oracle_identical=True, revived_identical=True, launches=server_launches)

    # 14b. open loop with seeded shard deaths, replayed twice
    oreqs = traffic.poisson_requests(
        connected_pins(graph, 1024), traffic.OpenLoopConfig(
            offered_qps=0.5 * 1000.0 / float(np.percentile(hlat, 50)),
            n_requests=24, seed=SEED, max_pins=shape.n_slots, n_feats=4))
    faults = traffic.sample_fault_schedule(traffic.ChaosConfig(
        horizon_s=oreqs[-1].t_arrival, seed=SEED, n_shard_deaths=2,
        n_shards=n_shards, death_max_superstep=16))
    reps = []
    _build.reset_launches()
    for _ in range(2):
        osrv = PixieServer(shg, cfg0, buckets=[(1, shape.n_slots)], seed=SEED,
                           fabric=fabric, slack=SHARDED_SLACK)
        reps.append((traffic.run_open_loop(osrv, oreqs, faults=faults), osrv))
        if len(reps) == 1:
            open_launches = dict(_build.launches)
    (a, sa), (b, sb) = reps
    if sorted(a.results) != sorted(b.results) or sa.dead_shards() != sb.dead_shards():
        raise AssertionError("sharded open loop: the replay served other requests")
    assert_results_equal([a.results[k] for k in sorted(a.results)],
                         [b.results[k] for k in sorted(b.results)],
                         "sharded open-loop replay")
    if not sa.dead_shards() or sa.stats.killed != sb.stats.killed:
        raise AssertionError("sharded open loop: deaths did not replay")
    log("sharded_open_loop", requests=len(oreqs), served=a.n_served,
        deaths=[[e.shard, e.at_superstep, e.t_start] for e in faults.of_kind("shard_death")],
        dead_shards=sa.dead_shards(), killed=sa.stats.killed,
        route_dropped=sa.stats.route_dropped, replay_identical=True,
        offered_qps=a.offered_qps, achieved_qps=a.achieved_qps,
        p50_ms=a.percentile(50), p99_ms=a.percentile(99), launches=open_launches)
    del shg, srv, osrv, reps, captured, hops
    torch.cuda.empty_cache()
    return hop_row, [parity_launches, recipe_launches, server_launches, open_launches]


def nccl_fabric(sg, dev) -> None:
    """Phase 16: ProcessGroupFabric over NCCL on one rank (a TCP store on
    localhost) equals LocalFabric(1) on the 20k graph; board counts of the
    4-way sharded walk equal the unsharded engine's."""
    import datetime
    import socket

    import torch
    import torch.distributed as tdist
    from repro_torch.core import counter, distributed as dist, prng, walk

    cfg = walk.WalkConfig(n_steps=20_000, n_walkers=512, chunk_steps=4, n_p=300,
                          n_v=3, bias_beta=0.0, count_boards=True, backend="pallas")
    from repro_torch.graphs import synthetic

    qs = synthetic.top_degree_pins(sg, 16)
    pins = torch.as_tensor(qs[:12].reshape(3, 4).astype(np.int32), device=dev)
    weights = torch.full((3, 4), 0.5, device=dev)
    keys = prng.split(prng.key(SEED + 6, dev), 3)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    tdist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                             world_size=1, rank=0,
                             timeout=datetime.timedelta(seconds=120))
    try:
        shg1 = dist.shard_graph(sg.graph, 1)
        runs = [dist.pixie_walk_sharded_batched(shg1, pins, weights, keys, cfg, f, slack=2.0)
                for f in (dist.ProcessGroupFabric(device=dev), dist.LocalFabric(1, device=dev))]
        tops = [dist._hierarchical_topk(r.counts, 1, 3, 4, shg1.pins_per_shard, 50, f)
                for r, f in zip(runs, (dist.ProcessGroupFabric(device=dev), None))]
        torch.cuda.synchronize()
    finally:
        tdist.destroy_process_group()
    for name, x in runs[0]._asdict().items():
        y = getattr(runs[1], name)
        if (x is None) != (y is None) or (x is not None and not torch.equal(x, y)):
            raise AssertionError(f"NCCL fabric: {name} differs from LocalFabric(1)")
    if not all(torch.equal(x, y) for x, y in zip(*tops)):
        raise AssertionError("NCCL fabric: top-k differs from LocalFabric(1)")
    shg4 = dist.shard_graph(sg.graph, 4)
    res4 = dist.pixie_walk_sharded_batched(shg4, pins, weights, keys, cfg,
                                           dist.LocalFabric(4, device=dev), slack=8.0)
    flat = walk.pixie_random_walk_batched(
        sg.graph, pins, weights, torch.zeros(3, dtype=torch.int32, device=dev), keys, cfg)
    folded = counter.fold_sharded_counts(res4.board_counts, 3, 4, shg4.boards_per_shard)
    if int(res4.dropped) or not torch.equal(folded[..., :sg.graph.n_boards], flat.board_counts):
        raise AssertionError("4-way sharded board counts differ from the unsharded engine's")
    log("nccl_fabric", backend="nccl", world_size=1, identical_to_local=True,
        board_counts_4way_identical=True, board_visits=int(flat.board_counts.sum()))


# ---------------------------------------------------------------------------
# Phases 17-20: dense-LM decode serving (Qwen2.5-3B and SmolLM-360M)
# ---------------------------------------------------------------------------

LM_BATCH = 4
LM_PROMPT = 512
LM_NEW_TOKENS = 32
SMOLLM_PROMPT = 128
SMOLLM_NEW_TOKENS = 16
# the reference's decode_32k cell (repro/configs/registry.py LM_SHAPES) is
# 128 sequences of 32,768 tokens; 128 x 32,768 x 36,864 bytes of bf16 cache
# is 154.6 GB, more than one card holds, so the batch is cut to 16 (19.3 GB)
DECODE_32K = dict(seq_len=32_768, batch=16, reference_batch=128)
F32_PEAK_FLOPS = 67e12     # H100 SXM, float32 outside the tensor cores
ATTN_TOL = 2e-6            # kernel vs twin, absolute, on the float32 output
ATTN_EDGE_CASES = [        # (b, h, kh, dh, s, lengths, cache dtype)
    (2, 8, 2, 64, 300, 1, "float32"),            # length 1
    (4, 16, 2, 128, 544, "ragged", "bfloat16"),  # ragged lengths, group 8
    (3, 15, 5, 64, 700, 131, "float32"),         # not a tile multiple, group 3
    (2, 24, 8, 128, 1000, "ragged", "bfloat16"), # group 3, dh 128
    (2, 16, 2, 128, 4096, 4095, "float32"),      # group 8, dh 128
    (2, 6, 2, 16, 40, 33, "bfloat16"),           # dh 16, the smoke configs'
    (2, 3, 1, 20, 70, "ragged", "float32"),      # dh 20, not a multiple of 32
]


def attn_inputs(dev, b, h, kh, dh, s, lengths, kv_dtype, q_dtype, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, dh), generator=g, device=dev).to(q_dtype)
    k = torch.randn((b, s, kh, dh), generator=g, device=dev).to(kv_dtype)
    v = torch.randn((b, s, kh, dh), generator=g, device=dev).to(kv_dtype)
    if lengths == "ragged":
        lengths = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                                dtype=torch.int32)
        lengths[0] = s
    return q, k, v, lengths


def check_attn(q, k, v, lengths, what: str) -> float:
    """The decode-attention kernel against its twin on the same inputs:
    max abs difference, which must stay within ATTN_TOL."""
    import torch
    from repro_torch.kernels import decode_attention as da

    got = da.decode_attention(q, k, v, lengths)
    want = da.decode_attention_plain(q, k, v, lengths)
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"decode_attention {what}: bad output")
    err = float((got - want).abs().max())
    if err > ATTN_TOL:
        raise AssertionError(f"decode_attention {what}: max err {err} > {ATTN_TOL}")
    return err


def attn_bound(q, k, lengths) -> dict:
    """The least time for this call: q, the output and lengths once, and K
    and V each read once up to each row's length, over the HBM rate; the
    float32 multiply-adds (scores and p @ V) over the float32 peak."""
    b, h, dh = q.shape
    kh = k.shape[2]
    lens = ([int(lengths)] * b if isinstance(lengths, int)
            else [int(x) for x in lengths.tolist()])
    kv_bytes = 2 * sum(lens) * kh * dh * k.element_size()
    nbytes = (q.numel() * q.element_size() + b * h * dh * 4 + kv_bytes
              + (0 if isinstance(lengths, int) else 4 * b))
    flops = 4 * h * dh * sum(lens)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_PEAK_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, flops=flops)


def sdpa_yardstick(q, k, v, lengths):
    """One PyTorch call computing the same function, timed beside the
    kernel and never served with: scaled_dot_product_attention with
    enable_gqa over (b, heads, s, dh) views of the cache; the length mask
    is passed only where some row is shorter than the cache (an all-true
    mask would only push SDPA onto a slower backend)."""
    import torch
    import torch.nn.functional as F

    b, h, dh = q.shape
    s = k.shape[1]
    qs = q.to(k.dtype)[:, :, None, :]
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    mask = None
    if isinstance(lengths, int):
        if lengths < s:
            mask = (torch.arange(s, device=k.device) < lengths)[None, None, None, :]
    elif bool((lengths < s).any()):
        mask = (torch.arange(s, device=k.device)[None, :] < lengths[:, None])[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                  enable_gqa=True)


def time_attn(q, k, v, lengths, what: str) -> dict:
    """Device ms of the kernel (back to back), its twin's ms, SDPA's ms
    and the bound, on one call's inputs (``lengths`` an int: the wrapper
    then never synchronises), with the kernel's split plan; two calls on
    the same inputs must give the same bits."""
    import torch
    from repro_torch.kernels import decode_attention as da

    err = check_attn(q, k, v, lengths, what)
    if not torch.equal(da.decode_attention(q, k, v, lengths),
                       da.decode_attention(q, k, v, lengths)):
        raise AssertionError(f"decode_attention {what}: two runs differ")
    b, h, dh = q.shape
    plan = da.plan(b, h, k.shape[2], dh, k.dtype,
                   lengths if isinstance(lengths, int) else k.shape[1])
    row = dict(
        ms=device_ms(lambda: da.decode_attention(q, k, v, lengths), 20),
        plain_ms=cuda_ms(lambda: da.decode_attention_plain(q, k, v, lengths), 3),
        library_ms=device_ms(sdpa_yardstick(q, k, v, lengths), 20),
        max_abs_err=err, **attn_bound(q, k, lengths))
    log("attn_timing", what=what, q=list(q.shape), k=list(k.shape),
        cache_dtype=str(k.dtype), lengths=lengths, splits=plan.n_splits,
        split_len=plan.split_len, ctas=plan.ctas,
        kernel_over_sdpa=row["ms"] / row["library_ms"],
        share_of_bound=row["bound_ms"] / row["ms"], **row)
    return row


def capture_attention(fn):
    """Run ``fn`` with the decode step's attention op wrapped so that its
    first call's inputs are kept: ``(result of fn, (q, k, v, lengths))``.
    k and v stay views of the cache's layer 0."""
    from repro_torch.kernels import ops

    real, seen = ops.decode_attention, []

    def spy(q, k, v, lengths, *, use_kernel):
        if not seen:
            seen.append((q.clone(), k, v, lengths))
        return real(q, k, v, lengths, use_kernel=use_kernel)

    ops.decode_attention = spy
    try:
        out = fn()
    finally:
        ops.decode_attention = real
    return out, seen[0]


def lockstep_logits(params, cfg, prompt, n_new: int) -> list:
    """Prefill once, then decode on the kernel path and the plain path side
    by side, both fed the kernel path's greedy token: the max |logit
    difference| per step; the greedy tokens must agree at every step."""
    import torch
    from repro_torch.models import transformer

    logits, cache_k = transformer.prefill(params, prompt, cfg,
                                          max_seq=prompt.shape[1] + n_new)
    cache_p = {name: t.clone() for name, t in cache_k.items()}
    cur = torch.argmax(logits, dim=-1).to(torch.int32)
    diffs = []
    for i in range(n_new - 1):
        pos = prompt.shape[1] + i
        lk, cache_k = transformer.decode_step(params, cache_k, cur, pos, cfg)
        lp, cache_p = transformer.decode_step(params, cache_p, cur, pos, cfg,
                                              backend="xla")
        if not bool(torch.isfinite(lk).all()):
            raise AssertionError(f"{cfg.name}: step {i} logits not finite")
        diffs.append(float((lk - lp).abs().max()))
        cur = torch.argmax(lk, dim=-1).to(torch.int32)
        if not torch.equal(cur, torch.argmax(lp, dim=-1).to(torch.int32)):
            raise AssertionError(f"{cfg.name}: greedy tokens differ at step {i}")
    return diffs


def generate_both(params, cfg, prompt, n_new: int, what: str, identical=True):
    """Greedy generate on the kernel path (its launches counted) and on the
    plain path; the tokens must be in range and, with ``identical``, equal.
    Returns the kernel path's tokens, its launches, its wall seconds and
    the share of generated tokens the two paths agree on.  In bf16 the two
    attention outputs round to different bf16 values, so greedy paths may
    part; in float32 they must not."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.serving import decode

    torch.cuda.synchronize()
    _build.reset_launches()
    t = time.perf_counter()
    toks = decode.generate(params, prompt, cfg, max_new_tokens=n_new)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    launches = dict(_build.launches)
    plain = decode.generate(params, prompt, cfg, max_new_tokens=n_new, backend="xla")
    torch.cuda.synchronize()
    if _build.launches["decode_attention"] != launches["decode_attention"]:
        raise AssertionError(f"{what}: the plain path launched the kernel")
    b, s0 = prompt.shape
    if toks.shape != (b, s0 + n_new) or not torch.equal(toks[:, :s0], prompt):
        raise AssertionError(f"{what}: generated tokens have the wrong shape")
    new = toks[:, s0:]
    if int(new.min()) < 0 or int(new.max()) >= cfg.vocab_size:
        raise AssertionError(f"{what}: a generated token is outside the vocabulary")
    if identical and not torch.equal(toks, plain):
        raise AssertionError(f"{what}: kernel and plain paths generate different tokens")
    agree = float((new == plain[:, s0:]).float().mean())
    return toks, launches, wall_s, agree


def profile_decode_step(fn) -> dict:
    """One decode step under torch.profiler: wall ms, device busy ms and the
    idle share, the device operations it issued, and the host operations
    that took the most host time (self time, profiler overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    return dict(wall_ms=wall, device_busy_ms=busy,
                device_idle_share=max(0.0, 1 - busy / wall) if wall else None,
                device_ops=sum(e.count for e in kernels),
                top=[dict(kernel=e.key[:80], count=e.count,
                          ms=e.self_device_time_total / 1e3) for e in kernels[:6]],
                top_host=[dict(op=e.key[:80], count=e.count,
                               ms=e.self_cpu_time_total / 1e3) for e in host[:8]])


def lm_phases(dev, qwen, smollm, lm_batch=LM_BATCH, prompt_len=LM_PROMPT,
              new_tokens=LM_NEW_TOKENS, smollm_prompt=SMOLLM_PROMPT,
              smollm_new=SMOLLM_NEW_TOKENS, long=DECODE_32K):
    """Phases 17-20 (see the module docstring); returns the kernels-line
    row of decode_attention and the launch counts of the three LM paths."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)

    # 17. the kernel against its twin at edge shapes
    errs = []
    for i, (b, h, kh, dh, s, lengths, kv) in enumerate(ATTN_EDGE_CASES):
        for q_dtype in (torch.float32, getattr(torch, kv)):
            q, k, v, lens = attn_inputs(dev, b, h, kh, dh, s, lengths,
                                        getattr(torch, kv), q_dtype, SEED + i)
            errs.append(check_attn(q, k, v, lens, f"edge case {i}"))
    log("attn_kernel", cases=len(errs), max_abs_err=max(errs), tolerance=ATTN_TOL,
        shapes=[list(c) for c in ATTN_EDGE_CASES])
    del q, k, v, lens

    # 18. Qwen2.5-3B at full width in float32: kernel path == plain path
    cfg32 = dataclasses.replace(qwen, **f32)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = transformer.init_params(torch.Generator(device=dev).manual_seed(SEED), cfg32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    prompt = torch.randint(0, qwen.vocab_size, (lm_batch, prompt_len), dtype=torch.int32,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 1),
                           device=dev)
    _, f32_launches, f32_wall, _ = generate_both(params, cfg32, prompt, new_tokens,
                                                 "qwen f32")
    diffs = lockstep_logits(params, cfg32, prompt, new_tokens)
    log("lm_f32", model=qwen.name, n_layers=qwen.n_layers, d_model=qwen.d_model,
        vocab=qwen.vocab_size, params=qwen.param_count(), init_s=init_s,
        batch=lm_batch, prompt=prompt_len, new_tokens=new_tokens,
        tokens_identical=True, max_logit_diff_per_step=diffs,
        generate_s=f32_wall, launches=f32_launches,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)

    # 19. the serving dtypes (bf16 compute and cache): prefill, decode steps
    served = transformer.cast_for_serving(params, qwen)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    transformer.decode_step(served, transformer.prefill(served, prompt[:, :8], qwen,
                                                        max_seq=9)[1],
                            prompt[:, 8], 8, qwen)                     # warm-up
    toks, bf16_launches, bf16_wall, bf16_agree = generate_both(
        served, qwen, prompt, new_tokens, "qwen bf16", identical=False)
    out = {}
    prefill_ms = wall_ms(lambda: out.setdefault("p", transformer.prefill(
        served, prompt, qwen, max_seq=prompt_len + new_tokens)))
    cache = out["p"][1]
    step_ms = [wall_ms(lambda i=i: transformer.decode_step(
        served, cache, toks[:, prompt_len + i], prompt_len + i, qwen))
        for i in range(new_tokens)]
    prof = profile_decode_step(lambda: transformer.decode_step(
        served, cache, toks[:, -1], prompt_len + new_tokens - 1, qwen))
    # the kernel at the serving shape: layer 0 of the last step
    _, (q, k, v, lengths) = capture_attention(lambda: transformer.decode_step(
        served, cache, toks[:, -1], prompt_len + new_tokens - 1, qwen))
    serve_row = time_attn(q, k, v, lengths, f"serving batch {lm_batch} layer 0")
    del q, k, v
    p50 = float(np.percentile(step_ms, 50))
    log("lm_bf16", model=qwen.name, compute_dtype="bfloat16", cache_dtype="bfloat16",
        batch=lm_batch, prompt=prompt_len, new_tokens=new_tokens,
        prefill_ms=prefill_ms, decode_p50_ms=p50, decode_ms=step_ms,
        decode_tokens_per_s=lm_batch * 1e3 / p50,
        generate_s=bf16_wall, generate_tokens_per_s=lm_batch * new_tokens / bf16_wall,
        tokens_agreeing_with_plain=bf16_agree,
        attention_launches=bf16_launches["decode_attention"],
        launches=bf16_launches, profiled_step=prof,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del cache, out

    # 19b. decode_32k, cut: one decode step at position 32,767
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lb, ls = long["batch"], long["seq_len"]
    lcache = transformer.init_kv_cache(qwen, lb, ls, device=dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    for t_ in lcache.values():
        t_.normal_(generator=g)
    ltoks = torch.randint(0, qwen.vocab_size, (lb,), dtype=torch.int32, generator=g, device=dev)
    step = lambda backend: transformer.decode_step(served, lcache, ltoks, ls - 1, qwen,
                                                   backend=backend)
    step("pallas")                                                     # warm-up
    torch.cuda.synchronize()
    _build.reset_launches()
    long_ms = wall_ms(lambda: step("pallas"))
    long_launches = dict(_build.launches)
    long_plain_ms = wall_ms(lambda: step("xla"))
    (logits_k, _), (q, k, v, lengths) = capture_attention(lambda: step("pallas"))
    logits_p, _ = step("xla")
    torch.cuda.synchronize()
    row = time_attn(q, k, v, lengths, "decode_32k layer 0")
    long_prof = profile_decode_step(lambda: step("pallas"))
    log("decode_32k", model=qwen.name, seq_len=ls, batch=lb,
        cut=f"batch {lb} instead of {long['reference_batch']}: "
            f"{long['reference_batch']} x {ls} tokens x "
            f"{2 * qwen.n_layers * qwen.n_kv_heads * qwen.head_dim * 2} bytes of bf16 "
            "cache exceed one card",
        cache_gb=sum(t_.numel() * t_.element_size() for t_ in lcache.values()) / 1e9,
        step_ms=long_ms, plain_step_ms=long_plain_ms,
        max_logit_diff=float((logits_k - logits_p).abs().max()),
        launches=long_launches, profiled_step=long_prof,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del lcache, served, q, k, v, logits_k, logits_p
    torch.cuda.empty_cache()

    # 20. SmolLM-360M at full width in float32: pad heads on the card
    scfg = dataclasses.replace(smollm, **f32)
    torch.cuda.reset_peak_memory_stats()
    sparams = transformer.init_params(torch.Generator(device=dev).manual_seed(SEED + 3), scfg)
    sprompt = torch.randint(0, smollm.vocab_size, (lm_batch, smollm_prompt), dtype=torch.int32,
                            generator=torch.Generator(device=dev).manual_seed(SEED + 4),
                            device=dev)
    _, small_launches, small_wall, _ = generate_both(sparams, scfg, sprompt, smollm_new,
                                                     "smollm f32")
    sdiffs = lockstep_logits(sparams, scfg, sprompt, smollm_new)
    log("lm_smollm", model=smollm.name, n_heads=smollm.n_heads,
        n_heads_padded=smollm.n_heads_padded, batch=lm_batch, prompt=smollm_prompt,
        new_tokens=smollm_new, tokens_identical=True, max_logit_diff_per_step=sdiffs,
        generate_s=small_wall, launches=small_launches,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    del sparams
    torch.cuda.empty_cache()

    paths = [f32_launches, bf16_launches, long_launches, small_launches]
    if any(p["decode_attention"] == 0 for p in paths):
        raise AssertionError(f"an LM phase never launched decode_attention: {paths}")
    row = dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:80",
        launches=None,
        max_abs_err=max(row["max_abs_err"], serve_row["max_abs_err"], *errs),
        **{key: row[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
    )
    return row, paths


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# Phases 21-23: event-mode serving and the legacy kernels
# ---------------------------------------------------------------------------

WIDE_SLOTS = 16            # the reference's PixieArchConfig.n_slots
WIDE_REQUEST_PINS = (16, 12, 9, 16, 4, 16, 1, 10)
CHECK_EVERY = (1, 2, 4)    # FULL_WALK runs 4 chunks: 4 checks, 2, or 1
DENSE_CHECKED = (0, 1, 2)  # requests held against the dense engine
LEGACY_STEPS = 5
EVENT_FIELDS = ("slot_events", "pin_events", "steps_taken", "chunks_run",
                "n_high", "scores", "ids")


def wide_requests(graph):
    """Requests of up to ``WIDE_SLOTS`` pins with edges, as
    ``full_width_requests`` draws them."""
    import torch

    rng = np.random.default_rng(SEED + 3)
    cand = torch.from_numpy(
        rng.integers(0, graph.n_pins, 512).astype(np.int32)
    ).to(graph.device)
    cand = cand[graph.pin_degree(cand) > 0].cpu().numpy()
    reqs, at = [], 0
    for k in WIDE_REQUEST_PINS:
        pins = [int(p) for p in cand[at:at + k]]
        at += k
        weights = [float(w) for w in rng.uniform(0.1, 1.0, k).astype(np.float32)]
        reqs.append((pins, weights, int(rng.integers(0, 4))))
    return reqs


def event_request(graph, req, rid: int, n_slots: int, cfg, **kw):
    """One request through ``pixie_walk_events`` + ``recommend_from_events``
    under the server key's fold for ``rid``: the EventWalkResult's fields,
    then ``(scores, ids)``."""
    from repro_torch.core import prng, walk

    dev = graph.device
    pins, weights, feats = padded_batch([req], n_slots, dev)
    key = prng.fold_in(prng.key(SEED, dev), rid)
    r = walk.pixie_walk_events(graph, pins[0], weights[0], feats[0], key, cfg, **kw)
    return (*r, *walk.recommend_from_events(r, n_slots, graph.n_pins, pins[0],
                                            cfg.top_k))


def assert_events_equal(a, b, what: str) -> None:
    import torch

    for name, x, y in zip(EVENT_FIELDS, a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: {name} differs")


def serve_events(graph, reqs, n_slots, cfg):
    """Every request through event mode, each timed on the host clock
    between two synchronisations -> (outputs, latencies in ms)."""
    import torch

    outs, lat = [], []
    for rid, req in enumerate(reqs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs.append(event_request(graph, req, rid, n_slots, cfg))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t) * 1e3)
    return outs, lat


def dense_oracle(graph, req, rid: int, n_slots: int, cfg):
    """The dense engine on one request under the same key: ``walk.recommend``
    itself; the dense counts with every query pin's column zeroed, boosted
    and ranked (event mode's query-pin rule: the dense engine debits only a
    slot's own query pin); and the visits query pins got from other
    slots, the only thing that can part the two."""
    from repro_torch.core import counter, prng, walk

    dev = graph.device
    pins, weights, feats = padded_batch([req], n_slots, dev)
    key = prng.fold_in(prng.key(SEED, dev), rid)
    rec = walk.recommend(graph, pins[0], weights[0], feats[0], key, cfg)
    counts = walk.pixie_random_walk(graph, pins[0], weights[0], feats[0], key,
                                    cfg).counts
    q = pins[0][pins[0] >= 0].long()
    cross = int(counts[:, q].sum())
    counts[:, q] = 0
    masked = counter.topk_dense(counter.boost_combine(counts), cfg.top_k)
    return rec, masked, cross


VISIT_EDGE_CASES = [(0, 64), (1, 1), (5000, 1300), (777, 33), (4096, 1),
                    (300, 0), (200_000, 4099)]   # (events, bins)
STEP_EDGE_WALKERS = (1, 100, 256, 4096)
STEP_EDGE_ALPHAS = (0, 2**31, 2**32 - 1)


def dead_end_csr(dev):
    """6 pins, 4 boards (global ids 6..9): pins 0 and 5 (the last row)
    have no boards, boards 2 and 3 (the last row) no pins, and pins 3 and
    1 point at them, so both last rows are reached."""
    import torch

    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return (t([0, 0, 2, 3, 4, 6, 6]), t([6, 9, 7, 8, 6, 7]),
            t([0, 2, 4, 4, 4]), t([1, 4, 2, 4])), 6


def int_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def legacy_edge_cases(graph, dev) -> int:
    """Both legacy kernels against their twins at edge shapes; returns the
    number of cases checked."""
    import torch
    from repro_torch.kernels import visit_counter as vc
    from repro_torch.kernels import walk_step as ws

    n = 0
    for i, (m, n_bins) in enumerate(VISIT_EDGE_CASES):
        rng = np.random.default_rng(SEED + 10 + i)
        ev = rng.integers(-5, n_bins + 20, m).astype(np.int32)
        if m >= 4:
            ev[:4] = [-(2**31), 2**31 - 1, n_bins, -1]
        ev = torch.as_tensor(ev, device=dev)
        if int_err(vc.visit_counter(ev, n_bins), vc.visit_counter_plain(ev, n_bins)):
            raise AssertionError(f"visit_counter edge case {(m, n_bins)} differs")
        n += 1
    dead, dead_pins = dead_end_csr(dev)
    full = (graph.p2b.offsets, graph.p2b.targets, graph.b2p.offsets,
            graph.b2p.targets)
    for csr, n_pins, walkers in ((dead, dead_pins, STEP_EDGE_WALKERS),
                                 (full, graph.n_pins, (8192,))):
        for w in walkers:
            for alpha in STEP_EDGE_ALPHAS:
                gen = torch.Generator(device=dev).manual_seed(SEED + w + alpha % 97)
                curr = torch.randint(0, n_pins, (w,), generator=gen, device=dev,
                                     dtype=torch.int32)
                query = torch.randint(0, n_pins, (w,), generator=gen, device=dev,
                                      dtype=torch.int32)
                words = torch.randint(0, 2**32, (w, 3), generator=gen, device=dev,
                                      dtype=torch.int64)
                words[::2] |= 2**31                 # high-bit draws
                rb = ws.u32_bits_as_int32(words).contiguous()
                got = ws.walk_step(curr, query, rb, *csr, n_pins=n_pins,
                                   alpha_u32=alpha)
                want = ws.walk_step_plain(curr, query, rb, *csr, n_pins=n_pins,
                                          alpha_u32=alpha)
                if any(int_err(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"walk_step edge case w={w} alpha={alpha} differs")
                n += 1
    return n


def event_phases(graph, reqs, shape, dev):
    """Phases 21-23 on the full-width graph; returns the kernels-line rows
    of visit_counter and walk_step and the launch counts of each path."""
    import torch
    from repro_torch.configs.pixie import FULL_WALK
    from repro_torch.core import counter, walk
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import visit_counter as vc
    from repro_torch.kernels import walk_step as ws

    cfg = FULL_WALK
    plain = dataclasses.replace(cfg, backend="xla")
    n_slots = shape.n_slots
    n_pins = graph.n_pins

    # 21. the replicated cell in event mode
    torch.cuda.reset_peak_memory_stats()
    event_request(graph, reqs[0], 0, n_slots, cfg)     # warm-up
    _build.reset_launches()
    outs, lat = serve_events(graph, reqs, n_slots, cfg)
    replicated_launches = dict(_build.launches)
    if replicated_launches["walk_steps_fused"] == 0:
        raise AssertionError("event mode never launched walk_steps_fused")
    for rid, out in enumerate(outs):
        check_result(out[5], out[6], cfg.top_k, n_pins, f"event request {rid}")
        assert_events_equal(out, event_request(graph, reqs[rid], rid, n_slots, plain),
                            f"event request {rid}, kernel vs plain path")
    modes = []
    for rid in (0, 3):
        for every in CHECK_EVERY:
            inc = event_request(graph, reqs[rid], rid, n_slots, cfg, check_every=every)
            full = event_request(graph, reqs[rid], rid, n_slots, cfg,
                                 check_every=every, check_mode="full")
            assert_events_equal(inc, full, f"event request {rid}, check_every "
                                f"{every}: incremental vs full")
            modes.append(dict(request=rid, check_every=every,
                              chunks_run=int(inc[3]), n_high=int(inc[4].sum())))
    nes = cfg.without_early_stop()
    dense = []
    for rid in DENSE_CHECKED:
        ev = event_request(graph, reqs[rid], rid, n_slots, nes)
        rec, masked, cross = dense_oracle(graph, reqs[rid], rid, n_slots, nes)
        same_rec = torch.equal(ev[5], rec[0]) and torch.equal(ev[6], rec[1])
        if not (torch.equal(ev[5], masked[0]) and torch.equal(ev[6], masked[1])):
            raise AssertionError(f"event request {rid}: event mode differs from "
                                 "the dense engine's counts")
        if cross == 0 and not same_rec:
            raise AssertionError(f"event request {rid}: event mode differs from "
                                 "walk.recommend")
        dense.append(dict(request=rid, query_pin_visits_from_other_slots=cross,
                          equal_to_recommend=same_rec))
    log("events_replicated", name=shape.name, n_slots=n_slots,
        requests=len(outs), p50_ms=float(np.percentile(lat, 50)),
        max_ms=float(np.max(lat)), latencies_ms=lat,
        max_events=int(outs[0][0].shape[0]),
        chunks_run=[int(o[3]) for o in outs],
        steps_taken=[int(o[2].sum()) for o in outs],
        n_high=[int(o[4].sum()) for o in outs],
        identical_to_plain=True, incremental_equals_full=modes,
        dense_without_early_stop=dense, launches=replicated_launches,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        resident_gb=torch.cuda.memory_allocated() / 1e9)
    profile_call(lambda: event_request(graph, reqs[0], 0, n_slots, cfg),
                 trace="chip_smoke_events_trace.json")

    # 22. 16 slots: 2.24e9 packed ids, past what dense counting can index
    try:
        walk.select_count_engine(cfg.backend, WIDE_SLOTS, n_pins)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("dense counting accepted 16 slots at full width")
    if "pixie_walk_events" not in refused:
        raise AssertionError(f"dense refusal does not name event mode: {refused}")
    wreqs = wide_requests(graph)
    _build.reset_launches()
    wouts, wlat = serve_events(graph, wreqs, WIDE_SLOTS, cfg)
    wide_launches = dict(_build.launches)
    if wide_launches["walk_steps_fused"] == 0:
        raise AssertionError("16-slot event mode never launched walk_steps_fused")
    for rid, out in enumerate(wouts):
        check_result(out[5], out[6], cfg.top_k, n_pins, f"16-slot request {rid}")
        assert_events_equal(out, event_request(graph, wreqs[rid], rid, WIDE_SLOTS,
                                               plain),
                            f"16-slot request {rid}, kernel vs plain path")
    log("events_wide", n_slots=WIDE_SLOTS, packed_ids=WIDE_SLOTS * n_pins,
        dense_refused=refused, requests=len(wouts),
        pins=[len(r[0]) for r in wreqs], p50_ms=float(np.percentile(wlat, 50)),
        max_ms=float(np.max(wlat)), latencies_ms=wlat,
        chunks_run=[int(o[3]) for o in wouts], identical_to_plain=True,
        launches=wide_launches)

    # 23. the legacy kernels: ops.walk_step chained, ops.visit_counts over
    # one event request's pin lane
    w = cfg.n_walkers
    qpins = torch.tensor([p for r in reqs for p in r[0]], dtype=torch.int32,
                         device=dev)
    query = qpins.repeat(-(-w // qpins.numel()))[:w].contiguous()
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    words = [torch.randint(0, 2**32, (w, 3), generator=gen, device=dev,
                           dtype=torch.int64) for _ in range(LEGACY_STEPS)]
    csr = (graph.p2b.offsets, graph.p2b.targets, graph.b2p.offsets,
           graph.b2p.targets)
    alpha = walk._prob_u32(cfg.alpha)
    sev, pev = outs[0][0], outs[0][1]
    lane = torch.where(sev < n_slots, pev, -1)
    _build.reset_launches()
    curr_k = curr_p = query
    hops, step_err = [], 0
    for s in range(LEGACY_STEPS):
        got = ops.walk_step(curr_k, query, words[s], *csr, n_pins=n_pins,
                            alpha_u32=alpha)
        want = ops.walk_step(curr_p, query, words[s], *csr, n_pins=n_pins,
                             alpha_u32=alpha, use_kernel=False)
        step_err = max(step_err, *(int_err(a, b) for a, b in zip(got, want)))
        if step_err:
            raise AssertionError(f"ops.walk_step superstep {s}: kernel vs twin differ")
        hops.append(int(got[2].sum()))
        curr_k, curr_p = got[0], want[0]
    hist = ops.visit_counts(lane, n_pins)
    visit_err = int_err(hist, ops.visit_counts(lane, n_pins, use_kernel=False))
    if visit_err:
        raise AssertionError("ops.visit_counts: kernel vs twin differ")
    uniq_slot, uniq_pin, counts = counter.events_to_counts(sev, pev, n_slots,
                                                           sev.shape[0])
    for slot in range(n_slots):
        hs = ops.visit_counts(torch.where(sev == slot, pev, -1), n_pins)
        sel = uniq_slot == slot
        if not (torch.equal(hs[uniq_pin[sel].long()], counts[sel])
                and int(hs.sum()) == int(counts[sel].sum())):
            raise AssertionError(f"slot {slot}: histogram differs from the event runs")
    legacy_launches = dict(_build.launches)
    for name in ("walk_step", "visit_counter"):
        if legacy_launches[name] == 0:
            raise AssertionError(f"the legacy path never launched {name}")
    n_edge = legacy_edge_cases(graph, dev)
    log("legacy_kernels", walkers=w, supersteps=LEGACY_STEPS, hops_ok=hops,
        events=int(lane.numel()), valid_events=int((lane >= 0).sum()),
        n_bins=n_pins, identical=True, per_slot_equals_event_runs=True,
        edge_cases_identical=n_edge, launches=legacy_launches)

    # the two rows of the kernels line, at the legacy path's shapes
    valid_ids = lane[lane >= 0]
    ms = device_ms(lambda: vc.visit_counter(lane, n_pins), 50)
    sectors = int(torch.unique(valid_ids >> 3).numel())
    nbytes = 4 * lane.numel() + 4 * n_pins + SECTOR * sectors
    visit_row = dict(
        name="visit_counter", route="cuda",
        source="src/repro_torch/kernels/csrc/visit_counter.cu",
        replaces="src/repro/kernels/visit_counter.py:83", launches=None,
        max_abs_err=visit_err, ms=ms,
        plain_ms=cuda_ms(lambda: vc.visit_counter_plain(lane, n_pins), 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=cuda_ms(lambda: torch.bincount(valid_ids, minlength=n_pins), 50),
    )
    log("kernel", name="visit_counter", device_ms=ms, events=int(lane.numel()),
        valid_events=int(valid_ids.numel()), bins=n_pins,
        distinct_sectors=sectors, bound_bytes=nbytes)
    rb = ws.u32_bits_as_int32(words[0]).contiguous()
    step = lambda: ws.walk_step(query, query, rb, *csr, n_pins=n_pins,
                                alpha_u32=alpha)
    _, visited, _ = step()
    rb4 = torch.zeros((1, w, 4), dtype=torch.int32, device=dev)
    rb4[0, :, 0], rb4[0, :, 2], rb4[0, :, 3] = rb[:, 0], rb[:, 1], rb[:, 2]
    sectors = walk_sectors(dict(
        rbits=rb4, feat=torch.zeros_like(query), query=query, curr=query,
        csr=(*csr, None, None), kw=dict(n_pins=n_pins, alpha_u32=alpha,
                                        beta_u32=0)), visited[None, :])
    nbytes = SECTOR * sectors + (4 + 4 + 12 + 4 + 4 + 1) * w
    ms = device_ms(step, 50)
    step_row = dict(
        name="walk_step", route="cuda",
        source="src/repro_torch/kernels/csrc/walk_step.cu",
        replaces="src/repro/kernels/walk_step.py:143", launches=None,
        max_abs_err=step_err, ms=ms,
        plain_ms=cuda_ms(lambda: ws.walk_step_plain(query, query, rb, *csr,
                                                    n_pins=n_pins,
                                                    alpha_u32=alpha), 5),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None,
    )
    log("kernel", name="walk_step", device_ms=ms, walkers=w,
        distinct_sectors=sectors, bound_bytes=nbytes)
    del outs, wouts, lane, hist, counts
    torch.cuda.empty_cache()
    return [visit_row, step_row], [replicated_launches, wide_launches,
                                   legacy_launches]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs import qwen2_5_3b, smollm_360m
    from repro_torch.configs.pixie import FULL_WALK, SERVE_200M_REPLICATED
    from repro_torch.core import prng, service, walk
    from repro_torch.core import counter as counter_lib
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels import visit_counter as vc
    from repro_torch.kernels import walk_step as ws
    from repro_torch.serving import ranker, traffic
    from repro_torch.serving.resilience import ResilienceConfig
    from repro_torch.serving.server import PixieServer

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log("env", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())

    # 1. build --------------------------------------------------------------
    t = time.perf_counter()
    built = _build.build()
    log("build", seconds=time.perf_counter() - t, built=built)

    # 2. full-width serving ---------------------------------------------------
    shape = SERVE_200M_REPLICATED
    cfg = FULL_WALK
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    graph = full_width_graph(shape, dev)
    torch.cuda.synchronize()
    log("graph", name=shape.name, n_pins=graph.n_pins, n_boards=graph.n_boards,
        n_edges=graph.n_edges, max_pin_degree=graph.max_pin_degree,
        graph_gb=graph.nbytes() / 1e9, build_s=time.perf_counter() - t,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9, cuts="none")
    reqs = full_width_requests(graph, shape.n_slots)
    # warm-up outside the measured run: library load, allocator growth
    service.serve_batch(graph, *padded_batch(reqs[:1], shape.n_slots, dev),
                        prng.key(SEED, dev), cfg)
    torch.cuda.synchronize()

    server = PixieServer(graph, cfg, buckets=[(1, shape.n_slots)], seed=SEED)
    _build.reset_launches()
    results = []
    for rid, (p, w, f) in enumerate(reqs):
        server.submit(p, w, user_feat=f, req_id=rid)
        server.pump()
        results += server.harvest()
    torch.cuda.synchronize()
    serve_launches = dict(_build.launches)
    for name in ("walk_steps_fused", "visit_counter_update_high"):
        if serve_launches[name] == 0:
            raise AssertionError(f"the full-width run never launched {name}")
    for r in results:
        check_result(r.scores, r.ids, cfg.top_k, graph.n_pins, f"request {r.req_id}")
    lat = [r.latency_ms for r in results]
    # per-phase split of one request, each phase synchronised
    pins, weights, feats = padded_batch(reqs[:1], shape.n_slots, dev)
    keys = prng.fold_in(prng.key(SEED, dev), 0)[None, :]
    res = {}
    phase_ms = dict(walk_loop=wall_ms(lambda: res.setdefault(
        "w", walk.pixie_random_walk_batched(graph, pins, weights, feats, keys, cfg))))
    boosted = {}
    phase_ms["boost"] = wall_ms(lambda: boosted.setdefault(
        "b", counter_lib.boost_combine(res["w"].counts)))
    phase_ms["topk"] = wall_ms(lambda: counter_lib.topk_dense(boosted["b"], cfg.top_k))
    del res, boosted
    log("serve", requests=len(results), p50_ms=float(np.percentile(lat, 50)),
        max_ms=float(np.max(lat)), latencies_ms=lat, phase_ms=phase_ms,
        launches=serve_launches,
        steps_budget=cfg.n_steps, walkers=cfg.n_walkers)

    profile_request(server, reqs[0], len(reqs))

    # 3. parity on the card -----------------------------------------------------
    ids = list(range(len(reqs)))
    kern = serve_with_stats(graph, reqs, ids, shape.n_slots, cfg, "pallas")
    plain = serve_with_stats(graph, reqs, ids, shape.n_slots, cfg, "xla")
    for rid, a, b, r in zip(ids, kern, plain, results):
        assert_same(a, b, f"full-width request {rid}")
        if not (np.array_equal(a[0][0].cpu().numpy(), r.scores)
                and np.array_equal(a[1][0].cpu().numpy(), r.ids)):
            raise AssertionError(f"request {rid}: server result differs from serve_batch")
    log("parity", requests=len(ids), identical=True,
        steps_taken=[int(a[2].sum()) for a in kern],
        n_high=[int(a[3].sum()) for a in kern])

    # 5a. walk + update_high at the full-width shapes, while that graph is
    # resident (launch counts are filled in from phases 2 and 4)
    winp = walk_inputs(graph, reqs[:1], shape.n_slots, cfg)
    walk_row, lanes = check_walk_kernel(winp)
    _, qev, sev, pev, _ = lanes
    high_row = check_counter_kernel(
        "visit_counter_update_high", vc.visit_counter_update_high,
        vc.visit_counter_update_high_plain,
        shape.n_slots * graph.n_pins, (qev.reshape(-1), sev.reshape(-1), pev.reshape(-1)),
        dict(n_slots=shape.n_slots, n_pins=graph.n_pins, n_v=cfg.n_v, n_queries=1),
        "src/repro/kernels/visit_counter.py:329",
    )
    del winp, lanes, qev, sev, pev, kern, plain, server, results
    torch.cuda.empty_cache()

    # 21-23. event-mode serving and the legacy kernels on the same graph ---------
    event_rows, event_paths = event_phases(graph, reqs, shape, dev)

    # 6. full-width ranked serving ------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    rcfg = ranker.RankerConfig(n_items=graph.n_pins)
    t = time.perf_counter()
    rank = ranker.RankRequest(ranker.init_ranker_params(
        torch.Generator(device=dev).manual_seed(SEED), rcfg), rcfg)
    torch.cuda.synchronize()
    table = rank.params["items"]
    log("ranker", n_items=rcfg.n_items, d_model=rcfg.d_model,
        n_neighbors=rcfg.n_neighbors, n_candidates=rcfg.n_candidates,
        final_k=rcfg.final_k, scenarios=list(rcfg.scenarios),
        table_gb=table.numel() * table.element_size() / 1e9,
        init_s=time.perf_counter() - t,
        resident_gb=torch.cuda.memory_allocated() / 1e9)
    rwalk = dataclasses.replace(cfg, top_k=rcfg.n_candidates)
    scen = [rid % 2 for rid in range(len(reqs))]
    service.serve_batch(graph, *padded_batch(reqs[:1], shape.n_slots, dev),
                        prng.key(SEED, dev), rwalk, rank=rank)   # warm-up
    rserver = PixieServer(graph, rwalk, buckets=[(1, shape.n_slots)],
                          seed=SEED, ranker=rank)
    torch.cuda.synchronize()
    _build.reset_launches()
    ranked = []
    for rid, (p, w, f) in enumerate(reqs):
        rserver.submit(p, w, user_feat=f, req_id=rid, scenario=scen[rid])
        rserver.pump()
        ranked += rserver.harvest()
    torch.cuda.synchronize()
    ranked_launches = dict(_build.launches)
    for name in ("walk_steps_fused", "visit_counter_update_high", "embedding_bag"):
        if ranked_launches[name] == 0:
            raise AssertionError(f"the full-width ranked run never launched {name}")
    server_key = prng.key(SEED, dev)
    for r in ranked:
        check_ranked(r.scores, r.ids, rcfg.final_k, graph.n_pins, f"ranked {r.req_id}")
        batch = padded_batch([reqs[r.req_id]], shape.n_slots, dev)
        keys = prng.fold_in(server_key, r.req_id)[None, :]
        sc = torch.tensor([scen[r.req_id]], dtype=torch.int32, device=dev)
        kern = service.serve_batch(graph, *batch, keys, rwalk, backend="pallas",
                                   rank=rank, scenario=sc, with_stats=True)
        assert_same(kern, ranked_plain(graph, rank, *batch, keys, rwalk, sc),
                    f"full-width ranked request {r.req_id}")
        if not (np.array_equal(kern[0][0].cpu().numpy(), r.scores)
                and np.array_equal(kern[1][0].cpu().numpy(), r.ids)):
            raise AssertionError(f"ranked request {r.req_id}: server differs from serve_batch")
    rlat = [r.latency_ms for r in ranked]
    r_p50 = float(np.percentile(rlat, 50))
    split = ranked_split_ms(
        graph, rank, *padded_batch(reqs[:1], shape.n_slots, dev),
        prng.fold_in(server_key, 0)[None, :], rwalk,
        torch.zeros(1, dtype=torch.int32, device=dev))
    log("ranked", requests=len(ranked), p50_ms=r_p50, max_ms=float(np.max(rlat)),
        latencies_ms=rlat, split_ms=split, launches=ranked_launches,
        identical_to_plain=True,
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        resident_gb=torch.cuda.memory_allocated() / 1e9)

    # 7. open loop on the full-width ranked replica ----------------------------------
    offered = 0.5 * 1000.0 / r_p50
    oreqs = traffic.poisson_requests(
        connected_pins(graph, 1024), traffic.OpenLoopConfig(
            offered_qps=offered, n_requests=OPEN_LOOP_REQUESTS, seed=SEED,
            max_pins=shape.n_slots, n_feats=4))
    oserver = PixieServer(
        graph, rwalk, buckets=[(1, shape.n_slots)], seed=SEED, ranker=rank,
        resilience=ResilienceConfig(elastic=False, max_queue_per_bucket=8))
    _build.reset_launches()
    t = time.perf_counter()
    report = traffic.run_open_loop(oserver, oreqs)
    torch.cuda.synchronize()
    open_wall = time.perf_counter() - t
    open_launches = dict(_build.launches)
    if report.n_served + report.n_dropped != OPEN_LOOP_REQUESTS or not report.n_served:
        raise AssertionError(f"open loop: {report.summary()}")
    for r in report.results.values():
        check_ranked(r.scores, r.ids, rcfg.final_k, graph.n_pins, f"open-loop {r.req_id}")
    log("open_loop", offered_qps=report.offered_qps, target_qps=offered,
        achieved_qps=report.achieved_qps, served=report.n_served,
        dropped=report.n_dropped, rejected=report.n_rejected,
        drop_rate=report.drop_rate, p50_ms=report.percentile(50),
        p99_ms=report.percentile(99), max_ms=float(report.latency_ms.max()),
        mean_wait_ms=float(report.wait_ms.mean()),
        mean_queue_ms=float(report.queue_ms.mean()),
        mean_compute_ms=float(report.compute_ms.mean()),
        p99_compute_ms=float(np.percentile(report.compute_ms, 99)),
        batches=oserver.stats.batches, makespan_s=report.makespan_s,
        wall_s=open_wall, launches=open_launches)

    # 8. the bag kernel at the ranked path's shapes, then edge shapes -----------------
    s0, i0 = service.serve_batch(
        graph, *padded_batch(reqs[:1], shape.n_slots, dev),
        prng.fold_in(server_key, 0)[None, :], rwalk)
    nbr_ids, nbr_w = ranker.candidate_neighborhoods(graph, i0, s0 > 0,
                                                    rcfg.n_neighbors)
    q_ids, q_w = ranker.query_bag(i0, s0)
    nbr = time_bag(table, nbr_ids, nbr_w, "mean", "neighbor bag")
    qry = time_bag(table, q_ids, q_w, "mean", "query bag")
    n_edge = check_edge_bags(dev)
    bag_row = dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:108",
        launches=None, max_abs_err=0.0,
        **{k: nbr[k] + qry[k] for k in ("ms", "plain_ms", "bound_ms", "library_ms")},
        bound_by="bytes",
    )
    log("bag_kernel", main_shapes=[list(nbr_ids.shape), list(q_ids.shape)],
        identical=True, edge_cases_identical=n_edge,
        row_is="the sum of the two launches of one ranked request")
    del rank, table, rserver, oserver, report, ranked, kern
    del s0, i0, nbr_ids, nbr_w, q_ids, q_w
    torch.cuda.empty_cache()

    # 11-15. the sharded engine on the full-width graph (the item table is
    # freed first) ----------------------------------------------------------------
    hop_row, sharded_paths = sharded_phases(graph, reqs, shape, dev)
    del graph
    torch.cuda.empty_cache()

    # 4. batched qid lanes, count_boards -----------------------------------------
    sg = synthetic.generate(
        synthetic.SyntheticGraphConfig(
            n_pins=20_000, n_boards=2_000, n_topics=16, n_langs=4, seed=7),
        device=dev,
    )
    bcfg = service.board_rec_config(cfg)
    rng = np.random.default_rng(SEED + 1)
    top = synthetic.top_degree_pins(sg, 256)
    breqs = []
    for i in range(32):
        k = 1 + i % 8
        breqs.append(([int(p) for p in rng.choice(top, k, replace=False)],
                      [float(x) for x in rng.uniform(0.1, 1.0, k).astype(np.float32)],
                      int(rng.integers(0, 4))))
    outs = {}
    batch_launches = {}
    for backend in ("pallas", "xla"):
        srv = PixieServer(sg.graph, bcfg, buckets=[(16, 4), (8, 8)],
                          seed=SEED, backend=backend)
        _build.reset_launches()
        for rid, (p, w, f) in enumerate(breqs):
            srv.submit(p, w, user_feat=f, now=0.0, req_id=rid)
        srv.pump(now=1.0)
        outs[backend] = sorted(srv.harvest(), key=lambda r: r.req_id)
        torch.cuda.synchronize()
        batch_launches[backend] = dict(_build.launches)
    if any(batch_launches["pallas"][k] == 0 for k in
           ("walk_steps_fused", "visit_counter_update_high", "visit_counter_wide")):
        raise AssertionError(f"batched run missed a kernel: {batch_launches['pallas']}")
    if any(batch_launches["xla"].values()):
        raise AssertionError("the plain path launched a kernel")
    for a, b in zip(outs["pallas"], outs["xla"]):
        if not (np.array_equal(a.scores, b.scores) and np.array_equal(a.ids, b.ids)):
            raise AssertionError(f"batched request {a.req_id}: kernel and plain paths differ")
        check_result(a.scores, a.ids, bcfg.top_k, sg.graph.n_pins, f"batched {a.req_id}")
    # stats parity on one 16-query bucket
    small = [r for r in breqs if len(r[0]) <= 4][:16]
    bp, bw, bf = padded_batch(small, 4, dev)
    bkeys = prng.fold_in(prng.key(SEED, dev), torch.arange(len(small), device=dev))
    assert_same(
        service.serve_batch(sg.graph, bp, bw, bf, bkeys, bcfg, backend="pallas", with_stats=True),
        service.serve_batch(sg.graph, bp, bw, bf, bkeys, bcfg, backend="xla", with_stats=True),
        "batched 16-query bucket",
    )
    log("batched", requests=len(breqs), batches=srv.stats.batches,
        identical=True, launches=batch_launches["pallas"])

    # 5b. wide counter at the batched board shapes
    binp = walk_inputs(sg.graph, small, 4, bcfg)
    _, bq, bs, _, bb = ws.walk_steps_fused(
        binp["curr"], binp["query"], binp["feat"], binp["slot"], binp["rbits"],
        *binp["csr"], binp["qid"], **binp["kw"])
    wide_row = check_counter_kernel(
        "visit_counter_wide", vc.visit_counter_wide, vc.visit_counter_wide_plain,
        len(small) * 4 * sg.graph.n_boards,
        (bq.reshape(-1), bs.reshape(-1), bb.reshape(-1)),
        dict(n_slots=4, n_dim=sg.graph.n_boards, n_queries=len(small)),
        "src/repro/kernels/visit_counter.py:196",
    )

    # 9. batched ranked serving and multi-interest users -----------------------------
    rcfg20 = ranker.RankerConfig(n_items=sg.graph.n_pins)
    rank20 = ranker.RankRequest(ranker.init_ranker_params(
        torch.Generator(device=dev).manual_seed(SEED + 2), rcfg20), rcfg20)
    rscen = [rid % 2 for rid in range(len(breqs))]
    routs, rlaunches = {}, {}
    for backend in ("pallas", "xla"):
        srv = PixieServer(sg.graph, cfg, buckets=[(16, 4), (8, 8)], seed=SEED,
                          backend=backend, ranker=rank20)
        _build.reset_launches()
        routs[backend] = serve_requests(srv, breqs, rscen)
        torch.cuda.synchronize()
        rlaunches[backend] = dict(_build.launches)
    if any(rlaunches["pallas"][k] == 0 for k in
           ("walk_steps_fused", "visit_counter_update_high", "embedding_bag")):
        raise AssertionError(f"batched ranked run missed a kernel: {rlaunches['pallas']}")
    if rlaunches["xla"]["walk_steps_fused"] or rlaunches["xla"]["visit_counter_update_high"]:
        raise AssertionError("the plain walk launched a walk kernel")
    assert_results_equal(routs["pallas"], routs["xla"], "batched ranked backends")
    oracle = PixieServer(sg.graph, cfg, buckets=[(8, 8)], seed=SEED, ranker=rank20)
    for rid, (p, w, f) in enumerate(breqs):
        oracle.submit(p, w, user_feat=f, now=0.0, req_id=rid, scenario=rscen[rid])
    assert_results_equal(routs["pallas"], oracle.flush(now=0.0), "ranked flush oracle")
    for r in routs["pallas"]:
        if r.ids.shape != (rcfg20.final_k,) or not np.isfinite(r.scores).all():
            raise AssertionError(f"batched ranked {r.req_id}: bad result")
    log("batched_ranked", requests=len(breqs), identical=True,
        flush_oracle_identical=True, launches=rlaunches["pallas"])
    user_launches = multi_interest_users(sg, cfg, rank20, dev)

    # 10. chaos on the 20k retrieval replica --------------------------------------
    chaos_launches = chaos_runs(sg, cfg, dev)

    # 16. the NCCL fabric on one rank, 4-way board counts ------------------------------
    nccl_fabric(sg, dev)

    # 17-20. dense-LM decode serving, after the Pixie state is freed ----------------
    del sg, srv, outs, routs, oracle, rank20, binp, bq, bs, bb
    torch.cuda.empty_cache()
    log("lm_start", resident_gb=torch.cuda.memory_allocated() / 1e9)
    attn_row, lm_paths = lm_phases(dev, qwen2_5_3b.FULL, smollm_360m.FULL)

    # the kernels line ---------------------------------------------------------------
    paths = [serve_launches, batch_launches["pallas"], ranked_launches,
             open_launches, rlaunches["pallas"], user_launches, chaos_launches,
             *sharded_paths, *lm_paths, *event_paths]
    rows = [walk_row, high_row, wide_row, bag_row, hop_row, attn_row, *event_rows]
    for row in rows:
        row["launches"] = sum(p[row["name"]] for p in paths)
    if bag_row["launches"] == 0 or ranked_launches["embedding_bag"] == 0:
        raise AssertionError("the embedding bag never launched on the ranked path")
    if any(p["walk_hop_fused"] == 0 for p in sharded_paths):
        raise AssertionError("a sharded path never launched walk_hop_fused")
    if any(row["launches"] == 0 for row in rows):
        raise AssertionError(f"a kernel never launched: {[r['name'] for r in rows if not r['launches']]}")
    log("launches", retrieval=serve_launches, batched=batch_launches["pallas"],
        ranked=ranked_launches, open_loop=open_launches,
        batched_ranked=rlaunches["pallas"], users=user_launches,
        chaos=chaos_launches, sharded_parity=sharded_paths[0],
        sharded_recipe=sharded_paths[1], sharded_server=sharded_paths[2],
        sharded_open_loop=sharded_paths[3], lm_f32=lm_paths[0],
        lm_bf16=lm_paths[1], decode_32k=lm_paths[2], lm_smollm=lm_paths[3],
        events_replicated=event_paths[0], events_wide=event_paths[1],
        legacy_kernels=event_paths[2])
    print(json.dumps({"kernels": rows}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
