#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's retrieval main path on one GPU and check it.

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
             bandwidth bound and, for the counters, torch's index_add_.
             Each bound counts the distinct 32-byte sectors the run's own
             inputs touch (repeat reads of a row are L2 hits), plus the
             lanes and walker state read or written once.

Prints one ``{"kernels": [...]}`` line, then the card's name and power
limit, then ``{"ok": true, "device": {...}}`` as the last line.  Exits
non-zero without a result when no CUDA device is visible or when run
outside a checkout of the repository.
"""

from __future__ import annotations

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


def profile_request(server, req, req_id: int, top: int = 14) -> None:
    """One full-width request under torch.profiler: the device's busy and
    idle share of the request's wall time, and where the device time goes
    by kernel.  The trace goes to chiprun_out/chip_smoke_trace.json."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t = time.perf_counter()
        server.submit(*req[:2], user_feat=req[2], req_id=req_id)
        server.pump()
        server.harvest()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    log("profile", wall_ms=wall, device_busy_ms=busy,
        device_idle_share=max(0.0, 1 - busy / wall) if wall else None,
        kernel_launches=sum(e.count for e in kernels),
        top=[dict(kernel=e.key[:90], count=e.count,
                  ms=e.self_device_time_total / 1e3) for e in kernels[:top]])
    out = Path(__file__).resolve().parent / "chiprun_out"
    out.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(out / "chip_smoke_trace.json"))


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
    import torch
    from repro_torch.kernels.visit_counter import _valid_bins

    dev = lanes[0].device
    base = torch.zeros((n_bins,), dtype=torch.int32, device=dev)
    qev, sev, iev = lanes
    n_dim = kw.get("n_pins", kw.get("n_dim"))
    bins = _valid_bins(sev, iev, qev, kw["n_slots"], n_dim, kw["n_queries"])
    # a warm buffer: every other touched bin sits one below n_v, so the
    # checked round's first event there crosses it
    base[bins[::2]] = kw.get("n_v", 4) - 1
    ck, cp = base.clone(), base.clone()
    got = kernel(ck, sev, iev, qev, **kw)
    want = plain(cp, sev, iev, qev, **kw)
    err = int((ck.long() - cp.long()).abs().max())
    if name == "visit_counter_update_high":
        if int(want.sum()) == 0:
            raise AssertionError(f"{name}: the checked round crossed no bin")
        err = max(err, int((got.long() - want.long()).abs().max()))
    if err:
        raise AssertionError(f"{name} differs from its twin: max err {err}")
    del cp
    ms = device_ms(lambda: kernel(ck, sev, iev, qev, **kw), 50)
    call_ms = cuda_ms(lambda: kernel(ck, sev, iev, qev, **kw), 50)
    plain_ms = cuda_ms(lambda: plain(ck, sev, iev, qev, **kw), 5)
    ones = torch.ones_like(bins, dtype=torch.int32)
    library_ms = device_ms(lambda: ck.index_add_(0, bins, ones), 50)
    m = sev.shape[0]
    # bound: the lanes read once, and each distinct 32-byte sector of the
    # count buffer the events touch read once and written once (a bin hit
    # again is an L2 hit: the buffer of the wide check fits in L2 whole)
    sectors = int(torch.unique(bins >> 3).numel())
    n_rows = n_bins // n_dim
    nbytes = 4 * 3 * m + 2 * SECTOR * sectors
    if name == "visit_counter_update_high":
        nbytes += 4 * n_rows
    log("kernel", name=name, device_ms=ms, call_ms=call_ms, events=m,
        valid_events=int(bins.shape[0]), bins=n_bins,
        distinct_sectors=sectors, bound_bytes=nbytes,
        crossed=int(want.sum()) if name == "visit_counter_update_high" else None)
    return dict(
        name=name, route="cuda",
        source="src/repro_torch/kernels/csrc/visit_counter.cu",
        replaces=replaces, launches=None, max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=library_ms,
    )


# ---------------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.configs.pixie import FULL_WALK, SERVE_200M_REPLICATED
    from repro_torch.core import prng, service, walk
    from repro_torch.core import counter as counter_lib
    from repro_torch.graphs import synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels import visit_counter as vc
    from repro_torch.kernels import walk_step as ws
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
    del graph, winp, lanes, qev, sev, pev, kern, plain, server, results
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
    if any(batch_launches["pallas"][k] == 0 for k in batch_launches["pallas"]):
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

    # 6. the kernels line -----------------------------------------------------------
    for row in (walk_row, high_row, wide_row):
        row["launches"] = (serve_launches[row["name"]]
                           + batch_launches["pallas"][row["name"]])
    print(json.dumps({"kernels": [walk_row, high_row, wide_row]}), flush=True)
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
