#!/usr/bin/env python3
"""Time design variants of the CUDA kernels on one GPU.

    python3 kernel_sweep.py [wide] [bag] [high] [step] [topk]

(no argument: every sweep).  Each variant is the committed source
(``src/repro_torch/kernels/csrc/visit_counter.cu``, ``embedding_bag.cu``,
``walk_step.cu`` or ``topk_select.cu``) with a few lines rewritten, built with nvcc into
``build/sweep/`` (one process per variant, all at once) and loaded in
place of the committed library.  Every variant is held bit for bit
against the plain twin, then timed with ``chip_smoke.device_ms`` (50
launches back to back), twice, in turns:

* ``wide``: ``visit_counter_wide`` on the board-rec bucket's lanes
  (chip_smoke.py phase 5b: 1,048,576 events into 16 x 4 x 2,000 bins,
  every tile inside the block's shared window) and on a full-width-like
  chunk (65,536 events over ~6,400 hot boards of 8 x 60M bins, no
  window): the committed kernel (shared atomics in the window,
  warp-combined global atomics elsewhere), warp-combined in the window
  too, combined nowhere, and 4 or 16 events a thread in place of 8;
* ``bag``: the ranked request's bag pair ((1, 64, 8) and (1, 1, 64) bags,
  random ids, mean mode) over a 140M x 32 float32 table, back to back and
  one launch at a time with a warm and an evicted L2: the committed kernel
  (blocks of 8 warps, the 64-element bag on all 8), blocks of 4 warps (the
  bag on 4), blocks of 4 with the bag on 2, and blocks of 16;
* ``high``: ``visit_counter_update_high`` on a retrieval-sized chunk
  (65,536 events, rows in contiguous runs as the walk's query-major lanes
  lay them, hot pins) at 8, 512, 4,096, 12,288 and 16,384 rows, with a
  query lane (8 slots) and without, n_v 1 and 4: the committed kernel
  (crossings added into the tally with global atomics, warp-combined by
  row) against the first design's per-block tally in shared memory (up to
  12,288 rows, 48 KB).  Each launch first zeroes the touched bins (so
  every launch crosses as a first chunk does); that reset is timed alone
  and subtracted;
* ``step``: the legacy ``walk_step`` at chip_smoke.py phase 23's shape
  (8,192 walkers on the full-width graph, started on the requests' query
  pins) and from 8,192 random pins: blocks of 32, 64, 128 and 256, each
  with the committed read-only loads (``__ldg``) and with non-allocating
  ones (``ld.global.nc.L1::no_allocate``, inline PTX); at 32, also that
  PTX without ``volatile``; plain loads at 32 and at 128 (the first
  design's blocks and loads); beside the committed
  launcher (blocks sized to the SM count); back to back and one launch at
  a time with a warm and an evicted L2.

* ``topk``: the top-k's selection (``topk_select.cu``) on keys shaped as
  the walk's boosted counts (140M float32 a row, 150,000 visited pins a
  row, counts with heavy ties, k = 1,000) at 8 rows (the related cell's
  batch) and 1 row (homefeed's): units of 4,096 keys (committed), 1,024
  and 16,384, and 4 loads in flight a lane in place of 8.  Beside them,
  with the committed kernel: the selection's twin on the card (the
  ``cumsum`` and ``nonzero`` path it replaced; host-synchronising, so
  timed with events around 5 calls), the same selection with the tie
  mask's ``cumsum`` taken over the rows laid end to end as one
  (``flat_select``: cub's device-wide scan, each row's offset
  subtracted), ``torch.topk`` alone, the whole ``counter.topk_dense`` by
  each route, its peak memory above the keys by each route, and the
  kernel's byte bound (the keys read once at 3.35 TB/s); then
  ``counter.topk_total`` at the MoE router's (4,096, 64), k = 6, by each
  route (events around 50 calls, host time included).

Prints one JSON line per variant, then the card's name and power limit.
The numbers choose between designs; PERF.md section 6 cites them.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "sweep"

MATCH_BOTH = ("""      if (windowed) {
        if (bin >= 0) atomicAdd(&window[bin - lo], 1);
      } else {
        const unsigned peers = __match_any_sync(0xffffffffu, bin);
        if (bin >= 0 && lane == __ffs(peers) - 1)
          atomicAdd(&counts[bin], __popc(peers));
      }""", """      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1) {
        if (windowed)
          atomicAdd(&window[bin - lo], __popc(peers));
        else
          atomicAdd(&counts[bin], __popc(peers));
      }""")
MATCH_NONE = (MATCH_BOTH[0], """      if (bin >= 0) {
        if (windowed) atomicAdd(&window[bin - lo], 1);
        else atomicAdd(&counts[bin], 1);
      }""")
PER = "constexpr int kWidePer = 8; "
WARPS = ("constexpr int kWarps = 8; ", "constexpr int kRowsPerWarp = 32; ")
TEAMS = "l <= 16 ? 1 : (l <= 48 ? 2 : kWarps)"

WIDE = {
    "committed": [],
    "match_in_window_too": [MATCH_BOTH],
    "match_nowhere": [MATCH_NONE],
    "4_events_a_thread": [(PER, "constexpr int kWidePer = 4; ")],
    "16_events_a_thread": [(PER, "constexpr int kWidePer = 16;")],
}
BAG = {
    "committed": [],
    "4_warp_blocks": [(WARPS[0], "constexpr int kWarps = 4; "),
                      (WARPS[1], "constexpr int kRowsPerWarp = 64; ")],
    "4_warp_blocks_bag_on_2": [(WARPS[0], "constexpr int kWarps = 4; "),
                               (WARPS[1], "constexpr int kRowsPerWarp = 64; "),
                               (TEAMS, "l <= 16 ? 1 : 2")],
    "16_warp_blocks": [(WARPS[0], "constexpr int kWarps = 16;"),
                       (WARPS[1], "constexpr int kRowsPerWarp = 16; ")],
}


# the first design's tally: per block in shared memory, flushed at the end
# (at most 12,288 rows: 48 KB)
SHARED_TALLY = [
    ("""  const int lane = threadIdx.x & 31;
  // block-uniform loop: every lane reaches __match_any_sync""",
     """  extern __shared__ int tally[];
  const int n_rows = qev != nullptr ? n_queries * n_slots : n_slots;
  for (int r = threadIdx.x; r < n_rows; r += kHighBlock) tally[r] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;"""),
    ("""    if (__any_sync(0xffffffffu, crossed)) {
      const unsigned same = __match_any_sync(0xffffffffu, crossed ? row : -1);
      if (crossed && lane == __ffs(same) - 1) atomicAdd(&high[row], __popc(same));
    }
  }
}""", """    if (crossed) atomicAdd(&tally[row], 1);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < n_rows; r += kHighBlock) {
    const int t = tally[r];
    if (t) atomicAdd(&high[r], t);
  }
}"""),
    ("update_high_kernel<<<grid, kHighBlock, 0,",
     "update_high_kernel<<<grid, kHighBlock,\n"
     "(qev != nullptr ? n_queries * n_slots : n_slots) * sizeof(int),"),
]
HIGH = {"committed": [], "shared_tally": SHARED_TALLY}
HIGH_ROWS = (8, 512, 4096, 12288, 16384)
HIGH_EVENTS = 65_536
HIGH_PINS = 20_000
MAX_BLOCK, MIN_BLOCK = "constexpr int kMaxBlock = 256;", "int block = 32;"
LDG = "{ return __ldg(p); }"
HINT = (LDG, """{
  int v;
  asm volatile("ld.global.nc.L1::no_allocate.b32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}""")
STEP = {"committed": []}
for _b in (32, 64, 128, 256):
    _fixed = [(MAX_BLOCK, f"constexpr int kMaxBlock = {_b};"),
              (MIN_BLOCK, f"int block = {_b};")]
    STEP[f"block{_b}_hint"] = _fixed + [HINT]
    STEP[f"block{_b}_no_hint"] = _fixed
STEP["block32_hint_not_volatile"] = STEP["block32_no_hint"] + [
    (HINT[0], HINT[1].replace("asm volatile", "asm"))]
STEP["block32_plain_load"] = STEP["block32_no_hint"] + [(LDG, "{ return *p; }")]
# the first design's launch (blocks of 128) and loads
STEP["block128_plain_load"] = STEP["block128_no_hint"] + [(LDG, "{ return *p; }")]

UNIT = "constexpr int kUnit = 4096;"
TOPK = {"committed": [],
        "unit_1024": [(UNIT, "constexpr int kUnit = 1024;")],
        "unit_16384": [(UNIT, "constexpr int kUnit = 16384;")],
        "4_loads_in_flight": [("constexpr int kBatch = 8;", "constexpr int kBatch = 4;")]}
TOPK_PINS, TOPK_VISITED, TOPK_K = 140_000_000, 150_000, 1000

# sweep -> (source, variants)
SWEEPS = {"wide": ("visit_counter", WIDE), "bag": ("embedding_bag", BAG),
          "high": ("visit_counter", HIGH), "step": ("walk_step", STEP),
          "topk": ("topk_select", TOPK)}


def lib_path(sweep: str, name: str) -> Path:
    return OUT / f"lib{sweep}_{name}.so"


def build_variants(csrc: Path, nvcc: str, flags, sweeps=tuple(SWEEPS)) -> None:
    """Write and compile every variant of ``sweeps``; raise on a failed
    rewrite or build."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for sweep in sweeps:
        source, variants = SWEEPS[sweep]
        text = (csrc / f"{source}.cu").read_text()
        for name, subs in variants.items():
            s = text
            for old, new in subs:
                if s.count(old) != 1:
                    raise RuntimeError(f"{sweep}/{name}: rewrite target not found once")
                s = s.replace(old, new)
            cu = OUT / f"{sweep}_{name}.cu"
            cu.write_text(s)
            jobs.append((cu.name, subprocess.Popen(
                [nvcc, *flags, "-I", str(csrc), "-o", str(lib_path(sweep, name)),
                 str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for name, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out}")


def bucket_lanes(dev):
    """chip_smoke.py phase 5b's lanes: the board-rec bucket's first chunk."""
    import chip_smoke as cs
    from repro_torch.configs.pixie import FULL_WALK
    from repro_torch.core import service
    from repro_torch.graphs import synthetic

    sg = synthetic.generate(synthetic.SyntheticGraphConfig(
        n_pins=20_000, n_boards=2_000, n_topics=16, n_langs=4, seed=7),
        device=dev)
    rng = np.random.default_rng(cs.SEED + 1)
    top = synthetic.top_degree_pins(sg, 256)
    reqs = []
    for i in range(32):
        k = 1 + i % 8
        reqs.append(([int(p) for p in rng.choice(top, k, replace=False)],
                     [float(x) for x in rng.uniform(0.1, 1.0, k).astype(np.float32)],
                     int(rng.integers(0, 4))))
    small = [r for r in reqs if len(r[0]) <= 4][:16]
    inp = cs.walk_inputs(sg.graph, small, 4, service.board_rec_config(FULL_WALK))
    _, q, s, _, b = cs.run_walk_kernel(inp)
    return (q.reshape(-1), s.reshape(-1), b.reshape(-1),
            dict(n_slots=4, n_dim=sg.graph.n_boards, n_queries=len(small)))


def full_width_lanes(dev, gen):
    """65,536 events over ~6,400 hot boards of 8 x 60M bins, one query."""
    import torch

    m = 65_536
    hot = torch.randint(0, 60_000_000, (6_411,), generator=gen, device=dev,
                        dtype=torch.int32)
    ids = hot[(torch.rand(m, generator=gen, device=dev) ** 3 * 6_411).long()]
    return (torch.zeros(m, dtype=torch.int32, device=dev), (ids % 8).int(), ids,
            dict(n_slots=8, n_dim=60_000_000, n_queries=1))


def high_lanes(n_rows: int, with_query: bool, dev, gen):
    """A retrieval-sized chunk over ``n_rows`` rows: rows in contiguous
    runs (the walk's query-major lanes), hot pins; with a query lane the
    rows are (query, slot) pairs of 8 slots."""
    import torch

    m = HIGH_EVENTS
    row = (torch.arange(m, device=dev) * n_rows // m).int()
    pin = (torch.rand(m, generator=gen, device=dev) ** 3 * HIGH_PINS).int()
    if with_query:
        return (row // 8).contiguous(), (row % 8).contiguous(), pin, dict(
            n_slots=8, n_pins=HIGH_PINS, n_queries=n_rows // 8)
    return None, row, pin, dict(n_slots=n_rows, n_pins=HIGH_PINS, n_queries=0)


def sweep_wide(dev, gen) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import visit_counter as vc

    cases = {"bucket": bucket_lanes(dev), "full_width": full_width_lanes(dev, gen)}
    for rnd in range(2):
        for what, (q, s, i, kw) in cases.items():
            n_bins = kw["n_queries"] * kw["n_slots"] * kw["n_dim"]
            want = vc.visit_counter_wide_plain(
                torch.zeros(n_bins, dtype=torch.int32, device=dev), s, i, q, **kw)
            for name in WIDE:
                _build._libs["visit_counter"] = ctypes.CDLL(str(lib_path("wide", name)))
                got = torch.zeros_like(want)
                vc.visit_counter_wide(got, s, i, q, **kw)
                if not torch.equal(got, want):
                    raise AssertionError(f"visit_counter_wide {name} differs from its twin")
                ms = cs.device_ms(lambda: vc.visit_counter_wide(got, s, i, q, **kw), 50)
                cs.log("sweep", kernel="visit_counter_wide", lanes=what,
                       variant=name, round=rnd, ms=ms)


def sweep_bag(dev, gen) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as eb

    table = torch.empty((140_000_000, 32), device=dev)
    table.normal_(generator=gen)
    v = table.shape[0]
    nbr = (torch.randint(-1, v, (1, 64, 8), generator=gen, device=dev, dtype=torch.int32),
           torch.rand((1, 64, 8), generator=gen, device=dev))
    qry = (torch.randint(-1, v, (1, 1, 64), generator=gen, device=dev, dtype=torch.int32),
           torch.rand((1, 1, 64), generator=gen, device=dev))
    want = eb.embedding_bag_pair_plain(table, *nbr, *qry, mode="mean")
    run = lambda: eb.embedding_bag_pair(table, *nbr, *qry, mode="mean")
    for rnd in range(2):
        for name in BAG:
            _build._libs["embedding_bag"] = ctypes.CDLL(str(lib_path("bag", name)))
            if not all(torch.equal(a, b) for a, b in zip(run(), want)):
                raise AssertionError(f"embedding_bag {name} differs from its twin")
            cs.log("sweep", kernel="embedding_bag_pair", variant=name, round=rnd,
                   ms=cs.device_ms(run, 50), **cs.cold_l2_ms(run, dev))
    del table


def sweep_high(dev, gen) -> None:
    """Both tally forms at every row count; the shared one only where its
    tally fits 48 KB."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import visit_counter as vc

    counts = torch.zeros(max(HIGH_ROWS) * HIGH_PINS, dtype=torch.int32, device=dev)
    cases = [(r, wq, high_lanes(r, wq, dev, gen)) for r in HIGH_ROWS
             for wq in (True, False)]
    for rnd in range(2):
        for n_rows, with_query, (q, s, p, kw) in cases:
            ck = counts[:n_rows * HIGH_PINS]
            bins = vc._valid_bins(s, p, q, kw["n_slots"], HIGH_PINS, kw["n_queries"])
            reset = lambda: ck.index_fill_(0, bins, 0)
            for n_v in (1, 4):
                reset()
                want_c = ck.clone()
                want = vc.visit_counter_update_high_plain(want_c, s, p, q, n_v=n_v, **kw)
                reset_ms = cs.device_ms(reset, 50)
                for name in HIGH:
                    if name == "shared_tally" and n_rows > 12288:
                        continue                 # past 48 KB of tally
                    _build._libs["visit_counter"] = ctypes.CDLL(
                        str(lib_path("high", name)))
                    reset()
                    got = vc.visit_counter_update_high(ck, s, p, q, n_v=n_v, **kw)
                    if not (torch.equal(got, want) and torch.equal(ck, want_c)):
                        raise AssertionError(f"update_high {name} differs from its twin "
                                             f"at {n_rows} rows")
                    high = torch.zeros_like(got)
                    both = cs.device_ms(lambda: (reset(), vc.visit_counter_update_high(
                        ck, s, p, q, n_v=n_v, high=high, **kw)), 50)
                    cs.log("sweep", kernel="visit_counter_update_high", variant=name,
                           round=rnd, n_rows=n_rows, query_lane=with_query, n_v=n_v,
                           events=HIGH_EVENTS, crossed=int(want.sum()),
                           reset_and_kernel_ms=both, reset_ms=reset_ms,
                           ms=both - reset_ms)
        ck.zero_()


def sweep_step(dev, gen) -> None:
    """At phase 23's shape (the full-width graph, 8,192 walkers on the
    requests' query pins) and from random pins."""
    import torch

    import chip_smoke as cs
    from repro_torch.configs.pixie import FULL_WALK, SERVE_200M_REPLICATED
    from repro_torch.kernels import _build
    from repro_torch.kernels import walk_step as ws

    graph, _ = cs.full_width_graph(SERVE_200M_REPLICATED, dev)
    reqs = cs.full_width_requests(graph, SERVE_200M_REPLICATED.n_slots)
    query, words, csr, alpha = cs.legacy_step_inputs(graph, reqs, FULL_WALK)
    rb = ws.u32_bits_as_int32(words[0]).contiguous()
    w = query.numel()
    live = torch.nonzero(graph.p2b.degrees() > 0).flatten()
    rand = live[torch.randint(0, live.numel(), (w,), generator=gen,
                              device=dev)].int()
    n_pins = graph.n_pins
    for rnd in range(2):
        for start, curr in (("query_pins", query), ("random_pins", rand)):
            want = ws.walk_step_plain(curr, query, rb, *csr, n_pins=n_pins,
                                      alpha_u32=alpha)
            run = lambda: ws.walk_step(curr, query, rb, *csr, n_pins=n_pins,
                                       alpha_u32=alpha)
            for name in STEP:
                _build._libs["walk_step"] = ctypes.CDLL(str(lib_path("step", name)))
                if not all(torch.equal(a, b) for a, b in zip(run(), want)):
                    raise AssertionError(f"walk_step {name} differs from its twin")
                cs.log("sweep", kernel="walk_step", variant=name, round=rnd,
                       start=start, walkers=w, ms=cs.device_ms(run, 50),
                       **cs.cold_l2_ms(run, dev))
    del graph


def boosted_like(rows: int, dev, gen):
    """``(rows, 140M)`` float32 zeros with 150,000 visited pins a row at
    random places, their counts ``floor(e**U(0, 4))``: few high counts and
    heavy ties below, as the walk's boosted counts."""
    import torch

    keys = torch.zeros((rows, TOPK_PINS), device=dev)
    for r in range(rows):
        at = torch.randint(0, TOPK_PINS, (TOPK_VISITED,), generator=gen, device=dev)
        keys[r, at] = torch.exp(4 * torch.rand(TOPK_VISITED, generator=gen,
                                               device=dev)).floor()
    return keys


def flat_select(keys, kth, k: int):
    """The twin's selection (``counter.topk_select_plain``) with the ties
    counted by one ``cumsum`` over the rows laid end to end, each row's
    offset (the ties of the rows before it) subtracted: one row goes
    through cub's device-wide scan where ``rows`` go one block row each.
    Its ``nonzero`` still waits on the host."""
    import torch

    above = keys > kth
    ties = keys == kth
    need = k - above.sum(-1, keepdim=True)
    run = torch.cumsum(ties.reshape(-1), 0).view(ties.shape)
    before = torch.cat([run.new_zeros((1, 1)), run[:-1, -1:]])
    take = above | (ties & (run - before <= need))
    return take.nonzero()[:, 1].reshape(-1, k)


def sweep_topk(dev, gen) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.core import counter
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import topk_select as ts

    k = TOPK_K

    def old_route(fn, *args, select=counter.topk_select_plain):
        """``fn`` with the top-k's selection ``select``: by default the
        twin, the cumsum path."""
        real = ops.topk_select
        ops.topk_select = select
        try:
            return fn(*args)
        finally:
            ops.topk_select = real

    def peak_gb(fn, base):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated(dev) - base) / 1e9

    for rows in (8, 1):
        keys = boosted_like(rows, dev, gen)
        kth = torch.topk(keys, k, dim=-1, sorted=True).values[:, -1:]
        want = counter.topk_select_plain(keys, kth, k)
        ties = int((keys == kth).sum())
        bound_ms = keys.numel() * 4 / 3.35e12 * 1e3
        for rnd in range(2):
            for name in TOPK:
                _build._libs["topk_select"] = ctypes.CDLL(str(lib_path("topk", name)))
                if not torch.equal(ts.topk_select(keys, kth, k), want):
                    raise AssertionError(f"topk_select {name} differs from its twin")
                cs.log("sweep", kernel="topk_select", variant=name, round=rnd,
                       rows=rows, n=TOPK_PINS, k=k, ties_at_kth=ties,
                       ms=cs.device_ms(lambda: ts.topk_select(keys, kth, k), 20),
                       bound_ms=bound_ms)
        _build._libs["topk_select"] = ctypes.CDLL(str(lib_path("topk", "committed")))
        got, old = counter.topk_dense(keys, k), old_route(counter.topk_dense, keys, k)
        if not all(torch.equal(a, b) for a, b in zip(got, old)):
            raise AssertionError("topk_dense differs from the cumsum path")
        if not torch.equal(flat_select(keys, kth, k), want):
            raise AssertionError("flat_select differs from the twin")
        base = torch.cuda.memory_allocated(dev)
        cs.log("sweep", kernel="topk_select", variant="yardsticks", rows=rows,
               n=TOPK_PINS, k=k, ties_at_kth=ties, bound_ms=bound_ms,
               plain_select_ms=cs.cuda_ms(
                   lambda: counter.topk_select_plain(keys, kth, k), 5),
               flat_select_ms=cs.cuda_ms(lambda: flat_select(keys, kth, k), 5),
               torch_topk_ms=cs.device_ms(
                   lambda: torch.topk(keys, k, dim=-1, sorted=True), 5),
               topk_dense_ms=cs.device_ms(lambda: counter.topk_dense(keys, k), 5),
               old_topk_dense_ms=cs.cuda_ms(
                   lambda: old_route(counter.topk_dense, keys, k), 5),
               flat_topk_dense_ms=cs.cuda_ms(
                   lambda: old_route(counter.topk_dense, keys, k, select=flat_select), 5),
               topk_dense_peak_gb=peak_gb(lambda: counter.topk_dense(keys, k), base),
               old_topk_dense_peak_gb=peak_gb(
                   lambda: old_route(counter.topk_dense, keys, k), base),
               flat_topk_dense_peak_gb=peak_gb(
                   lambda: old_route(counter.topk_dense, keys, k, select=flat_select), base))
        del keys, kth, want
        torch.cuda.empty_cache()
    # the MoE router's shape: many short rows, host-bound on both routes
    probs = torch.rand((4096, 64), generator=gen, device=dev).softmax(-1)
    got, old = counter.topk_total(probs, 6), old_route(counter.topk_total, probs, 6)
    if not all(torch.equal(a, b) for a, b in zip(got, old)):
        raise AssertionError("topk_total differs from the cumsum path")
    cs.log("sweep", kernel="topk_select", variant="moe_router", rows=4096, n=64, k=6,
           topk_total_ms=cs.cuda_ms(lambda: counter.topk_total(probs, 6), 50),
           old_topk_total_ms=cs.cuda_ms(
               lambda: old_route(counter.topk_total, probs, 6), 50))


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device is visible", file=sys.stderr)
        return 1
    sweeps = argv or list(SWEEPS)
    unknown = [w for w in sweeps if w not in SWEEPS]
    if unknown:
        print(f"kernel_sweep: unknown sweep {unknown}; choose from {list(SWEEPS)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    build_variants(_build.CSRC, _build._nvcc(), _build.NVCC_FLAGS, sweeps)
    gen = torch.Generator(device=dev).manual_seed(1)
    run = dict(wide=sweep_wide, bag=sweep_bag, high=sweep_high, step=sweep_step,
               topk=sweep_topk)
    for sweep in sweeps:
        run[sweep](dev, gen)
        torch.cuda.empty_cache()
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
