#!/usr/bin/env python3
"""Time design variants of the bag and wide-counter CUDA kernels on one GPU.

    python3 kernel_sweep.py

Each variant is the committed source (``src/repro_torch/kernels/csrc/
visit_counter.cu`` or ``embedding_bag.cu``) with a few lines rewritten,
built with nvcc into ``build/sweep/`` (one process per variant, all at
once) and loaded in place of the committed library.  Every variant is held
bit for bit against the plain twin, then timed with ``chip_smoke.device_ms``
(50 launches back to back), twice, in turns:

* ``visit_counter_wide`` on the board-rec bucket's lanes (chip_smoke.py
  phase 5b: 1,048,576 events into 16 x 4 x 2,000 bins, every tile inside
  the block's shared window) and on a full-width-like chunk (65,536 events
  over ~6,400 hot boards of 8 x 60M bins, no window): the committed kernel
  (shared atomics in the window, warp-combined global atomics elsewhere),
  warp-combined in the window too, combined nowhere, and 4 or 16 events a
  thread in place of 8;
* the ranked request's bag pair ((1, 64, 8) and (1, 1, 64) bags, random
  ids, mean mode) over a 140M x 32 float32 table, back to back and one
  launch at a time with a warm and an evicted L2: the committed kernel
  (blocks of 8 warps, the 64-element bag on all 8), blocks of 4 warps
  (the bag on 4), blocks of 4 with the bag on 2, and blocks of 16.

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


def build_variants(csrc: Path, nvcc: str, flags) -> None:
    """Write and compile every variant; raise on a failed rewrite or build."""
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source, variants in (("visit_counter", WIDE), ("embedding_bag", BAG)):
        text = (csrc / f"{source}.cu").read_text()
        for name, subs in variants.items():
            s = text
            for old, new in subs:
                if s.count(old) != 1:
                    raise RuntimeError(f"{source}/{name}: rewrite target not found once")
                s = s.replace(old, new)
            cu = OUT / f"{source}_{name}.cu"
            cu.write_text(s)
            lib = OUT / f"lib{source}_{name}.so"
            jobs.append((cu.name, subprocess.Popen(
                [nvcc, *flags, "-o", str(lib), str(cu)], stdout=subprocess.PIPE,
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import visit_counter as vc

    dev = torch.device("cuda", 0)
    build_variants(_build.CSRC, _build._nvcc(), _build.NVCC_FLAGS)
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = {"bucket": bucket_lanes(dev), "full_width": full_width_lanes(dev, gen)}
    for rnd in range(2):
        for what, (q, s, i, kw) in cases.items():
            n_bins = kw["n_queries"] * kw["n_slots"] * kw["n_dim"]
            want = vc.visit_counter_wide_plain(
                torch.zeros(n_bins, dtype=torch.int32, device=dev), s, i, q, **kw)
            for name in WIDE:
                _build._libs["visit_counter"] = ctypes.CDLL(
                    str(OUT / f"libvisit_counter_{name}.so"))
                got = torch.zeros_like(want)
                vc.visit_counter_wide(got, s, i, q, **kw)
                if not torch.equal(got, want):
                    raise AssertionError(f"visit_counter_wide {name} differs from its twin")
                ms = cs.device_ms(lambda: vc.visit_counter_wide(got, s, i, q, **kw), 50)
                cs.log("sweep", kernel="visit_counter_wide", lanes=what,
                       variant=name, round=rnd, ms=ms)
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
            _build._libs["embedding_bag"] = ctypes.CDLL(
                str(OUT / f"libembedding_bag_{name}.so"))
            if not all(torch.equal(a, b) for a, b in zip(run(), want)):
                raise AssertionError(f"embedding_bag {name} differs from its twin")
            cs.log("sweep", kernel="embedding_bag_pair", variant=name, round=rnd,
                   ms=cs.device_ms(run, 50), **cs.cold_l2_ms(run, dev))
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
