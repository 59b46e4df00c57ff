"""Read the control's numbers at a cell's own size: the reference put in
the program's place with its float32 boost in bfloat16, held to the
reference by the run's own comparison (``checks.compare``).

    python3 pixiebench/control.py --workload <cell> --seconds <s> --seeds 11 22 33

Per seed: the cell's graph drawn and compiled by the reference, the
traffic's payloads, and as many requests as a run checks, drawn as a run
draws them from the window's request ids (an open loop's arrivals; a
closed loop's first ``callers`` x 30 ids).  Prints one JSON line a seed
with the sound reading (the reference against itself) and the control's.
The benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from pixiebench import checks, graphgen, harness, manifest, reference, traffic

    cell = manifest.cell(args.workload, ROOT)
    config, mix = cell.config, cell.traffic
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    walk = reference.walk_from(config)
    for seed in args.seeds:
        t = time.perf_counter()
        e = graphgen.draw(config, seed, dev)
        has_edge = graphgen.pins_with_edges(e, config["n_pins"])
        g = reference.compile_graph(e.pins, e.boards, e.pin_lang, e.board_lang,
                                    config["n_pins"], config["n_boards"], config["n_langs"])
        del e
        torch.cuda.empty_cache()
        if mix["loop"] == "open":
            n = len(traffic.arrivals(mix, args.seconds, seed))
            ids = range(n)
        else:
            n = mix["pool"]
            ids = range(mix["callers"] * 30)
        pay = traffic.payloads(mix, n, has_edge, config["n_langs"], seed)
        slots = harness.slots_for(config, pay.pins.shape[1])
        exact, lower = {}, {}
        for rid in checks.sample(ids, mix["check_requests"], seed):
            pins, weights = harness.padded(pay, rid % n, slots)
            key = reference.request_key(seed, rid, dev)
            for out, dtype in ((exact, torch.float32), (lower, torch.bfloat16)):
                a = reference.recommend(g, pins, weights, int(pay.feats[rid % n]), key, walk,
                                        dtype)
                out[rid] = (a.scores.numpy(), a.ids.numpy())
        print(json.dumps({"seed": seed, "requests": len(exact),
                          "sound": checks.compare(exact, exact),
                          "control": checks.compare(lower, exact),
                          "seconds": time.perf_counter() - t}), flush=True)
        del g
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
