"""Sweep the offered rate of an open-loop cell, to find its knee.

    python3 pixiebench/sweep.py --workload <open-loop cell> --seed <n> \\
        --seconds <s> --rates 15 20 25 30

One set-up, then one window a rate, in the order given, on the cell's
traffic with only ``rate_qps`` changed.  Prints one JSON line a rate:
offered and achieved rates, the requests due but unanswered at the
window's close (the backlog), and the latency percentiles over every
request due in the window (an unanswered one beyond every limit).  The
knee is the highest offered rate whose achieved rate matches it and whose
backlog stays a few requests.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--drain", type=float, default=15.0)
    args = ap.parse_args(argv)

    import torch

    from pixiebench import harness, manifest, stats

    cell = manifest.cell(args.workload, ROOT)
    if cell.traffic["loop"] != "open":
        raise SystemExit(f"{args.workload} is not an open-loop cell")
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    rep = harness.set_up(cell, args.seed, args.seconds, dev, trace=False)
    print(json.dumps({"setup_s": time.perf_counter() - T_START, **rep.phases,
                      "card": torch.cuda.get_device_name(dev)}), flush=True)
    for rate in args.rates:
        mix = dict(cell.traffic, rate_qps=rate, drain_s=args.drain)
        harness.traffic_for(rep, mix, args.seconds)
        stretch = harness._Stretch(False, 0.0, args.seconds, dev)
        answers, done_at, due_at, _, _ = harness.serve_window(rep, args.seconds, stretch)
        run = harness.Run(loop="open", seconds=args.seconds, setup_s=0.0, answers=answers,
                          done_at=done_at, due_at=due_at)
        lat = run.latencies_ms
        print(json.dumps({
            "offered_qps": len(due_at) / args.seconds,
            "achieved_qps": run.answered_in_window / args.seconds,
            "backlog_at_close": len(due_at) - run.answered_in_window,
            "unanswered": len(due_at) - len(answers),
            "latency_p50_ms": stats.nearest_rank(lat, 50),
            "latency_p95_ms": stats.nearest_rank(lat, 95),
            "batch_compute_ms": stats.mean_batch_compute_ms(run),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
