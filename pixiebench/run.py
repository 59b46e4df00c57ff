"""Run one cell of the Pixie port's benchmark once.

    python3 pixiebench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for.  Prints one JSON object as the last line of standard output, and each
number the correctness check compared, beside its limit, as the last
lines of standard error.  Exits non-zero without a result when no CUDA
device is visible, when fewer cards are visible than the cell asks for,
or when a module of JAX or of the JAX package is loaded once the window
has closed.  The cell's configuration names its kind (``kinds/<kind>.py``,
``pixie`` where it names none), which runs the cell; the guard looks over
the kind's reference modules, and the checks' lines hold the kind's
numbers beside its limits.  An unknown kind exits before any set-up.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, leads the path: no file here shadows
# a top-level module; the port lives under src/
sys.path[0] = str(ROOT)
sys.path.insert(1, str(ROOT / "src"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from pixiebench import manifest

    cell = manifest.cell(args.workload, ROOT)
    kind = manifest.kind(cell.kind)     # an unknown kind exits here, before set-up
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"visible: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return run(cell, kind, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))


def run(cell, kind, seed: int, seconds: float, trace: bool, device) -> int:
    """The cell's run by its kind on ``device``, between the import guard's
    two looks; prints the result line and the checks' lines."""
    from pixiebench import checks, guard

    bad = [b for m in kind.REFERENCE_MODULES for b in guard.port_objects(m)]
    if bad:
        print(f"the reference holds the port or JAX: {bad}", file=sys.stderr)
        return 3
    result = kind.run_cell(cell, seed, seconds, trace, device, T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package loaded: {found}", file=sys.stderr)
        return 3
    numbers = {k: v["value"] for k, v in result["checks"].items()}
    for line in checks.lines(numbers, kind.LIMITS):
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
