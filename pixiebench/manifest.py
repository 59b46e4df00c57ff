"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration, whose file is
``configs`` entry's ``file``, and a traffic mix, ``traffic/<name>.json``.
The configuration names its kind (``"kind"``; ``"pixie"`` where absent):
the module ``kinds/<kind>.py`` that sets the system up, runs the window
and checks it (``run_cell``), with the limits that decide ``correct``
(``LIMITS``) and the modules the import guard holds free of the port and
of JAX (``REFERENCE_MODULES``).
Each metric is read by ``metrics/<name>.py``, a module with one function
``read(run)`` that returns the value or None where it finds nothing to
read.  A cell reports the end-to-end metrics that list it (or list no
cells); with ``--trace 1`` it reports the per-layer metrics that list it,
or list no cells and move an end-to-end metric it reports.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Metric(NamedTuple):
    name: str
    unit: str
    read: Callable


class Cell(NamedTuple):
    name: str
    chips: int
    kind: str
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]


def load(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(name: str) -> Callable:
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pixiebench.metrics.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


KIND_NAMES = ("run_cell", "LIMITS", "REFERENCE_MODULES")


def kind(name: str):
    """``kinds/<name>.py``; exits naming the kinds present where there is
    none, or where it lacks a name of ``KIND_NAMES``."""
    present = sorted(p.stem for p in (HERE / "kinds").glob("*.py"))
    if name not in present:
        raise SystemExit(f"no kind {name!r} in {HERE.name}/kinds; have {present}")
    path = HERE / "kinds" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pixiebench.kinds.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    missing = [n for n in KIND_NAMES if not hasattr(module, n)]
    if missing:
        raise SystemExit(f"kind {name!r} lacks {missing}")
    return module


def _lists(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: Path = ROOT) -> Cell:
    bench = load(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _json(root / configs[w["config"]]["file"])
    mix = _json(HERE / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _lists(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    as_metric = lambda m: Metric(m["name"], m["unit"], reader(m["name"]))
    return Cell(name, int(w["chips"]), config.get("kind", "pixie"), config, mix,
                [as_metric(m) for m in e2e], [as_metric(m) for m in per_layer])
