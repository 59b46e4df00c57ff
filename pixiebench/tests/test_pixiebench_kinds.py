"""A configuration names its kind, and a new kind is new files only.

A stub kind is added to a copy of the benchmark (``BENCHMARK.json`` and
``pixiebench/``) as new files and new ``BENCHMARK.json`` entries, and run
there through ``run.py``'s dispatch, past the look for a card: its result
line has every key of the driver's contract, its checks' lines are its own
limits', and the import guard looks over its reference modules.  Both
Pixie cells, cut to the CPU, read the same through the dispatch as through
``harness.run_cell``.
"""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

from pixiebench import checks, manifest
from pixiebench.tests import tinycell

ROOT = manifest.ROOT
SRC = ROOT / "src"
CELL = "stub-echo.closed"
CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}

STUB = '''
"""A stub kind: a server that answers each payload times the
configuration's factor, held to a reference that doubles it."""

import dataclasses

import torch

from pixiebench import cellrun

LIMITS = {"wrong_answers": 0, "unanswered": 0}
REFERENCE_MODULES = ()


@dataclasses.dataclass
class Answer:
    req_id: int
    value: int


class EchoServer:
    def __init__(self, factor):
        self.factor, self.queue, self.done = factor, [], []

    def submit(self, rid, x):
        self.queue.append((rid, x))

    def pump(self, now):
        n = len(self.queue)
        self.done += [Answer(rid, self.factor * x) for rid, x in self.queue]
        self.queue = []
        return n

    def harvest(self):
        out, self.done = self.done, []
        return out

    def next_deadline(self):
        return None

    def flush(self):
        return self.harvest()


def run_cell(cell, seed, seconds, trace, device, t_start):
    mix, phases = cell.traffic, {}
    gen = torch.Generator().manual_seed(seed % 2**63)
    values = torch.randint(0, 1000, (mix["pool"],), generator=gen).tolist()
    server = EchoServer(cell.config["factor"])
    setup_s = cellrun.clock() - t_start
    t_window = cellrun.clock()
    stretch = cellrun._Stretch(trace, t_window, seconds, device)
    answers, done_at, due_at, order, window = cellrun.closed_loop(
        server, lambda j, rid, now: server.submit(rid, values[j]), mix["pool"],
        mix["callers"], seconds, stretch)
    peak = cellrun.memory_peak(device)
    run = cellrun.Run(loop="closed", seconds=window, setup_s=setup_s, answers=answers,
                      done_at=done_at, due_at=due_at, config=cell.config)
    cellrun.read_trace(run, stretch, order, t_window, phases)
    numbers = {"wrong_answers": sum(a.value != 2 * values[rid % mix["pool"]]
                                    for rid, a in answers.items()),
               "unanswered": sum(1 for rid in due_at if rid not in answers)}
    metrics = cellrun.read_metrics(cell, run, trace, phases)
    return cellrun.result(cell, run, numbers, LIMITS, metrics, attempted=len(due_at),
                          failed=numbers["unanswered"], peak=peak, device=device,
                          phases=phases)
'''

BAD_REFERENCE = '''
import types

from repro_torch.core import walk

_reference = types.ModuleType("stub_reference")
_reference.recommend = walk.recommend
REFERENCE_MODULES = (_reference,)
'''

READERS = {
    "stub_answers_per_s": "def read(run):\n    return run.answered_in_window / run.seconds\n",
    "stub_untraced_answers": "def read(run):\n    return len(run.untraced) or None\n",
}

ENTRIES = {
    "configs": {"name": "stub-echo", "source": "https://example.org/stub-echo",
                "file": "pixiebench/configs/stub-echo.json", "reduced": [],
                "why": "a stub"},
    "workloads": {"name": CELL, "config": "stub-echo", "traffic": "stub-closed", "chips": 1,
                  "why": "four callers, no think time"},
    "end_to_end": {"name": "stub_answers_per_s", "unit": "req/s", "better": "higher",
                   "bound": 0.05, "source": "host_clock", "workloads": [CELL]},
    "per_layer": {"name": "stub_untraced_answers", "unit": "answers", "better": "higher",
                  "source": "program_counter", "layer": "stub", "moves": "stub_answers_per_s",
                  "workloads": [CELL]},
}


def copy_with_stub(tmp_path, kind="stub", factor=2, extra=""):
    """The benchmark's files copied to ``tmp_path``, plus the stub's new
    files and entries; returns the copy's root and the paths added."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "pixiebench", root / "pixiebench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = manifest.load()
    for section, entry in ENTRIES.items():
        bench[section].append(entry)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    body = {"name": "stub-echo", "source": ENTRIES["configs"]["source"], "kind": kind,
            "reduced": [], "assumed": [], "factor": factor}
    files = {
        "pixiebench/configs/stub-echo.json": json.dumps(body),
        "pixiebench/traffic/stub-closed.json": json.dumps(
            {"loop": "closed", "callers": 4, "pool": 16}),
        "pixiebench/kinds/stub.py": STUB + extra,
        **{f"pixiebench/metrics/{n}.py": text for n, text in READERS.items()},
    }
    for rel, text in files.items():
        assert not (root / rel).exists(), rel
        (root / rel).write_text(text)
    return root, set(files)


def dispatch(cwd, cell, seed, trace, imports=""):
    """``run.py``'s dispatch in a process of its own, as the driver runs it
    (here other tests' JAX would trip the guard), on the CPU, past the look
    for a card; ``cell`` is an expression for the cell."""
    driver = textwrap.dedent(f"""
        import importlib.util, sys, torch
        spec = importlib.util.spec_from_file_location("run", "pixiebench/run.py")
        run = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(run)
        from pixiebench import manifest
        {imports}
        cell = {cell}
        sys.exit(run.run(cell, manifest.kind(cell.kind), {seed}, 0.6, {bool(trace)},
                         torch.device("cpu")))
    """)
    return subprocess.run([sys.executable, "-c", driver], capture_output=True, text=True,
                          timeout=300, cwd=cwd, env=dict(os.environ, PYTHONPATH=str(SRC)))


def run_in(root, trace=0):
    return dispatch(root, f"manifest.cell({CELL!r}, run.ROOT)", 2**33 + 5, trace)


def test_the_stub_is_new_files_and_entries_only(tmp_path):
    root, added = copy_with_stub(tmp_path)
    copied = {p.relative_to(root).as_posix() for p in (root / "pixiebench").rglob("*")
              if p.is_file()}
    ours = {p.relative_to(ROOT).as_posix() for p in (ROOT / "pixiebench").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts and "tests" not in p.parts}
    assert copied - ours == added
    for rel in ours:
        assert (root / rel).read_bytes() == (ROOT / rel).read_bytes(), rel
    theirs, mine = json.loads((root / "BENCHMARK.json").read_text()), manifest.load()
    for section in mine:
        if isinstance(mine[section], list) and section in ENTRIES:
            assert theirs[section][:len(mine[section])] == mine[section]
        else:
            assert theirs[section] == mine[section]


@pytest.mark.parametrize("factor,trace", [(2, 0), (2, 1), (3, 0)])
def test_a_stub_kind_runs_and_is_checked_by_its_own_limits(tmp_path, factor, trace):
    root, _ = copy_with_stub(tmp_path, factor=factor)
    done = run_in(root, trace)
    assert done.returncode == 0, done.stderr[-2000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert CONTRACT <= set(out) and DEVICE <= set(out["device"])
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu" and out["device"]["count"] == 1
    assert out["attempted"] > 4 and out["failed"] == 0
    want = {"stub_untraced_answers"} if trace else {"setup_s", "stub_answers_per_s"}
    assert set(out["metrics"]) == want
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out
    limits = {"wrong_answers": 0, "unanswered": 0}
    assert {k: v["limit"] for k, v in out["checks"].items()} == limits
    numbers = {k: v["value"] for k, v in out["checks"].items()}
    assert done.stderr.strip().splitlines()[-2:] == checks.lines(numbers, limits)
    assert out["correct"] == (factor == 2) == (numbers["wrong_answers"] == 0)


def test_an_unknown_kind_fails_before_set_up_and_names_the_kinds(tmp_path):
    root, _ = copy_with_stub(tmp_path, kind="nosuch")
    done = subprocess.run(
        [sys.executable, "pixiebench/run.py", "--workload", CELL, "--seed", str(2**33),
         "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=root)
    assert done.returncode != 0 and done.stdout == ""
    assert "no kind 'nosuch'" in done.stderr and "['pixie', 'stub']" in done.stderr
    assert "CUDA" not in done.stderr


def test_the_guard_looks_over_the_kinds_reference_modules(tmp_path):
    root, _ = copy_with_stub(tmp_path, extra=BAD_REFERENCE)
    done = run_in(root)
    assert done.returncode == 3 and done.stdout == ""
    assert "the reference holds the port or JAX" in done.stderr
    assert "stub_reference.recommend -> repro_torch.core.walk" in done.stderr


def test_a_configuration_without_a_kind_is_pixie():
    assert manifest.kind("pixie").LIMITS is checks.LIMITS
    for w in manifest.load()["workloads"]:
        assert manifest.cell(w["name"]).kind == "pixie"


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["homefeed-8pin-open", "related-1pin-closed32"])
def test_pixie_cells_read_the_same_through_the_dispatch(cell, trace):
    seed = 4_000_000_019
    done = dispatch(ROOT, f"tinycell.tiny({cell!r})", seed, trace,
                    imports="from pixiebench.tests import tinycell")
    assert done.returncode == 0, done.stderr[-2000:]
    through = json.loads(done.stdout.strip().splitlines()[-1])
    direct = tinycell.run(cell, seed=seed, trace=trace)
    assert list(through) == list(direct)
    assert through["checks"] == direct["checks"]
    assert set(through["checks"]) == set(checks.LIMITS)
    assert set(through["metrics"]) == set(direct["metrics"])
    assert set(through["device"]) == set(direct["device"])
    numbers = {k: v["value"] for k, v in through["checks"].items()}
    assert done.stderr.strip().splitlines()[-len(checks.LIMITS):] == checks.lines(numbers)
    assert through["correct"] and direct["correct"]


def test_the_contract_module_holds_nothing_of_the_port():
    from pixiebench import cellrun, guard

    assert guard.port_objects(cellrun) == []
    assert guard.port_objects(manifest.kind("pixie")) == []
