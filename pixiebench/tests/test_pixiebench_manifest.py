"""``BENCHMARK.json`` against the contract it is written to."""

import ast
import json
import re
from pathlib import Path

import pytest

from pixiebench import manifest
from repro_torch.configs import pixie
from repro_torch.core import service

ROOT = manifest.ROOT
BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.match(p) for p in BENCH["paths"])
    assert all(not p.endswith("_torch") and ".." not in p for p in BENCH["paths"])
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    assert all(not w.startswith("/") and ".." not in w for w in cmd)
    assert any((ROOT / w).is_file() and w.startswith(BENCH["paths"][0] + "/") for w in cmd)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 seconds
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_keys_and_names(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert one_line(e[key]), (e["name"], key)


def test_configs_cells_and_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    files = [c["file"] for c in configs.values()]
    assert len(set(files)) == len(files)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for c in configs.values():
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["source"] == c["source"]
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and k in body for k in c["reduced"])
        assert "assumed" in body
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (ROOT / BENCH["paths"][0] / "traffic" / f"{w['traffic']}.json").is_file()


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    setup = next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")
    assert "workloads" not in setup and setup["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        cell = manifest.cell(w["name"])
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_each_layer_metric_moves_a_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            reported = {e.name for e in manifest.cell(cell).end_to_end}
            assert m["moves"] in reported, (m["name"], cell)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_layers_are_named_as_perf_md_lists_them():
    perf = (ROOT / "PERF.md").read_text()
    for m in BENCH["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_every_metric_has_a_reader():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("name,make", [("pixie-200m-homefeed", service.homefeed_config),
                                       ("pixie-200m-related", service.related_pins_config)])
def test_configs_are_the_programs_production_settings(name, make):
    body = json.loads((ROOT / "pixiebench" / "configs" / f"{name}.json").read_text())
    want = make(pixie.FULL_WALK)
    for key, value in body["walk"].items():
        assert getattr(want, key) == value, key
    shape = pixie.SERVE_200M_REPLICATED
    assert (body["n_pins"], body["n_boards"], body["n_edges"]) == (
        shape.n_pins, shape.n_boards, shape.n_edges)
    assert max(s for _, s in body["buckets"]) <= shape.n_slots


def imports_of(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_nothing_imports_jax_and_the_yardstick_nothing_of_the_port():
    here = ROOT / "pixiebench"
    yardstick = {"reference.py", "graphgen.py", "checks.py", "roofline.py", "traffic.py",
                 "stats.py", "devtrace.py"}
    for path in here.rglob("*.py"):
        if "tests" in path.parts:
            continue
        tops = {name.split(".")[0] for name in imports_of(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if path.name in yardstick:
            assert "repro_torch" not in tops, path


def test_the_guard_compares_whole_top_level_names():
    from pixiebench import guard, reference

    assert guard.forbidden_modules(["repro_torch", "repro_torch.core", "jaxtyping"]) == []
    assert guard.forbidden_modules(["jax.numpy", "repro.core.walk", "flax"]) == [
        "flax", "jax.numpy", "repro.core.walk"]
    assert guard.port_objects(reference) == []
    import types
    from repro_torch.core import walk

    fake = types.ModuleType("pixiebench.fake")
    fake.walk, fake.f = walk, walk.recommend
    assert len(guard.port_objects(fake)) == 2
