"""The PyTorch/CUDA port stands alone: no jax, no repro, and no quiet CPU
fallback.

Every file under src/repro_torch and chip_smoke.py is parsed and its
imports checked; a fresh interpreter imports the whole port and must not
load jax.  Entry points default to ``cuda`` and raise without a card; the
kernel wrappers take CUDA tensors only.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in FORBIDDEN


def test_port_files_exist():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for twin in ("core/prng.py", "core/graph.py", "core/sampling.py",
                 "core/counter.py", "core/walk.py", "core/service.py",
                 "graphs/synthetic.py", "kernels/walk_step.py",
                 "kernels/visit_counter.py", "kernels/ops.py",
                 "serving/server.py", "configs/pixie.py"):
        assert twin in names


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix()
)
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path} imports {bad}"


def test_forbidden_rule_catches_the_reference():
    assert _forbidden("jax.numpy") and _forbidden("repro.core.walk")
    assert not _forbidden("repro_torch.core.walk")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import repro_torch.serving.server, repro_torch.graphs.synthetic\n"
        "import repro_torch.configs.pixie, repro_torch.kernels.ops\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch import resolve_device
    from repro_torch.core import prng
    from repro_torch.graphs import synthetic

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic.small_test_graph()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prng.key(0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import visit_counter as vc
    from repro_torch.kernels import walk_step as ws

    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        vc.visit_counter_update_high(z, z, z, n_slots=1, n_pins=4, n_v=2)
    with pytest.raises(ValueError, match="CUDA"):
        vc.visit_counter_wide(z, z, z, n_slots=1, n_dim=4)
    rb = torch.zeros((1, 4, 4), dtype=torch.int32)
    off = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ws.walk_steps_fused(z, z, z, z, rb, off, z, off, z, n_pins=4,
                            n_slots=1, n_boards=4, alpha_u32=0, beta_u32=0)


def test_dispatch_refuses_devices_without_a_path():
    from repro_torch.kernels import ops

    m = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        ops.visit_counts_wide(m, m, m, n_slots=1, n_dim=4, use_kernel=True)


def test_launch_counters_name_the_three_kernels_and_reset():
    from repro_torch.kernels import _build

    assert set(_build.launches) == {
        "walk_steps_fused", "visit_counter_update_high", "visit_counter_wide"
    }
    _build.launches["visit_counter_wide"] += 3
    _build.reset_launches()
    assert not any(_build.launches.values())


def test_cuda_sources_name_the_kernel_they_replace():
    csrc = PORT / "kernels" / "csrc"
    walk = (csrc / "walk_steps_fused.cu").read_text()
    counter = (csrc / "visit_counter.cu").read_text()
    assert "src/repro/kernels/walk_step.py" in walk
    assert "walk_steps_fused" in walk
    assert "visit_counter_update_high" in counter
    assert "visit_counter_wide" in counter
    assert "sm_90a" in (PORT / "kernels" / "_build.py").read_text()


def test_chip_smoke_fails_without_a_card(tmp_path):
    """chip_smoke.py must exit non-zero and print no result without a card,
    both in the checkout and copied alone into an empty directory."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    for script in (ROOT / "chip_smoke.py", alone):
        proc = subprocess.run(
            [sys.executable, str(script)], capture_output=True, text=True,
            timeout=120, cwd=script.parent,
        )
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
