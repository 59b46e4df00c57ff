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
                 "kernels/visit_counter.py", "kernels/embedding_bag.py",
                 "kernels/ops.py", "serving/server.py", "serving/ranker.py",
                 "serving/recommend.py", "serving/resilience.py",
                 "serving/traffic.py", "configs/pixie.py",
                 "core/distributed.py", "models/layers.py",
                 "models/transformer.py", "serving/decode.py",
                 "kernels/decode_attention.py", "configs/qwen2_5_3b.py",
                 "configs/smollm_360m.py", "configs/minitron_4b.py",
                 "core/pruning.py", "core/baselines.py", "core/reference.py",
                 "graphs/sampler.py", "graphs/gnn_data.py",
                 "models/embedding.py", "models/sequential_rec.py",
                 "models/dlrm.py", "configs/sasrec.py", "configs/bst.py",
                 "configs/dlrm_rm2.py", "configs/dlrm_mlperf.py",
                 "models/moe.py", "models/gnn.py",
                 "configs/granite_moe_3b_a800m.py",
                 "configs/deepseek_moe_16b.py", "configs/gin_tu.py",
                 "training/optim.py", "training/microbatch.py",
                 "training/train_loop.py", "training/checkpoint.py",
                 "training/resilience.py", "training/compression.py",
                 "training/tree.py", "data/pipeline.py", "launch/mesh.py",
                 "distribution/sharding.py"):
        assert twin in names
    for src in ("walk_steps_fused.cu", "visit_counter.cu", "embedding_bag.cu",
                "walk_hop.cu", "decode_attention.cu", "walk_step.cu",
                "walk_bits.cu", "threefry.cuh", "topk_select.cu"):
        assert (PORT / "kernels" / "csrc" / src).exists()


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
        "import repro_torch.serving.traffic, repro_torch.serving.recommend\n"
        "import repro_torch.core.distributed\n"
        "import repro_torch.serving.decode, repro_torch.configs.qwen2_5_3b\n"
        "import repro_torch.configs.smollm_360m, repro_torch.configs.minitron_4b\n"
        "import repro_torch.core.pruning, repro_torch.core.baselines\n"
        "import repro_torch.core.reference, repro_torch.graphs.sampler\n"
        "import repro_torch.graphs.gnn_data\n"
        "import repro_torch.models.embedding, repro_torch.models.dlrm\n"
        "import repro_torch.models.sequential_rec, repro_torch.configs.sasrec\n"
        "import repro_torch.configs.bst, repro_torch.configs.dlrm_rm2\n"
        "import repro_torch.configs.dlrm_mlperf, repro_torch.configs.registry\n"
        "import repro_torch.models.moe, repro_torch.models.gnn\n"
        "import repro_torch.configs.granite_moe_3b_a800m\n"
        "import repro_torch.configs.deepseek_moe_16b, repro_torch.configs.gin_tu\n"
        "import repro_torch.training, repro_torch.data\n"
        "import repro_torch.training.optim, repro_torch.training.microbatch\n"
        "import repro_torch.training.train_loop, repro_torch.training.checkpoint\n"
        "import repro_torch.training.resilience, repro_torch.training.compression\n"
        "import repro_torch.training.tree, repro_torch.data.pipeline\n"
        "import repro_torch.launch.mesh, repro_torch.distribution.sharding\n"
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
    from repro_torch.core import distributed

    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.LocalFabric(2)
    from repro_torch.launch import mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.local_mesh((1, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_host_mesh()
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels import visit_counter as vc
    from repro_torch.kernels import walk_step as ws

    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        vc.visit_counter_update_high(z, z, z, n_slots=1, n_pins=4, n_v=2)
    with pytest.raises(ValueError, match="CUDA"):
        vc.visit_counter_wide(z, z, z, n_slots=1, n_dim=4)
    from repro_torch.kernels import embedding_bag as eb

    table = torch.zeros((4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        eb.embedding_bag(table, torch.zeros((2, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        eb.embedding_bag_batched(table, torch.zeros((1, 2, 3), dtype=torch.int32))
    key = torch.zeros(2, dtype=torch.int32)
    off = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ws.walk_steps_fused(z, z, z, z, key, off, z, off, z, step_base=0,
                            chunk_steps=1, n_pins=4, n_slots=1, n_boards=4,
                            alpha_u32=0, beta_u32=0)
    with pytest.raises(ValueError, match="CUDA"):
        ws.walk_bits(key, 0, 1, 4)
    table = torch.zeros((1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        ws.walk_hop_fused(z, z.bool(), table, 0, 2, z, z[:1], off, z)
    with pytest.raises(ValueError, match="CUDA"):
        vc.visit_counter(z, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ws.walk_step(z, z, torch.zeros((4, 3), dtype=torch.int32), off, z,
                     off, z, n_pins=4, alpha_u32=0)
    from repro_torch.kernels import decode_attention as da

    kv = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention(torch.zeros((1, 2, 8)), kv, kv, 2)


def test_dispatch_refuses_devices_without_a_path():
    from repro_torch.kernels import ops

    m = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        ops.visit_counts_wide(m, m, m, n_slots=1, n_dim=4, use_kernel=True)
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        ops.embedding_bag_batched(torch.zeros((4, 8), device="meta"),
                                  m.reshape(1, 1, 4))
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        ops.walk_hop(m, m.bool(), m, m, m, m[:1], step=0, column=2, walker=m,
                     use_kernel=True)
    # the legacy entry points: None lets the device decide, as True does
    for use_kernel in (None, True):
        with pytest.raises(ValueError, match="no kernel and no plain path"):
            ops.visit_counts(m, 4, use_kernel=use_kernel)
        with pytest.raises(ValueError, match="no kernel and no plain path"):
            ops.walk_step(m, m, m.reshape(4, 1), m, m, m, m, n_pins=3,
                          alpha_u32=0, use_kernel=use_kernel)
    kv = torch.zeros((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        ops.decode_attention(torch.zeros((1, 2, 8), device="meta"), kv, kv, 2,
                             use_kernel=True)


def test_launch_counters_name_the_three_kernels_and_reset():
    """Name kept from the first slice; the embedding bag is the fourth
    counter, the sharded engine's hop the fifth, the LM decode step's
    attention the sixth, and the legacy flat histogram and one-superstep
    walk the seventh and eighth: one counter per TPU kernel of the repo,
    plus the walk's word table drawn on the card (``walk_bits``), the
    attention kernel's partial form over one ``kv_seq`` block
    (``decode_attention_partial``, the tensor-parallel decode step's) and
    the top-k's selection (``topk_select``, which replaces no TPU kernel)."""
    from repro_torch.kernels import _build

    assert set(_build.launches) == {
        "walk_steps_fused", "visit_counter_update_high", "visit_counter_wide",
        "embedding_bag", "walk_hop_fused", "decode_attention",
        "decode_attention_partial", "visit_counter", "walk_step", "walk_bits",
        "topk_select",
    }
    assert set(_build.SOURCES) == {
        "walk_steps_fused", "visit_counter", "embedding_bag", "walk_hop",
        "decode_attention", "decode_attention_partial", "walk_step", "walk_bits",
        "topk_select",
    }
    _build.launches["visit_counter_wide"] += 3
    _build.reset_launches()
    assert not any(_build.launches.values())


def test_cuda_sources_name_the_kernel_they_replace():
    csrc = PORT / "kernels" / "csrc"
    walk = (csrc / "walk_steps_fused.cu").read_text()
    counter = (csrc / "visit_counter.cu").read_text()
    bag = (csrc / "embedding_bag.cu").read_text()
    hop = (csrc / "walk_hop.cu").read_text()
    step = (csrc / "walk_step.cu").read_text()
    assert "src/repro/kernels/walk_step.py" in hop
    assert "_walk_hop_kernel" in hop and "walk_hop_ref" in hop
    assert "src/repro/kernels/walk_step.py" in step
    assert "_walk_step_kernel" in step and "walk_step_ref" in step
    assert "_visit_counter_kernel" in counter and "visit_counter_ref" in counter
    # the walk kernels pick an edge with the one shared function
    for src in (walk, hop, step):
        assert '#include "pick_edge.cuh"' in src
        assert "int pick_edge(" not in src
    assert "int pick_edge(" in (csrc / "pick_edge.cuh").read_text()
    assert "src/repro/kernels/embedding_bag.py" in bag
    assert "_embedding_bag_kernel" in bag and "__fmul_rn" in bag
    assert "src/repro/kernels/walk_step.py" in walk
    # the walk's words come from the one device threefry, in the walk
    # kernel and in the table kernel alike
    bits = (csrc / "walk_bits.cu").read_text()
    for src in (walk, bits):
        assert '#include "threefry.cuh"' in src
        assert "uint2 threefry2x32(" not in src
    assert "uint2 threefry2x32(" in (csrc / "threefry.cuh").read_text()
    assert "walk_steps_fused" in walk
    assert "visit_counter_update_high" in counter
    assert "visit_counter_wide" in counter
    attn = (csrc / "decode_attention.cu").read_text()
    assert "src/repro/kernels/decode_attention.py" in attn
    assert "_decode_attn_kernel" in attn and "decode_attention_plain" in attn
    partial = (csrc / "decode_attention_partial.cu").read_text()
    assert "src/repro/kernels/decode_attention.py" in partial
    assert "decode_attention_partial_plain" in partial
    for src in (attn, partial):   # one kernel source, two libraries
        assert '#include "decode_attention.cuh"' in src and "__global__" not in src
    topk = (csrc / "topk_select.cu").read_text()
    assert "Replaces no Pallas kernel" in topk and "topk_select_plain" in topk
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
