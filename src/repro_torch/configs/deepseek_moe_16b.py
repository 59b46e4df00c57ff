"""deepseek-moe-16b [arXiv:2401.06066]: 28L d=2048 16H (MHA kv=16)
expert-ff=1408 vocab=102400 — 2 shared + 64 routed experts top-6,
fine-grained segmentation; layer 0 is a dense FFN (d_ff=10944).

Twin of ``repro/configs/deepseek_moe_16b.py``: ``FULL``, ``SMOKE`` and ``spec()``
with the reference's values field for field."""

import torch

from repro_torch.configs.registry import LM_SHAPES, ArchSpec, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

SOURCE = "arXiv:2401.06066"

FULL = LMConfig(
    name="deepseek-moe-16b",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  ep_shard_map=True),
    first_dense_ff=10944,
)

SMOKE = LMConfig(
    name="deepseek-moe-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=48,
    vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=48, n_shared=2),
    first_dense_ff=96,
    remat=False,
    compute_dtype=torch.float32,
)


@register("deepseek-moe-16b")
def spec() -> ArchSpec:
    return ArchSpec(
        name="deepseek-moe-16b",
        family="lm",
        source=SOURCE,
        config=FULL,
        smoke_config=SMOKE,
        shapes=LM_SHAPES,
    )
