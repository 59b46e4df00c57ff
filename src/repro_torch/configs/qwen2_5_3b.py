"""qwen2.5-3b [hf:Qwen/Qwen2.5-3B]: 36L d=2048 16H (GQA kv=2) ff=11008
vocab=151936 — GQA with QKV bias, tied embeddings, rope theta 1e6.

Twin of ``repro/configs/qwen2_5_3b.py``: ``FULL``, ``SMOKE`` and ``spec()`` with the
reference's values field for field."""

import torch

from repro_torch.configs.registry import LM_SHAPES, ArchSpec, register
from repro_torch.models.transformer import LMConfig

SOURCE = "hf:Qwen/Qwen2.5-3B"

FULL = LMConfig(
    name="qwen2.5-3b",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab_size=151936,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
)

SMOKE = LMConfig(
    name="qwen2.5-3b-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    tie_embeddings=True,
    remat=False,
    compute_dtype=torch.float32,
)


@register("qwen2.5-3b")
def spec() -> ArchSpec:
    return ArchSpec(
        name="qwen2.5-3b",
        family="lm",
        source=SOURCE,
        config=FULL,
        smoke_config=SMOKE,
        shapes=LM_SHAPES,
    )
