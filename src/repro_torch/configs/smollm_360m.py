"""smollm-360m [hf:HuggingFaceTB/SmolLM-360M]: 32L d=960 15H (GQA kv=5)
ff=2560 vocab=49152 — llama-arch small model.

Twin of ``repro/configs/smollm_360m.py``: ``FULL``, ``SMOKE`` and ``spec()`` with the
reference's values field for field."""

import torch

from repro_torch.configs.registry import LM_SHAPES, ArchSpec, register
from repro_torch.models.transformer import LMConfig

SOURCE = "hf:HuggingFaceTB/SmolLM-360M"

FULL = LMConfig(
    name="smollm-360m",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab_size=49152,
    rope_theta=10_000.0,
    tie_embeddings=True,
    pad_heads_to=16,
)

SMOKE = LMConfig(
    name="smollm-360m-smoke",
    n_layers=2,
    d_model=60,
    n_heads=3,
    n_kv_heads=1,
    head_dim=20,
    d_ff=128,
    vocab_size=512,
    tie_embeddings=True,
    remat=False,
    compute_dtype=torch.float32,
)


@register("smollm-360m")
def spec() -> ArchSpec:
    return ArchSpec(
        name="smollm-360m",
        family="lm",
        source=SOURCE,
        config=FULL,
        smoke_config=SMOKE,
        shapes=LM_SHAPES,
    )
