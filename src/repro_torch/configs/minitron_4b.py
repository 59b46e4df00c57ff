"""minitron-4b [arXiv:2407.14679]: 32L d=3072 24H (GQA kv=8) ff=9216
vocab=256000 — width-pruned Nemotron-4.

Twin of ``repro/configs/minitron_4b.py``: ``FULL``, ``SMOKE`` and ``spec()`` with the
reference's values field for field."""

import torch

from repro_torch.configs.registry import LM_SHAPES, ArchSpec, register
from repro_torch.models.transformer import LMConfig

SOURCE = "arXiv:2407.14679"

FULL = LMConfig(
    name="minitron-4b",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    rope_theta=10_000.0,
    pad_heads_to=32,
)

SMOKE = LMConfig(
    name="minitron-4b-smoke",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=192,
    vocab_size=512,
    remat=False,
    compute_dtype=torch.float32,
)


@register("minitron-4b")
def spec() -> ArchSpec:
    return ArchSpec(
        name="minitron-4b",
        family="lm",
        source=SOURCE,
        config=FULL,
        smoke_config=SMOKE,
        shapes=LM_SHAPES,
        # 24 heads over the 16-way 'model' axis: GSPMD pads to 32 slots
        # (25% attention waste, recorded in the roofline notes).
    )
