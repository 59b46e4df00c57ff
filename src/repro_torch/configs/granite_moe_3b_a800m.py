"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-3b-a800m-base]:
32L d=1536 24H (GQA kv=8) expert-ff=512 vocab=49155, MoE 40 experts top-8.

Twin of ``repro/configs/granite_moe_3b_a800m.py``: ``FULL``, ``SMOKE`` and ``spec()``
with the reference's values field for field.  Heads are padded to 32,
the vocabulary to 49,168 and the experts to 48 (pad experts are
router-masked and receive no tokens); ``ep_shard_map`` is carried: with a
mesh the MoE blocks take the expert-parallel route, 12 experts a shard
over 4 'model' shards."""

import torch

from repro_torch.configs.registry import LM_SHAPES, ArchSpec, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

SOURCE = "hf:ibm-granite/granite-3.0-3b-a800m-base"

FULL = LMConfig(
    name="granite-moe-3b-a800m",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    rope_theta=10_000.0,
    tie_embeddings=True,
    pad_heads_to=32,
    pad_vocab_to=49168,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512, n_shared=0,
                  pad_experts_to=48, ep_shard_map=True),
)

SMOKE = LMConfig(
    name="granite-moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=64,
    vocab_size=512,
    tie_embeddings=True,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64, n_shared=0),
    remat=False,
    compute_dtype=torch.float32,
)


@register("granite-moe-3b-a800m")
def spec() -> ArchSpec:
    return ArchSpec(
        name="granite-moe-3b-a800m",
        family="lm",
        source=SOURCE,
        config=FULL,
        smoke_config=SMOKE,
        shapes=LM_SHAPES,
        # EP over 48 padded experts (see MoEConfig.pad_experts_to)
    )
