"""dlrm-rm2 [arXiv:1906.00091]: the RM2 variant — dim=64,
bot 13-512-256-64, top 512-512-256-1, dot interaction.

Twin of ``repro/configs/dlrm_rm2.py``: ``FULL``, ``SMOKE`` and ``spec()`` with the
reference's values field for field (``jnp.bfloat16`` is
``torch.bfloat16``)."""

import torch

from repro_torch.configs.registry import (
    CRITEO_ROWS, RECSYS_SHAPES, ArchSpec, register,
)
from repro_torch.models.dlrm import DLRMConfig

SOURCE = "arXiv:1906.00091"

FULL = DLRMConfig(
    name="dlrm-rm2",
    n_dense=13,
    embed_dim=64,
    bot_mlp=(13, 512, 256, 64),
    top_mlp=(512, 512, 256, 1),
    feature_rows=CRITEO_ROWS,
    table_dtype=torch.bfloat16,
)

SMOKE = DLRMConfig(
    name="dlrm-rm2-smoke",
    n_dense=13,
    embed_dim=8,
    bot_mlp=(13, 32, 8),
    top_mlp=(32, 16, 1),
    feature_rows=tuple([64] * 26),
)


@register("dlrm-rm2")
def spec() -> ArchSpec:
    return ArchSpec(
        name="dlrm-rm2",
        family="recsys",
        source=SOURCE,
        config=FULL,
        smoke_config=SMOKE,
        shapes=RECSYS_SHAPES,
    )
