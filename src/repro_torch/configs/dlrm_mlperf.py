"""dlrm-mlperf [arXiv:1906.00091]: MLPerf DLRM benchmark config
(Criteo 1TB): 13 dense + 26 sparse, dim=128, bot 13-512-256-128,
top 1024-1024-512-256-1, dot interaction, ~188M embedding rows.

Twin of ``repro/configs/dlrm_mlperf.py``: ``FULL``, ``SMOKE`` and ``spec()`` with the
reference's values field for field (``jnp.bfloat16`` is
``torch.bfloat16``)."""

import torch

from repro_torch.configs.registry import (
    CRITEO_ROWS, RECSYS_SHAPES, ArchSpec, register,
)
from repro_torch.models.dlrm import DLRMConfig

SOURCE = "arXiv:1906.00091 (MLPerf config)"

FULL = DLRMConfig(
    name="dlrm-mlperf",
    n_dense=13,
    embed_dim=128,
    bot_mlp=(13, 512, 256, 128),
    top_mlp=(1024, 1024, 512, 256, 1),
    feature_rows=CRITEO_ROWS,
    table_dtype=torch.bfloat16,
)

SMOKE = DLRMConfig(
    name="dlrm-mlperf-smoke",
    n_dense=13,
    embed_dim=16,
    bot_mlp=(13, 32, 16),
    top_mlp=(64, 32, 1),
    feature_rows=tuple([100] * 26),
)


@register("dlrm-mlperf")
def spec() -> ArchSpec:
    return ArchSpec(
        name="dlrm-mlperf",
        family="recsys",
        source=SOURCE,
        config=FULL,
        smoke_config=SMOKE,
        shapes=RECSYS_SHAPES,
    )
