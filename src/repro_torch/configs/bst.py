"""bst [arXiv:1905.06874]: Behavior Sequence Transformer (Alibaba) —
dim=32, seq_len=20, 1 block, 8 heads, MLP head 1024-512-256.
Item catalog sized at 10M.

Twin of ``repro/configs/bst.py``: ``FULL``, ``SMOKE`` and ``spec()`` with the
reference's values field for field."""

from repro_torch.configs.registry import RECSYS_SHAPES, ArchSpec, register
from repro_torch.models.sequential_rec import SeqRecConfig

SOURCE = "arXiv:1905.06874"

FULL = SeqRecConfig(
    name="bst",
    kind="bst",
    n_items=10_000_000,
    embed_dim=32,
    seq_len=20,
    n_blocks=1,
    n_heads=8,
    mlp_dims=(1024, 512, 256),
)

SMOKE = SeqRecConfig(
    name="bst-smoke",
    kind="bst",
    n_items=500,
    embed_dim=16,
    seq_len=8,
    n_blocks=1,
    n_heads=4,
    mlp_dims=(32, 16),
)


@register("bst")
def spec() -> ArchSpec:
    return ArchSpec(
        name="bst",
        family="recsys",
        source=SOURCE,
        config=FULL,
        smoke_config=SMOKE,
        shapes=RECSYS_SHAPES,
    )
