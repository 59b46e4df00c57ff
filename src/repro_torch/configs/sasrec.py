"""sasrec [arXiv:1808.09781]: dim=50, 2 blocks, 1 head, seq_len=50,
causal self-attention over the user sequence.  Item catalog sized at 10M
(production-representative; the paper's datasets are small).

Twin of ``repro/configs/sasrec.py``: ``FULL``, ``SMOKE`` and ``spec()`` with the
reference's values field for field."""

from repro_torch.configs.registry import RECSYS_SHAPES, ArchSpec, register
from repro_torch.models.sequential_rec import SeqRecConfig

SOURCE = "arXiv:1808.09781"

FULL = SeqRecConfig(
    name="sasrec",
    kind="sasrec",
    n_items=10_000_000,
    embed_dim=50,
    seq_len=50,
    n_blocks=2,
    n_heads=1,
    n_negatives=127,
)

SMOKE = SeqRecConfig(
    name="sasrec-smoke",
    kind="sasrec",
    n_items=500,
    embed_dim=16,
    seq_len=12,
    n_blocks=2,
    n_heads=1,
    n_negatives=8,
)


@register("sasrec")
def spec() -> ArchSpec:
    return ArchSpec(
        name="sasrec",
        family="recsys",
        source=SOURCE,
        config=FULL,
        smoke_config=SMOKE,
        shapes=RECSYS_SHAPES,
    )
