"""gin-tu [arXiv:1810.00826]: 5 layers, d_hidden=64, sum aggregator,
learnable eps — the TU-benchmark GIN config.

Twin of ``repro/configs/gin_tu.py``: ``FULL``, ``SMOKE`` and ``spec()`` with the
reference's values field for field.  ``d_in`` and ``n_classes`` belong to
a shape cell (FULL carries full_graph_sm's 1,433 and 7); a caller
replaces them for another cell."""

from repro_torch.configs.registry import GNN_SHAPES, ArchSpec, register
from repro_torch.models.gnn import GINConfig

SOURCE = "arXiv:1810.00826"

FULL = GINConfig(
    name="gin-tu",
    n_layers=5,
    d_hidden=64,
    d_in=1433,
    n_classes=7,
    train_eps=True,
)

SMOKE = GINConfig(
    name="gin-tu-smoke",
    n_layers=3,
    d_hidden=16,
    d_in=32,
    n_classes=3,
    train_eps=True,
)


@register("gin-tu")
def spec() -> ArchSpec:
    return ArchSpec(
        name="gin-tu",
        family="gnn",
        source=SOURCE,
        config=FULL,
        smoke_config=SMOKE,
        shapes=GNN_SHAPES,
    )
