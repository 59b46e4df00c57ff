"""pixie — the paper's own architecture as an 11th config: the Pixie
random-walk recommender at production scale (twin of
``repro/configs/pixie.py``).

  * serve_3b_sharded   — the paper's deployed scale: 3B nodes (2B pins +
    1B boards) / 17B edges, node-range-sharded across the 'model' axis of
    one pod; walkers migrate between shards (core/distributed.py).
  * serve_200m_replicated — a replicated-graph configuration (the paper's
    single-machine regime).

``PixieArchConfig``, ``FULL``, ``SMOKE``, ``PIXIE_SHAPES`` and ``spec``
carry the reference's fields and values, with one difference by design:
``FULL.walk`` and ``FULL.sharded_walk`` carry ``backend="pallas"``, the
hand kernels.  The reference's default ``"xla"`` was a real TPU lowering;
in the port it selects the plain twins, the oracle, so the production
config names the kernels.  ``SMOKE`` keeps the default.

The names the serving code used before the registry stay:

  * ``FULL_WALK`` is ``FULL.walk`` (200k steps over 8192 walkers, top
    1000: the paper's production query budget);
  * ``SHARDED_WALK`` is ``FULL.sharded_walk`` (24 supersteps x 16 shards x
    512 walkers, about the paper's 200k-step budget per query);
  * ``SERVE_200M_REPLICATED`` and ``SERVE_3B_SHARDED`` are the two shape
    cells as ``GraphShape``s: 140M pins, 60M boards, 1.2B edges and 8
    query slots on one device; and 2B pins, 1B boards, 17B edges (an
    int32 CSR of ~136 GB, which fits no single card) split over 16
    node-range shards.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.registry import ArchSpec, ShapeCell, register
from repro_torch.core.distributed import ShardedWalkConfig
from repro_torch.core.walk import WalkConfig


@dataclasses.dataclass(frozen=True)
class PixieArchConfig:
    n_pins: int
    n_boards: int
    n_edges: int
    walk: WalkConfig
    sharded_walk: ShardedWalkConfig
    n_slots: int = 16


FULL = PixieArchConfig(
    n_pins=2_000_000_000,
    n_boards=1_000_000_000,
    n_edges=17_000_000_000,
    walk=WalkConfig(n_steps=200_000, n_walkers=8192, top_k=1000,
                    backend="pallas"),
    # 24 supersteps x 16 shards x 512 walkers ~ the paper's 200k-step
    # budget per query; fat supersteps minimize all_to_all rounds
    sharded_walk=ShardedWalkConfig(
        n_supersteps=24, walkers_per_shard=512, top_k=1000, backend="pallas"
    ),
)

SMOKE = PixieArchConfig(
    n_pins=300,
    n_boards=80,
    n_edges=1500,
    walk=WalkConfig(n_steps=20_000, n_walkers=256, top_k=50),
    sharded_walk=ShardedWalkConfig(
        n_supersteps=32, walkers_per_shard=128, top_k=50
    ),
    n_slots=4,
)

PIXIE_SHAPES = (
    ShapeCell(
        "serve_3b_sharded", "pixie_sharded",
        {"n_pins": FULL.n_pins, "n_boards": FULL.n_boards,
         "n_edges": FULL.n_edges},
        note="paper production scale; graph sharded over 'model', queries "
        "over ('pod','data')",
    ),
    ShapeCell(
        "serve_200m_replicated", "pixie_replicated",
        {"n_pins": 140_000_000, "n_boards": 60_000_000,
         "n_edges": 1_200_000_000, "n_slots": 8},
        note="largest graph that replicates into one 16 GB chip (int32 CSR "
        "~10.6 GB); the paper's single-machine serving regime. 8 query "
        "slots keep packed (slot, pin) events in int32",
    ),
)


@register("pixie")
def spec() -> ArchSpec:
    return ArchSpec(
        name="pixie",
        family="pixie",
        source="this paper (Eksombatchai et al., 2017)",
        config=FULL,
        smoke_config=SMOKE,
        shapes=PIXIE_SHAPES,
    )


FULL_WALK = FULL.walk
SHARDED_WALK = FULL.sharded_walk


@dataclasses.dataclass(frozen=True)
class GraphShape:
    name: str
    n_pins: int
    n_boards: int
    n_edges: int
    n_slots: int
    note: str = ""
    n_shards: int = 1


SERVE_200M_REPLICATED = GraphShape(
    name="serve_200m_replicated",
    n_pins=140_000_000,
    n_boards=60_000_000,
    n_edges=1_200_000_000,
    n_slots=8,
    note="largest graph the reference replicates into one device (int32 "
    "CSR ~10.4 GB plus ~4 GB of feature bounds with 4 edge languages); "
    "8 query slots keep the dense (slot, pin) bins inside int32",
)

SERVE_3B_SHARDED = GraphShape(
    name="serve_3b_sharded",
    n_pins=2_000_000_000,
    n_boards=1_000_000_000,
    n_edges=17_000_000_000,
    n_slots=16,
    n_shards=16,
    note="the paper's production scale; graph node-range sharded 16 ways "
    "and walked with SHARDED_WALK",
)
