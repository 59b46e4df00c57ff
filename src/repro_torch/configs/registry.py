"""Architecture registry: ``--arch <id>`` resolves here.

Twin of ``repro/configs/registry.py``.  Each arch module contributes an
``ArchSpec``: the exact published full config, a reduced smoke config
(CPU-runnable), its shape cells, and optional per-arch sharding rule
overrides.  Importing ``repro_torch.configs`` registers every arch, as
importing ``repro.configs`` does; ``LM_SHAPES``, ``RECSYS_SHAPES`` and
``GNN_SHAPES`` carry the reference's names, kinds, params and notes, and
``CRITEO_ROWS`` its per-feature rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str        # 'train' | 'prefill' | 'decode' | 'serve' | 'retrieval'
    params: Dict[str, Any]
    note: str = ""


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                       # 'lm' | 'gnn' | 'recsys' | 'pixie'
    source: str                       # citation from the assignment
    config: Any
    smoke_config: Any
    shapes: Tuple[ShapeCell, ...]
    train_rule_overrides: Dict[str, Any] = dataclasses.field(
        default_factory=dict
    )
    serve_rule_overrides: Dict[str, Any] = dataclasses.field(
        default_factory=dict
    )


_REGISTRY: Dict[str, Callable[[], ArchSpec]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchSpec]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_arch(name: str) -> ArchSpec:
    if name not in _REGISTRY:
        # import side-effect registration
        from repro_torch import configs  # noqa: F401
    if name not in _REGISTRY:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]()


def all_archs() -> Tuple[str, ...]:
    from repro_torch import configs  # noqa: F401

    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Shared shape-cell tables
# ---------------------------------------------------------------------------

LM_SHAPES = (
    ShapeCell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeCell("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeCell("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeCell(
        "long_500k", "decode", {"seq_len": 524288, "global_batch": 1},
        note="decode vs 524k KV cache is O(seq) (flash-decode, seq-sharded); "
        "runnable for full-attention archs. 500k *prefill* would be "
        "quadratic but is not an assigned cell.",
    ),
)

RECSYS_SHAPES = (
    ShapeCell("train_batch", "train", {"batch": 65536}),
    ShapeCell("serve_p99", "serve", {"batch": 512}),
    ShapeCell("serve_bulk", "serve", {"batch": 262144}),
    ShapeCell(
        "retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}
    ),
)

GNN_SHAPES = (
    ShapeCell(
        "full_graph_sm", "train",
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7},
    ),
    ShapeCell(
        "minibatch_lg", "train",
        {
            "n_nodes": 232_965, "n_edges": 114_615_892,
            "batch_nodes": 1024, "fanout": (15, 10),
            "d_feat": 602, "n_classes": 41,
        },
        note="fixed-fanout sampled subgraph (graphs/sampler.py); the jitted "
        "step sees the padded block shape, never the full graph",
    ),
    ShapeCell(
        "ogb_products", "train",
        {
            "n_nodes": 2_449_029, "n_edges": 61_859_140,
            "d_feat": 100, "n_classes": 47,
        },
    ),
    ShapeCell(
        "molecule", "train",
        {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16,
         "n_classes": 2},
    ),
)

# MLPerf DLRM (Criteo 1TB, uncapped) per-feature embedding rows.
CRITEO_ROWS = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63,
    38532951, 2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14,
    39979771, 25641295, 39664984, 585935, 12972, 108, 36,
)
