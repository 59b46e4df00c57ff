"""The Pixie configurations the port serves (twin of the two pieces of
``repro/configs/pixie.py`` it needs; the registry is not ported).

  * ``FULL_WALK`` is the reference's ``FULL.walk``: 200k steps over 8192
    walkers, top 1000 (the paper's production query budget), on the hand
    kernels (``backend="pallas"``).  The reference's default ``"xla"``
    was a real TPU lowering; in the port it selects the plain twins, the
    oracle, so the production config names the kernels.
  * ``SERVE_200M_REPLICATED`` is the reference's ``serve_200m_replicated``
    shape: 140M pins, 60M boards, 1.2B edges, 8 query slots, the graph
    replicated on one device (the paper's single-machine regime).
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.walk import WalkConfig

FULL_WALK = WalkConfig(n_steps=200_000, n_walkers=8192, top_k=1000,
                       backend="pallas")


@dataclasses.dataclass(frozen=True)
class GraphShape:
    name: str
    n_pins: int
    n_boards: int
    n_edges: int
    n_slots: int
    note: str = ""


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
