"""Roofline terms of a cell's per-rank program, on H100 data-sheet constants.

Twin of ``repro/launch/hlo_analysis.py``: its contract, not its HLO
parsing.  The reference reads FLOPs and bytes from XLA's
``cost_analysis`` and collective bytes from the partitioned HLO text;
the port reads them from a traced per-rank program (``launch/fake.py``'s
``Tally``: every operation the program issues, its backward included).

  compute term    = sum over dtypes of FLOPs / the H100's peak for the dtype
  memory term     = bytes / HBM3 bandwidth
  collective term = sum over mesh axes of wire bytes / the axis's link rate

Wire bytes carry the reference's factors: all-reduce 2x the payload;
all-gather, reduce-scatter, all-to-all and permute 1x.  An axis whose
process group lies inside one 8-GPU node (NVLink 4) runs at 450 GB/s a
direction; one that spans nodes at a 400 Gb/s NDR port's 50 GB/s a GPU.
Every term is a reckoning from the data sheet, never a measurement, and
every quantity is per rank.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from repro_torch.launch.fake import COLLECTIVE_FACTOR

# NVIDIA H100 SXM5 data sheet (per GPU)
BF16_PEAK_FLOPS = 989.4e12   # bf16 / fp16 dense tensor-core peak, FLOP/s
FP32_PEAK_FLOPS = 66.9e12    # float32 (not TF32: torch leaves TF32 off by default)
# 32-bit integer operations: an SM has half as many INT32 lanes as FP32
# lanes, and the FP32 rate counts an FMA as two operations
INT32_OPS_PER_S = FP32_PEAK_FLOPS / 4
HBM_BW = 3.35e12             # HBM3, bytes/s
NVLINK_BW = 450e9            # NVLink 4, bytes/s a direction a GPU (18 links)
NDR_BW = 50e9                # one 400 Gb/s NDR InfiniBand port a GPU, bytes/s
GPUS_PER_NODE = 8            # an HGX H100 node

PEAK_BY_DTYPE = {
    "bfloat16": BF16_PEAK_FLOPS,
    "float16": BF16_PEAK_FLOPS,
    "float32": FP32_PEAK_FLOPS,
    "int32": INT32_OPS_PER_S,
}


def collective_bytes(tally) -> Dict[str, float]:
    """Weighted per-rank collective bytes by op kind (plus 'total')."""
    out = {k: float(tally.collectives.get(k, 0.0)) for k in COLLECTIVE_FACTOR}
    out["total"] = sum(out[k] for k in COLLECTIVE_FACTOR)
    return out


def axis_bandwidth(mesh, axes) -> float:
    """The link rate of the process group of ``axes`` (names in mesh
    order): NVLink when the group's ranks lie in one node (ranks are laid
    out row-major, eight to a node), NDR when it spans nodes."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    size = 1
    for a in names:
        size *= mesh.shape[a]
    # the group's span of ranks: from its first to its last member
    stride_span = 0
    for a in names:
        stride = 1
        for b in mesh.axis_names[mesh.axis_names.index(a) + 1:]:
            stride *= mesh.shape[b]
        stride_span += (mesh.shape[a] - 1) * stride
    return NVLINK_BW if size == 1 or stride_span < GPUS_PER_NODE else NDR_BW


@dataclasses.dataclass
class RooflineTerms:
    """All quantities are PER RANK: the traced program is one rank's.
    ``flops_by_dtype`` splits ``flops`` by the product's dtype (each over
    its own peak); ``coll_seconds_by_axis`` is each axis's wire bytes over
    its link rate."""

    flops: float                 # per-rank FLOPs (and integer operations)
    hbm_bytes: float             # per-rank bytes read and written
    coll_bytes_per_dev: float    # weighted per-rank collective bytes
    n_chips: int
    bytes_per_device: Optional[float] = None   # peak live bytes
    flops_by_dtype: Optional[Dict[str, float]] = None
    coll_seconds_by_axis: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        if not self.flops_by_dtype:
            return self.flops / BF16_PEAK_FLOPS
        return sum(n / PEAK_BY_DTYPE.get(dt, FP32_PEAK_FLOPS)
                   for dt, n in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.coll_seconds_by_axis is None:
            return self.coll_bytes_per_dev / NDR_BW
        return sum(self.coll_seconds_by_axis.values())

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """No-overlap lower bound = max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "flops_by_dtype": dict(self.flops_by_dtype or {}),
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes_per_dev,
            "n_chips": self.n_chips,
            "bytes_per_device": self.bytes_per_device,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
        }


def analyze_tally(tally, mesh, n_chips: int,
                  bytes_per_device: Optional[float] = None) -> RooflineTerms:
    """The three terms of a ``fake.Tally`` over one rank of ``mesh``; the
    tally's axis labels are axis names joined by '+' (``"pod+data"``)."""
    coll_s = {}
    for label, wire in tally.coll_by_axis.items():
        axes = tuple(label.split("+"))
        if not all(a in mesh.axis_names for a in axes):
            raise ValueError(f"collective over an unnamed group {label!r}")
        coll_s[label] = wire / axis_bandwidth(mesh, axes)
    return RooflineTerms(
        flops=sum(tally.flops.values()),
        hbm_bytes=tally.hbm_bytes,
        coll_bytes_per_dev=collective_bytes(tally)["total"],
        n_chips=n_chips,
        bytes_per_device=bytes_per_device,
        flops_by_dtype=dict(tally.flops),
        coll_seconds_by_axis=coll_s,
    )
