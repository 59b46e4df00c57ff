"""Named device meshes (twin of ``repro/launch/mesh.py``).

  single-pod: (data=16, model=16)           axes ('data', 'model')
  multi-pod:  (pod=2, data=16, model=16)    axes ('pod', 'data', 'model')

'model' is the latency-critical axis (TP / EP / kv-sequence / graph
shards); 'data' is per-pod data parallelism; 'pod' carries only the
once-per-step gradient all-reduce.

A ``Mesh`` has the reference's ``axis_names``, ``shape`` (a dict in axis
order, as ``jax.sharding.Mesh.shape`` is) and ``devices.size``, in one of
three forms:

  * **abstract**: axes and sizes only, for resolving sharding specs
    (``make_production_mesh``: one host cannot start 256 or 512 ranks);
  * **local**: every shard of every axis on one device in one process;
    an axis's collectives are a ``LocalFabric`` over a leading shard dim;
  * **process group**: a ``torch.distributed`` ``DeviceMesh`` with
    ``mesh_dim_names``, one rank a mesh point; an axis's collectives are a
    ``ProcessGroupFabric`` over ``device_mesh.get_group(axis)`` (NCCL on
    cards, gloo on CPUs).  The caller starts the process group.

Functions, never module-level meshes: importing this module starts no
process group.  ``make_mesh_compat`` and ``set_mesh_compat`` are shims
over JAX versions and have no counterpart.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.distributed import LocalFabric, ProcessGroupFabric
from repro_torch.device import DeviceLike, resolve_device

KINDS = ("abstract", "local", "process_group")


class Mesh:
    """Axis names and sizes, and the devices behind them (see the module
    docstring for the three forms)."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str], *,
                 kind: str = "local", device: DeviceLike = None, device_mesh=None):
        if kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
        if len(shape) != len(axis_names) or len(set(axis_names)) != len(axis_names):
            raise ValueError(f"shape {tuple(shape)} and axes {tuple(axis_names)} "
                             "do not name each dim once")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = {a: int(n) for a, n in zip(axis_names, shape)}
        self.kind = kind
        self.device_mesh = device_mesh
        self.device = None if kind == "abstract" else resolve_device(device)
        if device_mesh is not None:
            self.devices = device_mesh.mesh.cpu().numpy()
        else:
            self.devices = np.arange(math.prod(shape)).reshape(tuple(shape))
        self._fabrics: Dict[Tuple[str, ...], object] = {}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, kind={self.kind!r})"

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, axes: Union[str, Sequence[str]]) -> int:
        return math.prod(self.shape[a] for a in _names(axes))

    def coordinate(self, axes: Union[str, Sequence[str]]) -> int:
        """This rank's index along ``axes`` (major to minor, as JAX blocks
        a dim split over several axes); 0 on a mesh of another form."""
        if self.device_mesh is None:
            return 0
        idx = 0
        for a in _names(axes):
            idx = idx * self.shape[a] + self.device_mesh.get_local_rank(a)
        return idx

    def fabric(self, axes: Union[str, Sequence[str]]):
        """The collectives of ``axes`` (one name or several, in mesh
        order): a ``LocalFabric`` over their shards on a local mesh, a
        ``ProcessGroupFabric`` over their ranks on a process-group mesh.
        Several axes of a process-group mesh are flattened into one group;
        every rank must ask for them in the same order."""
        names = _names(axes)
        if self.kind == "abstract":
            raise ValueError("an abstract mesh only resolves specs; it has no devices")
        if list(names) != [a for a in self.axis_names if a in names]:
            raise ValueError(f"axes {names} are not in mesh order {self.axis_names}")
        if names not in self._fabrics:
            if self.kind == "local":
                fab = LocalFabric(self.axis_size(names), device=self.device)
            elif len(names) == 1:
                fab = ProcessGroupFabric(self.device_mesh.get_group(names[0]),
                                         device=self.device)
            else:
                flat = self.device_mesh[names]._flatten("_".join(names))
                fab = ProcessGroupFabric(flat.get_group(), device=self.device)
            self._fabrics[names] = fab
        return self._fabrics[names]


def _names(axes: Union[str, Sequence[str]]) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def local_mesh(shape: Sequence[int], axes: Sequence[str] = ("data", "model"),
               device: DeviceLike = None) -> Mesh:
    """Every shard on ``device`` (``cuda`` unless named), in this process."""
    return Mesh(shape, axes, kind="local", device=device)


def process_group_mesh(shape: Sequence[int], axes: Sequence[str] = ("data", "model"),
                       device: DeviceLike = None) -> Mesh:
    """A ``DeviceMesh`` over the started process group (its world size
    must equal the mesh size), one rank a point, ranks in row-major order;
    tensors on ``device`` (``cuda`` unless named: this rank's card)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    dm = init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))
    return Mesh(shape, axes, kind="process_group", device=dev, device_mesh=dm)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh, abstract: (16, 16) ('data', 'model') or (2, 16,
    16) ('pod', 'data', 'model').  It resolves specs only; one host cannot
    start its 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, kind="abstract")


def make_host_mesh(shape=None, axes=("data", "model"), device: DeviceLike = None) -> Mesh:
    """A small mesh over what this host runs (tests): a process-group mesh
    over the started group's ranks, else a local mesh on ``device``.  With
    no ``shape``, the reference's choice for ``n`` devices."""
    import torch.distributed as dist

    pg = dist.is_available() and dist.is_initialized()
    n = dist.get_world_size() if pg else 1
    if shape is None:
        a = 1
        while (a * 2) * (a * 2) <= n or a * 2 * a <= n:
            if (a * 2) * a <= n:
                a *= 2
            else:
                break
        shape = (max(n // a, 1), a) if a <= n else (1, 1)
    if pg:
        return process_group_mesh(shape, axes, device)
    return local_mesh(shape, axes, device)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def n_chips(mesh: Mesh) -> int:
    return mesh.size

