"""The dry run's tracing tools: a fake process group and a tally of the
work a traced per-rank program does.

The dry run (``launch/dryrun.py``) runs a cell's per-rank program eagerly
on fake tensors (``repro_torch/abstract.py``: they carry shapes and dtypes
and allocate nothing, and within ``reckon_card`` take the card's route on
any host) over a fake process group of the production mesh's world size,
as rank 0.  Private torch tools are imported here and in
``abstract.py`` (``torch._subclasses.fake_tensor``), nowhere else:

  * ``torch.utils._python_dispatch`` (which ``import torch`` loads itself);
  * ``torch.testing._internal.distributed.fake_pg.FakeStore`` and the
    ``"fake"`` backend: collectives that accept any tensor and move none.

The last loads when the dry run starts; where it is missing
``DryRunUnavailable`` names it (the dry run never skips a cell).

**The tally** (``Tally``, a dispatch mode) reads every operation the
program issues, its backward included:

  * FLOPs of products, convolutions and attention, by the dtype of the
    product (``torch.utils.flop_counter``'s formulas);
  * bytes: each operation's tensor inputs read once and outputs written
    once (eager PyTorch's own traffic).  Views and ``empty`` move none; a
    gather is charged by the rows it reads (its output) and its indices,
    not the whole table; an in-place scatter by the rows it touches, read
    and written, not the whole buffer; ``copy_`` by its source and
    destination once;
  * collectives: the payload by kind, with the reference's wire factors
    (all-reduce 2x; all-gather, reduce-scatter, all-to-all and permute
    1x), and by the mesh axes of their group; a group of one rank moves
    nothing and counts none.  Each all-gather's result is listed by shape
    and dtype under its axes (``gathers``: what a program gathers whole);
  * the hand kernels' fake forms, which charge their own work
    (``kernels._build.charge``) and are counted in ``kernels``, apart from
    ``kernels._build.launches``, which counts real launches only;
  * the peak of the live storages: each storage counted from the first
    operation that gives it out (or ``track``) until it is freed, its
    bytes exact (no allocator rounding).  torch's ``MemTracker`` does the
    same with module hooks and snapshots, at twice the cost of the whole
    trace.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.abstract import is_fake
from repro_torch.kernels import _build

# the reference's per-op wire factors (repro/launch/hlo_analysis.py)
COLLECTIVE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# c10d operator name -> (collective kind, index of the argument whose
# tensors are the payload; None: the result)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "all_reduce": ("all-reduce", None),
    "all_reduce_": ("all-reduce", 0),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "all_gather_into_tensor": ("all-gather", None),
    "all_gather_into_tensor_out": ("all-gather", None),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor": ("reduce-scatter", None),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "all_to_all_single": ("all-to-all", None),
    "send": ("collective-permute", 0),
}
_NO_TRAFFIC_COLLECTIVES = ("wait_tensor", "barrier", "monitored_barrier_")
# a tensor's device, asked from C++ (autograd's engine, einsum): two in
# three of a training step's operations, and no work
_PRIM_DEVICE = torch.ops.prim.device.default

_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "detach", "alias", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "set_",
         "resize_", "_unsafe_view"}
# gathers: the first input charged by the rows read (the output)
_GATHERS = {"index", "index_select", "embedding", "gather", "take", "_unsafe_index"}
# in-place scatters: the buffer charged by the rows touched, read and written
_SCATTERS = {"index_put_", "_index_put_impl_", "index_add_", "scatter_", "scatter_add_",
             "scatter_reduce_", "index_copy_", "index_fill_", "masked_scatter_"}
_WRITES_ONLY = {"fill_", "zero_", "copy_"}


class DryRunUnavailable(RuntimeError):
    """A private torch tool the dry run needs is missing."""


def start_fake_world(world_size: int) -> None:
    """This process as rank 0 of a fake process group of ``world_size``
    ranks.  Process-global: one world size a process."""
    import torch.distributed as dist

    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise DryRunUnavailable(
            "the dry run needs torch.testing._internal.distributed.fake_pg, which "
            f"this torch ({torch.__version__}) lacks: {e}") from e
    if dist.is_initialized():
        if dist.get_world_size() != world_size or dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} group of {dist.get_world_size()} ranks is "
                f"running; the dry run of a {world_size}-rank mesh needs its own "
                "process")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _group(args):
    """The process group a collective's arguments name (its name for a
    functional collective, the boxed group for a c10d one), or None."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d

    for a in args:
        if isinstance(a, str):
            return distributed_c10d._resolve_process_group(a)
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:      # a ReduceOp, not the group
                continue
    return None


class Tally(TorchDispatchMode):
    """FLOPs by dtype, bytes, collective bytes by kind and by axes, and the
    fake kernel calls of the operations run inside it.  ``axis_of`` maps a
    process group's name to the mesh axes it spans."""

    def __init__(self, axis_of: Optional[Dict[str, str]] = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.axis_of = dict(axis_of or {})
        self.flops: Dict[str, float] = {}
        self.hbm_bytes = 0.0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_FACTOR}
        self.coll_by_axis: Dict[str, float] = {}
        # axis -> "shape dtype" of each all-gather's result -> count
        self.gathers: Dict[str, Dict[str, int]] = {}
        self.kernels: Dict[str, int] = {}
        self.bytes_by_op: Dict[str, float] = {}
        self.n_ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, int] = {}

    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (a DTensor's local) as
        live: arguments made before the tally."""
        from torch.distributed.tensor import DTensor

        for x in _tensors(tree):
            self._see(x.to_local() if isinstance(x, DTensor) else x)

    def _see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key, n = st._cdata, st.nbytes()
        old = self._storages.get(key)
        if old is None:
            weakref.finalize(st, self._free, key)
            old = 0
        self._storages[key] = n
        self.live_bytes += n - old
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    def __enter__(self):
        _build.tallies.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.tallies.remove(self)
        return super().__exit__(*exc)

    @property
    def coll_bytes(self) -> float:
        return sum(self.collectives.values())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if func is _PRIM_DEVICE and is_fake(args[0]):
            self.n_ops += 1
            return args[0].fake_device
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented       # let DTensor desugar to local ops first
        if func is torch.ops._c10d_functional.wait_tensor.default and is_fake(args[0]):
            # eagerly the wait returns the collective's own output; the fake
            # kernel would return a copy (MemTracker makes the same repair)
            return args[0]
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        for t in _tensors(out):
            self._see(t)
        if func.namespace in ("c10d", "_c10d_functional", "c10d_functional"):
            self._collective(func, args, out)
            return out
        name = func._schema.name.split("::")[-1]
        fl = self._flop_registry.get(func._overloadpacket)
        if fl is not None:
            dt = next((a.dtype for a in args
                       if isinstance(a, torch.Tensor) and a.is_floating_point()),
                      torch.float32)
            key = str(dt).replace("torch.", "")
            # an out_dtype overload (bmm.dtype) passes the dtype where the
            # formula takes the output's shape: count on the inputs alone
            fargs = args[:2] if func._overloadname in ("dtype", "dtype_out") else args
            self.flops[key] = self.flops.get(key, 0.0) + fl(*fargs, out_val=out)
        nb = self._bytes(func, name, args, kwargs, out)
        if nb:
            self.hbm_bytes += nb
            self.bytes_by_op[name] = self.bytes_by_op.get(name, 0.0) + nb
        return out

    def _bytes(self, func, name, args, kwargs, out) -> float:
        if name in _FREE or func.is_view or not _nbytes(out):
            return 0       # views, allocations and queries (no tensor out)
        tensors = [a for a in list(args) + list(kwargs.values())
                   if isinstance(a, (torch.Tensor, list, tuple))]
        if name in _GATHERS:
            return _nbytes(tensors[1:]) + 2 * _nbytes(out)
        if name in _SCATTERS:
            vals = _nbytes(tensors[1:])
            return vals + 2 * _nbytes(tensors[-1])
        if name in _WRITES_ONLY:
            return _nbytes(tensors[1:]) + _nbytes(tensors[0])
        return _nbytes(tensors) + _nbytes(out)

    def _collective(self, func, args, out) -> None:
        name = func._schema.name.split("::")[-1]
        if name in _NO_TRAFFIC_COLLECTIVES:
            return
        if name not in _COLLECTIVES:
            raise NotImplementedError(f"the tally has no wire factor for {func}")
        kind, at = _COLLECTIVES[name]
        group = _group(args)
        if group is not None and group.size() == 1:
            return                    # a group of one rank moves nothing
        payload = _nbytes(out if at is None else args[at])
        wire = payload * COLLECTIVE_FACTOR[kind]
        self.collectives[kind] += wire
        gname = None if group is None else group.group_name
        axis = self.axis_of.get(gname, f"group {gname}")
        self.coll_by_axis[axis] = self.coll_by_axis.get(axis, 0.0) + wire
        if kind == "all-gather":
            seen = self.gathers.setdefault(axis, {})
            for t in _tensors(out if at is None else args[at]):
                key = f"{tuple(t.shape)} {str(t.dtype).replace('torch.', '')}"
                seen[key] = seen.get(key, 0) + 1
