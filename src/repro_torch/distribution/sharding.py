"""Logical-axis sharding: one rule table maps model-space names to mesh axes.

Twin of ``repro/distribution/sharding.py``.  Models annotate every
parameter / activation dimension with a *logical* name ('embed', 'heads',
'mlp', 'vocab', 'experts', 'batch', 'kv_seq', 'rows', ...).  A
``RuleSet`` maps logical names to mesh axes; ``spec(...)`` resolves a
tuple of logical names to a ``PartitionSpec``, dropping the axes a mesh
lacks ('pod' on the single-pod mesh).  The five tables carry the
reference's names and values.

``TensorParallel`` is the port's explicit form of what GSPMD does with
the LM cells' rules: each leaf dim a rule places on 'model' stays a
block, computed on as a block (``models/transformer.py``'s tensor-
parallel prefill, decode and training forward), on a process-group mesh
or a local one; under autograd its collectives are the ones with
backward formulas (``core/distributed.py``: the FSDP gather's
reduce-scatter, Megatron's ``copy_to`` / ``reduce_from``).

``PartitionSpec`` is a tuple, one entry a tensor dim: ``None``, an axis
name, or a tuple of names; it compares equal to the reference's spec
turned into a tuple.  ``NamedSharding`` pairs a spec with a mesh and turns
it into DTensor placements, one a mesh dim: ``Shard(d)`` where the spec
names that mesh axis on tensor dim ``d``, ``Replicate()`` elsewhere.  A
tensor dim split over several axes (``("pod", "data")``) is sharded over
each in mesh order, major to minor, as JAX blocks it.  DTensor would pad
an uneven shard (``torch.chunk``); JAX refuses one, and so does
``NamedSharding.check``, naming the leaf.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.core.distributed import copy_to, fsdp_gather, reduce_from
from repro_torch.launch.mesh import Mesh
from repro_torch.training import tree as tree_lib

Axes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """``P(*parts)``: one entry a tensor dim (``None``, a mesh axis name or
    a tuple of names)."""

    def __new__(cls, *parts: Axes):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def is_logical(x) -> bool:
    """A leaf of a logical tree: a tuple of names (``None`` or ``str``)."""
    return isinstance(x, tuple) and all(n is None or isinstance(n, str) for n in x)


def map_logical(fn: Callable, tree, *rest):
    """``fn`` over the logical tuples of ``tree`` (and the matching leaves
    of ``rest``), in a tree of ``tree``'s structure: ``jax.tree.map`` with
    ``is_leaf=is_logical``.  dicts, lists, tuples and NamedTuples are
    containers; ``None`` holds no leaf."""
    if tree is None:
        return None
    if is_logical(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_logical(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        kids = [map_logical(fn, c, *(r[i] for r in rest)) for i, c in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*kids)
        return type(tree)(kids)
    raise TypeError(f"not a logical tree node: {type(tree)}")


def _axes(part: Axes) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: its placements and the local block of a rank."""

    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim."""
        from torch.distributed.tensor import Replicate, Shard

        owner = {}
        for d, part in enumerate(self.spec):
            names = _axes(part)
            if list(names) != [a for a in self.mesh.axis_names if a in names]:
                raise ValueError(f"spec {self.spec}: axes {names} of dim {d} are not "
                                 f"in mesh order {self.mesh.axis_names}")
            for a in names:
                if a in owner:
                    raise ValueError(f"spec {self.spec}: axis {a!r} shards two dims")
                owner[a] = d
        return tuple(Shard(owner[a]) if a in owner else Replicate()
                     for a in self.mesh.axis_names)

    def shards(self, dim: int) -> int:
        """Blocks tensor dim ``dim`` is split into."""
        if dim >= len(self.spec):
            return 1
        return math.prod(self.mesh.shape[a] for a in _axes(self.spec[dim]))

    def check(self, shape: Sequence[int], name: str = "") -> None:
        """Refuse a spec longer than the tensor, or a split dim that does
        not divide its shards (DTensor would pad it)."""
        if len(self.spec) > len(shape):
            raise ValueError(f"{name or 'leaf'}: spec {self.spec} has more dims "
                             f"than shape {tuple(shape)}")
        for d, n in enumerate(shape):
            k = self.shards(d)
            if n % k:
                raise ValueError(f"{name or 'leaf'}: dim {d} of shape {tuple(shape)} "
                                 f"does not divide into {k} shards of {self.spec[d]}")

    def block(self, shape: Sequence[int], coord: Optional[Dict[str, int]] = None
              ) -> Tuple[slice, ...]:
        """The slices of the block held at mesh coordinate ``coord`` (an
        axis -> index dict; this rank's on a process-group mesh)."""
        if coord is None:
            coord = {a: self.mesh.coordinate(a) for a in self.mesh.axis_names}
        out = []
        for d, n in enumerate(shape):
            names = _axes(self.spec[d]) if d < len(self.spec) else ()
            idx = 0
            for a in names:
                idx = idx * self.mesh.shape[a] + coord[a]
            size = n // self.shards(d)
            out.append(slice(idx * size, (idx + 1) * size))
        return tuple(out)

    def distribute(self, full, name: str = ""):
        """``full`` (the whole tensor, on every rank) as a DTensor with this
        rank's block, on a process-group mesh; no collective."""
        from torch.distributed.tensor import DTensor

        if self.mesh.kind != "process_group":
            raise ValueError("DTensor placements need a process-group mesh")
        self.check(full.shape, name)
        local = full[self.block(full.shape)].contiguous()
        return DTensor.from_local(local, self.mesh.device_mesh, self.placements,
                                  run_check=False)


@dataclasses.dataclass(frozen=True)
class RuleSet:
    """Logical axis name -> mesh axes (None = replicate)."""

    rules: Dict[str, Axes]

    def axes_for(self, name: Optional[str], mesh: Mesh) -> Axes:
        if name is None:
            return None
        ax = self.rules.get(name)
        if ax is None:
            return None
        if isinstance(ax, str):
            ax = (ax,)
        # drop axes the mesh doesn't have (e.g. 'pod' on the single-pod mesh)
        present = tuple(a for a in ax if a in mesh.axis_names)
        if not present:
            return None
        return present if len(present) > 1 else present[0]

    def spec(self, logical: Tuple[Optional[str], ...], mesh: Mesh) -> PartitionSpec:
        return P(*(self.axes_for(name, mesh) for name in logical))

    def sharding(self, logical: Tuple[Optional[str], ...], mesh: Mesh) -> NamedSharding:
        return NamedSharding(mesh, self.spec(logical, mesh))

    def tree_specs(self, logical_tree, mesh: Mesh):
        """Map a tree of logical-name tuples to a tree of PartitionSpecs."""
        return map_logical(lambda names: self.spec(names, mesh), logical_tree)

    def with_overrides(self, **kv: Axes) -> "RuleSet":
        new = dict(self.rules)
        new.update(kv)
        return RuleSet(new)


# ---------------------------------------------------------------------------
# Default rule tables per model family
# ---------------------------------------------------------------------------

# Megatron-style TP on 'model' + DP/FSDP on ('pod','data') for LM training.
LM_TRAIN_RULES = RuleSet({
    "batch": ("pod", "data"),
    "seq": None,
    "embed": "data",          # FSDP: gather params per layer
    "embed_kv": None,         # see transformer._block_logical
    "heads": "model",         # TP: attention heads
    "kv_heads": None,         # small GQA kv counts don't divide 16; replicate
    "head_dim": None,
    "mlp": "model",           # TP: FFN hidden
    "vocab": "model",         # TP: output projection + embedding
    "experts": "model",       # EP: routed experts
    "expert_mlp": None,
    "capacity": None,
    "layers": None,
    "kv_seq": None,
})

# Decode: batch over data, KV sequence over model (sequence parallelism).
LM_SERVE_RULES = RuleSet({
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "embed_kv": None,
    "heads": "model",
    "kv_heads": None,
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "capacity": None,
    "layers": None,
    "kv_seq": "model",        # long-context KV cache sharded along sequence
})

# GNN: edges across every device; node state replicated (baseline).
GNN_RULES = RuleSet({
    "edges": ("pod", "data", "model"),
    "nodes": None,
    "feat": None,
    "hidden": None,
    "batch": ("pod", "data"),
    "layers": None,
})

# RecSys: mega embedding table row-sharded on 'model', MLPs data-parallel.
RECSYS_RULES = RuleSet({
    "batch": ("pod", "data"),
    "rows": "model",          # embedding-table rows
    "dim": None,
    "features": None,
    "mlp_in": None,
    "mlp_out": None,
    "seq": None,
    "heads": None,
    "candidates": "model",    # retrieval scoring: candidate axis
    "layers": None,
})

# Pixie graph serving: CSR arrays node-range-sharded on 'model',
# query batch on ('pod','data').
PIXIE_RULES = RuleSet({
    "batch": ("pod", "data"),
    "graph_nodes": "model",
    "graph_edges": "model",
    "slots": None,
    "walkers": None,
    "pins": None,
})


def param_shardings(logical_tree, rules: RuleSet, mesh: Mesh):
    """Tree of ``NamedSharding`` from a tree of logical-name tuples."""
    return map_logical(lambda names: rules.sharding(names, mesh), logical_tree)


def place(tree: Any, shardings: Any) -> Any:
    """``tree``'s whole tensors (the same on every rank) as DTensors in
    ``shardings``' placements (a tree of ``NamedSharding`` matching
    ``tree``): each rank keeps its block, refused where a dim does not
    divide."""
    names, leaves = tree_lib.flatten_with_names(tree)
    sh = tree_lib.leaves(shardings)
    if len(sh) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves but {len(sh)} shardings")
    return tree_lib.unflatten(tree, [s.distribute(x, n) for n, x, s in zip(names, leaves, sh)])


def _full(x):
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def gather_state(tree: Any) -> Any:
    """Every leaf whole (a collective over the placements' ranks)."""
    return tree_lib.tree_map(_full, tree)


# ---------------------------------------------------------------------------
# Tensor parallelism: the leaves a rule set places on 'model' as blocks
# ---------------------------------------------------------------------------


class TensorParallel:
    """Where a tensor-parallel step's leaves live: ``rules`` (the
    parameters') and ``cache_rules`` (the KV cache's) on ``mesh``.  A leaf
    dim whose logical name a rule places on the model axis is split into
    blocks there and each shard computes on its own; a dim placed on the
    data axes (FSDP, ``LM_TRAIN_RULES``' 'embed') is all-gathered where a
    layer uses it and freed after that layer.  One body serves two forms:

      * process-group mesh: every leaf is this rank's block (``cells.place``'
        ``"block"`` form); the one local model shard is this rank's
        coordinate, and the collectives are the 'model' group's;
      * local mesh: every shard in this process.  Only its data axes of
        size 1 are served (each data shard would need its own rows and
        blocks; refused by name).  A leaf with a dim on the model axis
        carries its shards stacked on a new dim right after 'layers' (first
        where it has no 'layers'): ``local_form``.  Its collectives
        (``fabric``, a ``LocalFabric``) act over that dim, sums chained in
        shard order.

    ``shards`` hands the body one layer's leaf as ``(stacked, split)``: its
    local shards' blocks on a leading dim (one on a process group) when a
    dim is on 'model', else the leaf whole on a leading dim of 1.  Under
    autograd a data dim's gather is ``fsdp_gather`` (its gradient comes
    back reduce-scattered over the data ranks); without it, a plain
    all-gather.  ``reduce`` and ``copy`` are the model axis's sum of a
    row-parallel product's partials and the identity on a column-parallel
    product's input, each with Megatron's backward."""

    axis = "model"

    def __init__(self, mesh: Mesh, rules: RuleSet, cache_rules: Optional[RuleSet] = None):
        if mesh.kind == "abstract":
            raise ValueError("an abstract mesh only resolves specs; it has no devices")
        if self.axis not in mesh.axis_names:
            raise ValueError(f"mesh axes {mesh.axis_names} lack {self.axis!r}")
        others = [a for a in mesh.axis_names if a != self.axis]
        if mesh.kind == "local" and mesh.axis_size(others) > 1:
            raise ValueError(
                f"a local mesh serves tensor-parallel only with its axes {others} of "
                f"size 1, got {mesh.shape}: each data shard would need its own rows")
        self.mesh, self.rules = mesh, rules
        self.cache_rules = cache_rules or rules
        self.n = mesh.shape[self.axis]
        self.local = mesh.kind == "local"
        self.fabric = mesh.fabric(self.axis)
        # the model coordinates of the local shards, in order
        self.coords: List[int] = (list(range(self.n)) if self.local
                                  else [mesh.coordinate(self.axis)])
        self.data_ranks = mesh.axis_size(others)
        self._data_axes = tuple(others)

    @property
    def data_fabric(self):
        """The collectives over the data axes (the MoE route over the
        global batch, the aux's mean over the data ranks)."""
        return self.mesh.fabric(self._data_axes)

    def split(self, name: Optional[str], rules: Optional[RuleSet] = None) -> bool:
        """The logical name is placed on the model axis (alone)."""
        names = _axes((rules or self.rules).axes_for(name, self.mesh))
        if self.axis in names and len(names) > 1:
            raise ValueError(f"{name!r} is split over {names}: tensor parallelism "
                             f"takes the model axis alone")
        return names == (self.axis,)

    def _model_dim(self, logical, rules) -> Optional[int]:
        dims = [d for d, n in enumerate(logical) if self.split(n, rules)]
        if len(dims) > 1:
            raise ValueError(f"{logical}: two dims on the model axis")
        return dims[0] if dims else None

    def offsets(self, split: bool) -> List[int]:
        """The block index of each local shard of a leaf: the model
        coordinates where it is split, else the one whole block."""
        return self.coords if split else [0]

    def shards(self, x: torch.Tensor, logical: Tuple, rules: Optional[RuleSet] = None,
               fsdp: bool = True) -> Tuple[torch.Tensor, bool]:
        """One layer's leaf (``logical`` its names without 'layers') ->
        ``(stacked, split)`` (the class docstring); with ``fsdp`` (a
        parameter) a process-group rank's data-split dims gathered whole
        first, else (the cache: its batch dim is this rank's rows) kept."""
        rules = rules or self.rules
        split = self._model_dim(logical, rules) is not None
        if self.local:
            return (x, True) if split else (x[None], False)
        if fsdp:
            x = self._gather_data(x, logical, rules)
        return x[None], split

    def whole(self, x: torch.Tensor, logical: Tuple, rules: Optional[RuleSet] = None
              ) -> torch.Tensor:
        """A leaf no rule splits over the model axis, its data dims gathered."""
        stacked, split = self.shards(x, logical, rules)
        if split:
            raise ValueError(f"{logical} is split over {self.axis!r}; this step "
                             "takes it whole")
        return stacked[0]

    def _gather_data(self, x: torch.Tensor, logical: Tuple, rules: RuleSet) -> torch.Tensor:
        for d, name in enumerate(logical):
            axes = _axes(rules.axes_for(name, self.mesh))
            if not axes or self.axis in axes or self.mesh.axis_size(axes) == 1:
                continue
            parts = fsdp_gather(self.mesh.fabric(axes), x[None].contiguous())
            x = parts.movedim(0, d).flatten(d, d + 1)
        return x

    def reduce(self, parts: torch.Tensor, split: bool) -> torch.Tensor:
        """The local shards' partials ``(S_l, ...)`` of a product over a
        split leaf summed over the model axis (``reduce_from``: every shard
        uses the sum alike), or the one part of a whole leaf."""
        return reduce_from(self.fabric, parts) if split else parts[0]

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, which every shard holds alike and reads in part (the input
        of a column-parallel product): its gradient summed over the model
        axis (``copy_to``)."""
        return copy_to(self.fabric, x)

    def local_form(self, tree: Any, logical_tree: Any, rules: Optional[RuleSet] = None
                   ) -> Any:
        """Whole tensors -> the local mesh's form (the class docstring), as
        views of ``tree``'s storage (a cache the decode kernel reads must
        be made contiguous)."""
        if not self.local:
            raise ValueError("the stacked-shard form is a local mesh's")
        rules = rules or self.rules

        def one(logical, x):
            d = self._model_dim(logical, rules)
            if d is None:
                return x
            if x.shape[d] % self.n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not divide into "
                                 f"{self.n} shards")
            at = 1 if logical and logical[0] == "layers" else 0
            return x.unflatten(d, (self.n, x.shape[d] // self.n)).movedim(d, at)

        return map_logical(one, logical_tree, tree)

    def whole_form(self, tree: Any, logical_tree: Any, rules: Optional[RuleSet] = None
                   ) -> Any:
        """The local mesh's form (``local_form``) -> whole tensors: each
        split leaf's shards put back along its model dim (a copy where the
        stacked form is not a view of a whole tensor)."""
        if not self.local:
            raise ValueError("the stacked-shard form is a local mesh's")
        rules = rules or self.rules

        def one(logical, x):
            d = self._model_dim(logical, rules)
            if d is None:
                return x
            at = 1 if logical and logical[0] == "layers" else 0
            return x.movedim(at, d).flatten(d, d + 1)

        return map_logical(one, logical_tree, tree)
