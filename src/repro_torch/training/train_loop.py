"""Train-step factory: loss -> microbatched grads -> AdamW -> metrics.

Twin of ``repro/training/train_loop.py``.  ``make_train_step`` packages
the reference's step on one device (``TrainStep``):
``microbatch.accumulated_grads``, then AdamW (``optim.prepare_step`` and
``optim.adamw_leaf`` on each leaf, in place, the counterpart of the
reference's donated state), with the mean loss added to the metrics.  The
step runs eagerly on the device of the parameters.

The mesh half resolves shardings from the logical rule table
(``distribution/sharding.py``): ``state_shardings`` (optionally ZeRO-1:
the moments sharded over 'data' on top of the parameter sharding) and
``batch_shardings``, as ``NamedSharding`` trees whose specs equal the
reference's.  There is no jit: ``jit_train_step`` returns a step over a
mesh through the same step body (``TrainStep.run``), in one of two forms.
With ``tp`` (an LM whose loss runs tensor-parallel, ``loss_fn(tp=)``)
the state is each rank's blocks and nothing is gathered whole
(``_blocks_step``).  Without it the mesh is a process group's, the state
DTensors in those placements, and the loss takes whole parameters (the
recsys models' ``loss_fn(mesh=)``, and an LM's without ``tp``).  Each
step of that gathered form:

  1. gathers every parameter whole (leaves placed on 'model' too: FSDP
     style);
  2. takes this rank's rows of every microbatch (the batch dim split over
     its sharding's axes, each microbatch split as GSPMD splits it) and
     runs ``accumulated_grads`` on them; the loss must return this rank's
     share of the global loss (``transformer.loss_fn`` with the mesh
     normalises by the token count summed over the data ranks);
  3. all-reduces the loss and grads over the data axes, leaf by leaf in
     the tree's order;
  4. clips by the global norm and updates this rank's ZeRO-1 block of
     ``m``, ``v`` and the parameters (``optim.adamw_leaf``, elementwise);
  5. all-gathers the updated blocks over 'data' back to each parameter's
     placement, in place.

At world size 1 every collective adds nothing, and the step gives
``make_train_step``'s bits.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.distribution.sharding import (
    NamedSharding, P, PartitionSpec, RuleSet, gather_state, map_logical,
)
from repro_torch.launch.mesh import Mesh, data_axes
from repro_torch.training import microbatch, optim
from repro_torch.training import tree as tree_lib

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    adamw: optim.AdamWConfig = optim.AdamWConfig()
    n_micro: int = 1
    zero1: bool = False          # shard m/v over the data axis too (mesh only)
    donate: bool = True


class TrainStep:
    """``make_train_step``'s step: ``step((params, opt_state), batch) ->
    (state', metrics)`` on one device.  ``jit_train_step`` runs the same
    body (``run``) over a mesh with its own reduction and leaf update."""

    def __init__(self, loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
                 config: TrainStepConfig):
        self.loss_fn, self.config = loss_fn, config

    def __call__(self, state, batch):
        params, opt_state = state
        p, m, v = (tree_lib.leaves(t) for t in (params, opt_state.m, opt_state.v))

        def update(i, g, hyper):
            optim.adamw_leaf(p[i], m[i], v[i], g, hyper, self.config.adamw)

        return (params, opt_state), self.run(params, batch, opt_state.step, update)

    def run(self, params: PyTree, batch: PyTree, step: torch.Tensor,
            update: Callable, loss_reduce: Optional[Callable] = None,
            grad_reduce: Optional[Callable] = None,
            norm_reduce: Optional[optim.SumsReduce] = None):
        """The step body: the mean loss and grads of ``loss_fn`` at
        ``params`` over ``batch``'s microbatches; ``loss_reduce`` (a sum
        over the data ranks) on the loss and ``grad_reduce(i, grad)`` on
        each grad in the tree's order; the grads clipped (by their norm
        over blocks with ``norm_reduce``) and ``step`` counted
        (``optim.prepare_step``); then ``update(i, grad, hyper)`` for each
        leaf ``i``.  Returns ``{"grad_norm", "lr", "loss"}``."""
        cfg = self.config
        loss, grads = microbatch.accumulated_grads(self.loss_fn, params, batch,
                                                   cfg.n_micro)
        with torch.no_grad():
            if loss_reduce is not None:
                loss = loss_reduce(loss)
            if grad_reduce is not None:
                grads = tree_lib.unflatten(grads, [
                    grad_reduce(i, g) for i, g in enumerate(tree_lib.leaves(grads))])
            grads, hyper = optim.prepare_step(grads, step, cfg.adamw, norm_reduce)
            for i, g in enumerate(tree_lib.leaves(grads)):
                update(i, g, hyper)
        return {"grad_norm": hyper["grad_norm"], "lr": hyper["lr"], "loss": loss}


def make_train_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    cfg: TrainStepConfig,
) -> TrainStep:
    """Returns ``train_step((params, opt_state), batch) -> (state',
    metrics)``; ``state'`` holds the same tensors, updated in place, and
    ``metrics`` is ``{"grad_norm", "lr", "loss"}`` as 0-d tensors on the
    device (reading one synchronises)."""
    return TrainStep(loss_fn, cfg)


def _zero1_spec(spec: PartitionSpec, mesh: Mesh, shape=None) -> PartitionSpec:
    """Add 'data' sharding to the largest unsharded *divisible* dim (the
    first such dim without ``shape``); unchanged when 'data' is used or no
    dim qualifies."""
    parts = list(spec)
    used = set()
    for p in parts:
        if p is None:
            continue
        for a in (p if isinstance(p, tuple) else (p,)):
            used.add(a)
    if "data" in used or not parts:
        return spec
    n_data = mesh.shape.get("data", 1)
    candidates = [
        i for i, p in enumerate(parts)
        if p is None
        and (shape is None or (len(shape) > i and shape[i] % n_data == 0))
    ]
    if not candidates:
        return spec
    if shape is not None:
        i = max(candidates, key=lambda j: shape[j])
    else:
        i = candidates[0]
    parts[i] = "data"
    return P(*parts)


def state_shardings(
    param_logical: PyTree,
    rules: RuleSet,
    mesh: Mesh,
    zero1: bool = False,
    params_abs: Optional[PyTree] = None,
) -> Tuple[PyTree, optim.OptState]:
    """(param shardings, OptState shardings) from logical axes.

    Pass ``params_abs`` (leaves with ``.shape``: tensors, meta tensors) so
    ZeRO-1 only shards divisible dims."""
    # walked along the logical tree (a spec is a tuple too)
    param_sh = map_logical(lambda names: NamedSharding(mesh, rules.spec(names, mesh)),
                           param_logical)
    if not zero1:
        opt_sh = param_sh
    elif params_abs is not None:
        opt_sh = map_logical(lambda names, s, p: NamedSharding(
            mesh, _zero1_spec(s.spec, mesh, tuple(p.shape))), param_logical, param_sh,
            params_abs)
    else:
        opt_sh = map_logical(lambda names, s: NamedSharding(mesh, _zero1_spec(s.spec, mesh)),
                             param_logical, param_sh)
    return param_sh, optim.OptState(m=opt_sh, v=opt_sh, step=NamedSharding(mesh, P()))


def batch_shardings(batch_logical: PyTree, rules: RuleSet, mesh: Mesh):
    return map_logical(lambda names: NamedSharding(mesh, rules.spec(names, mesh)),
                       batch_logical)


def _local(x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _rank_rows(x: torch.Tensor, sharding: NamedSharding, n_micro: int,
               name: str) -> torch.Tensor:
    """This rank's rows of every microbatch of ``x``: microbatch ``i`` is
    rows ``[i * bm, (i + 1) * bm)``, split over the batch dim's axes."""
    if any(p is not None for p in sharding.spec[1:]):
        raise ValueError(f"batch leaf {name}: only the batch dim may be sharded "
                         f"({sharding.spec})")
    n = sharding.shards(0)
    if n == 1:
        return x
    bm = x.shape[0] // n_micro
    if x.shape[0] % n_micro or bm % n:
        raise ValueError(f"batch leaf {name}: {x.shape[0]} rows do not split into "
                         f"{n_micro} microbatches over {n} data shards")
    rows = sharding.block((bm,) + tuple(x.shape[1:]))[0]
    return torch.cat([x[i * bm:(i + 1) * bm][rows] for i in range(n_micro)])


def jit_train_step(
    train_step: TrainStep,
    param_sharding: PyTree,
    opt_sharding: optim.OptState,
    batch_sharding: PyTree,
    donate: bool = True,
    *,
    tp=None,
):
    """``train_step`` (from ``make_train_step``) over the mesh of the
    shardings: ``step((params, opt_state), batch) -> (state', metrics)``,
    ``batch`` the whole global batch on every rank (see the module
    docstring).  Without ``tp`` the mesh is a process group's and the
    state DTensors in ``param_sharding`` / ``opt_sharding``
    (``sharding.place`` puts a whole state there), every parameter gathered
    whole for compute.  With ``tp`` (a ``sharding.TensorParallel`` on the
    shardings' mesh, the one the loss computes on) the state is this rank's
    blocks as plain tensors (``cells.place``' ``"block"`` form), or on a
    local mesh its stacked-shard form (``tp.local_form``), and nothing is
    gathered whole (``_blocks_step``).  ``donate`` updates the given state
    in place; without it the step updates a copy."""
    if not isinstance(train_step, TrainStep):
        raise TypeError("jit_train_step runs a step made by make_train_step, got "
                        f"{type(train_step).__name__}")
    cfg = train_step.config
    mesh = tree_lib.leaves(param_sharding)[0].mesh
    if tp is not None:
        if tp.mesh is not mesh:
            raise ValueError("tp's mesh is not the shardings' mesh")
        return _blocks_step(train_step, param_sharding, opt_sharding, batch_sharding,
                            donate, tp)
    if mesh.kind != "process_group":
        raise ValueError("jit_train_step runs over a process-group mesh")
    d_axes = data_axes(mesh)
    reduce = mesh.fabric(d_axes) if d_axes else None
    zero = mesh.fabric("data") if "data" in mesh.axis_names else None
    p_specs = [s.spec for s in tree_lib.leaves(param_sharding)]
    o_sh = tree_lib.leaves(opt_sharding.m)

    def step(state, batch):
        if not donate:
            state = tree_lib.tree_map(lambda x: x.clone(), state)
        params, opt = state
        full = gather_state(params)
        local = _local_batch(batch, batch_sharding, cfg.n_micro)
        p, pf, m, v = (tree_lib.leaves(t) for t in (params, full, opt.m, opt.v))

        def update(i, g, hyper):
            # this rank's ZeRO-1 block of the leaf, then back to its placement
            blk = o_sh[i].block(pf[i].shape)
            region = pf[i][blk]
            optim.adamw_leaf(region, _local(m[i]), _local(v[i]), g[blk], hyper, cfg.adamw)
            _write_back(p[i], region, p_specs[i], o_sh[i].spec, zero)

        metrics = train_step.run(
            full, local, _local(opt.step), update,
            loss_reduce=(lambda x: _all_reduce(reduce, x)) if reduce is not None else None,
            grad_reduce=(lambda i, g: _all_reduce(reduce, g)) if reduce is not None else None)
        return (params, opt), metrics

    return step


def _all_reduce(fabric, x: torch.Tensor) -> torch.Tensor:
    return fabric.psum(x.reshape(1, *(x.shape or (1,)))).reshape(x.shape)


def _local_batch(batch: PyTree, batch_sharding: PyTree, n_micro: int) -> PyTree:
    names, leaves = tree_lib.flatten_with_names(batch)
    return tree_lib.unflatten(batch, [
        _rank_rows(x, s, n_micro, n) for n, x, s in
        zip(names, leaves, tree_lib.leaves(batch_sharding))])


def _axes_of(spec: PartitionSpec) -> set:
    return {a for part in spec if part is not None
            for a in (part if isinstance(part, tuple) else (part,))}


def _blocks_step(train_step: TrainStep, param_sharding, opt_sharding, batch_sharding,
                 donate: bool, tp):
    """``jit_train_step`` on each rank's blocks (``tp``).  The loss runs
    tensor-parallel on them, so each gradient comes out in its parameter's
    placement; a leaf's data-split (FSDP) dims had their gradient
    reduce-scattered in the gather's backward, and the rest of the data
    axes are all-reduced here, leaf by leaf in the tree's order.  Nothing
    is reduced over 'model': every model shard computes the same loss, so
    a leaf replicated over it already holds its whole gradient.  The
    global norm sums each leaf's squares over the axes it is split on
    (``optim.global_norm``), then the ZeRO-1 block of each leaf (within
    this rank's block) is updated and all-gathered back over 'data', as
    the gathered step does.  A local mesh's stacked shards are each leaf's
    whole (its data axes have size 1): no collective."""
    cfg = train_step.config
    mesh = tp.mesh
    pg = mesh.kind == "process_group"
    p_specs = [s.spec for s in tree_lib.leaves(param_sharding)]
    o_specs = [s.spec for s in tree_lib.leaves(opt_sharding.m)]
    live = [a for a in mesh.axis_names if pg and mesh.shape[a] > 1]
    d_axes = tuple(a for a in data_axes(mesh) if a in live)
    grad_axes = [tuple(a for a in d_axes if a not in _axes_of(sp)) for sp in p_specs]
    norm_axes = [tuple(a for a in live if a in _axes_of(sp)) for sp in p_specs]
    reduce = mesh.fabric(d_axes) if d_axes else None
    zero = mesh.fabric("data") if "data" in live else None

    def grad_reduce(i, g):
        return _all_reduce(mesh.fabric(grad_axes[i]), g) if grad_axes[i] else g

    def norm_reduce(sums):
        out = list(sums)
        for axes in dict.fromkeys(a for a in norm_axes if a):
            idx = [i for i, a in enumerate(norm_axes) if a == axes]
            got = mesh.fabric(axes).psum(torch.stack([sums[i] for i in idx])[None])
            for j, i in enumerate(idx):
                out[i] = got[j]
        return out

    def zero1_block(i, shape):
        """This rank's ZeRO-1 block of leaf ``i`` within its parameter
        block: the dim ZeRO-1 split over 'data' on top of the parameter's
        placement, if any."""
        blk = [slice(None)] * len(shape)
        for d, (a, b) in enumerate(zip(p_specs[i], o_specs[i])):
            if a != b:
                n = shape[d] // zero.n_shards
                blk[d] = slice(zero.rank * n, (zero.rank + 1) * n)
        return tuple(blk)

    def step(state, batch):
        if not donate:
            state = tree_lib.tree_map(lambda x: x.clone(), state)
        params, opt = state
        local = _local_batch(batch, batch_sharding, cfg.n_micro)
        p, m, v = (tree_lib.leaves(t) for t in (params, opt.m, opt.v))

        def update(i, g, hyper):
            if zero is None:
                optim.adamw_leaf(p[i], m[i], v[i], g, hyper, cfg.adamw)
                return
            blk = zero1_block(i, p[i].shape)
            region = p[i][blk]
            optim.adamw_leaf(region, m[i], v[i], g[blk], hyper, cfg.adamw)
            _write_back(p[i], region, p_specs[i], o_specs[i], zero)

        metrics = train_step.run(
            params, local, opt.step, update,
            loss_reduce=(lambda x: _all_reduce(reduce, x)) if reduce is not None else None,
            grad_reduce=grad_reduce, norm_reduce=norm_reduce)
        return (params, opt), metrics

    return step


def _write_back(p, region: torch.Tensor, pspec, ospec, zero) -> None:
    """The updated ZeRO-1 block into the parameter's own block: as is, or
    all-gathered over 'data' along the dim ZeRO-1 split."""
    dims = [i for i, (a, b) in enumerate(zip(pspec, ospec)) if a != b]
    if dims:
        parts = zero.all_gather(region[None].contiguous())
        region = torch.cat(list(parts.unbind(0)), dim=dims[0])
    local = _local(p)
    if not _same_memory(local, region):          # (a one-rank gather may alias)
        local.copy_(region)


def _same_memory(a: torch.Tensor, b: torch.Tensor) -> bool:
    """``a`` and ``b`` view the same elements (compared by storage and
    offset: a dry run's fake tensors have no data pointer)."""
    return (a.untyped_storage()._cdata == b.untyped_storage()._cdata
            and a.storage_offset() == b.storage_offset() and a.shape == b.shape)
