"""Dry-run cell builders: (arch x shape x mesh) -> one rank's program.

Twin of ``repro/launch/cells.py``.  Each builder returns a ``Cell``:

  * ``args``: meta tensors of the reference's GLOBAL shapes and dtypes
    (nothing allocates: parameters, optimizer state, caches and batches
    are ``abstract_*`` stand-ins);
  * ``in_shardings`` / ``out_shardings``: the port's ``NamedSharding``s,
    spec for spec the reference's; ``donate``: the reference's;
  * ``fn``: the port's per-rank program over a process-group mesh
    (``launch/mesh.py``).  The port has no GSPMD, so the program is
    written out; ``place`` turns whole arguments into the forms ``fn``
    takes (``forms``, one an argument): ``"block"`` this rank's block of
    its sharding, ``"dtensor"`` that block as a DTensor, ``"whole"`` the
    global tensor (``jit_train_step``'s batch: it takes its own rows).

The per-rank programs:

  * LM train: ``train_loop.jit_train_step`` (ZeRO-1, ``n_micro``) on this
    rank's blocks of the state in the reference's placements, the loss
    tensor-parallel (``transformer.loss_fn(tp=)``: Megatron column / row
    products with their backward passes, the FSDP 'data' dims gathered a
    layer at a time and their gradients reduce-scattered, the vocab-parallel
    lookup, head and cross-entropy); no leaf is gathered whole over
    'model';
  * LM prefill and decode: ``transformer.prefill`` / ``decode_step``
    tensor-parallel on this rank's blocks (``sharding.TensorParallel``:
    every leaf the cell's rules place on 'model' stays a block, the
    products on 'heads' / 'mlp' / 'vocab' / 'experts' are Megatron's with
    one sum or gather over 'model', prefill's FSDP 'data' dims gathered a
    layer at a time) on this rank's rows; prefill writes this rank's
    ``kv_seq`` block of the cache, and decode attends over that block
    (``decode_attention_partial``) and merges the shards' partial
    softmaxes after one gather of their ``(o, m, l)``;
  * MoE blocks with ``ep_shard_map``: each shard's own experts routed on
    this rank's tokens (the reference's ``shard_map``); without it over
    several data ranks, routing over the global batch
    (``moe.moe_ffn_global``: each expert's count all-gathered over the
    data axes, the aux summed over them);
  * GIN: the edges split over every axis, the partial aggregates summed
    (``gnn.forward(edge_fabric=)``), parameters replicated;
  * DLRM: ``embedding.lookup_sharded`` over 'model', the batch over the
    data axes; training hybrid as the reference's (rowwise AdaGrad on the
    table block, AdamW with ZeRO-1 blocks on the MLPs, grads all-reduced
    over the data axes); retrieval merges the data ranks' top 100;
  * SASRec / BST: ``jit_train_step`` over replicated tables, serving on
    this rank's rows, retrieval over this rank's candidates with the
    ranks' top 100 merged;
  * ``pixie_sharded``: ``distributed.pixie_walk_sharded`` over the
    'model' fabric, one shard's CSR a rank;
  * ``pixie_replicated``: one query a rank (``prng.split(key, Q)[rank]``).

**Host reads a traced program cannot make.**  A fake tensor has no values,
so every place where the port sizes work by reading data to the host
takes a stated static bound under the dry run (none is caught and passed
over):

  * the event walk's early stop (``core/walk.py`` ``pixie_walk_events``,
    ``bool(slot_active.any())``): the replicated cell runs the fixed twin
    ``pixie_walk_events_fixed`` at ``cfg.walk.max_chunks()`` chunks, as the
    reference's cost cell does; the record says ``"form": "fixed"``
    (``build_cell(..., dry=True)``);
  * the sharded engine's all-rows-done exit (``core/distributed.py``
    ``pixie_walk_sharded_batched``): every chunk runs;
  * ``recommend_from_events`` (``core/counter.py``): the live event runs
    are all ``max_unique`` of them, and a pin's chain ``n_slots`` adds;
  * ``gnn.segment_sum``'s depth: one ``index_add`` (``models/gnn.py``);
  * the decode step's ``pos`` (an int in ``decode_step``): ``seq_len - 1``,
    the cache's last position, so attention reads the whole cache;
  * the walk's feature-range check (``walk._check_feats``): skipped, the
    features hold no values.

The reference's ``cost_depth`` / ``build_cost_cell`` exist because XLA's
cost analysis counts a while body once; a traced torch program counts
every iteration, so the port has no depth extrapolation.  The reference's
PRNG-key arguments are typed keys; the port's are ``(2,)`` int64 word
pairs (``core/prng.py``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, Tuple

import torch

from repro_torch import abstract
from repro_torch.configs.registry import ArchSpec, ShapeCell
from repro_torch.core import counter
from repro_torch.core import distributed as pixie_dist
from repro_torch.core import prng
from repro_torch.core import walk as walk_lib
from repro_torch.core.graph import CSR, PinBoardGraph, graph_abstract
from repro_torch.distribution import sharding as shlib
from repro_torch.distribution.sharding import NamedSharding, P
from repro_torch.launch.mesh import Mesh, data_axes
from repro_torch.models import dlrm as dlrm_lib
from repro_torch.models import embedding as emb_lib
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import sequential_rec as sr
from repro_torch.models import transformer as tf
from repro_torch.training import optim, train_loop
from repro_torch.training import tree as tree_lib

FORMS = ("block", "dtensor", "whole")


@dataclasses.dataclass
class Cell:
    fn: Any
    args: Tuple
    in_shardings: Any
    out_shardings: Any
    donate: Tuple[int, ...] = ()
    forms: Tuple[str, ...] = ()
    form: str = "real"        # "fixed": a data-dependent loop at its bound


def _ns(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))


def _batch_axes(mesh: Mesh):
    ax = data_axes(mesh)
    return ax if len(ax) > 1 else (ax[0] if ax else None)


def _all_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data", "model") if a in mesh.axis_names)


SDS = abstract.meta          # the reference's jax.ShapeDtypeStruct


# ---------------------------------------------------------------------------
# Placing whole arguments as one rank's
# ---------------------------------------------------------------------------


def place(cell: Cell, args: Tuple) -> Tuple:
    """``args`` (whole tensors, the same on every rank: real or fake) in
    the forms ``cell.fn`` takes on this rank."""
    out = []
    for a, sh, form in zip(args, cell.in_shardings, cell.forms):
        if form not in FORMS:
            raise ValueError(f"unknown argument form {form!r}")
        names, leaves = tree_lib.flatten_with_names(a)
        shs = tree_lib.leaves(sh)
        if len(shs) != len(leaves):
            raise ValueError(f"{len(leaves)} leaves but {len(shs)} shardings")
        new = []
        for n, x, s in zip(names, leaves, shs):
            if form == "whole":
                new.append(x)
                continue
            s.check(x.shape, n)
            local = x[s.block(x.shape)].clone()      # its own storage
            if form == "dtensor":
                from torch.distributed.tensor import DTensor

                local = DTensor.from_local(local, s.mesh.device_mesh, s.placements,
                                           run_check=False)
            new.append(local)
        out.append(tree_lib.unflatten(a, new))
    return tuple(out)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_train_rules(spec: ArchSpec) -> shlib.RuleSet:
    return shlib.LM_TRAIN_RULES.with_overrides(**spec.train_rule_overrides)


def _lm_serve_rules(spec: ArchSpec) -> shlib.RuleSet:
    rules = shlib.LM_SERVE_RULES.with_overrides(
        heads=None, embed=None
    )  # decode: attention DP, KV sequence-sharded
    return rules.with_overrides(**spec.serve_rule_overrides)


def _static_pos(pos: torch.Tensor, bound: int) -> int:
    """``decode_step``'s position: read from the tensor, or under a dry run
    (no values) the cache's last position."""
    return bound if abstract.is_fake(pos) else int(pos)


def build_lm_cell(
    spec: ArchSpec, cell: ShapeCell, mesh: Mesh, n_micro: int = 4
) -> Cell:
    cfg = spec.config
    seq = cell.params["seq_len"]
    batch = cell.params["global_batch"]
    bax = _batch_axes(mesh)

    if cell.kind == "train":
        rules = _lm_train_rules(spec)
        logical = tf.param_logical(cfg)
        params_abs = tf.abstract_params(cfg)
        opt_abs = optim.abstract_state(params_abs)
        param_sh, opt_sh = train_loop.state_shardings(
            logical, rules, mesh, zero1=True, params_abs=params_abs
        )
        batch_abs = {
            "tokens": SDS((batch, seq), torch.int32),
            "labels": SDS((batch, seq), torch.int32),
            "mask": SDS((batch, seq), torch.float32),
        }
        batch_sh = {k: _ns(mesh, bax, None) for k in batch_abs}

        def train(state, b):
            tp = shlib.TensorParallel(mesh, rules)
            step = train_loop.make_train_step(
                lambda p, bb: tf.loss_fn(p, bb["tokens"], bb["labels"], bb["mask"], cfg,
                                         tp=tp),
                train_loop.TrainStepConfig(n_micro=n_micro),
            )
            return train_loop.jit_train_step(step, param_sh, opt_sh, batch_sh, tp=tp)(state, b)

        return Cell(
            fn=train,
            args=((params_abs, opt_abs), batch_abs),
            in_shardings=((param_sh, opt_sh), batch_sh),
            out_shardings=((param_sh, opt_sh), None),
            donate=(0,),
            forms=("block", "whole"),
        )

    if cell.kind == "prefill":
        # training-style placement for the prompt pass; cache comes out
        # seq-sharded
        rules = _lm_train_rules(spec)
        params_abs = tf.abstract_params(cfg)
        param_sh = shlib.param_shardings(tf.param_logical(cfg), rules, mesh)
        tokens_abs = SDS((batch, seq), torch.int32)
        serve_rules = shlib.LM_SERVE_RULES.with_overrides(
            **spec.serve_rule_overrides
        )
        cache_sh = {
            k: serve_rules.sharding(v, mesh) for k, v in tf.kv_cache_logical().items()
        }

        def prefill_fn(p, tokens):
            tp = shlib.TensorParallel(mesh, rules, serve_rules)
            with torch.no_grad():
                return tf.prefill(p, tokens, cfg, max_seq=seq, tp=tp)

        return Cell(
            fn=prefill_fn,
            args=(params_abs, tokens_abs),
            in_shardings=(param_sh, _ns(mesh, bax, None)),
            out_shardings=(_ns(mesh, bax, None), cache_sh),
            forms=("block", "block"),
        )

    if cell.kind == "decode":
        rules = _lm_serve_rules(spec)
        if batch == 1:
            # batch of 1 cannot shard over data; keep it replicated
            rules = rules.with_overrides(batch=None)
            bax = None
        params_abs = tf.abstract_params(cfg)
        param_sh = shlib.param_shardings(tf.param_logical(cfg), rules, mesh)
        cache_abs = tf.abstract_kv_cache(cfg, batch, seq)
        cache_sh = {
            k: rules.sharding(v, mesh) for k, v in tf.kv_cache_logical().items()
        }
        tokens_abs = SDS((batch,), torch.int32)
        pos_abs = SDS((), torch.int32)

        def decode_fn(p, cache, tokens, pos):
            tp = shlib.TensorParallel(mesh, rules)
            with torch.no_grad():
                logits, _ = tf.decode_step(p, cache, tokens, _static_pos(pos, seq - 1),
                                           cfg, tp=tp)
            return logits, cache

        return Cell(
            fn=decode_fn,
            args=(params_abs, cache_abs, tokens_abs, pos_abs),
            in_shardings=(
                param_sh, cache_sh, _ns(mesh, bax), _ns(mesh),
            ),
            out_shardings=(_ns(mesh, bax, None), cache_sh),
            donate=(1,),
            forms=("block", "block", "block", "whole"),
        )

    raise ValueError(f"unknown LM cell kind {cell.kind}")


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def build_gnn_cell(spec: ArchSpec, cell: ShapeCell, mesh: Mesh) -> Cell:
    base: gnn_lib.GINConfig = spec.config
    p = cell.params
    edge_ax = _all_axes(mesh)

    if cell.name == "minibatch_lg":
        # fixed-fanout sampled block shapes
        batch = p["batch_nodes"]
        f = p["fanout"]
        n_nodes = batch * (1 + f[0] + f[0] * f[1])
        n_edges = batch * (f[0] + f[0] * f[1])
        d_feat, n_classes = p["d_feat"], p["n_classes"]
        readout = None
        n_graphs = 0
    elif cell.name == "molecule":
        n_nodes = p["n_nodes"] * p["batch"]
        n_edges = p["n_edges"] * p["batch"]
        d_feat, n_classes = p["d_feat"], p["n_classes"]
        readout = "sum"
        n_graphs = p["batch"]
    else:
        n_nodes, n_edges = p["n_nodes"], p["n_edges"]
        d_feat, n_classes = p["d_feat"], p["n_classes"]
        readout = None
        n_graphs = 0

    cfg = dataclasses.replace(
        base, d_in=d_feat, n_classes=n_classes, readout=readout
    )
    params_abs = gnn_lib.abstract_params(cfg)
    opt_abs = optim.abstract_state(params_abs)
    # GIN params are tiny: replicate everywhere
    rep = tree_lib.tree_map(lambda _: _ns(mesh), params_abs)
    opt_rep = tree_lib.tree_map(lambda _: _ns(mesh), opt_abs)

    # pad the edge count so the edge axis shards evenly
    n_shards = mesh.axis_size(edge_ax) if edge_ax else 1
    n_edges = -(-n_edges // n_shards) * n_shards
    fabric = lambda: mesh.fabric(edge_ax)

    if readout == "sum":
        batch_abs = {
            "feats": SDS((n_nodes, d_feat), torch.float32),
            "edge_src": SDS((n_edges,), torch.int32),
            "edge_dst": SDS((n_edges,), torch.int32),
            "graph_ids": SDS((n_nodes,), torch.int32),
            "labels": SDS((n_graphs,), torch.int32),
        }

        def loss_fn(pp, b):
            return gnn_lib.graph_classification_loss(
                pp, b["feats"], b["edge_src"], b["edge_dst"],
                b["graph_ids"], b["labels"], cfg, n_graphs, edge_fabric=fabric(),
            )
    else:
        batch_abs = {
            "feats": SDS((n_nodes, d_feat), torch.float32),
            "edge_src": SDS((n_edges,), torch.int32),
            "edge_dst": SDS((n_edges,), torch.int32),
            "labels": SDS((n_nodes,), torch.int32),
            "mask": SDS((n_nodes,), torch.float32),
        }

        def loss_fn(pp, b):
            return gnn_lib.node_classification_loss(
                pp, b["feats"], b["edge_src"], b["edge_dst"],
                b["labels"], b["mask"], cfg, edge_fabric=fabric(),
            )

    eax = edge_ax if len(edge_ax) > 1 else (edge_ax[0] if edge_ax else None)
    batch_sh = {
        k: _ns(mesh, eax) if k.startswith("edge_") else _ns(mesh)
        for k in batch_abs
    }
    # every rank runs the whole loss over its own edges (the aggregates are
    # summed over the ranks), so each holds the whole grads: no reduction
    step = train_loop.make_train_step(
        loss_fn, train_loop.TrainStepConfig(n_micro=1)
    )
    return Cell(
        fn=step,
        args=((params_abs, opt_abs), batch_abs),
        in_shardings=((rep, opt_rep), batch_sh),
        out_shardings=((rep, opt_rep), None),
        donate=(0,),
        forms=("block", "block"),
    )


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------


def build_recsys_cell(spec: ArchSpec, cell: ShapeCell, mesh: Mesh) -> Cell:
    cfg = spec.config
    bax = _batch_axes(mesh)
    if isinstance(cfg, dlrm_lib.DLRMConfig):
        return _build_dlrm_cell(spec, cell, mesh, bax)
    return _build_seqrec_cell(spec, cell, mesh, bax)


def _dlrm_shardings(cfg, mesh, zero1: bool):
    rules = shlib.RECSYS_RULES
    logical = dlrm_lib.param_logical(cfg)
    params_abs = dlrm_lib.abstract_params(cfg)
    opt_abs = optim.abstract_state(params_abs)
    param_sh, opt_sh = train_loop.state_shardings(
        logical, rules, mesh, zero1=zero1, params_abs=params_abs
    )
    return params_abs, opt_abs, param_sh, opt_sh


def _sharded_forward(cfg, mesh):
    """DLRM forward on this rank's rows, the mega-table lookup over the
    'model' shards (``embedding.lookup_sharded``)."""

    def forward(params, dense, sparse_ids):
        cd = cfg.compute_dtype
        bot = dlrm_lib._mlp_fwd(
            params["bot"], dense.to(cd), len(cfg.bot_mlp) - 1, True
        )
        sparse = emb_lib.lookup_sharded(
            params["table"], sparse_ids, cfg.table, mesh.fabric("model"),
        )
        inter = dlrm_lib._interact(bot, sparse.to(cd))
        top_in = torch.cat([bot, inter], dim=-1)
        logits = dlrm_lib._mlp_fwd(
            params["top"], top_in, len(cfg.top_mlp), False
        )
        return logits[:, 0].float()

    return forward


def _merge_topk(vals: torch.Tensor, ids: torch.Tensor, mesh: Mesh, axes,
                k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top ``k`` from each rank's top ``k`` of its block of a
    score vector (blocks in rank order along ``axes``): ``lax.top_k`` of
    the whole vector, ties to the lower index."""
    if not axes or mesh.axis_size(axes) == 1:
        return vals, ids
    fab = mesh.fabric(axes)
    all_v = fab.all_gather(vals[None].contiguous()).reshape(1, -1)
    all_i = fab.all_gather(ids[None].contiguous()).reshape(-1)
    top, at = counter.topk_total(all_v, k)
    return top[0], all_i[at[0].long()]


def _build_dlrm_cell(spec: ArchSpec, cell: ShapeCell, mesh: Mesh, bax) -> Cell:
    cfg: dlrm_lib.DLRMConfig = spec.config
    fwd = _sharded_forward(cfg, mesh)
    d_axes = data_axes(mesh)

    if cell.kind == "train":
        batch = cell.params["batch"]
        # hybrid optimizer (the recsys production shape): the mega-table
        # trains with rowwise AdaGrad (one f32 scalar per row), the dense
        # MLPs with AdamW + ZeRO-1
        params_abs = dlrm_lib.abstract_params(cfg)
        dense_abs = {k: v for k, v in params_abs.items() if k != "table"}
        opt_abs = optim.abstract_state(dense_abs)
        accum_abs = SDS((cfg.table.total_rows,), torch.float32)
        logical = dlrm_lib.param_logical(cfg)
        rules = shlib.RECSYS_RULES
        param_sh, _ = train_loop.state_shardings(
            logical, rules, mesh, zero1=False, params_abs=params_abs
        )
        dense_logical = {k: v for k, v in logical.items() if k != "table"}
        dense_sh, dense_opt_sh = train_loop.state_shardings(
            dense_logical, rules, mesh, zero1=True, params_abs=dense_abs
        )
        accum_sh = _ns(mesh, "model")
        batch_abs = {
            "dense": SDS((batch, cfg.n_dense), torch.float32),
            "sparse": SDS((batch, cfg.n_sparse), torch.int32),
            "labels": SDS((batch,), torch.float32),
        }
        batch_sh = {
            "dense": _ns(mesh, bax, None),
            "sparse": _ns(mesh, bax, None),
            "labels": _ns(mesh, bax),
        }
        adamw = optim.AdamWConfig()

        def step(state, b):
            return _dlrm_train_step(state, b, fwd, mesh, d_axes, batch, adamw,
                                    dense_sh, dense_opt_sh)

        return Cell(
            fn=step,
            args=((params_abs, opt_abs, accum_abs), batch_abs),
            in_shardings=((param_sh, dense_opt_sh, accum_sh), batch_sh),
            out_shardings=((param_sh, dense_opt_sh, accum_sh), None),
            donate=(0,),
            forms=("block", "block"),
        )

    if cell.kind == "serve":
        batch = cell.params["batch"]
        params_abs, _, param_sh, _ = _dlrm_shardings(cfg, mesh, zero1=False)
        args = (
            params_abs,
            SDS((batch, cfg.n_dense), torch.float32),
            SDS((batch, cfg.n_sparse), torch.int32),
        )

        def serve(params, dense, sparse_ids):
            with torch.no_grad():
                return fwd(params, dense, sparse_ids)

        return Cell(
            fn=serve,
            args=args,
            in_shardings=(
                param_sh, _ns(mesh, bax, None), _ns(mesh, bax, None)
            ),
            out_shardings=_ns(mesh, bax),
            forms=("block", "block", "block"),
        )

    if cell.kind == "retrieval":
        n_cand = cell.params["n_candidates"]
        params_abs, _, param_sh, _ = _dlrm_shardings(cfg, mesh, zero1=False)

        def retrieval(params, dense, sparse_ids, candidates):
            with torch.no_grad():
                n = candidates.shape[0]
                dense_b = dense[None, :].expand(n, cfg.n_dense)
                ids_b = sparse_ids[None, :].expand(n, cfg.n_sparse).clone()
                ids_b[:, 0] = candidates
                scores = fwd(params, dense_b, ids_b)
                vals, idx = counter.topk_total(scores[None], 100)
                return _merge_topk(vals[0], candidates[idx[0].long()], mesh, d_axes, 100)

        args = (
            params_abs,
            SDS((cfg.n_dense,), torch.float32),
            SDS((cfg.n_sparse,), torch.int32),
            SDS((n_cand,), torch.int32),
        )
        return Cell(
            fn=retrieval,
            args=args,
            in_shardings=(param_sh, _ns(mesh), _ns(mesh), _ns(mesh, bax)),
            out_shardings=(_ns(mesh), _ns(mesh)),
            forms=("block", "block", "block", "block"),
        )

    raise ValueError(cell.kind)


def _dlrm_train_step(state, b, fwd, mesh, d_axes, global_batch, adamw,
                     dense_sh, dense_opt_sh):
    """One rank's hybrid DLRM step: the BCE over this rank's rows as its
    share of the global mean; the grads (the table block's too: it is
    replicated over the data axes) all-reduced over the data axes; the
    table block by rowwise AdaGrad; the MLPs by AdamW, each rank updating
    its ZeRO-1 block and all-gathering it over 'data'."""
    params, opt, accum = state
    reduce = mesh.fabric(d_axes) if d_axes else None
    zero = mesh.fabric("data") if "data" in mesh.axis_names else None
    flat = [x.detach().requires_grad_(True) for x in tree_lib.leaves(params)]
    p = tree_lib.unflatten(params, flat)
    logits = fwd(p, b["dense"], b["sparse"])
    y = b["labels"]
    per_row = (torch.clamp(logits, min=0) - logits * y
               + torch.log1p(torch.exp(-torch.abs(logits))))
    loss = per_row.sum() / torch.tensor(float(global_batch), device=logits.device)
    grads = torch.autograd.grad(loss, flat)
    with torch.no_grad():
        if reduce is not None:
            loss = reduce.psum(loss.reshape(1)).reshape(())
            grads = [reduce.psum(g[None].contiguous()) for g in grads]
        g_tree = tree_lib.unflatten(params, list(grads))
        table, new_accum = optim.rowwise_adagrad_update(
            params["table"], g_tree["table"], accum, lr=0.01)
        params["table"].copy_(table)
        accum.copy_(new_accum)
        dense_g = {k: v for k, v in g_tree.items() if k != "table"}
        dense_p = {k: v for k, v in params.items() if k != "table"}
        dense_g, hyper = optim.prepare_step(dense_g, opt.step, adamw)
        o_sh = tree_lib.leaves(dense_opt_sh.m)
        p_specs = [s.spec for s in tree_lib.leaves(dense_sh)]
        for i, (pl, m, v, g) in enumerate(zip(
                tree_lib.leaves(dense_p), tree_lib.leaves(opt.m),
                tree_lib.leaves(opt.v), tree_lib.leaves(dense_g))):
            blk = o_sh[i].block(pl.shape)
            region = pl[blk]
            optim.adamw_leaf(region, m, v, g[blk], hyper, adamw)
            train_loop._write_back(pl, region, p_specs[i], o_sh[i].spec, zero)
    metrics = {"grad_norm": hyper["grad_norm"], "lr": hyper["lr"], "loss": loss}
    return (params, opt, accum), metrics


def _build_seqrec_cell(spec: ArchSpec, cell: ShapeCell, mesh: Mesh, bax) -> Cell:
    cfg: sr.SeqRecConfig = spec.config
    # item tables at 10M x 50 fit per-chip: replicate (rows -> None);
    # ZeRO-1 shards the optimizer moments over 'data'.
    rules = shlib.RECSYS_RULES.with_overrides(rows=None)
    logical = sr.param_logical(cfg)
    params_abs = sr.abstract_params(cfg)
    opt_abs = optim.abstract_state(params_abs)
    param_sh, opt_sh = train_loop.state_shardings(
        logical, rules, mesh, zero1=True, params_abs=params_abs
    )
    d_axes = data_axes(mesh)

    if cell.kind == "train":
        batch = cell.params["batch"]
        if cfg.kind == "sasrec":
            batch_abs = {
                "seq": SDS((batch, cfg.seq_len), torch.int32),
                "targets": SDS((batch, cfg.seq_len), torch.int32),
                "negatives": SDS(
                    (batch, cfg.seq_len, cfg.n_negatives), torch.int32
                ),
            }
            batch_sh = {
                "seq": _ns(mesh, bax, None),
                "targets": _ns(mesh, bax, None),
                "negatives": _ns(mesh, bax, None, None),
            }

            def loss_fn(p, b):
                # this rank's share: its masked sum over the global count
                mean = sr.sasrec_loss(p, b["seq"], b["targets"], b["negatives"], cfg)
                count = (b["targets"] >= 0).float().sum().reshape(1)
                total = mesh.fabric(d_axes).psum(count[None]) if d_axes else count
                return mean * torch.clamp(count, min=1.0)[0] / torch.clamp(
                    total.reshape(()), min=1.0)
        else:
            batch_abs = {
                "seq": SDS((batch, cfg.seq_len), torch.int32),
                "candidate": SDS((batch,), torch.int32),
                "labels": SDS((batch,), torch.float32),
            }
            batch_sh = {
                "seq": _ns(mesh, bax, None),
                "candidate": _ns(mesh, bax),
                "labels": _ns(mesh, bax),
            }
            n_data = mesh.axis_size(d_axes) if d_axes else 1

            def loss_fn(p, b):
                # equal rows a rank: the global mean is the ranks' mean
                return sr.bst_loss(p, b["seq"], b["candidate"], b["labels"], cfg) / (
                    torch.tensor(float(n_data), device=b["labels"].device))

        step = train_loop.make_train_step(
            loss_fn, train_loop.TrainStepConfig(n_micro=1)
        )

        def train(state, b):
            return train_loop.jit_train_step(step, param_sh, opt_sh, batch_sh)(state, b)

        return Cell(
            fn=train,
            args=((params_abs, opt_abs), batch_abs),
            in_shardings=((param_sh, opt_sh), batch_sh),
            out_shardings=((param_sh, opt_sh), None),
            donate=(0,),
            forms=("dtensor", "whole"),
        )

    if cell.kind == "serve":
        batch = cell.params["batch"]
        if cfg.kind == "sasrec":
            def serve(p, seq):
                with torch.no_grad():
                    return sr.sasrec_user_state(p, seq, cfg)

            args = (params_abs, SDS((batch, cfg.seq_len), torch.int32))
            return Cell(
                fn=serve,
                args=args,
                in_shardings=(param_sh, _ns(mesh, bax, None)),
                out_shardings=_ns(mesh, bax, None),
                forms=("block", "block"),
            )

        def serve(p, seq, cand):
            with torch.no_grad():
                return sr.bst_forward(p, seq, cand, cfg)

        args = (
            params_abs,
            SDS((batch, cfg.seq_len), torch.int32),
            SDS((batch,), torch.int32),
        )
        return Cell(
            fn=serve,
            args=args,
            in_shardings=(
                param_sh, _ns(mesh, bax, None), _ns(mesh, bax)
            ),
            out_shardings=_ns(mesh, bax),
            forms=("block", "block", "block"),
        )

    if cell.kind == "retrieval":
        n_cand = cell.params["n_candidates"]
        call_ax = _all_axes(mesh)
        cax = call_ax if len(call_ax) > 1 else call_ax[0]
        n_dev = mesh.axis_size(call_ax)
        n_cand = -(-n_cand // n_dev) * n_dev  # pad to shard evenly

        if cfg.kind == "sasrec":
            def retrieval(p, seq, candidates):
                with torch.no_grad():
                    state = sr.sasrec_user_state(p, seq, cfg)
                    vals, ids = sr.score_candidates(p, state, candidates, cfg, top_k=100)
                    vals, ids = _merge_topk(vals[0], ids[0], mesh, call_ax, 100)
                    return vals[None], ids[None]        # (1, 100), the reference's

            args = (
                params_abs,
                SDS((1, cfg.seq_len), torch.int32),
                SDS((n_cand,), torch.int32),
            )
        else:
            # BST retrieval: score the candidates through the CTR head
            def retrieval(p, seq, candidates):
                with torch.no_grad():
                    n = candidates.shape[0]
                    seq_b = seq[None, :].expand(n, cfg.seq_len)
                    scores = sr.bst_forward(p, seq_b, candidates, cfg)
                    vals, idx = counter.topk_total(scores[None], 100)
                    return _merge_topk(vals[0], candidates[idx[0].long()], mesh,
                                       call_ax, 100)

            args = (
                params_abs,
                SDS((cfg.seq_len,), torch.int32),
                SDS((n_cand,), torch.int32),
            )
        return Cell(
            fn=retrieval,
            args=args,
            in_shardings=(param_sh, _ns(mesh), _ns(mesh, cax)),
            out_shardings=(_ns(mesh), _ns(mesh)),
            forms=("block", "block", "block"),
        )

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# Pixie cells (the paper's own architecture)
# ---------------------------------------------------------------------------


def build_pixie_cell(spec: ArchSpec, cell: ShapeCell, mesh: Mesh, dry: bool = False) -> Cell:
    cfg = spec.config
    p = cell.params
    n_slots = cfg.n_slots

    if cell.kind == "pixie_sharded":
        n_shards = mesh.shape["model"]
        graph_abs = pixie_dist.abstract_sharded_graph(
            p["n_pins"], p["n_boards"], p["n_edges"], n_shards
        )
        gspec = pixie_dist.sharded_graph_specs("model")
        graph_sh = [NamedSharding(mesh, s) for s in gspec[:4]]

        def serve(g_off, g_tgt, b_off, b_tgt, qp, qw, key):
            graph = pixie_dist.ShardedGraph(
                g_off, g_tgt, b_off, b_tgt,
                graph_abs.n_pins, graph_abs.n_boards, n_shards,
            )
            with torch.no_grad():
                res = pixie_dist.pixie_walk_sharded(
                    graph, qp, qw, key, cfg.sharded_walk, mesh.fabric("model")
                )
            return res.top_scores, res.top_pins, res.dropped

        args = (
            graph_abs.p2b_offsets, graph_abs.p2b_targets,
            graph_abs.b2p_offsets, graph_abs.b2p_targets,
            SDS((n_slots,), torch.int32),
            SDS((n_slots,), torch.float32),
            SDS((2,), torch.int64),
        )
        return Cell(
            fn=serve,
            args=args,
            in_shardings=tuple(graph_sh) + (_ns(mesh), _ns(mesh), _ns(mesh)),
            out_shardings=(_ns(mesh), _ns(mesh), _ns(mesh)),
            forms=("block",) * 7,
        )

    if cell.kind == "pixie_replicated":
        # graph replicated on every chip; the query batch is sharded over
        # the whole mesh (each chip is one serving replica — the fleet)
        n_slots = cell.params.get("n_slots", n_slots)
        graph_abs = graph_abstract(
            p["n_pins"], p["n_boards"], p["n_edges"], offset_dtype=torch.int32,
        )
        wcfg = dataclasses.replace(cfg.walk, count_boards=False)
        all_ax = _all_axes(mesh)
        qbatch = mesh.axis_size(all_ax)  # one query per replica
        aax = all_ax if len(all_ax) > 1 else all_ax[0]

        def serve(p2b_off, p2b_tgt, b2p_off, b2p_tgt, qp, qw, feats, key):
            graph = PinBoardGraph(
                p2b=CSR(p2b_off, p2b_tgt), b2p=CSR(b2p_off, b2p_tgt),
                n_pins=p["n_pins"], n_boards=p["n_boards"], max_pin_degree=4096,
            )
            # this rank's query and its key of the batch's split
            k_i = prng.split(key, qbatch)[mesh.coordinate(all_ax)]
            with torch.no_grad():
                if dry:
                    res = walk_lib.pixie_walk_events_fixed(
                        graph, qp[0], qw[0], feats[0], k_i, wcfg,
                        n_chunks=wcfg.max_chunks())
                else:
                    res = walk_lib.pixie_walk_events(graph, qp[0], qw[0], feats[0], k_i, wcfg)
                scores, ids = walk_lib.recommend_from_events(
                    res, n_slots, p["n_pins"], qp[0], wcfg.top_k)
            return scores[None], ids[None]

        args = (
            graph_abs.p2b.offsets, graph_abs.p2b.targets,
            graph_abs.b2p.offsets, graph_abs.b2p.targets,
            SDS((qbatch, n_slots), torch.int32),
            SDS((qbatch, n_slots), torch.float32),
            SDS((qbatch,), torch.int32),
            SDS((2,), torch.int64),
        )
        return Cell(
            fn=serve,
            args=args,
            in_shardings=(
                _ns(mesh), _ns(mesh), _ns(mesh), _ns(mesh),
                _ns(mesh, aax, None), _ns(mesh, aax, None),
                _ns(mesh, aax), _ns(mesh),
            ),
            out_shardings=(_ns(mesh, aax, None), _ns(mesh, aax, None)),
            forms=("block",) * 8,
            form="fixed" if dry else "real",
        )

    raise ValueError(cell.kind)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def build_cell(spec: ArchSpec, cell: ShapeCell, mesh: Mesh, *, dry: bool = False,
               **kw) -> Cell:
    """The cell's ``Cell``; ``dry`` builds the dry run's form (a
    data-dependent loop at its static bound: the module docstring)."""
    if spec.family == "lm":
        return build_lm_cell(spec, cell, mesh, **kw)
    if spec.family == "gnn":
        return build_gnn_cell(spec, cell, mesh)
    if spec.family == "recsys":
        return build_recsys_cell(spec, cell, mesh)
    if spec.family == "pixie":
        return build_pixie_cell(spec, cell, mesh, dry=dry)
    raise ValueError(spec.family)


def axis_groups(mesh: Mesh) -> Dict[str, str]:
    """Every non-empty set of ``mesh``'s axes (in mesh order) made into its
    fabric, and each fabric's process group named by its axes joined with
    '+': the tally's labels.  Run before any fake tensor exists (a
    ``DeviceMesh`` cannot flatten under ``FakeTensorMode``)."""
    out = {}
    names = mesh.axis_names
    for r in range(1, len(names) + 1):
        for combo in itertools.combinations(names, r):
            fab = mesh.fabric(combo)
            out[fab.group.group_name] = "+".join(combo)
    if mesh.device_mesh is not None:
        for a in names:
            out[mesh.device_mesh.get_group(a).group_name] = a
    return out
