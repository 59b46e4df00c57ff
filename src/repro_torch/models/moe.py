"""Mixture-of-Experts FFN with sort-based capacity dispatch.

Twin of ``repro/models/moe.py``: the DeepSeekMoE / granite shape, optional
shared experts that see every token plus ``E`` routed experts with top-k
gating, dispatched in the "dropping" formulation:

  1. top-k routing per token, the gates renormalised over the selected k;
  2. the (token, expert) assignments sorted by expert id (stably), each
     given its position within its expert;
  3. assignments past the per-expert capacity ``C`` dropped (their gate
     mass is lost, as in GShard / Switch);
  4. kept tokens placed in an ``(E, C, d)`` buffer, the experts run as
     batched products, the results added back per token.

The same ``MoEConfig`` (``pad_experts_to`` and ``ep_shard_map`` carried:
without a mesh the reference ignores ``ep_shard_map``, and so does the
port; with one, ``transformer`` takes ``moe_ffn_sharded``), the same parameter tree and the same float order where it shows:

  * the router runs in float32 whatever the compute dtype; pad experts'
    logits are ``-1e30``; the top-k is ``lax.top_k``'s, ties to the lower
    index, in its IEEE total order (``counter.topk_total``): a token whose
    router row is NaN is served, NaN in its own output row only, and the
    aux loss NaN, as in the reference;
  * the buffer is built by adding into zeros, as ``.at[dest].add`` does
    (``0 + -0.0`` is ``+0.0``); the dropped rows land in a drop slot past
    the end that is then cut off;
  * the expert products take the compute dtype in and give float32 out
    (``preferred_element_type=float32``): ``torch.bmm(..., out_dtype=
    float32)`` on the card; torch (2.13) has no CPU kernel for that
    overload, so on the CPU the inputs are upcast first (exact products,
    another summation order).  That overload has no autograd formula, so
    under autograd on the card ``_MixedBmm`` gives it one: the gradients
    are float32 products rounded to the inputs' dtype.  Pad experts'
    products are computed as the reference computes them;
  * the combine adds each token's ``k`` contributions in ascending expert
    order, one add at a time in the compute dtype: the order of the
    reference's sorted ``.at[st].add``, and deterministic on the card
    (``index_add_`` there adds with atomics, in another order each run);
  * the shared experts are added after the routed output;
  * the dispatch and combine gathers (``x[st]``, ``y_flat[dest]``) go
    through ``embedding.gather_rows``, whose backward adds a token's k
    gradient rows in the same order every run, on either device.

``init_moe_params`` draws from an explicit ``torch.Generator`` through
``layers.dense_init`` with the reference's fan-in rule: an ``(E, d, ff)``
expert tensor has fan-in ``E``, so its standard deviation is ``E**-0.5``.
That quirk is the reference's and is kept.

``moe_ffn_sharded`` is the expert-parallel form over a
``launch.mesh.Mesh``: each 'model' shard keeps its own experts'
assignments of the routing every shard computes alike, and one sum of
the ``(t_local, d)`` partial outputs over 'model' combines them (see the
section below).  ``moe_ffn_global`` is ``moe_ffn`` over the tokens of
several data ranks, the reference's GSPMD semantics without
``ep_shard_map``: one capacity and one expert order for the global batch,
each rank's positions offset by the lower ranks' counts (exchanged, not
the tokens), and the aux from the global means (the last section).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import counter
from repro_torch.core.distributed import copy_to, reduce_from
from repro_torch.device import on_card
from repro_torch.models import layers
from repro_torch.models.embedding import gather_rows


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared experts (DeepSeekMoE)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01   # load-balance aux loss (Switch)
    # physical expert padding (granite: 40 -> 48); pad experts' router
    # logits are masked, so they receive no tokens
    pad_experts_to: Optional[int] = None
    # expert-parallel dispatch (moe_ffn_sharded) when a mesh is given
    ep_shard_map: bool = False

    @property
    def n_experts_padded(self) -> int:
        return self.pad_experts_to or self.n_experts

    def capacity(self, n_tokens: int) -> int:
        c = int(n_tokens * self.top_k * self.capacity_factor / self.n_experts)
        return max(8, -(-c // 8) * 8)  # pad to 8 for clean tiling


def init_moe_params(gen: torch.Generator, d_model: int,
                    cfg: MoEConfig) -> Dict[str, torch.Tensor]:
    """One layer's MoE parameters, float32, on the generator's device."""
    dev = gen.device
    ep = cfg.n_experts_padded
    p = {
        "router": layers.dense_init(gen, (d_model, ep), device=dev),
        "w_gate": layers.dense_init(gen, (ep, d_model, cfg.d_ff_expert), device=dev),
        "w_up": layers.dense_init(gen, (ep, d_model, cfg.d_ff_expert), device=dev),
        "w_down": layers.dense_init(gen, (ep, cfg.d_ff_expert, d_model), device=dev),
    }
    if cfg.n_shared > 0:
        ff_sh = cfg.n_shared * cfg.d_ff_expert
        p["shared_gate"] = layers.dense_init(gen, (d_model, ff_sh), device=dev)
        p["shared_up"] = layers.dense_init(gen, (d_model, ff_sh), device=dev)
        p["shared_down"] = layers.dense_init(gen, (ff_sh, d_model), device=dev)
    return p


def moe_param_specs(cfg: MoEConfig) -> Dict[str, Tuple]:
    """Logical axis names per parameter (leading 'layers' added by the LM)."""
    p = {
        "router": ("embed", "experts"),
        "w_gate": ("experts", "embed", "expert_mlp"),
        "w_up": ("experts", "embed", "expert_mlp"),
        "w_down": ("experts", "expert_mlp", "embed"),
    }
    if cfg.n_shared > 0:
        p["shared_gate"] = ("embed", "mlp")
        p["shared_up"] = ("embed", "mlp")
        p["shared_down"] = ("mlp", "embed")
    return p


class _MixedBmm(torch.autograd.Function):
    """``bmm(a, b, out_dtype=float32)``, which has no autograd formula in
    torch: the forward on the tensor cores with float32 accumulation; the
    backward takes the float32 output gradient times the other operand in
    float32 and rounds each input's gradient to its dtype, as the
    reference's transposed ``dot_general`` returns the operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = torch.bmm(g, b.float().transpose(1, 2)).to(a.dtype)
        gb = torch.bmm(a.float().transpose(1, 2), g).to(b.dtype)
        return ga, gb


def expert_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum("ecd,edf->ecf", a, b, preferred_element_type=float32)``:
    the inputs' dtype in, float32 out."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if on_card(a):
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _MixedBmm.apply(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """Router probabilities over the real experts ``(t, E)`` (float32),
    the renormalised top-k gates and the selected expert ids (int32)."""
    return route_logits(x.float() @ router.float(), cfg)


def route_logits(logits: torch.Tensor, cfg: MoEConfig):
    """``route`` from the router's float32 logits ``(t, e_pad)`` (a
    tensor-parallel step gathers them from the router's blocks)."""
    e, e_pad = cfg.n_experts, cfg.n_experts_padded
    if e_pad != e:  # mask pad experts: no tokens
        pad = torch.arange(e_pad, device=logits.device) >= e
        logits = logits.masked_fill(pad, layers.NEG_INF)
    probs = torch.softmax(logits, dim=-1)[:, :e]
    gate, sel = counter.topk_total(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, sel


def expert_segments(sel: torch.Tensor, cfg: MoEConfig):
    """The ``t * k`` assignments sorted by expert id (stably): ``(order,
    se, seg_start)``, ``se`` the sorted expert ids and ``seg_start`` the
    first index of each expert's segment (``se`` is sorted: no bincount,
    whose output size would read the card).  An expert's count is the
    next segment's start less its own."""
    flat_expert = sel.reshape(-1).long()
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    seg_start = torch.searchsorted(se, torch.arange(cfg.n_experts_padded, device=se.device))
    return order, se, seg_start


def dispatch(sel: torch.Tensor, t: int, cfg: MoEConfig, start: Optional[torch.Tensor] = None,
             cap: Optional[int] = None, segments=None):
    """The sort-based dispatch plan: ``(order, dest, keep)`` over the
    ``t * k`` assignments in expert order, and the buffer's rows an
    expert.  ``dest`` is each assignment's row of the ``(e_pad * rows +
    1)`` buffer, the last row the drop slot.

    Alone (no ``start``) the tokens are the whole batch: an assignment's
    position is its place in its expert's segment, cut at
    ``cfg.capacity(t)``, which is also the rows an expert.  With
    ``start`` (``(e_pad,)``: each expert's assignments on the lower data
    ranks) and ``cap`` (the global batch's capacity) its global position
    is that place plus ``start``, cut at ``cap``; the buffer holds this
    rank's assignments only, each at its place in the segment, in
    ``min(cap, t)`` rows an expert (a rank holds at most ``t`` of an
    expert's, and keeps fewer than ``cap``).  ``segments`` is
    ``expert_segments(sel, cfg)`` where the caller has it."""
    k, e_pad = cfg.top_k, cfg.n_experts_padded
    order, se, seg_start = segments if segments is not None else expert_segments(sel, cfg)
    pos = torch.arange(t * k, device=se.device) - seg_start[se]
    if start is None:
        rows = cfg.capacity(t)
        keep = pos < rows
    else:
        rows = min(cap, t)
        keep = pos + start[se] < cap
    dest = torch.where(keep, se * rows + pos, e_pad * rows)
    return order, dest, keep, rows


def load_balance_aux(probs: torch.Tensor, sel: torch.Tensor,
                     cfg: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance loss of ``t`` routed tokens."""
    t, e = probs.shape
    dev = probs.device
    density = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, sel[:, 0].long(), torch.ones(t, dtype=torch.float32, device=dev)) / t
    density_proxy = probs.mean(dim=0)
    return cfg.router_aux_weight * e * torch.sum(density * density_proxy)


def token_order(order: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """``(t, k)``: each token's k assignments by their place in the sorted
    order, which is ascending expert id: the reference's scatter adds a
    token's contributions in that order."""
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=order.device)
    return torch.sort(rank.reshape(t, k), dim=1).values


def expert_contrib(x: torch.Tensor, st: torch.Tensor, dest: torch.Tensor,
                   keep: torch.Tensor, sg: torch.Tensor, w: Dict[str, torch.Tensor],
                   cap: int) -> torch.Tensor:
    """The experts' half of the FFN over the assignments in sorted order:
    token ``st``, buffer row ``dest``, kept or not, gate ``sg``.  The
    ``(n_e * cap + 1, d)`` buffer is built by adding each kept token row at
    its ``dest`` (each kept row's dest is its own, so each takes one add;
    the drop slot, the last row, takes every dropped row and is cut off),
    the ``n_e`` experts of ``w`` run as three batched products, and each
    assignment's output row is read back times its gate (zero where
    dropped).  Returns ``(t * k, d)`` contributions."""
    d, cd = x.shape[1], x.dtype
    n_e = w["w_gate"].shape[0]
    buf = torch.zeros((n_e * cap + 1, d), dtype=cd, device=x.device)
    buf.index_add_(0, dest, gather_rows(x, st) * keep[:, None].to(cd))
    buf = buf[:-1].reshape(n_e, cap, d)
    g = expert_matmul(buf, w["w_gate"].to(cd))
    u = expert_matmul(buf, w["w_up"].to(cd))
    h = layers.swiglu(g, u).to(cd)
    y = expert_matmul(h, w["w_down"].to(cd)).to(cd)       # (n_e, cap, d)
    y_flat = torch.cat([y.reshape(n_e * cap, d), y.new_zeros((1, d))])
    return gather_rows(y_flat, dest) * (sg * keep.float())[:, None].to(cd)


def moe_ffn(
    x: torch.Tensor,                 # (t, d) flattened tokens
    params: Dict[str, torch.Tensor],
    cfg: MoEConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (t, d), aux_loss scalar)."""
    t, d = x.shape
    k = cfg.top_k
    cd = x.dtype
    dev = x.device

    # ---- routing ----------------------------------------------------------
    probs, gate, sel = route(x, params["router"], cfg)
    aux = load_balance_aux(probs, sel, cfg)

    # ---- sort-based dispatch, batched expert FFN ----------------------------
    order, dest, keep, cap = dispatch(sel, t, cfg)
    contrib = expert_contrib(x, order // k, dest, keep, gate.reshape(-1)[order],
                             params, cap)

    # ---- combine ------------------------------------------------------------
    rank = token_order(order, t, k)
    out = torch.zeros((t, d), dtype=cd, device=dev)
    for j in range(k):
        out = out + contrib[rank[:, j]]

    # ---- shared experts ------------------------------------------------------
    if cfg.n_shared > 0:
        gs = x @ params["shared_gate"].to(cd)
        us = x @ params["shared_up"].to(cd)
        out = out + layers.swiglu(gs, us) @ params["shared_down"].to(cd)

    return out, aux


# ---------------------------------------------------------------------------
# Expert-parallel dispatch over a mesh
#
# The tokens are sharded over the data axes and replicated over 'model', so
# expert parallelism moves no token: each model shard routes its local
# tokens, keeps the assignments to its own experts, runs them, and one sum
# of the (t_local, d) partial outputs over 'model' combines the shards.
# ---------------------------------------------------------------------------


def _expert_slice(w: torch.Tensor, shard_ids: torch.Tensor, e_loc: int) -> torch.Tensor:
    """The local shards' experts of ``w``: ``w`` itself when it holds just
    theirs (a tensor-parallel rank's block, or every expert on a local
    mesh), else their rows of every expert's weights."""
    if shard_ids.numel() * e_loc == w.shape[0]:      # the local experts only
        return w
    return w.unflatten(0, (-1, e_loc))[shard_ids.long()].flatten(0, 1)


def ep_partials(x: torch.Tensor, params: Dict[str, torch.Tensor], cfg: MoEConfig,
                shard_ids: torch.Tensor, e_loc: int, fabric=None,
                logits: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One data shard's tokens ``x`` (t_loc, d) through the model shards
    ``shard_ids`` (the local ones: every shard on a local mesh, this rank's
    on a process group), each owning experts ``[m * e_loc, (m + 1) *
    e_loc)``.  Returns the partial outputs ``(S_local, t_loc, d)``, to be
    summed over 'model', and the shard's aux loss.

    Each shard sees the full routing: the capacity is ``cfg.capacity(t_loc)``
    and an assignment's position counts every expert's, as the reference's
    ``local_fn`` counts; a shard keeps its own experts' assignments
    (``shard_partials``).

    The expert leaves hold every expert or just the local shards' (a
    tensor-parallel rank's block); ``logits`` (the router's, float32, over
    every expert) stand in for ``x @ params["router"]`` where the router is
    split over the shards and its logits were gathered.

    ``fabric`` (the 'model' group of a process-group mesh) makes the gates
    the experts read ``copy_to`` it: under autograd each rank's part of
    their gradient, from its own experts, is all-reduced over the group,
    so the router sees the whole.  The tokens ``x`` are the caller's to put
    under ``copy_to``: with ``logits`` they are read in part by the router's
    block too (and by the shared experts), and one all-reduce sums all of
    it."""
    if logits is None:
        logits = x.float() @ params["router"].float()
    probs, gate, sel = route_logits(logits, cfg)
    plan = dispatch(sel, x.shape[0], cfg)
    return (shard_partials(x, gate, sel, params, cfg, shard_ids, e_loc, plan, fabric),
            load_balance_aux(probs, sel, cfg))


def shard_partials(x: torch.Tensor, gate: torch.Tensor, sel: torch.Tensor,
                   params: Dict[str, torch.Tensor], cfg: MoEConfig, shard_ids: torch.Tensor,
                   e_loc: int, plan, fabric=None) -> torch.Tensor:
    """The experts' half of ``ep_partials`` for routed tokens (``gate``,
    ``sel``) and a ``dispatch`` plan: each local model shard's partial
    outputs ``(S_local, t, d)``.  A shard keeps its own experts'
    assignments of the plan; its partial adds each token's k assignments
    in ascending expert id, the others' as ``0 * (gate * 0)`` (zero, or
    NaN for a NaN gate), as the reference adds them from its drop slot."""
    t, d = x.shape
    k = cfg.top_k
    cd, dev = x.dtype, x.device
    s_l = shard_ids.numel()
    if fabric is not None:
        gate = copy_to(fabric, gate)
    order, dest_g, keep, cap = plan
    st = order // k
    sg = gate.reshape(-1)[order]
    owner = sel.reshape(-1).long()[order] // e_loc            # (t * k,)
    match = owner[None, :] == shard_ids.long()[:, None]      # (S_l, t * k)
    mine = match.any(0)
    sidx = match.int().argmax(0)
    kept = keep & mine
    # the global buffer row moved to the local shard's block (the same row
    # on a local mesh, where the local shards are all of them)
    block = e_loc * cap
    dest = torch.where(kept, dest_g + (sidx - owner) * block, s_l * block)
    w = {n: _expert_slice(params[n], shard_ids, e_loc)
         for n in ("w_gate", "w_up", "w_down")}
    contrib = expert_contrib(x, st, dest, kept, sg, w, cap)
    # another shard's assignment: its drop slot's zero row times (gate * 0)
    other = ((sg * 0.0)[:, None].to(cd) * torch.zeros((), dtype=cd, device=dev))
    own = torch.where(mine, sidx, -1)
    shard = torch.arange(s_l, device=dev)[:, None]
    rank = token_order(order, t, k)
    partial = torch.zeros((s_l, t, d), dtype=cd, device=dev)
    for j in range(k):
        a = rank[:, j]
        is_own = (own[a][None, :] == shard)[..., None]        # (S_l, t, 1)
        partial = partial + torch.where(is_own, contrib[a][None], other[a][None])
    return partial


def moe_ffn_sharded(
    x: torch.Tensor,                 # (t, d) tokens
    params: Dict[str, torch.Tensor],
    cfg: MoEConfig,
    mesh,
    model_axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """EP MoE over ``mesh`` (``launch.mesh.Mesh``), experts owned by the
    'model' shards; ``cfg.n_experts_padded`` must divide over them, and
    ``params`` holds every expert (a tensor-parallel step holds only its
    own and calls ``ep_partials`` itself, the router's logits gathered over
    'model': ``transformer._moe_tp``).  Shared experts are not handled here
    (the caller adds them).  Returns ``(out (t, d), aux)``, ``aux`` the
    mean over the data shards.

    On a local mesh ``x`` is every token, split over the data axes in
    blocks of rows (major to minor); the model shards are a leading dim of
    each data block's partials, summed as a chain in shard order.  On a
    process-group mesh ``x`` is this rank's data block and the sum is the
    'model' group's all-reduce.  Autograd runs through both forms: over a
    process group the partials' sum hands its gradient to every rank
    (``reduce_from``), the experts' tokens and gates all-reduce theirs over
    'model' (``copy_to``), and the data ranks' aux mean all-reduces its own,
    so each rank's grads are those of its share of the global loss (the
    form ``train_loop.jit_train_step`` sums over the data axes)."""
    e_pad = cfg.n_experts_padded
    n_model = mesh.shape[model_axis]
    if e_pad % n_model:
        raise ValueError(f"{e_pad} experts do not divide over {n_model} model shards")
    e_loc = e_pad // n_model
    d_axes = tuple(a for a in mesh.axis_names if a != model_axis)
    n_data = mesh.axis_size(d_axes)
    model = mesh.fabric(model_axis)
    if mesh.kind == "local":
        t = x.shape[0]
        if t % n_data:
            raise ValueError(f"{t} tokens do not split over {n_data} data shards")
        t_loc = t // n_data
        outs, auxes = [], []
        for i in range(n_data):
            partial, aux = ep_partials(x[i * t_loc:(i + 1) * t_loc], params, cfg,
                                       model.shard_ids, e_loc)
            outs.append(model.psum(partial))
            auxes.append(aux)
        out, aux = torch.cat(outs), torch.stack(auxes)
    else:
        # the whole router reads x on every rank; the experts' part of its
        # gradient is each rank's own
        logits = x.float() @ params["router"].float()
        partial, aux = ep_partials(copy_to(model, x), params, cfg, model.shard_ids, e_loc,
                                   fabric=model, logits=logits)
        out, aux = reduce_from(model, partial), aux[None]
    if d_axes:      # pmean: the sum over the data shards over their count
        aux = reduce_from(mesh.fabric(d_axes), aux, grad="psum") / torch.tensor(
            float(n_data), dtype=aux.dtype, device=aux.device)
    else:
        aux = aux[0]
    return out, aux


# ---------------------------------------------------------------------------
# Routing over the global batch across data ranks
#
# Without ep_shard_map the reference's moe_ffn runs under GSPMD on the
# tokens of every data rank: one capacity for the global batch, one stable
# sort of every rank's assignments (rank-major: the flattened (b * s)
# tokens, the batch split over ('pod', 'data')), and the aux loss from the
# global means.  Each rank here routes its own tokens and exchanges only
# each expert's count: an assignment's global position is the lower ranks'
# count of its expert plus its place among the rank's own.
# ---------------------------------------------------------------------------


def moe_ffn_global(
    x: torch.Tensor,                 # (t, d): this rank's tokens, or every block's
    params: Dict[str, torch.Tensor],
    cfg: MoEConfig,
    data,
    shard_ids: Optional[torch.Tensor] = None,
    e_loc: Optional[int] = None,
    model=None,
    logits: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_ffn``'s routed experts over the global batch of the data
    ranks of ``data`` (a fabric over the data axes, ranks in mesh order,
    major to minor).  Returns the partial outputs ``(S_local, t, d)`` of
    the model shards ``shard_ids`` (``ep_partials``' arguments; by default
    one shard holding every expert) and the global aux loss, the same on
    every rank.  Shared experts are the caller's to add.

    A ``ProcessGroupFabric`` makes ``x`` this rank's data block; a
    ``LocalFabric`` makes it every block, split in rows (major to minor)
    and run one block after another, the exchanges over the stacked
    blocks (the router's product is one over every block: a row's logits
    are the whole batch's).  Each block routes its tokens
    (``route_logits`` of the router's logits, or of the gathered
    ``logits``), takes each expert's count among its ``t_loc
    * k`` assignments from its segment starts, and all-gathers the counts
    over ``data``: an assignment's global position is the lower ranks'
    count of its expert plus its place among the block's own, cut at
    ``cfg.capacity(t_loc * n_data)``, and ``dispatch`` sizes the block's
    buffer at ``min(cap, t_loc)`` rows an expert.  The aux is the
    reference's ``w * E * sum(mean(one_hot) * mean(probs))`` over every
    token: each block's one-hot and probability sums, summed over
    ``data`` (the probabilities' sum hands its gradient back summed too:
    ``reduce_from(grad="psum")``), each over the global token count.  No
    gradient reaches the counts or the density.

    ``model`` (the 'model' group of a tensor-parallel rank) puts the gates
    under ``copy_to``, as ``ep_partials`` does."""
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device
    n_loc, n_data = data.shard_ids.numel(), data.n_shards
    t = x.shape[0]
    if t % n_loc:
        raise ValueError(f"{t} tokens do not split over {n_loc} data blocks")
    t_loc = t // n_loc
    cap = cfg.capacity(t_loc * n_data)
    if shard_ids is None:
        shard_ids, e_loc = torch.zeros(1, dtype=torch.int32, device=dev), cfg.n_experts_padded
    if logits is None:      # one product over the local blocks, as ``route`` takes it
        logits = x.float() @ params["router"].float()
    blocks = []
    for j in range(n_loc):
        probs, gate, sel = route_logits(logits[j * t_loc:(j + 1) * t_loc], cfg)
        blocks.append((probs, gate, sel, expert_segments(sel, cfg)))
    end = torch.full((1,), t_loc * k, dtype=torch.long, device=dev)
    counts = torch.stack([torch.diff(seg[2], append=end) for *_, seg in blocks])
    every = data.all_gather(counts)                         # (n_data, e_pad)
    start = (torch.cumsum(every, 0) - every)[data.shard_ids.long()]
    parts = [shard_partials(x[j * t_loc:(j + 1) * t_loc], gate, sel, params, cfg, shard_ids,
                            e_loc, dispatch(sel, t_loc, cfg, start[j], cap, seg), model)
             for j, (_, gate, sel, seg) in enumerate(blocks)]
    ones = torch.ones(t_loc, dtype=torch.float32, device=dev)
    density = data.psum(torch.stack([
        torch.zeros(e, dtype=torch.float32, device=dev).index_add_(0, sel[:, 0].long(), ones)
        for _, _, sel, _ in blocks]))
    proxy = reduce_from(data, torch.stack([probs.sum(0) for probs, *_ in blocks]),
                        grad="psum")
    n_tok = torch.tensor(float(t_loc * n_data), dtype=torch.float32, device=dev)
    aux = cfg.router_aux_weight * e * torch.sum((density / n_tok) * (proxy / n_tok))
    return torch.cat(parts, dim=1), aux


def kept_assignments(sel: torch.Tensor, cfg: MoEConfig, n_blocks: int = 1) -> torch.Tensor:
    """``(t, k)``: which of the tokens' assignments the capacity cut keeps
    when the ``t`` tokens are split into ``n_blocks`` blocks of rows, each
    routed and cut alone at ``cfg.capacity(t / n_blocks)`` (the per-rank
    cut); one block is the global batch's cut.  The tests' and the card's
    witness that the global cut binds where the per-rank cut keeps
    another set."""
    t, k = sel.shape
    t_loc = t // n_blocks
    out = []
    for j in range(n_blocks):
        order, _, keep, _ = dispatch(sel[j * t_loc:(j + 1) * t_loc], t_loc, cfg)
        kept = torch.empty_like(keep)
        kept[order] = keep
        out.append(kept.reshape(t_loc, k))
    return torch.cat(out)
