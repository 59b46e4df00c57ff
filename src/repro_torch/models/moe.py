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
port), the same parameter tree and the same float order where it shows:

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
    another summation order).  Pad experts' products are computed as the
    reference computes them;
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
That quirk is the reference's and is kept.  The expert-parallel
``moe_ffn_sharded`` is not ported (it needs a mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import counter
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
    # expert-parallel dispatch over a mesh; no mesh here, so ignored
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


def expert_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum("ecd,edf->ecf", a, b, preferred_element_type=float32)``:
    the inputs' dtype in, float32 out."""
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def route(x: torch.Tensor, router: torch.Tensor, cfg: MoEConfig):
    """Router probabilities over the real experts ``(t, E)`` (float32),
    the renormalised top-k gates and the selected expert ids (int32)."""
    e, e_pad = cfg.n_experts, cfg.n_experts_padded
    logits = x.float() @ router.float()
    if e_pad != e:  # mask pad experts: no tokens
        pad = torch.arange(e_pad, device=x.device) >= e
        logits = logits.masked_fill(pad, layers.NEG_INF)
    probs = torch.softmax(logits, dim=-1)[:, :e]
    gate, sel = counter.topk_total(probs, cfg.top_k)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return probs, gate, sel


def dispatch(sel: torch.Tensor, t: int, cfg: MoEConfig):
    """The sort-based dispatch plan: ``(order, dest, keep)`` over the
    ``t * k`` assignments in expert order, and ``cap``.  ``dest`` is each
    assignment's row of the ``(e_pad * cap + 1)`` buffer, the last row the
    drop slot."""
    k, e_pad = cfg.top_k, cfg.n_experts_padded
    cap = cfg.capacity(t)
    flat_expert = sel.reshape(-1).long()
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    # the first index of each expert's segment (se is sorted): no bincount,
    # whose output size would read the card
    seg_start = torch.searchsorted(se, torch.arange(e_pad, device=se.device))
    pos = torch.arange(t * k, device=se.device) - seg_start[se]
    keep = pos < cap
    dest = torch.where(keep, se * cap + pos, e_pad * cap)
    return order, dest, keep, cap


def moe_ffn(
    x: torch.Tensor,                 # (t, d) flattened tokens
    params: Dict[str, torch.Tensor],
    cfg: MoEConfig,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (t, d), aux_loss scalar)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    e_pad = cfg.n_experts_padded
    cd = x.dtype
    dev = x.device

    # ---- routing ----------------------------------------------------------
    probs, gate, sel = route(x, params["router"], cfg)
    # Switch-style load-balance aux loss
    density = torch.zeros(e, dtype=torch.float32, device=dev).index_add_(
        0, sel[:, 0].long(), torch.ones(t, dtype=torch.float32, device=dev)) / t
    density_proxy = probs.mean(dim=0)
    aux = cfg.router_aux_weight * e * torch.sum(density * density_proxy)

    # ---- sort-based dispatch ------------------------------------------------
    order, dest, keep, cap = dispatch(sel, t, cfg)
    st = order // k                                    # token of each assignment
    sg = gate.reshape(-1)[order]
    # each kept row's dest is its own, so each takes one add; the drop
    # slot takes every dropped row and is cut off
    buf = torch.zeros((e_pad * cap + 1, d), dtype=cd, device=dev)
    buf.index_add_(0, dest, gather_rows(x, st) * keep[:, None].to(cd))
    buf = buf[:-1].reshape(e_pad, cap, d)

    # ---- batched expert FFN -------------------------------------------------
    g = expert_matmul(buf, params["w_gate"].to(cd))
    u = expert_matmul(buf, params["w_up"].to(cd))
    h = layers.swiglu(g, u).to(cd)
    y = expert_matmul(h, params["w_down"].to(cd)).to(cd)   # (e_pad, cap, d)

    # ---- combine ------------------------------------------------------------
    y_flat = torch.cat([y.reshape(e_pad * cap, d), y.new_zeros((1, d))])
    contrib = gather_rows(y_flat, dest) * (sg * keep.float())[:, None].to(cd)
    # each token's k assignments by their place in the sorted order, which
    # is ascending expert id: the reference's scatter adds them so
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * k, device=dev)
    rank = torch.sort(rank.reshape(t, k), dim=1).values
    out = torch.zeros((t, d), dtype=cd, device=dev)
    for j in range(k):
        out = out + contrib[rank[:, j]]

    # ---- shared experts ------------------------------------------------------
    if cfg.n_shared > 0:
        gs = x @ params["shared_gate"].to(cd)
        us = x @ params["shared_up"].to(cd)
        out = out + layers.swiglu(gs, us) @ params["shared_down"].to(cd)

    return out, aux
