"""Decoder-only LM: GQA + RoPE + RMSNorm + SwiGLU, dense or MoE FFN.

Twin of ``repro/models/transformer.py`` for all five LM configurations
(qwen2.5-3b, smollm-360m, minitron-4b, granite-moe-3b-a800m,
deepseek-moe-16b): the same ``LMConfig`` fields and defaults, the same
parameter tree (plain nested dicts with the stacked ``(L, ...)`` block
layout: ``wq`` is ``(L, d, hp, dh)``, ``wo`` is ``(L, hp, dh, d)``; an MoE
block's FFN is the nested ``moe`` dict of ``models/moe.py``, stacked the
same way; DeepSeekMoE's dense layer 0 is the unstacked ``dense0``, which
the other blocks follow) and the same KV-cache layout ``(L, b, max_seq,
kh, dh)``, ``dense0``'s K/V at layer 0.

Differences from the reference, none of which changes a value:

  * layers run as a Python loop over the stacked params; with ``remat``
    each block runs under ``torch.utils.checkpoint`` (non-reentrant) when
    autograd records, so the backward pass keeps each block's input and
    recomputes the rest, the reference's ``jax.checkpoint`` with
    ``nothing_saveable``: a memory knob, the gradients the same bits with
    it on and off.  ``unroll_layers`` is a TPU compile knob, accepted and
    ignored;
  * ``mesh`` (a ``launch.mesh.Mesh``) reaches the MoE blocks: with
    ``ep_shard_map`` they take ``moe.moe_ffn_sharded`` (experts owned by
    'model' shards, the reference's expert-parallel route); without it
    over several data ranks ``moe.moe_ffn_global`` (the reference's GSPMD
    ``moe_ffn``: routing over the global batch, a rank's block on a
    process group, a local mesh's data blocks one after another); and
    ``loss_fn`` over a process-group mesh returns this rank's share of
    the global loss (``train_loop.jit_train_step``);
  * GQA expands K/V to the padded heads by ``expand`` (a broadcast whose
    backward is a sum), where the reference gathers with ``jnp.take``:
    the same values, and no scatter with atomics in the backward pass;
  * ``decode_step`` writes the new token's K/V into ``cache`` in place and
    returns the same dict (the reference returns a new cache; a 32k-token
    cache is tens of GB, so the port does not copy it), and takes
    ``pos`` as a Python int (or a 0-d tensor, read once);
  * decode attention goes through ``kernels.ops.decode_attention`` on the
    real heads ``q[:, :n_heads]``: the hand-written CUDA kernel for a CUDA
    tensor, its plain twin on the CPU or with ``backend="xla"``.  The
    kernel's head map ``i // (n_heads // n_kv_heads)`` equals the
    reference's ``min(i // group, kh - 1)`` on every real head, and the pad
    heads' outputs are zeros, as the reference's ``hmask`` makes them;
  * ``prefill`` and ``decode_step`` take ``tp`` (a
    ``distribution.sharding.TensorParallel``): the reference's GSPMD
    serving cells written out.  Every leaf dim its rules place on 'model'
    stays a block and each shard computes on its own, in one body for a
    process-group rank and a local mesh's stacked shards: column-parallel
    ``w_gate`` / ``w_up`` (and the shared experts') on 'mlp', row-parallel
    ``w_down`` and one sum over 'model'; the routed experts of the shard
    only (``moe.ep_partials``), the router's logits gathered over 'model'
    before the exact top-k, their partials and the shared experts' added
    before one sum; a vocab-parallel lookup (each shard gathers its
    rows, one sum, then the reference's wrap and NaN rows) and head (each
    shard its columns, the pad vocabulary masked by global column, the
    logits gathered); in prefill the attention heads on 'model' (``wq`` /
    ``bq`` column-, ``wo`` row-parallel, the GQA map and the pad-head mask
    by global head), the FSDP 'data' dims gathered a layer at a time, and
    each shard writes its own ``kv_seq`` block of the cache; in decode
    the heads whole, the new token's K/V written by the shard whose block
    holds ``pos``, and attention over each block by
    ``ops.decode_attention_partial`` merged across the shards
    (``decode_attention.merge_partials``) after one gather of their ``(o,
    m, l)``.  The sums add the shards' partials in shard order where the
    reference's one product sums in its own order: values within float32
    rounding, not bit for bit (tokens and ids exact in the tests);
  * ``forward`` and ``loss_fn`` take ``tp`` too: the reference's GSPMD train
    cell written out with the prefill's layer functions, autograd running
    through them.  Megatron's pairs (``core/distributed.py``) give each
    product its backward: the normed input of every column-parallel
    product, K and V (which every shard reads for its own heads) and the
    final hidden states have their gradients summed over 'model'
    (``copy_to``); a row-parallel sum, the lookup's sum and the loss's
    reductions hand every shard the whole gradient (``reduce_from``); the
    router's logits come back as each shard's slice (``gather_from``); an
    FSDP 'data' dim is gathered a layer at a time and its gradient
    reduce-scattered.  The cross-entropy is vocab-parallel
    (``layers.chunked_softmax_xent(vocab_blocks=)``), every model shard
    computes the same loss, and with ``remat`` each block is checkpointed
    (its recompute gathers the FSDP dims again).  The operations run in
    the unsharded block's order, so one shard gives its bits forward and
    backward;
  * ``cast_for_serving`` casts the matrices to ``compute_dtype`` once
    (the reference casts with ``.astype(cd)`` at every use, which gives
    the same values); the MoE router stays float32, as the reference
    routes in float32, and ``init_params(..., dtype=)`` draws a tree
    already cast, one layer's slice at a time, so a float32 tree and its
    cast copy never coexist.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import abstract
from repro_torch.core.distributed import gather_from, reduce_from
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import merge_partials
from repro_torch.launch.mesh import data_axes
from repro_torch.models import layers
from repro_torch.models.embedding import gather_rows, nan_rows, take_rows, wrap_ids
from repro_torch.models.moe import (
    MoEConfig, ep_partials, init_moe_params, moe_ffn, moe_ffn_global, moe_ffn_sharded,
    moe_param_specs,
)

BACKENDS = ("pallas", "xla")
# matrices the reference casts to compute_dtype at each use; the norm
# weights stay float32 (rmsnorm upcasts them), and so does the MoE router
# (the reference routes in float32)
_CAST = ("embed", "lm_head", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
         "w_gate", "w_up", "w_down", "shared_gate", "shared_up",
         "shared_down")


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float = 10_000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    first_dense_ff: Optional[int] = None  # DeepSeekMoE: layer 0 dense FFN
    norm_eps: float = 1e-6
    compute_dtype: Any = torch.bfloat16
    remat: bool = True
    kv_chunk: int = 512
    loss_chunk: int = 1024
    unroll_layers: bool = False
    # pad Q/O projections to this many heads (pad heads' outputs are zeroed)
    pad_heads_to: Optional[int] = None
    # pad the vocabulary (pad logits are masked to -1e30 in decode)
    pad_vocab_to: Optional[int] = None
    cache_dtype: Any = torch.bfloat16   # KV-cache storage dtype

    @property
    def n_heads_padded(self) -> int:
        return self.pad_heads_to or self.n_heads

    @property
    def vocab_padded(self) -> int:
        return self.pad_vocab_to or self.vocab_size

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def n_scan(self) -> int:
        """Layers in the stacked ``blocks`` (all but a dense layer 0)."""
        return self.n_layers - (1 if self.first_dense_ff else 0)

    def param_count(self) -> int:
        """Total parameters (for 6ND model-FLOPs accounting)."""
        d, l = self.d_model, self.n_layers
        attn = d * self.qkv_dim + 2 * d * self.kv_dim + self.qkv_dim * d
        if self.qkv_bias:
            attn += self.qkv_dim + 2 * self.kv_dim
        if self.moe is not None:
            m = self.moe
            ffn = d * m.n_experts + 3 * m.n_experts * d * m.d_ff_expert
            if m.n_shared:
                ffn += 3 * d * m.d_ff_expert * m.n_shared
            total = self.n_scan * (attn + ffn + 2 * d)
            if self.first_dense_ff:
                total += attn + 3 * d * self.first_dense_ff + 2 * d
        else:
            ffn = 3 * d * self.d_ff
            total = l * (attn + ffn + 2 * d)
        total += self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            total += d * self.vocab_size
        total += d  # final norm
        return total

    def physical_param_count(self) -> int:
        """param_count plus padding zeros (actual array elements)."""
        extra_h = self.n_heads_padded - self.n_heads
        per_layer = 2 * self.d_model * extra_h * self.head_dim  # wq + wo
        if self.qkv_bias:
            per_layer += extra_h * self.head_dim
        total = self.param_count() + self.n_layers * per_layer
        extra_v = self.vocab_padded - self.vocab_size
        total += extra_v * self.d_model * (1 if self.tie_embeddings else 2)
        if self.moe is not None:
            extra_e = self.moe.n_experts_padded - self.moe.n_experts
            per_moe_layer = extra_e * (
                self.d_model + 3 * self.d_model * self.moe.d_ff_expert
            )
            total += self.n_scan * per_moe_layer
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d, m = self.d_model, self.moe
        attn = d * self.qkv_dim + 2 * d * self.kv_dim + self.qkv_dim * d
        ffn_act = d * m.n_experts + 3 * m.top_k * d * m.d_ff_expert
        if m.n_shared:
            ffn_act += 3 * d * m.d_ff_expert * m.n_shared
        total = self.n_scan * (attn + ffn_act + 2 * d)
        if self.first_dense_ff:
            total += attn + 3 * d * self.first_dense_ff + 2 * d
        total += self.vocab_size * d
        if not self.tie_embeddings:
            total += d * self.vocab_size
        return total



# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _init_blocks(gen: torch.Generator, cfg: LMConfig, n: int,
                 dtype: torch.dtype) -> Dict[str, Any]:
    """``n`` blocks stacked on axis 0, the matrices in ``dtype`` (each
    layer's slice drawn in float32 and cast as it is stored)."""
    dev = gen.device
    d, hp, dh, kh = cfg.d_model, cfg.n_heads_padded, cfg.head_dim, cfg.n_kv_heads
    ones = lambda *s: torch.ones(s, dtype=torch.float32, device=dev)
    zeros = lambda *s: torch.zeros(s, dtype=dtype, device=dev)
    stack = lambda shape: layers.dense_stack(gen, n, shape, dtype=dtype)
    blocks = {
        "ln1": ones(n, d),
        "wq": stack((d, hp, dh)),
        "wk": stack((d, kh, dh)),
        "wv": stack((d, kh, dh)),
        "wo": stack((hp, dh, d)),
        "ln2": ones(n, d),
    }
    if cfg.qkv_bias:
        blocks.update(bq=zeros(n, hp, dh), bk=zeros(n, kh, dh),
                      bv=zeros(n, kh, dh))
    if cfg.moe is None:
        blocks.update(w_gate=stack((d, cfg.d_ff)), w_up=stack((d, cfg.d_ff)),
                      w_down=stack((cfg.d_ff, d)))
        return blocks
    moe: Dict[str, torch.Tensor] = {}
    for i in range(n):
        for name, w in init_moe_params(gen, d, cfg.moe).items():
            if name not in moe:
                kind = dtype if name in _CAST else torch.float32
                moe[name] = torch.empty((n,) + w.shape, dtype=kind, device=dev)
            moe[name][i] = w
    blocks["moe"] = moe
    return blocks


def init_params(gen: torch.Generator, cfg: LMConfig,
                dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """Seeded parameters on the generator's device, in the reference's
    tree and layout (the values differ: ``torch.Generator`` is not
    ``jax.random``).  With ``dtype`` the matrices ``cast_for_serving``
    casts come out in that dtype, with the values ``cast_for_serving``
    gives the float32 tree; the float32 tree is never held whole."""
    dev = gen.device
    d = cfg.d_model
    params: Dict[str, Any] = {
        "embed": layers.embed_init(gen, (cfg.vocab_padded, d), device=dev).to(dtype),
        "blocks": _init_blocks(gen, cfg, cfg.n_scan, dtype),
        "final_norm": torch.ones(d, dtype=torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = layers.dense_init(gen, (d, cfg.vocab_padded),
                                              device=dev).to(dtype)
    if cfg.first_dense_ff:
        dense_cfg = dataclasses.replace(cfg, moe=None, d_ff=cfg.first_dense_ff)
        params["dense0"] = _layer(_init_blocks(gen, dense_cfg, 1, dtype), 0)
    return params


def abstract_params(cfg: LMConfig) -> Dict[str, Any]:
    """``init_params``' tree as meta tensors (the dry run; no allocation)."""
    return abstract.abstract_of(lambda: init_params(torch.Generator(), cfg))


def _block_logical(cfg: LMConfig) -> Dict[str, Tuple]:
    p = {
        "ln1": ("layers", None),
        "wq": ("layers", "embed", "heads", "head_dim"),
        # KV projections are tiny (d x kh x dh): not FSDP-sharded
        "wk": ("layers", "embed_kv", "kv_heads", "head_dim"),
        "wv": ("layers", "embed_kv", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "ln2": ("layers", None),
    }
    if cfg.qkv_bias:
        p["bq"] = ("layers", "heads", "head_dim")
        p["bk"] = ("layers", "kv_heads", "head_dim")
        p["bv"] = ("layers", "kv_heads", "head_dim")
    if cfg.moe is not None:
        p["moe"] = {k: ("layers",) + v for k, v in moe_param_specs(cfg.moe).items()}
    else:
        p["w_gate"] = ("layers", "embed", "mlp")
        p["w_up"] = ("layers", "embed", "mlp")
        p["w_down"] = ("layers", "mlp", "embed")
    return p


def param_logical(cfg: LMConfig) -> Dict[str, Any]:
    """Logical axes of ``init_params``' tree (``distribution/sharding.py``).
    The embedding is sharded on vocab only; ``dense0`` is one unstacked
    block, so its tuples drop the leading 'layers'."""
    tree: Dict[str, Any] = {
        "embed": ("vocab", None),
        "blocks": _block_logical(cfg),
        "final_norm": (None,),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (None, "vocab")
    if cfg.first_dense_ff:
        dense_cfg = dataclasses.replace(cfg, moe=None, d_ff=cfg.first_dense_ff)
        tree["dense0"] = {k: v[1:] for k, v in _block_logical(dense_cfg).items()}
    return tree


# the reference's tree as the port's tensors (shared with the recsys models)
params_from_reference = layers.params_from_reference


def cast_for_serving(params: Dict[str, Any], cfg: LMConfig) -> Dict[str, Any]:
    """The same tree with every matrix and bias cast to ``compute_dtype``
    once, norm weights left float32; ``decode_step``'s per-use casts are
    then no-ops and give the values the reference's ``.astype(cd)`` gives."""
    cd = cfg.compute_dtype

    def conv(node, name=""):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        return node.to(cd) if name in _CAST else node

    return conv(params)


def lm_head_weight(params: Dict[str, Any], cfg: LMConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _layer(blocks: Dict[str, Any], i: int) -> Dict[str, Any]:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


def _layers(params: Dict[str, Any], cfg: LMConfig):
    """``(cache index, block params)`` of every layer in order: ``dense0``
    first when the config has one, then the stacked blocks (the reference
    scans those after it).  ``dense0`` holds no ``moe``, so ``_ffn`` takes
    its dense branch with its own ``d_ff`` under the model's config."""
    first = 1 if cfg.first_dense_ff else 0
    if first:
        yield 0, params["dense0"]
    # one unbind a leaf (its backward stacks the layers' grads once),
    # where a select a layer would add a full-size zero grad per layer
    layer_of = _unbind(params["blocks"])
    for i in range(cfg.n_scan):
        yield first + i, _layer(layer_of, i)


def _unbind(blocks: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _unbind(v) if isinstance(v, dict) else torch.unbind(v)
            for k, v in blocks.items()}


def _proj(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk", h, w)`` as one matrix product."""
    d, nh, dh = w.shape
    return (h @ w.reshape(d, nh * dh)).unflatten(-1, (nh, dh))


def _out_proj(attn: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd", attn, w)`` as one matrix product."""
    nh, dh, d = w.shape
    return attn.flatten(-2) @ w.reshape(nh * dh, d)


def _qkv(p, x, cfg: LMConfig, positions: torch.Tensor, freqs: torch.Tensor):
    cd = cfg.compute_dtype
    h = layers.rmsnorm(x, p["ln1"], cfg.norm_eps)
    q = _proj(h, p["wq"].to(cd))
    k = _proj(h, p["wk"].to(cd))
    v = _proj(h, p["wv"].to(cd))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = layers.apply_rope(q, positions, freqs)
    k = layers.apply_rope(k, positions, freqs)
    return q, k, v


def _expand_kv(x: torch.Tensor, cfg: LMConfig, lo: int = 0,
               n: Optional[int] = None) -> torch.Tensor:
    """``(b, s, kh, dh)`` -> ``(b, s, n, dh)``, padded heads ``lo`` to ``lo +
    n`` (all ``hp`` by default): head ``i`` reads kv head ``min(i // group,
    kh - 1)`` (the reference's ``jnp.take`` map), as a broadcast: its
    backward sums, with no atomic scatter."""
    b, s, kh, dh = x.shape
    hp = cfg.n_heads_padded
    n = hp - lo if n is None else n
    group = cfg.n_heads // kh
    real = kh * group               # the heads past it all read the last kv head
    parts = []
    if lo < real:
        k0, k1 = lo // group, -(-min(lo + n, real) // group)
        src = x if (k0, k1) == (0, kh) else x[:, :, k0:k1]
        out = src[:, :, :, None].expand(b, s, k1 - k0, group, dh).reshape(
            b, s, (k1 - k0) * group, dh)
        cut, cnt = lo - k0 * group, min(lo + n, real) - lo
        if (cut, cnt) != (0, out.shape[2]):
            out = out[:, :, cut:cut + cnt]
        parts.append(out)
    if lo + n > real:
        parts.append(x[:, :, -1:].expand(b, s, lo + n - max(lo, real), dh))
    return torch.cat(parts, dim=2) if len(parts) > 1 else parts[0]


def _expanded_attention(q, k, v, cfg: LMConfig, q_offset: int = 0):
    """GQA -> full (padded) heads, then flash attention, with the pad
    heads zeroed (the reference's ``_attention`` / ``block_kv``)."""
    hp = cfg.n_heads_padded
    group = cfg.n_heads // cfg.n_kv_heads
    if group > 1 or hp != cfg.n_kv_heads:
        k = _expand_kv(k, cfg)
        v = _expand_kv(v, cfg)
    attn = layers.flash_attention(q, k, v, causal=True, q_offset=q_offset,
                                  kv_chunk=cfg.kv_chunk)
    if hp != cfg.n_heads:
        mask = (torch.arange(hp, device=q.device) < cfg.n_heads).to(attn.dtype)
        attn = attn * mask[None, None, :, None]
    return attn


def _use_ep(cfg: LMConfig, mesh, n_tokens: int) -> bool:
    """The expert-parallel route: ``ep_shard_map`` set and a mesh given,
    and the tokens split over the data axes (decode at a batch that does
    not divide them takes ``moe_ffn``, as the reference does).  A
    process-group rank holds its own data block already."""
    if not cfg.moe.ep_shard_map or mesh is None:
        return False
    if mesh.kind == "process_group":
        return True
    return n_tokens % mesh.axis_size([a for a in mesh.axis_names if a != "model"]) == 0


def _use_global(cfg: LMConfig, mesh, n_tokens: int) -> bool:
    """Routing over the global batch in data blocks (``moe.moe_ffn_global``):
    no ``ep_shard_map`` and a mesh with several data ranks.  A
    process-group rank holds its own block; a local mesh splits the tokens
    into its data blocks where they divide (else ``moe_ffn`` of the whole,
    which is the global batch too)."""
    if cfg.moe.ep_shard_map or mesh is None:
        return False
    n_data = mesh.axis_size(data_axes(mesh))
    return n_data > 1 and (mesh.kind == "process_group" or n_tokens % n_data == 0)


def _ffn(p, x: torch.Tensor, cfg: LMConfig, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The FFN half of a block: ``(x + ffn(x), aux loss)``.  MoE when the
    block holds ``moe`` (the reference's test), on the flattened ``b * s``
    tokens, whose count sets the capacity: a data shard's count on the
    expert-parallel route, the global batch's on the others (``moe_ffn``,
    or ``moe_ffn_global`` over the data blocks of a mesh).  The shared
    experts are dense products added after the routed output."""
    cd = cfg.compute_dtype
    h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None and "moe" in p:
        b, s, d = h.shape
        flat = h.reshape(b * s, d)
        if _use_ep(cfg, mesh, b * s):
            out, aux = moe_ffn_sharded(flat, p["moe"], cfg.moe, mesh)
        elif _use_global(cfg, mesh, b * s):
            parts, aux = moe_ffn_global(flat, p["moe"], cfg.moe,
                                        mesh.fabric(data_axes(mesh)))
            out = parts[0]
        else:           # (moe_ffn adds its shared experts itself)
            out, aux = moe_ffn(flat, p["moe"], cfg.moe)
            return x + out.reshape(b, s, d), aux
        if cfg.moe.n_shared > 0:
            gs = flat @ p["moe"]["shared_gate"].to(cd)
            us = flat @ p["moe"]["shared_up"].to(cd)
            out = out + layers.swiglu(gs, us) @ p["moe"]["shared_down"].to(cd)
        return x + out.reshape(b, s, d), aux
    g = h @ p["w_gate"].to(cd)
    u = h @ p["w_up"].to(cd)
    out = layers.swiglu(g, u) @ p["w_down"].to(cd)
    return x + out, torch.zeros((), dtype=torch.float32, device=x.device)


def _embed(params, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    """``jnp.take(embed.astype(cd), tokens, axis=0)``, cast before the
    gather as the reference casts: ``-1`` wraps to the last row, an id
    still outside the padded vocabulary is a NaN row."""
    return take_rows(params["embed"].to(cfg.compute_dtype), tokens)


def _logits(params, x_last: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    logits = (x_last @ lm_head_weight(params, cfg).to(cfg.compute_dtype)).float()
    if cfg.vocab_padded != cfg.vocab_size:
        valid = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab_size
        logits = logits.masked_fill(~valid, layers.NEG_INF)
    return logits


def _block(p, x: torch.Tensor, cfg: LMConfig, pos: torch.Tensor,
           freqs: torch.Tensor, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of ``forward``: attention, then the FFN; ``(x, aux)``."""
    q, k, v = _qkv(p, x, cfg, pos, freqs)
    x = x + _out_proj(_expanded_attention(q, k, v, cfg), p["wo"].to(cfg.compute_dtype))
    return _ffn(p, x, cfg, mesh)


def forward(
    params: Dict[str, Any],
    tokens: torch.Tensor,      # (b, s) int32
    cfg: LMConfig,
    mesh=None,
    *,
    tp=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids -> final hidden states (b, s, d). Returns (hidden, aux_loss),
    the aux loss summed over the stacked blocks.  With ``tp`` the lookup and
    the blocks run tensor-parallel on ``params`` in its form (``_embed_tp``,
    ``_block_tp``), ``mesh`` is not read, and over a process group the
    expert-parallel aux is averaged over the data ranks (each routes its
    own rows; without ``ep_shard_map`` the aux is the global batch's
    already)."""
    b, s = tokens.shape
    if tp is None:
        x = _embed(params, tokens, cfg)
        block, extra = _block, (mesh,)
    else:
        x = _embed_tp(params, tokens, cfg, tp, param_logical(cfg))
        block, extra = _block_tp, (tp, _layer_logical(cfg))
    dev = x.device
    freqs = layers.rope_frequencies(cfg.head_dim, cfg.rope_theta, device=dev)
    pos = torch.arange(s, device=dev).expand(b, s)
    auxes = []
    remat = cfg.remat and torch.is_grad_enabled()
    for _, p in _layers(params, cfg):
        if remat:     # (a tensor-parallel recompute gathers the FSDP dims again)
            x, aux = checkpoint(block, p, x, cfg, pos, freqs, *extra, use_reentrant=False)
        else:
            x, aux = block(p, x, cfg, pos, freqs, *extra)
        auxes.append(aux)
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    # the reference sums the stacked blocks' aux, not dense0's (zero) one
    aux = torch.stack(auxes[cfg.n_layers - cfg.n_scan:]).sum()
    if (tp is not None and cfg.moe is not None and cfg.moe.ep_shard_map and not tp.local
            and tp.data_ranks > 1):
        aux = reduce_from(tp.data_fabric, aux[None], grad="psum") / torch.tensor(
            float(tp.data_ranks), dtype=aux.dtype, device=dev)
    return x, aux


def loss_fn(
    params: Dict[str, Any],
    tokens: torch.Tensor,      # (b, s)
    labels: torch.Tensor,      # (b, s)
    mask: torch.Tensor,        # (b, s)
    cfg: LMConfig,
    mesh=None,
    *,
    tp=None,
) -> torch.Tensor:
    """Token-mean CE over the real vocabulary (chunked, the logits never
    whole) plus the summed MoE aux loss.

    With a process-group ``mesh`` the rows are this rank's and the result
    is its share of the global loss: its CE sum over the token count
    summed over the data ranks, plus its aux over their number; the shares
    add up to the loss over the data axes (``train_loop.jit_train_step``
    adds them).  With ``tp`` (``sharding.TensorParallel``; its mesh is the
    mesh) the blocks run tensor-parallel and the CE is vocab-parallel over
    the head's vocabulary blocks; every model shard computes the same
    loss."""
    if tp is not None:
        mesh = tp.mesh
    hidden, aux = forward(params, tokens, cfg, mesh=mesh, tp=tp)
    blocks = None
    if tp is None:
        head = lm_head_weight(params, cfg).to(cfg.compute_dtype)
    else:
        head, split = _head_tp(params, cfg, tp, param_logical(cfg))
        head = head.to(cfg.compute_dtype)
        blocks = (tp.offsets(split), tp.fabric if split else None)
    count = None
    if mesh is not None and mesh.kind == "process_group":
        d_axes = data_axes(mesh)
        n_data = mesh.axis_size(d_axes)
        if d_axes:
            count = mesh.fabric(d_axes).psum(mask.float().sum()[None])
        aux = aux / torch.tensor(float(n_data), device=aux.device)
    ce = layers.chunked_softmax_xent(hidden, head, labels, mask,
                                     chunk=cfg.loss_chunk,
                                     n_valid_vocab=cfg.vocab_size, count=count,
                                     vocab_blocks=blocks)
    return ce + aux


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(
    cfg: LMConfig, batch: int, max_seq: int, dtype=None, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    dtype = dtype or cfg.cache_dtype
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def abstract_kv_cache(
    cfg: LMConfig, batch: int, max_seq: int, dtype=None
) -> Dict[str, torch.Tensor]:
    """``init_kv_cache``'s dict as meta tensors."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    dtype = dtype or cfg.cache_dtype
    return {"k": abstract.meta(shape, dtype), "v": abstract.meta(shape, dtype)}


def kv_cache_logical() -> Dict[str, Tuple]:
    ax = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax}


def decode_step(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,      # (b,) int32 — the newest token per sequence
    pos,                       # int — its position (same across batch)
    cfg: LMConfig,
    mesh=None,
    *,
    backend: str = "pallas",
    tp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Append one token, return (logits (b, v) f32, cache updated in place).

    ``backend="pallas"`` attends through the decode-attention kernel on a
    CUDA cache (its twin on the CPU); ``"xla"`` takes the twin anywhere.
    With ``tp`` (``sharding.TensorParallel``) the step is tensor-parallel
    over its mesh (the module docstring): the params and the cache are in
    its form, the cache's ``kv_seq`` blocks on 'model', and ``mesh`` is
    not read.
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if tp is not None:
        return _decode_step_tp(params, cache, tokens, int(pos), cfg, backend, tp)
    pos = int(pos)
    max_seq = cache["k"].shape[2]
    if not 0 <= pos < max_seq:
        raise ValueError(f"pos {pos} outside the cache's {max_seq} positions")
    cd = cfg.compute_dtype
    b = tokens.shape[0]
    x = _embed(params, tokens, cfg)[:, None, :]
    dev = x.device
    freqs = layers.rope_frequencies(cfg.head_dim, cfg.rope_theta, device=dev)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    hp = cfg.n_heads_padded
    for i, p in _layers(params, cfg):
        q, k, v = _qkv(p, x, cfg, posb, freqs)
        ck, cv = cache["k"][i], cache["v"][i]
        ck[:, pos] = k[:, 0].to(ck.dtype)
        cv[:, pos] = v[:, 0].to(cv.dtype)
        attn = ops.decode_attention(q[:, 0, :cfg.n_heads], ck, cv, pos + 1,
                                    use_kernel=backend == "pallas")
        if hp != cfg.n_heads:   # pad heads contribute zeros
            attn = F.pad(attn, (0, 0, 0, hp - cfg.n_heads))
        x = x + _out_proj(attn[:, None].to(cd), p["wo"].to(cd))
        x, _ = _ffn(p, x, cfg, mesh)
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x[:, 0], cfg), cache


def prefill(
    params: Dict[str, Any],
    tokens: torch.Tensor,      # (b, s)
    cfg: LMConfig,
    max_seq: Optional[int] = None,
    mesh=None,
    *,
    tp=None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Run the prompt, build the KV cache. Returns (last-token logits, cache).

    The cache layout matches decode_step; padding beyond s is zeros.  With
    ``tp`` the prompt runs tensor-parallel (the module docstring) and the
    cache comes out in ``tp``'s form: this rank's ``kv_seq`` blocks of
    its rows, or a local mesh's shards stacked after 'layers'.
    """
    b, s = tokens.shape
    if max_seq is None:
        max_seq = s
    if tp is not None:
        return _prefill_tp(params, tokens, cfg, max_seq, tp)
    x = _embed(params, tokens, cfg)
    dev = x.device
    freqs = layers.rope_frequencies(cfg.head_dim, cfg.rope_theta, device=dev)
    pos = torch.arange(s, device=dev).expand(b, s)
    cache = init_kv_cache(cfg, b, max_seq, device=dev)
    for i, p in _layers(params, cfg):
        q, k, v = _qkv(p, x, cfg, pos, freqs)
        x = x + _out_proj(_expanded_attention(q, k, v, cfg), p["wo"].to(cfg.compute_dtype))
        x, _ = _ffn(p, x, cfg, mesh)
        cache["k"][i, :, :s] = k.to(cfg.cache_dtype)
        cache["v"][i, :, :s] = v.to(cfg.cache_dtype)
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, x[:, -1], cfg), cache


# ---------------------------------------------------------------------------
# Tensor-parallel serving (``prefill`` / ``decode_step`` with ``tp``)
# ---------------------------------------------------------------------------


def _layer_logical(cfg: LMConfig) -> Dict[str, Any]:
    """Logical axes of one layer's leaves, 'layers' dropped: the stacked
    blocks' and ``dense0``'s (whose FFN is the dense one)."""
    out: Dict[str, Any] = {}
    for c in (cfg, dataclasses.replace(cfg, moe=None)):
        for k, v in _block_logical(c).items():
            out[k] = {n: a[1:] for n, a in v.items()} if isinstance(v, dict) else v[1:]
    return out


def _embed_tp(params, tokens: torch.Tensor, cfg: LMConfig, tp, top) -> torch.Tensor:
    """``_embed`` over the table's vocabulary blocks (``top``: the tree's
    logical axes): the reference's wrap of a negative id first (``-1`` and
    ``-V`` reach another shard's rows), each shard its own rows (zeros for
    the others), one sum over 'model', then the NaN rows of ids still
    outside ``[0, V_pad)``."""
    cd = cfg.compute_dtype
    table, split = tp.shards(params["embed"], top["embed"])
    if not split:
        return take_rows(table[0].to(cd), tokens)
    rows = table.shape[1]
    i, ok = wrap_ids(tokens, rows * tp.n)
    zero = torch.zeros((), dtype=cd, device=i.device)
    parts = []
    for j, c in enumerate(tp.offsets(split)):
        local = i - c * rows
        mine = (local >= 0) & (local < rows)
        got = gather_rows(table[j].to(cd), local.clamp(0, rows - 1))
        parts.append(torch.where(mine[..., None], got, zero))
    return nan_rows(tp.reduce(torch.stack(parts), split), ok)


def _head_tp(params, cfg: LMConfig, tp, top) -> Tuple[torch.Tensor, bool]:
    """The head's vocabulary blocks ``(S_l, d, v_loc)`` (the tied table's
    transposed) and whether the vocabulary is split."""
    if cfg.tie_embeddings:
        head, split = tp.shards(params["embed"], top["embed"])
        return head.transpose(1, 2), split
    return tp.shards(params["lm_head"], top["lm_head"])


def _logits_tp(params, x_last: torch.Tensor, cfg: LMConfig, tp, top) -> torch.Tensor:
    """``_logits`` over the head's vocabulary blocks: each shard its
    columns, the pad vocabulary masked by global column on the shard that
    holds it, then the shards' columns gathered into ``(b, V_pad)``."""
    cd = cfg.compute_dtype
    head, split = _head_tp(params, cfg, tp, top)
    cols = head.shape[2]
    parts = []
    for j, c in enumerate(tp.offsets(split)):
        logits = (x_last @ head[j].to(cd)).float()
        if cfg.vocab_padded != cfg.vocab_size:
            col = c * cols + torch.arange(cols, device=logits.device)
            logits = logits.masked_fill(col >= cfg.vocab_size, layers.NEG_INF)
        parts.append(logits)
    if not split:
        return parts[0]
    whole = tp.fabric.all_gather(torch.stack(parts))          # (n, b, cols)
    return whole.permute(1, 0, 2).reshape(x_last.shape[0], tp.n * cols)


def _mlp_parts(h: torch.Tensor, p, names, cfg: LMConfig, tp, lg, copy: bool = True
               ) -> Tuple[torch.Tensor, bool]:
    """SwiGLU with column-parallel gate / up and a row-parallel down
    projection: the local shards' partial outputs ``(S_l, ..., d)``, to be
    summed over 'model', and whether the leaves are split (else the one
    part is the whole).  Under autograd a split product's input has its
    gradient summed over 'model' (``copy_to``; ``copy=False``: ``h`` is
    under it already)."""
    cd = cfg.compute_dtype
    wg, split = tp.shards(p[names[0]], lg[names[0]])
    wu, _ = tp.shards(p[names[1]], lg[names[1]])
    wd, _ = tp.shards(p[names[2]], lg[names[2]])
    if split and copy:
        h = tp.copy(h)
    parts = torch.stack([layers.swiglu(h @ wg[j].to(cd), h @ wu[j].to(cd)) @ wd[j].to(cd)
                         for j in range(wg.shape[0])])
    return parts, split


def _moe_tp(xr: torch.Tensor, p, cfg: LMConfig, tp, lg) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts over 'model' with the shard's own experts only:
    the router's logits gathered from its expert blocks (``gather_from``),
    the exact top-k of ``moe.route`` on every shard alike, ``ep_partials``
    over the local shards' experts; ``(partials (S_l, t, d), aux)``, the
    partials to be summed over 'model' and the aux alike on every model
    shard.  With ``ep_shard_map`` (or one data rank) the capacity is
    ``capacity(t)`` of this rank's tokens and the aux its own; without it
    over several data ranks the tokens are routed over the global batch
    (``moe_ffn_global``: the counts and the aux sums over the data axes,
    the aux global).  The tokens ``xr`` are under ``copy_to``
    (``_ffn_tp``), and under autograd over a process group the gates'
    gradients are summed over 'model' too."""
    mcfg = cfg.moe
    router, split = tp.shards(p["router"], lg["router"])
    experts = {n: tp.shards(p[n], lg[n]) for n in ("w_gate", "w_up", "w_down")}
    if not (split and all(sp for _, sp in experts.values())):
        raise ValueError("a tensor-parallel MoE block places 'experts' on the model axis")
    logits = torch.stack([xr.float() @ r.float() for r in router])      # (S_l, t, E/n)
    logits = gather_from(tp.fabric, logits).permute(1, 0, 2).reshape(xr.shape[0], -1)
    e_loc = experts["w_gate"][0].shape[1]
    w = {n: x.flatten(0, 1) for n, (x, _) in experts.items()}
    shard_ids = torch.tensor(tp.coords, dtype=torch.int32, device=xr.device)
    if not mcfg.ep_shard_map and tp.data_ranks > 1:
        # the reference's GSPMD moe_ffn: one cut and one aux over the data ranks
        return moe_ffn_global(xr, w, mcfg, tp.data_fabric, shard_ids, e_loc,
                              model=tp.fabric, logits=logits)
    return ep_partials(xr, w, mcfg, shard_ids, e_loc, fabric=tp.fabric, logits=logits)


def _ffn_tp(p, x: torch.Tensor, cfg: LMConfig, tp, lg) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_ffn`` tensor-parallel: ``(x + ffn(x), aux)``.  In a MoE block the
    router, the routed experts and the shared ones all read the tokens in
    part: one ``copy_to`` sums the three gradients over 'model', and one
    sum adds the routed and shared partials over it."""
    h = layers.rmsnorm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe is not None and "moe" in p:
        b, s, d = h.shape
        xr = tp.copy(h.reshape(b * s, d))
        parts, aux = _moe_tp(xr, p["moe"], cfg, tp, lg["moe"])
        if cfg.moe.n_shared > 0:
            shared, split = _mlp_parts(xr, p["moe"], ("shared_gate", "shared_up",
                                                      "shared_down"), cfg, tp, lg["moe"],
                                       copy=False)
            if not split:
                raise ValueError("a tensor-parallel MoE block places the shared experts' "
                                 "'mlp' on the model axis")
            parts = parts + shared
        return x + tp.reduce(parts, True).reshape(b, s, d), aux
    parts, split = _mlp_parts(h, p, ("w_gate", "w_up", "w_down"), cfg, tp, lg)
    return x + tp.reduce(parts, split), torch.zeros((), dtype=torch.float32, device=x.device)


def _whole_qkv(p, cfg: LMConfig, tp, lg, with_q: bool) -> Dict[str, torch.Tensor]:
    """The attention's leaves no rule splits over 'model' (``wq`` / ``bq``
    too with ``with_q``), whole."""
    names = ["ln1", "wk", "wv"] + (["wq"] if with_q else [])
    if cfg.qkv_bias:
        names += ["bk", "bv"] + (["bq"] if with_q else [])
    return {n: tp.whole(p[n], lg[n]) for n in names}


def _attention_tp(p, x: torch.Tensor, cfg: LMConfig, pos: torch.Tensor,
                  freqs: torch.Tensor, tp, lg):
    """Prefill and training attention with the query heads in blocks over
    'model' (``wq`` / ``bq`` column-, ``wo`` row-parallel, one sum), K and
    V whole on every shard: ``(x + attn, k, v)``.  A shard's head ``i`` is
    global head ``c * hp_loc + i``: it reads kv head ``min(g // group, kh
    - 1)`` and is zeroed past ``n_heads``, as the reference maps and masks
    the whole head axis.  The operations run in ``_qkv`` /
    ``_expanded_attention``'s order, so that one shard gives the unsharded
    block's bits, forward and backward.  Under autograd the normed input
    of the query products and K / V (each shard reads them for its own
    heads) have their gradients summed over 'model'."""
    cd = cfg.compute_dtype
    w = _whole_qkv(p, cfg, tp, lg, with_q=False)
    wq, split = tp.shards(p["wq"], lg["wq"])
    wo, _ = tp.shards(p["wo"], lg["wo"])
    bq = tp.shards(p["bq"], lg["bq"])[0] if cfg.qkv_bias else None
    h = layers.rmsnorm(x, w["ln1"], cfg.norm_eps)
    hq = tp.copy(h) if split else h
    qs = [_proj(hq, wq[j].to(cd)) for j in range(wq.shape[0])]
    k = _proj(h, w["wk"].to(cd))
    v = _proj(h, w["wv"].to(cd))
    if cfg.qkv_bias:
        qs = [q + bq[j].to(cd) for j, q in enumerate(qs)]
        k = k + w["bk"].to(cd)
        v = v + w["bv"].to(cd)
    if split:
        k, v = tp.copy(k), tp.copy(v)
    qs = [layers.apply_rope(q, pos, freqs) for q in qs]
    k = layers.apply_rope(k, pos, freqs)
    hp_loc = wq.shape[2]
    # (the unsharded block expands only where the head counts differ)
    expand = (cfg.n_heads // cfg.n_kv_heads > 1 or cfg.n_heads_padded != cfg.n_kv_heads
              or hp_loc != cfg.n_heads_padded)
    parts = []
    for j, c in enumerate(tp.offsets(split)):
        lo = c * hp_loc
        kj = _expand_kv(k, cfg, lo, hp_loc) if expand else k
        vj = _expand_kv(v, cfg, lo, hp_loc) if expand else v
        attn = layers.flash_attention(qs[j], kj, vj, causal=True, kv_chunk=cfg.kv_chunk)
        if cfg.n_heads_padded != cfg.n_heads:
            heads = lo + torch.arange(hp_loc, device=x.device)
            attn = attn * (heads < cfg.n_heads).to(attn.dtype)[None, None, :, None]
        parts.append(_out_proj(attn, wo[j].to(cd)))
    return x + tp.reduce(torch.stack(parts), split), k, v


def _block_tp(p, x: torch.Tensor, cfg: LMConfig, pos: torch.Tensor,
              freqs: torch.Tensor, tp, lg) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block of ``forward`` tensor-parallel: ``(x, aux)``."""
    x, _, _ = _attention_tp(p, x, cfg, pos, freqs, tp, lg)
    return _ffn_tp(p, x, cfg, tp, lg)


def _cache_blocks(cache_layer: torch.Tensor, tp) -> Tuple[torch.Tensor, bool]:
    """One layer of the cache -> its local ``kv_seq`` blocks ``(S_l, b,
    s_loc, kh, dh)`` and whether the sequence is split over 'model'."""
    return tp.shards(cache_layer, kv_cache_logical()["k"][1:], tp.cache_rules, fsdp=False)


def _init_cache_tp(cfg: LMConfig, b: int, max_seq: int, tp, dev) -> Dict[str, torch.Tensor]:
    """Zeros in ``tp``'s cache form: ``(L, b, s_loc, kh, dh)`` (a rank's
    block), or ``(L, n, b, s_loc, kh, dh)`` on a local mesh."""
    split = tp.split("kv_seq", tp.cache_rules)
    if split and max_seq % tp.n:
        raise ValueError(f"max_seq {max_seq} does not divide into {tp.n} kv_seq blocks")
    s_loc = max_seq // tp.n if split else max_seq
    lead = (cfg.n_layers, tp.n) if split and tp.local else (cfg.n_layers,)
    shape = lead + (b, s_loc, cfg.n_kv_heads, cfg.head_dim)
    return {n: torch.zeros(shape, dtype=cfg.cache_dtype, device=dev) for n in ("k", "v")}


def _prefill_tp(params, tokens: torch.Tensor, cfg: LMConfig, max_seq: int, tp):
    b, s = tokens.shape
    top = param_logical(cfg)
    x = _embed_tp(params, tokens, cfg, tp, top)
    dev = x.device
    freqs = layers.rope_frequencies(cfg.head_dim, cfg.rope_theta, device=dev)
    pos = torch.arange(s, device=dev).expand(b, s)
    cache = _init_cache_tp(cfg, b, max_seq, tp, dev)
    lg = _layer_logical(cfg)
    for i, p in _layers(params, cfg):
        x, k, v = _attention_tp(p, x, cfg, pos, freqs, tp, lg)
        x, _ = _ffn_tp(p, x, cfg, tp, lg)
        ck, split = _cache_blocks(cache["k"][i], tp)
        cv, _ = _cache_blocks(cache["v"][i], tp)
        s_loc = ck.shape[2]
        for j, c in enumerate(tp.offsets(split)):   # each shard its own block
            lo = c * s_loc
            n = min(max(s - lo, 0), s_loc)
            if n:
                ck[j, :, :n] = k[:, lo:lo + n].to(cfg.cache_dtype)
                cv[j, :, :n] = v[:, lo:lo + n].to(cfg.cache_dtype)
        del k, v
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits_tp(params, x[:, -1], cfg, tp, top), cache


def _decode_step_tp(params, cache, tokens: torch.Tensor, pos: int, cfg: LMConfig,
                    backend: str, tp):
    if tp.split("heads"):
        raise NotImplementedError("tensor-parallel decode keeps the attention heads "
                                  "whole (the serve rules' heads=None)")
    cd = cfg.compute_dtype
    b = tokens.shape[0]
    top = param_logical(cfg)
    x = _embed_tp(params, tokens, cfg, tp, top)[:, None, :]
    dev = x.device
    freqs = layers.rope_frequencies(cfg.head_dim, cfg.rope_theta, device=dev)
    posb = torch.full((b, 1), pos, dtype=torch.int32, device=dev)
    hp, nh = cfg.n_heads_padded, cfg.n_heads
    lg = _layer_logical(cfg)
    s_loc = _cache_blocks(cache["k"][0], tp)[0].shape[2]
    split = tp.split("kv_seq", tp.cache_rules)
    max_seq = s_loc * (tp.n if split else 1)
    if not 0 <= pos < max_seq:
        raise ValueError(f"pos {pos} outside the cache's {max_seq} positions")
    for i, p in _layers(params, cfg):
        q, k, v = _qkv(_whole_qkv(p, cfg, tp, lg, with_q=True), x, cfg, posb, freqs)
        ck, _ = _cache_blocks(cache["k"][i], tp)
        cv, _ = _cache_blocks(cache["v"][i], tp)
        parts = []
        for j, c in enumerate(tp.offsets(split)):
            lo = c * s_loc
            if lo <= pos < lo + s_loc:     # the block that holds pos writes it
                ck[j, :, pos - lo] = k[:, 0].to(ck.dtype)
                cv[j, :, pos - lo] = v[:, 0].to(cv.dtype)
            parts.append(ops.decode_attention_partial(
                q[:, 0, :nh], ck[j], cv[j], lo, pos + 1, use_kernel=backend == "pallas"))
        o, m, l = (torch.stack(t) for t in zip(*parts))
        if split:   # every shard's (o, m, l) in one gather
            packed = tp.fabric.all_gather(torch.cat([o, m[..., None], l[..., None]], dim=-1))
            o, m, l = packed[..., :-2], packed[..., -2], packed[..., -1]
        attn = merge_partials(o, m, l)
        if hp != nh:   # pad heads contribute zeros
            attn = F.pad(attn, (0, 0, 0, hp - nh))
        x = x + _out_proj(attn[:, None].to(cd), tp.whole(p["wo"], lg["wo"]).to(cd))
        x, _ = _ffn_tp(p, x, cfg, tp, lg)
    x = layers.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return _logits_tp(params, x[:, 0], cfg, tp, top), cache
