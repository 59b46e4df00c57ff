"""Shared neural building blocks: RMSNorm, LayerNorm, RoPE, flash
attention, SwiGLU, the token-mean cross-entropy and its chunked form
(vocab-parallel over a fabric's shards, the one device its one-shard
case).

Twin of ``repro/models/layers.py``: the same names, argument orders and
layouts (``(b, s, heads, head_dim)`` activations), and the reference's
float order where it shows: RMSNorm and RoPE compute in float32 and cast
back to the input's dtype, masked scores are ``NEG_INF = -1e30``.
``layernorm`` is the reference's, not ``F.layer_norm``: eps 1e-6 and the
population variance (``jnp.var``), mean and variance in float32.

``flash_attention`` is the reference's chunked online-softmax scan over KV
blocks, written as a Python loop over chunks in plain PyTorch.  It is
plain jnp in the reference too (no Pallas kernel), so it has no hand
kernel here; prefill and ``forward`` use it, decode uses the
``decode_attention`` kernel instead.

The initialisers draw from an explicit ``torch.Generator`` with the
reference's standard deviations; their numbers differ from ``jax.random``'s,
so a parity test carries the reference's arrays across
(``params_from_reference``, the identity on names and layouts, which the
LM and the recsys models share).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.distributed import copy_to, reduce_from
from repro_torch.device import DeviceLike, resolve_device

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms and activations
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * weight + bias).to(dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    # jax.nn.silu is x * logistic(x); F.silu rounds differently
    return gate * torch.sigmoid(gate) * up


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float = 10_000.0,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               freqs: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    angles = positions[..., :, None].float() * freqs      # (.., s, half)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Chunked (flash) attention — loop over KV blocks, online softmax
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,    # (b, sq, h, dh)
    k: torch.Tensor,    # (b, skv, kh, dh)
    v: torch.Tensor,    # (b, skv, kh, dh)
    causal: bool = True,
    q_offset: int = 0,  # absolute position of q[0]
    kv_chunk: int = 512,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Memory-efficient GQA attention -> (b, sq, h, dh), dtype of q.

    No (sq, skv) tensor is materialised: the loop carries the (m, l, acc)
    running-softmax state per query position, one KV chunk at a time.
    With ``causal`` a chunk updates only the query rows that see some of
    it: for the others the reference's update is exact no-op arithmetic
    (values and gradients the same, up to the sign of a zero), and
    skipping it halves the work at long sequences.
    Query head ``i`` reads kv head ``i // (h // kh)`` (the reference's
    reshape); its callers pass K/V already expanded to ``h`` heads.
    """
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    group = h // kh
    if scale is None:
        scale = dh ** -0.5
    kv_chunk = min(kv_chunk, skv)
    n_chunks = -(-skv // kv_chunk)
    dev = q.device

    qg = (q.reshape(b, sq, kh, group, dh) * scale).float()
    q_pos = q_offset + torch.arange(sq, device=dev)
    m = torch.full((b, sq, kh, group), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, sq, kh, group), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, sq, kh, group, dh), dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        lo = c * kv_chunk
        # causal: the rows before r0 see none of this chunk, so for them the
        # reference's step is exact no-op arithmetic (p = exp(-1e30 - m) is
        # 0, corr = exp(0) is 1): only rows r0.. take it
        r0 = min(max(lo - q_offset, 0), sq) if causal else 0
        if r0 == sq:
            break
        kb = k[:, lo:lo + kv_chunk].float()
        vb = v[:, lo:lo + kv_chunk].float()
        if kb.shape[1] < kv_chunk:   # the reference zero-pads the last chunk
            pad = (0, 0, 0, 0, 0, kv_chunk - kb.shape[1])
            kb, vb = F.pad(kb, pad), F.pad(vb, pad)
        kv_pos = lo + torch.arange(kv_chunk, device=dev)
        s = torch.einsum("bqkgd,bjkd->bqkgj", qg[:, r0:], kb)   # (b, sq - r0, kh, g, chunk)
        if causal:
            mask = kv_pos[None, :] <= q_pos[r0:, None]
        else:
            mask = torch.ones((sq, kv_chunk), dtype=torch.bool, device=dev)
        mask = mask & (kv_pos < skv)[None, :]
        s = s.masked_fill(~mask[None, :, None, None, :], NEG_INF)
        m_r = m[:, r0:]
        m_new = torch.maximum(m_r, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_r - m_new)
        l_new = l[:, r0:] * corr + p.sum(dim=-1)
        pv = torch.einsum("bqkgj,bjkd->bqkgd", p, vb)
        acc_new = acc[:, r0:] * corr[..., None] + pv
        if r0:
            m_new = torch.cat([m[:, :r0], m_new], dim=1)
            l_new = torch.cat([l[:, :r0], l_new], dim=1)
            acc_new = torch.cat([acc[:, :r0], acc_new], dim=1)
        m, l, acc = m_new, l_new, acc_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, sq, h, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


def cross_entropy_logits(logits: torch.Tensor, labels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Token-mean CE.  logits (..., v) f32; labels/mask (...).

    The label is read as ``jnp.take_along_axis`` reads it: a label in
    ``[-v, 0)`` wraps once, and one still outside ``[0, v)`` picks NaN
    (so its row's loss is NaN, masked or not), without a host sync."""
    logits = logits.float()
    v = logits.shape[-1]
    lab = labels.long()
    lab = torch.where(lab < 0, lab + v, lab)
    ok = (lab >= 0) & (lab < v)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lab.clamp(0, v - 1)[..., None])[..., 0]
    ll = torch.where(ok, ll, torch.full_like(ll, float("nan")))
    nll = (lse - ll) * mask
    return torch.sum(nll) / torch.clamp(torch.sum(mask), min=1.0)


def _stack_sum(fabric, x: torch.Tensor) -> torch.Tensor:
    """The shards' ``(S_l, ...)`` partials summed over the model axis
    (every shard uses the sum alike), or the one shard's."""
    return x[0] if fabric is None else reduce_from(fabric, x)


def _xent_chunk(hb: torch.Tensor, heads: torch.Tensor, lb: torch.Tensor,
                mb: torch.Tensor, n_valid_vocab: Optional[int], offsets, fabric
                ) -> torch.Tensor:
    """One chunk's summed masked NLL (the reference's scan body) over the
    vocabulary blocks ``heads`` ``(S_l, d, v_loc)``, local shard ``j``
    holding global columns ``[offsets[j] * v_loc, (offsets[j] + 1) *
    v_loc)``: each shard's float32 logits, the pad columns (global index
    from ``n_valid_vocab``) ``-1e30``; the row maximum over every shard
    (``pmax``), each shard's sum of exponentials and the label's logit
    summed over the shards (``fabric``; ``None``: the one shard).  The
    label is picked as the reference's one-hot picks it: from the shard
    whose columns hold it, and a label outside ``[0, V_pad)`` picks 0
    (no wrap, no NaN) and carries no gradient.  The maximum carries no
    gradient (it cancels)."""
    v_loc = heads.shape[2]
    lab = lb.long()
    logits, maxes, picks = [], [], []
    for j, c in enumerate(offsets):
        lg = (hb @ heads[j]).float()                          # (b, chunk, v_loc)
        lo = c * v_loc
        if n_valid_vocab is not None and n_valid_vocab < lo + v_loc:
            bad = lo + torch.arange(v_loc, device=lg.device) >= n_valid_vocab
            lg = lg.masked_fill(bad, NEG_INF)
        local = lab - lo
        mine = (local >= 0) & (local < v_loc)
        ll = torch.gather(lg, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
        picks.append(torch.where(mine, ll, torch.zeros_like(ll)))
        maxes.append(lg.detach().amax(-1))
        logits.append(lg)
    m = torch.stack(maxes)
    m = m[0] if fabric is None else fabric.pmax(m)
    sums = torch.stack([torch.exp(lg - m[..., None]).sum(-1) for lg in logits])
    lse = m + torch.log(_stack_sum(fabric, sums))
    return torch.sum((lse - _stack_sum(fabric, torch.stack(picks))) * mb)


def chunked_softmax_xent(
    hidden: torch.Tensor,     # (b, s, d) final hidden states
    lm_head: torch.Tensor,    # (d, v), or (S_l, d, v_loc) with vocab_blocks
    labels: torch.Tensor,     # (b, s) int
    mask: torch.Tensor,       # (b, s)
    chunk: int = 1024,
    n_valid_vocab: Optional[int] = None,  # mask padded vocab columns
    count: Optional[torch.Tensor] = None,  # the normaliser's token count
    *,
    vocab_blocks: Optional[Tuple[Any, Any]] = None,
) -> torch.Tensor:
    """CE without materialising ``(b, s, v)`` logits: a loop over sequence
    chunks, the sequence zero-padded to a multiple of ``chunk``.

    Each chunk's ``(b, chunk, v)`` logits are reduced to their masked NLL
    sum under ``torch.utils.checkpoint``, so autograd keeps only the
    chunk's inputs and recomputes its logits in the backward pass, one
    chunk at a time: at 4096 tokens and 49,152 columns, float32 logits
    are 805 MB a sequence.  Columns from ``n_valid_vocab`` on are
    ``-1e30``.  The NLL sum is divided by ``max(count, 1)``: the mask's
    count, or ``count`` where a caller sums shares of a larger batch.

    ``vocab_blocks`` ``(offsets, fabric)`` makes it vocab-parallel:
    ``lm_head`` holds the local shards' column blocks, shard ``j`` the
    ``offsets[j]``-th, and ``fabric`` (the model axis's) reduces the row
    maximum, the sums of exponentials and the label's logit over the
    shards (``_xent_chunk``), and under autograd sums ``hidden``'s gradient
    over them (``copy_to``).  The one-device loss is the one-shard case of
    the same body."""
    if vocab_blocks is None:
        heads, offsets, fabric = lm_head[None], [0], None
    else:
        heads, (offsets, fabric) = lm_head, vocab_blocks
        if fabric is not None:      # each shard's columns give part of its gradient
            hidden = copy_to(fabric, hidden)
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    n = -(-s // chunk)
    pad = n * chunk - s
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    own_count = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n):
        sl = slice(c * chunk, (c + 1) * chunk)
        hb, lb, mb = hidden[:, sl], labels[:, sl], mask[:, sl]
        args = (hb, heads, lb, mb, n_valid_vocab, offsets, fabric)
        if torch.is_grad_enabled():
            nll = checkpoint(_xent_chunk, *args, use_reentrant=False)
        else:
            nll = _xent_chunk(*args)
        total = total + nll
        own_count = own_count + torch.sum(mb.float())
    if count is None:
        count = own_count
    return total / torch.clamp(count.reshape(()), min=1.0)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               scale: str = "fan_in", device=None) -> torch.Tensor:
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    std = (1.0 / fan_in) ** 0.5
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * std


def embed_init(gen: torch.Generator, shape: Tuple[int, ...],
               std: float = 0.02, device=None) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * std


def dense_stack(gen: torch.Generator, n: int, shape: Tuple[int, ...],
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``n`` independent ``dense_init(shape)`` draws stacked on axis 0,
    each cast to ``dtype`` as it is stored."""
    out = torch.empty((n,) + shape, dtype=dtype, device=gen.device)
    for i in range(n):
        out[i] = dense_init(gen, shape, device=gen.device)
    return out


def params_from_reference(tree: Dict[str, Any], device: DeviceLike = None) -> Dict[str, Any]:
    """The reference's parameter pytree, as numpy arrays, as the port's
    tensors on ``device``: the identity on names and layouts."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.as_tensor(np.require(np.asarray(node), requirements="W"),
                               device=dev)

    return conv(tree)
