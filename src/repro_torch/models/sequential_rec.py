"""Sequential recommenders: SASRec (arXiv:1808.09781) and BST (1905.06874).

Twin of ``repro/models/sequential_rec.py``: the same ``SeqRecConfig``, the
same parameter tree (``blocks`` leaves stacked on axis 0, BST's ``head``
as ``w{i}`` / ``b{i}``) and the same forward functions.

SASRec: causal self-attention over the user's item sequence; next-item
training with sampled softmax; serving scores the last position's state
against candidate item embeddings.  BST: bidirectional attention over
``[behavior sequence; candidate item]``, then an MLP head (leaky ReLU,
slope 0.01, between its layers) on the flattened output gives the CTR
logit.  Both read the item mega-table (``models/embedding.py``).

As in the reference, and not "fixed" here:

  * a ``-1`` history id embeds row 0 times 0, still gets its position
    embedding, and is attended to (there is no key mask, only the causal
    one); the user state is ``h[:, -1]`` whatever the padding;
  * candidate, target and negative ids are read as ``jnp.take`` reads
    them (``embedding.take_rows``: negative ids wrap once, ids past the
    table give NaN), and rows between ``n_items`` and the padded
    ``total_rows`` are real drawn rows;
  * ``score_candidates`` orders its top-k as ``lax.top_k`` does, NaN
    first (``counter.topk_total``).

The blocks run as a Python loop where the reference scans; attention is
``layers.flash_attention`` with ``kv_chunk=min(512, s)``.  The losses are
forward values only.  ``init_params`` draws from an explicit
``torch.Generator`` with the reference's shapes and standard deviations;
``params_from_reference`` carries the reference's own arrays across.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import abstract
from repro_torch.core import counter
from repro_torch.models import embedding, layers

# the reference's tree as the port's tensors, as for the LM
params_from_reference = layers.params_from_reference


@dataclasses.dataclass(frozen=True)
class SeqRecConfig:
    name: str
    kind: str                 # 'sasrec' | 'bst'
    n_items: int
    embed_dim: int
    seq_len: int
    n_blocks: int
    n_heads: int
    mlp_dims: Tuple[int, ...] = ()   # BST head MLP (hidden dims, out=1 appended)
    d_ff: Optional[int] = None       # pointwise FFN width (default embed_dim)
    n_negatives: int = 127           # sampled-softmax negatives (training)
    dropout: float = 0.0             # kept for config fidelity; eval path only
    compute_dtype: Any = torch.float32
    unroll_layers: bool = False      # the reference's cost-model knob; ignored

    @property
    def ff(self) -> int:
        return self.d_ff if self.d_ff is not None else self.embed_dim

    @property
    def table(self) -> embedding.MegaTableConfig:
        return embedding.MegaTableConfig((self.n_items,), self.embed_dim)

    def param_count(self) -> int:
        d = self.embed_dim
        blk = 4 * d * d + 2 * d * self.ff + 4 * d  # qkvo + ffn + norms
        n = self.n_items * d + self.seq_len * d + self.n_blocks * blk
        if self.kind == "bst":
            dims = _head_dims(self)
            for i in range(len(dims) - 1):
                n += dims[i] * dims[i + 1] + dims[i + 1]
        return n


def _head_dims(cfg: SeqRecConfig) -> Tuple[int, ...]:
    return ((cfg.seq_len + 1) * cfg.embed_dim,) + cfg.mlp_dims + (1,)


def init_params(gen: torch.Generator, cfg: SeqRecConfig) -> Dict[str, Any]:
    """The reference's tree, drawn from ``gen`` on its device."""
    d, n, dev = cfg.embed_dim, cfg.n_blocks, gen.device
    total_len = cfg.seq_len + (1 if cfg.kind == "bst" else 0)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=dev)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    p: Dict[str, Any] = {
        "items": embedding.init_table(gen, cfg.table),
        "pos": layers.embed_init(gen, (total_len, d), device=dev),
        "blocks": {
            "ln1_w": ones(n, d), "ln1_b": zeros(n, d),
            "wq": layers.dense_stack(gen, n, (d, d)),
            "wk": layers.dense_stack(gen, n, (d, d)),
            "wv": layers.dense_stack(gen, n, (d, d)),
            "wo": layers.dense_stack(gen, n, (d, d)),
            "ln2_w": ones(n, d), "ln2_b": zeros(n, d),
            "w1": layers.dense_stack(gen, n, (d, cfg.ff)), "b1": zeros(n, cfg.ff),
            "w2": layers.dense_stack(gen, n, (cfg.ff, d)), "b2": zeros(n, d),
        },
        "final_ln_w": ones(d),
        "final_ln_b": zeros(d),
    }
    if cfg.kind == "bst":
        dims = _head_dims(cfg)
        p["head"] = {}
        for i in range(len(dims) - 1):
            p["head"][f"w{i}"] = layers.dense_init(gen, (dims[i], dims[i + 1]),
                                                   device=dev)
            p["head"][f"b{i}"] = zeros(dims[i + 1])
    return p


def abstract_params(cfg: SeqRecConfig) -> Dict[str, Any]:
    """``init_params``' tree as meta tensors (the dry run; no allocation)."""
    return abstract.abstract_of(lambda: init_params(torch.Generator(), cfg))


def param_logical(cfg: SeqRecConfig) -> Dict[str, Any]:
    blk = {
        "ln1_w": ("layers", None), "ln1_b": ("layers", None),
        "wq": ("layers", "dim", "dim"), "wk": ("layers", "dim", "dim"),
        "wv": ("layers", "dim", "dim"), "wo": ("layers", "dim", "dim"),
        "ln2_w": ("layers", None), "ln2_b": ("layers", None),
        "w1": ("layers", "dim", "mlp_out"), "b1": ("layers", "mlp_out"),
        "w2": ("layers", "mlp_out", "dim"), "b2": ("layers", "dim"),
    }
    p: Dict[str, Any] = {
        "items": embedding.table_logical(),
        "pos": ("seq", "dim"),
        "blocks": blk,
        "final_ln_w": (None,),
        "final_ln_b": (None,),
    }
    if cfg.kind == "bst":
        dims = _head_dims(cfg)
        p["head"] = {}
        for i in range(len(dims) - 1):
            p["head"][f"w{i}"] = ("mlp_in", "mlp_out")
            p["head"][f"b{i}"] = ("mlp_out",)
    return p


# ---------------------------------------------------------------------------
# Transformer encoder over item sequences
# ---------------------------------------------------------------------------


def _encode(
    params: Dict[str, Any],
    seq_ids: torch.Tensor,            # (b, s) int32, -1 padding
    cfg: SeqRecConfig,
    causal: bool,
    extra: Optional[torch.Tensor] = None,   # (b, 1, d) appended position (BST)
) -> torch.Tensor:
    cd = cfg.compute_dtype
    b, s = seq_ids.shape
    valid = seq_ids >= 0
    safe = torch.where(valid, seq_ids, 0)
    x = embedding.take_rows(params["items"], safe).to(cd)
    x = x * valid[..., None].to(cd)
    if extra is not None:
        x = torch.cat([x, extra.to(cd)], dim=1)
        s = s + 1
    x = x + params["pos"][:s].to(cd)[None]
    blocks = params["blocks"]
    for i in range(blocks["wq"].shape[0]):
        p = {k: v[i] for k, v in blocks.items()}
        h = layers.layernorm(x, p["ln1_w"], p["ln1_b"])
        q = (h @ p["wq"]).reshape(b, s, cfg.n_heads, -1)
        k = (h @ p["wk"]).reshape(b, s, cfg.n_heads, -1)
        v = (h @ p["wv"]).reshape(b, s, cfg.n_heads, -1)
        attn = layers.flash_attention(q, k, v, causal=causal, kv_chunk=min(512, s))
        x = x + attn.reshape(b, s, cfg.embed_dim) @ p["wo"]
        h2 = layers.layernorm(x, p["ln2_w"], p["ln2_b"])
        x = x + (torch.relu(h2 @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"])
    return layers.layernorm(x, params["final_ln_w"], params["final_ln_b"])


# ---------------------------------------------------------------------------
# SASRec: next-item with sampled softmax
# ---------------------------------------------------------------------------


def sasrec_loss(
    params: Dict[str, Any],
    seq_ids: torch.Tensor,        # (b, s) history, -1 padding
    targets: torch.Tensor,        # (b, s) next item at each position, -1 = no loss
    negatives: torch.Tensor,      # (b, s, n_neg) sampled negative item ids
    cfg: SeqRecConfig,
) -> torch.Tensor:
    h = _encode(params, seq_ids, cfg, causal=True)          # (b, s, d)
    valid = (targets >= 0).float()
    pos_emb = embedding.take_rows(params["items"], torch.clamp(targets, min=0))
    neg_emb = embedding.take_rows(params["items"], negatives)  # (b, s, n, d)
    pos_logit = torch.sum(h * pos_emb, dim=-1, keepdim=True)
    neg_logit = torch.einsum("bsd,bsnd->bsn", h, neg_emb)
    logits = torch.cat([pos_logit, neg_logit], dim=-1)
    # sampled softmax: the positive is class 0
    lse = torch.logsumexp(logits, dim=-1)
    nll = (lse - logits[..., 0]) * valid
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1.0)


def sasrec_user_state(params: Dict[str, Any], seq_ids: torch.Tensor,
                      cfg: SeqRecConfig) -> torch.Tensor:
    """Last-position hidden state per user -> ``(b, d)``."""
    return _encode(params, seq_ids, cfg, causal=True)[:, -1]


def score_candidates(
    params: Dict[str, Any],
    user_state: torch.Tensor,     # (b, d)
    candidates: torch.Tensor,     # (n_cand,) item ids
    cfg: SeqRecConfig,
    top_k: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched dot-product retrieval -> ``(scores (b, k), ids (b, k))``."""
    cand_emb = embedding.take_rows(params["items"], candidates)   # (n, d)
    scores = user_state @ cand_emb.T                              # (b, n)
    vals, idx = counter.topk_total(scores, top_k)
    return vals, candidates[idx.long()]


# ---------------------------------------------------------------------------
# BST: CTR prediction for (behavior sequence, candidate item)
# ---------------------------------------------------------------------------


def bst_forward(
    params: Dict[str, Any],
    seq_ids: torch.Tensor,        # (b, s)
    candidate: torch.Tensor,      # (b,) target item
    cfg: SeqRecConfig,
) -> torch.Tensor:
    """CTR logits ``(b,)`` float32."""
    cand_emb = embedding.take_rows(params["items"], candidate)[:, None, :]
    h = _encode(params, seq_ids, cfg, causal=False, extra=cand_emb)
    x = h.reshape(h.shape[0], -1)
    n = len(cfg.mlp_dims) + 1
    for i in range(n):
        x = x @ params["head"][f"w{i}"] + params["head"][f"b{i}"]
        if i < n - 1:
            x = torch.nn.functional.leaky_relu(x, 0.01)   # jax.nn.leaky_relu's slope
    return x[:, 0].float()


def bst_loss(
    params: Dict[str, Any],
    seq_ids: torch.Tensor,
    candidate: torch.Tensor,
    labels: torch.Tensor,         # (b,) 0/1
    cfg: SeqRecConfig,
) -> torch.Tensor:
    logits = bst_forward(params, seq_ids, candidate, cfg)
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )
