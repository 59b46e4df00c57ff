"""DLRM (arXiv:1906.00091): mega-table embeddings, dot interaction, MLPs.

Twin of ``repro/models/dlrm.py`` for the dlrm-mlperf and dlrm-rm2
configs: the same ``DLRMConfig``, parameter tree and functions.  The
sparse lookup is ``embedding.lookup`` (gathered in the table's dtype,
bf16 in the full configs, then cast to the float32 compute dtype); the
dot interaction is the lower triangle of ``Z Z^T`` over the stacked
``[bottom-MLP output; 26 embeddings]``, read in ``jnp.tril_indices``'
row-major order (``torch.tril_indices(f, f, -1)`` is the same order).

``retrieval_score`` scores one user against ``n_cand`` items by varying
sparse slot 0.  Rows are independent, so the port runs the candidate
axis in chunks of ``RETRIEVAL_CHUNK`` rows (dlrm-mlperf's 48 GB table
leaves no room for a million candidates' activations at once: ~28 GB
more in one chunk, ~5 GB in chunks of 2^17), merging each chunk's top-k
in candidate order under ``lax.top_k``'s rule (``counter.topk_total``):
the same result as one chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch import abstract
from repro_torch.core import counter
from repro_torch.models import embedding, layers

RETRIEVAL_CHUNK = 2**17   # candidates scored at once by retrieval_score


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    n_dense: int
    embed_dim: int
    bot_mlp: Tuple[int, ...]      # includes input dim, e.g. (13, 512, 256, 128)
    top_mlp: Tuple[int, ...]      # hidden dims + 1 output, e.g. (1024, 1024, 512, 256, 1)
    feature_rows: Tuple[int, ...]  # rows per sparse feature
    compute_dtype: Any = torch.float32
    table_dtype: Any = torch.float32   # bf16 halves the table at scale

    @property
    def n_sparse(self) -> int:
        return len(self.feature_rows)

    @property
    def table(self) -> embedding.MegaTableConfig:
        return embedding.MegaTableConfig(self.feature_rows, self.embed_dim)

    @property
    def n_interactions(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2

    @property
    def top_in(self) -> int:
        return self.bot_mlp[-1] + self.n_interactions

    def param_count(self) -> int:
        n = self.table.total_rows * self.embed_dim
        dims_b = self.bot_mlp
        for i in range(len(dims_b) - 1):
            n += dims_b[i] * dims_b[i + 1] + dims_b[i + 1]
        dims_t = (self.top_in,) + self.top_mlp
        for i in range(len(dims_t) - 1):
            n += dims_t[i] * dims_t[i + 1] + dims_t[i + 1]
        return n


def _init_mlp(gen: torch.Generator, dims: Sequence[int]) -> Dict[str, torch.Tensor]:
    p = {}
    for i in range(len(dims) - 1):
        p[f"w{i}"] = layers.dense_init(gen, (dims[i], dims[i + 1]), device=gen.device)
        p[f"b{i}"] = torch.zeros((dims[i + 1],), dtype=torch.float32, device=gen.device)
    return p


def _mlp_logical(dims: Sequence[int]) -> Dict[str, Tuple]:
    p = {}
    for i in range(len(dims) - 1):
        p[f"w{i}"] = ("mlp_in", "mlp_out")
        p[f"b{i}"] = ("mlp_out",)
    return p


def _mlp_fwd(p: Dict[str, torch.Tensor], x: torch.Tensor, n: int,
             final_act: bool) -> torch.Tensor:
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = torch.relu(x)
    return x


def init_params(gen: torch.Generator, cfg: DLRMConfig) -> Dict[str, Any]:
    """The reference's tree, drawn from ``gen`` on its device."""
    return {
        "table": embedding.init_table(gen, cfg.table, dtype=cfg.table_dtype),
        "bot": _init_mlp(gen, cfg.bot_mlp),
        "top": _init_mlp(gen, (cfg.top_in,) + cfg.top_mlp),
    }


def abstract_params(cfg: DLRMConfig) -> Dict[str, Any]:
    """``init_params``' tree as meta tensors (the dry run; no allocation)."""
    return abstract.abstract_of(lambda: init_params(torch.Generator(), cfg))


def param_logical(cfg: DLRMConfig) -> Dict[str, Any]:
    return {
        "table": embedding.table_logical(),
        "bot": _mlp_logical(cfg.bot_mlp),
        "top": _mlp_logical((cfg.top_in,) + cfg.top_mlp),
    }


def _interact(bot_out: torch.Tensor, sparse: torch.Tensor) -> torch.Tensor:
    """Dot interaction: lower triangle of Z Z^T, Z = [bot; embeddings]."""
    z = torch.cat([bot_out[:, None, :], sparse], dim=1)        # (b, f+1, d)
    zz = torch.einsum("bfd,bgd->bfg", z, z)                     # (b, f+1, f+1)
    f = z.shape[1]
    ii, jj = torch.tril_indices(f, f, offset=-1, device=z.device)
    return zz[:, ii, jj]                                        # (b, f(f-1)/2)


def forward(
    params: Dict[str, Any],
    dense: torch.Tensor,       # (b, n_dense) f32
    sparse_ids: torch.Tensor,  # (b, n_sparse) int32 per-feature local ids
    cfg: DLRMConfig,
) -> torch.Tensor:
    """CTR logits ``(b,)`` float32."""
    cd = cfg.compute_dtype
    bot_out = _mlp_fwd(params["bot"], dense.to(cd), len(cfg.bot_mlp) - 1,
                       final_act=True)
    sparse = embedding.lookup(params["table"], sparse_ids, cfg.table)
    inter = _interact(bot_out, sparse.to(cd))
    top_in = torch.cat([bot_out, inter], dim=-1)
    logits = _mlp_fwd(params["top"], top_in, len(cfg.top_mlp), final_act=False)
    return logits[:, 0].float()


def bce_loss(
    params: Dict[str, Any],
    dense: torch.Tensor,
    sparse_ids: torch.Tensor,
    labels: torch.Tensor,      # (b,) float 0/1
    cfg: DLRMConfig,
) -> torch.Tensor:
    logits = forward(params, dense, sparse_ids, cfg)
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def retrieval_score(
    params: Dict[str, Any],
    dense: torch.Tensor,       # (n_dense,) one user's dense features
    sparse_ids: torch.Tensor,  # (n_sparse,) one user's sparse ids
    candidates: torch.Tensor,  # (n_cand,) candidate ids for sparse slot 0
    cfg: DLRMConfig,
    top_k: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score one user against ``n_cand`` items (slot 0 varies),
    ``RETRIEVAL_CHUNK`` candidates at a time -> ``(scores, ids)``."""
    n = candidates.shape[0]
    if not 0 <= top_k <= n:
        raise ValueError(f"top_k={top_k} must lie in [0, {n}]")
    best_v = best_i = None
    for c0 in range(0, max(n, 1), RETRIEVAL_CHUNK):   # n = 0: one empty chunk
        cand = candidates[c0:c0 + RETRIEVAL_CHUNK]
        m = cand.shape[0]
        ids_b = sparse_ids[None, :].expand(m, cfg.n_sparse).clone()
        ids_b[:, 0] = cand
        scores = forward(params, dense[None, :].expand(m, cfg.n_dense), ids_b, cfg)
        v, i = counter.topk_total(scores, min(top_k, m))
        i = i.long() + c0
        if best_v is not None:
            # earlier chunks hold lower candidate indices and sit first,
            # so a tie keeps the lower index, as one top_k over all would
            both = torch.cat([best_v, v])
            v, at = counter.topk_total(both, min(top_k, both.numel()))
            i = torch.cat([best_i, i])[at.long()]
        best_v, best_i = v, i
    return best_v, candidates[best_i]
