"""Content baselines the paper compares Pixie against (Table 1), twin of
``repro/core/baselines.py``.

* **textual**: cosine similarity over one noisy projection of the topic
  vectors (the paper: word2vec annotations);
* **visual**: Hamming distance over a second projection, binarized at 0
  (the paper: VGG-16 fc6 codes);
* **combined**: rank-sum fusion of the two.

``make_content_embeddings`` and ``hit_rate_at_k`` are numpy, with the
reference's ``default_rng`` draws.  The three scorers take tensors on any
device and give the same bits on every device: the cosine's row norm and
its product with the query are written as float32 elementwise steps in
the order XLA's CPU backend computes them for the reference's width (64
columns), so the ranks the combined scorer fuses are the reference's too:

  * a row sum of squares: windows of 32 columns, each summed left to
    right, then the window sums left to right;
  * the product with the query: 8 accumulators (column ``j`` goes to
    accumulator ``j % 8``), each a chain of fused multiply-adds, then
    added as ``((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7))``.

Both orders were read off the reference on the CPU at that width; at
other widths the scores may part from it by float32 rounding (the tests
bound that by 2e-6).  Ranks break ties by index (a stable sort), as
``jnp.argsort`` does.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.sampling import _fma_f32

_WINDOW = 32      # XLA's CPU row-reduction window
_LANES = 8        # XLA's CPU matrix-vector accumulators


def make_content_embeddings(
    pin_topics: np.ndarray,
    dim: int = 64,
    noise: float = 0.25,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Project topic vectors into two noisy "modalities" (textual, visual)."""
    rng = np.random.default_rng(seed)
    nt = pin_topics.shape[1]
    proj_t = rng.normal(size=(nt, dim)).astype(np.float32)
    proj_v = rng.normal(size=(nt, dim)).astype(np.float32)
    text = pin_topics @ proj_t + noise * rng.normal(
        size=(pin_topics.shape[0], dim)
    ).astype(np.float32)
    vis = pin_topics @ proj_v + noise * rng.normal(
        size=(pin_topics.shape[0], dim)
    ).astype(np.float32)
    return text, vis


def _chain(cols) -> torch.Tensor:
    acc = torch.zeros_like(cols[0])
    for c in cols:
        acc = acc + c
    return acc


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over axis 1 in XLA's CPU order (windows of 32)."""
    cols = [x[:, j] for j in range(x.shape[1])]
    while len(cols) > _WINDOW:
        cols = [_chain(cols[i:i + _WINDOW]) for i in range(0, len(cols), _WINDOW)]
    return _chain(cols)


def _matvec(e: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``e @ q`` in XLA's CPU order: 8 fused multiply-add chains, then a
    pairwise tree."""
    acc = [torch.zeros(e.shape[0], dtype=torch.float32, device=e.device)
           for _ in range(_LANES)]
    for j in range(e.shape[1]):
        acc[j % _LANES] = _fma_f32(e[:, j], q[j], acc[j % _LANES])
    while len(acc) > 1:
        acc = [acc[i] + acc[i + 1] for i in range(0, len(acc), 2)]
    return acc[0]


def cosine_rank_scores(embeddings: torch.Tensor, query) -> torch.Tensor:
    """Scores of every pin for a query pin under cosine similarity."""
    x = embeddings.float()
    norm = torch.sqrt(_row_sum(x * x).double()).float()
    e = x / torch.clamp(norm, min=1e-9)[:, None]
    return _matvec(e, e[int(query)])


def hamming_rank_scores(embeddings: torch.Tensor, query) -> torch.Tensor:
    """Binarize at 0, then score by negative Hamming distance (visual)."""
    bits = embeddings > 0.0
    q = bits[int(query)]
    return -(bits != q[None, :]).sum(1, dtype=torch.int32).float()


def _ranks(s: torch.Tensor) -> torch.Tensor:
    """Rank of each entry under a stable descending sort (-0.0 == 0.0)."""
    order = torch.argsort(-s + 0.0, stable=True)
    r = torch.empty_like(order, dtype=torch.int32)
    r[order] = torch.arange(s.shape[0], dtype=torch.int32, device=s.device)
    return r


def combined_rank_scores(text: torch.Tensor, vis: torch.Tensor, query) -> torch.Tensor:
    """Rank-sum fusion of textual-cosine and visual-Hamming rankings."""
    st = cosine_rank_scores(text, query)
    sv = hamming_rank_scores(vis, query)
    return -(_ranks(st) + _ranks(sv)).float()


def hit_rate_at_k(scores: np.ndarray, target: int, ks=(10, 100, 1000)) -> dict:
    """Fraction helper: was `target` ranked in the top-k (per query)."""
    order = np.argsort(-scores)
    pos = int(np.where(order == target)[0][0])
    return {k: float(pos < k) for k in ks}
