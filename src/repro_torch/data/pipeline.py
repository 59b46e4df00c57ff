"""Stateless, step-indexed synthetic data pipelines (host numpy).

A copy of ``repro/data/pipeline.py`` (which imports no JAX; the port keeps
its own copy rather than import the reference): every batch equals the
reference's bit for bit for the same ``(step, seed)``.

Every batch is a pure function of (step, seed) — ``batch = f(step)`` —
which is the property the resilience layer depends on: replaying a step
after a restore reproduces the exact batch, making recovery deterministic.
The generators return numpy arrays; the caller moves them to its device.

  * ``TokenPipeline``     — zipf-distributed LM token streams with a planted
    bigram structure (so loss actually falls);
  * ``ClickLogPipeline``  — DLRM-style click logs: dense features + zipf
    sparse ids, labels from a planted logistic model (learnable);
  * ``SeqRecPipeline``    — user item-sequences with Markov item-item
    transitions for SASRec/BST (+ negatives).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

Array = np.ndarray


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2

    def __call__(self, step: int) -> Dict[str, Array]:
        rng = _rng(self.seed, step)
        # planted structure: token t prefers to be followed by (t*7+3) % V
        base = np.minimum(
            rng.zipf(self.zipf_a, size=(self.batch, self.seq_len)),
            self.vocab_size - 1,
        ).astype(np.int32)
        follow = (base * 7 + 3) % self.vocab_size
        use_follow = rng.random((self.batch, self.seq_len)) < 0.5
        tokens = base.copy()
        tokens[:, 1:] = np.where(
            use_follow[:, 1:], follow[:, :-1], base[:, 1:]
        )
        labels = np.zeros_like(tokens)
        labels[:, :-1] = tokens[:, 1:]
        mask = np.ones_like(tokens, np.float32)
        mask[:, -1] = 0.0
        return {"tokens": tokens, "labels": labels, "mask": mask}


@dataclasses.dataclass(frozen=True)
class ClickLogPipeline:
    n_dense: int
    feature_rows: Tuple[int, ...]
    batch: int
    seed: int = 0

    def __call__(self, step: int) -> Dict[str, Array]:
        rng = _rng(self.seed, step)
        dense = rng.normal(size=(self.batch, self.n_dense)).astype(np.float32)
        sparse = np.stack(
            [
                np.minimum(rng.zipf(1.2, size=self.batch) - 1, rows - 1)
                for rows in self.feature_rows
            ],
            axis=1,
        ).astype(np.int32)
        # planted logistic model over dense feats + a few id buckets
        w = _rng(self.seed, 0).normal(size=self.n_dense)
        logit = dense @ w + 0.3 * ((sparse[:, 0] % 7) - 3)
        prob = 1.0 / (1.0 + np.exp(-logit))
        labels = (rng.random(self.batch) < prob).astype(np.float32)
        return {"dense": dense, "sparse": sparse, "labels": labels}


@dataclasses.dataclass(frozen=True)
class SeqRecPipeline:
    n_items: int
    batch: int
    seq_len: int
    n_negatives: int = 0
    with_candidate: bool = False   # BST mode
    seed: int = 0

    def __call__(self, step: int) -> Dict[str, Array]:
        rng = _rng(self.seed, step)
        # Markov chain: item i tends to transition to (i*13+7) % V
        first = np.minimum(
            rng.zipf(1.3, size=self.batch) - 1, self.n_items - 1
        ).astype(np.int32)
        seq = np.zeros((self.batch, self.seq_len + 1), np.int32)
        seq[:, 0] = first
        for t in range(1, self.seq_len + 1):
            hot = (seq[:, t - 1] * 13 + 7) % self.n_items
            rand = np.minimum(
                rng.zipf(1.3, size=self.batch) - 1, self.n_items - 1
            )
            seq[:, t] = np.where(rng.random(self.batch) < 0.6, hot, rand)
        out: Dict[str, Array] = {"seq": seq[:, :-1]}
        if self.with_candidate:
            # candidate = true next item half the time (label 1), else random
            pos = seq[:, -1]
            neg = rng.integers(0, self.n_items, self.batch).astype(np.int32)
            is_pos = rng.random(self.batch) < 0.5
            out["candidate"] = np.where(is_pos, pos, neg).astype(np.int32)
            out["labels"] = is_pos.astype(np.float32)
        else:
            out["targets"] = seq[:, 1:]
            if self.n_negatives:
                out["negatives"] = rng.integers(
                    0, self.n_items,
                    (self.batch, self.seq_len, self.n_negatives),
                ).astype(np.int32)
        return out
