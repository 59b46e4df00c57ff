"""Batches past 12,288 counter rows, on the CPU.

The reference's ``visit_counter_update_high`` takes any row count, and its
``batched_engine_fits`` sends every batch whose query-major bins fit int32
to the batch-native engine: a shape that serves must never become an
error.  The port's kernel once kept its crossing tally in 48 KB of shared
memory and refused more than 12,288 rows (``n_queries * n_slots``), while
``serve_batch`` still routed such batches to it.  Held here:

* the twin (what the CPU runs, and what the card is checked against) with
  a prior tally, bit for bit ``ref.visit_counter_update_high_ref`` plus
  that tally at 12,289 and 16,384 rows, with a query lane and without;
* the kernel wrapper refuses CPU tensors at 16,384 rows for their device,
  and for nothing else: it has no row cap;
* ``serve_batch(backend="pallas")`` at 1,537 queries x 8 slots on
  ``small_test_graph`` takes the batched engine and equals the per-query
  engine bit for bit under the same keys.

The card's side (the kernel == twin past the cap, a sharded batch past
it) is in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import prng, service, walk
from repro_torch.graphs import synthetic
from repro_torch.kernels import visit_counter as vc

N_PINS = 12
PAST_CAP_QUERIES = 1_537      # x 8 slots = 12,296 rows


def _lanes(seed, m, n_rows, with_query):
    """Events over ``n_rows`` rows (sentinel lanes included), hot pins so
    that bins cross n_v, as (q, s, p, n_slots, n_queries)."""
    rng = np.random.default_rng(seed)
    p = rng.integers(0, N_PINS, m).astype(np.int32)
    p[: m // 2] = rng.integers(0, 3, m // 2)
    if with_query:
        n_slots = 8 if n_rows % 8 == 0 else 1
        n_queries = n_rows // n_slots
        q = rng.integers(0, n_queries + 1, m).astype(np.int32)   # + sentinel
        s = rng.integers(0, n_slots + 1, m).astype(np.int32)
        return q, s, p, n_slots, n_queries
    s = rng.integers(-1, n_rows + 1, m).astype(np.int32)         # both ends
    return None, s, p, n_rows, 0


@pytest.mark.parametrize("n_rows", [12_289, 16_384])
@pytest.mark.parametrize("with_query", [True, False], ids=["query_lane", "no_query_lane"])
def test_twin_matches_reference_past_the_old_cap(n_rows, with_query):
    n_v = 2
    q, s, p, n_slots, n_queries = _lanes(n_rows, 60_000, n_rows, with_query)
    rng = np.random.default_rng(1)
    prior_c = rng.integers(0, 3, n_rows * N_PINS).astype(np.int32)
    prior_h = rng.integers(0, 9, n_rows).astype(np.int32)
    want_c, delta = jref.visit_counter_update_high_ref(
        jnp.asarray(prior_c), jnp.asarray(s), jnp.asarray(p), n_slots, N_PINS,
        n_v, None if q is None else jnp.asarray(q), n_queries)
    counts = torch.from_numpy(prior_c.copy())
    high = torch.from_numpy(prior_h.copy())
    got = vc.visit_counter_update_high_plain(
        counts, torch.from_numpy(s), torch.from_numpy(p),
        None if q is None else torch.from_numpy(q), n_slots=n_slots,
        n_pins=N_PINS, n_v=n_v, n_queries=n_queries, high=high)
    assert got is high
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(high.numpy(), prior_h + np.asarray(delta))
    assert int(np.asarray(delta).sum()) > 0


def test_wrapper_has_no_row_cap():
    n_queries, n_slots = 2_048, 8
    q, s, p, _, _ = _lanes(3, 1_000, n_queries * n_slots, True)
    t = torch.from_numpy
    counts = torch.zeros(n_queries * n_slots * N_PINS, dtype=torch.int32)
    with pytest.raises(ValueError) as err:
        vc.visit_counter_update_high(counts, t(s), t(p), t(q), n_slots=n_slots,
                                     n_pins=N_PINS, n_v=2, n_queries=n_queries)
    assert "runs on CUDA tensors" in str(err.value)
    assert not hasattr(vc, "MAX_HIGH_ROWS")


def test_serve_batch_past_the_old_cap_takes_the_batched_engine(monkeypatch):
    graph = synthetic.small_test_graph(0, device="cpu").graph
    cfg = walk.WalkConfig(n_steps=48, n_walkers=8, chunk_steps=2, top_k=10,
                          n_p=4, n_v=2, backend="pallas")
    n_slots = 8
    rng = np.random.default_rng(4)
    live = np.nonzero(graph.p2b.degrees().numpy() > 0)[0]
    pins = np.full((PAST_CAP_QUERIES, n_slots), -1, np.int32)
    weights = np.zeros((PAST_CAP_QUERIES, n_slots), np.float32)
    for i in range(PAST_CAP_QUERIES):
        k = 1 + i % n_slots
        pins[i, :k] = rng.choice(live, k, replace=False)
        weights[i, :k] = rng.uniform(0.2, 1.0, k)
    feats = (np.arange(PAST_CAP_QUERIES) % 3).astype(np.int32)
    args = (graph, torch.from_numpy(pins), torch.from_numpy(weights),
            torch.from_numpy(feats), prng.key(11, "cpu"))
    assert PAST_CAP_QUERIES * n_slots > 12_288
    assert walk.batched_engine_fits(PAST_CAP_QUERIES, n_slots, graph.n_pins,
                                    graph.n_boards)

    calls = []
    real = walk.recommend_with_stats_batched

    def spy(*a, **kw):
        calls.append(a[1].shape)
        return real(*a, **kw)

    monkeypatch.setattr(walk, "recommend_with_stats_batched", spy)
    got = service.serve_batch(*args, cfg, with_stats=True)
    assert calls == [(PAST_CAP_QUERIES, n_slots)]
    want = service.serve_batch(*args, dataclasses.replace(cfg, backend="xla"),
                               with_stats=True)
    assert len(calls) == 1                  # the per-query engine ran
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(got[3].sum()) > 0            # early-stop tallies crossed
