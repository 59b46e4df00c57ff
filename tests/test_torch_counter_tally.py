"""The in-place crossing tally of ``visit_counter_update_high``, on the CPU.

The reference's ``visit_counter_update_high`` returns a fresh ``(n_rows,)``
delta and its caller adds it to the running tally.  The port's kernel adds
the crossings into the caller's tally in place, one launch per counting
call, and its plain twin (what the CPU runs) takes the same ``high``
argument.  Held here bit for bit against ``ref.visit_counter_update_high_ref``
plus a prior tally, at the three call sites' shapes: the per-query walk
(one row per slot), the batch-native walk (a query lane, one row per
(query, slot)) and the sharded engine (each local shard's row of an
``(n_local, n_rows)`` tally, passed as a view).  Without ``high`` the
twin still returns the reference's fresh delta.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.core import counter
from repro_torch.kernels import ops
from repro_torch.kernels import visit_counter as vc


def _events(seed, m, n_queries, n_slots, n_pins):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, n_queries + 1, m).astype(np.int32)   # n_queries = sentinel
    s = rng.integers(0, n_slots + 1, m).astype(np.int32)     # n_slots = sentinel
    p = rng.integers(0, n_pins, m).astype(np.int32)
    p[: m // 4] = rng.integers(0, 4, m // 4)                 # hot bins cross n_v
    return q, s, p


def _ref(prior_counts, prior_high, s, p, q, n_slots, n_pins, n_v, n_queries):
    c, d = jref.visit_counter_update_high_ref(
        jnp.asarray(prior_counts), jnp.asarray(s), jnp.asarray(p), n_slots,
        n_pins, n_v, None if q is None else jnp.asarray(q), n_queries)
    return np.asarray(c), prior_high + np.asarray(d)


@pytest.mark.parametrize("with_query", [False, True], ids=["per_query", "batched"])
def test_in_place_tally_matches_reference_plus_prior(with_query):
    n_queries, n_slots, n_pins, n_v = 3, 4, 50, 3
    q, s, p = _events(1, 1200, n_queries, n_slots, n_pins)
    qe = q if with_query else None
    nq = n_queries if with_query else 0
    n_rows = n_queries * n_slots if with_query else n_slots
    rng = np.random.default_rng(2)
    prior_c = rng.integers(0, 4, n_rows * n_pins).astype(np.int32)
    prior_h = rng.integers(0, 9, n_rows).astype(np.int32)
    want_c, want_h = _ref(prior_c, prior_h, s, p, qe, n_slots, n_pins, n_v, nq)
    counts = torch.from_numpy(prior_c.copy())
    high = torch.from_numpy(prior_h.copy())
    got = vc.visit_counter_update_high_plain(
        counts, torch.from_numpy(s), torch.from_numpy(p),
        None if qe is None else torch.from_numpy(qe), n_slots=n_slots,
        n_pins=n_pins, n_v=n_v, n_queries=nq, high=high)
    assert got is high
    np.testing.assert_array_equal(counts.numpy(), want_c)
    np.testing.assert_array_equal(high.numpy(), want_h)
    assert (want_h > prior_h).any()


def test_sharded_rows_are_updated_through_views():
    n_local, n_queries, n_slots, pps, n_v = 3, 2, 2, 40, 2
    n_rows = n_queries * n_slots
    rng = np.random.default_rng(5)
    counts = torch.from_numpy(rng.integers(0, 3, (n_local, n_rows * pps)).astype(np.int32))
    high = torch.from_numpy(rng.integers(0, 5, (n_local, n_rows)).astype(np.int32))
    want_c, want_h = counts.numpy().copy(), high.numpy().copy()
    for sh in range(n_local):
        q, s, p = _events(10 + sh, 500, n_queries, n_slots, pps)
        want_c[sh], want_h[sh] = _ref(want_c[sh], want_h[sh], s, p, q,
                                      n_slots, pps, n_v, n_queries)
        _, out = counter.accumulate_packed_events_with_high(
            counts[sh], high[sh], torch.from_numpy(s), torch.from_numpy(p),
            n_slots, pps, n_v, "pallas", query_events=torch.from_numpy(q),
            n_queries=n_queries)
        assert out.data_ptr() == high[sh].data_ptr()
    np.testing.assert_array_equal(counts.numpy(), want_c)
    np.testing.assert_array_equal(high.numpy(), want_h)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_without_a_tally_a_fresh_delta_is_returned(use_kernel):
    n_slots, n_pins, n_v = 2, 30, 2
    _, s, p = _events(3, 400, 1, n_slots, n_pins)
    prior = np.zeros(n_slots * n_pins, np.int32)
    want_c, want_d = _ref(prior, np.zeros(n_slots, np.int32), s, p, None,
                          n_slots, n_pins, n_v, 0)
    counts = torch.from_numpy(prior.copy())
    delta = ops.visit_counts_update_high(
        counts, torch.from_numpy(s), torch.from_numpy(p), n_slots=n_slots,
        n_pins=n_pins, n_v=n_v, use_kernel=use_kernel)
    assert delta.dtype == torch.int32 and delta.shape == (n_slots,)
    np.testing.assert_array_equal(counts.numpy(), want_c)
    np.testing.assert_array_equal(delta.numpy(), want_d)


def test_bad_tallies_are_refused():
    z = torch.zeros(8, dtype=torch.int32)
    kw = dict(n_slots=2, n_pins=4, n_v=1)
    with pytest.raises(ValueError, match=r"\(2,\) int32"):
        vc.visit_counter_update_high_plain(z, z, z, high=torch.zeros(3, dtype=torch.int32), **kw)
    with pytest.raises(ValueError, match=r"\(2,\) int32"):
        vc.visit_counter_update_high_plain(z, z, z, high=torch.zeros(2), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        vc.visit_counter_update_high_plain(
            z, z, z, high=torch.zeros(4, dtype=torch.int32)[::2], **kw)
