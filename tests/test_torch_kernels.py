"""The port's kernel twins and counters against the JAX package.

On the CPU every kernel wrapper of the port takes its plain twin, so the
twins are held here against ``repro.kernels.ref`` (and once each against
the Pallas kernel in interpret mode), on the same numpy inputs, exactly.
The dense counter layer, the Eq. 3 booster and the tie rule of the top-k
are held against ``repro.core.counter``.  The CUDA kernels themselves
are held against these twins on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counter as jcounter
from repro.graphs.synthetic import small_test_graph
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels import visit_counter as jvc
from repro_torch.core import counter as tcounter
from repro_torch.kernels import ops as tops
from repro_torch.kernels import visit_counter as tvc
from repro_torch.kernels import walk_step as tws

ALPHA_U32 = int(round(0.5 * 2**32))
BETA_U32 = int(round(0.9 * 2**32))


@pytest.fixture(scope="module")
def g():
    return small_test_graph(0).graph



def _csr(g, to):
    arrays = (g.p2b.offsets, g.p2b.targets, g.b2p.offsets, g.b2p.targets,
              g.p2b.feat_bounds, g.b2p.feat_bounds)
    return tuple(to(np.asarray(a)) for a in arrays)


def _torch(a, device="cpu"):
    return torch.tensor(np.asarray(a), device=device)


def _walkers(g, n_queries, w, chunk_steps, seed=0, n_slots=3):
    rng = np.random.default_rng(seed)
    n = n_queries * w
    degs = np.diff(np.asarray(g.p2b.offsets))
    live = np.nonzero(degs > 0)[0]
    dead = np.nonzero(degs == 0)[0]
    curr = rng.choice(live, n).astype(np.int32)
    if dead.size:  # a few dead-end starts exercise the invalid-event path
        curr[:3] = dead[0]
    query = rng.choice(live, n).astype(np.int32)
    feat = rng.integers(0, 3, n).astype(np.int32)
    slot = rng.integers(0, n_slots, n).astype(np.int32)
    qid = np.repeat(np.arange(n_queries, dtype=np.int32), w)
    rbits = rng.integers(0, 2**32, (chunk_steps, n, 4), dtype=np.uint64)
    return curr, query, feat, slot, qid, rbits.astype(np.uint32)


def _assert_lanes_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), i
        if a is not None:
            assert a.dtype == torch.int32, i
            np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b), err_msg=str(i))


@pytest.mark.parametrize("count_boards", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mode", ["per_query", "batched"])
def test_walk_chunk_twin_matches_reference(g, mode, bias, count_boards):
    n_queries = 1 if mode == "per_query" else 4
    curr, query, feat, slot, qid, rbits = _walkers(g, n_queries, 96, 5)
    beta = BETA_U32 if bias else 0
    kw = dict(n_pins=g.n_pins, n_slots=3, n_boards=g.n_boards,
              alpha_u32=ALPHA_U32, beta_u32=beta, count_boards=count_boards)
    jcsr = _csr(g, jnp.asarray)
    tcsr = _csr(g, _torch)
    rb_t = _torch(rbits.view(np.int32))
    if mode == "per_query":
        want = ref.walk_chunk_ref(*map(jnp.asarray, (curr, query, feat, slot, rbits)),
                                  *jcsr, **kw)
        got = tws.walk_chunk_plain(*map(_torch, (curr, query, feat, slot)), rb_t,
                                   *tcsr, **kw)
    else:
        want = ref.walk_chunk_batched_ref(
            *map(jnp.asarray, (curr, query, feat, slot, qid, rbits)), *jcsr,
            n_queries=n_queries, **kw)
        got = tws.walk_chunk_batched_plain(
            *map(_torch, (curr, query, feat, slot, qid)), rb_t, *tcsr,
            n_queries=n_queries, **kw)
    _assert_lanes_equal(got, want)
    sev = np.asarray(got[-3])
    assert (sev == 3).any() and (sev < 3).any()  # valid and dead-end events


def test_walk_chunk_twin_matches_pallas_kernel_in_interpret_mode(g):
    n_queries, w, chunk = 2, 8, 2
    curr, query, feat, slot, qid, rbits = _walkers(g, n_queries, w, chunk, seed=3)
    kw = dict(n_pins=g.n_pins, n_slots=3, n_queries=n_queries,
              n_boards=g.n_boards, alpha_u32=ALPHA_U32, beta_u32=BETA_U32,
              count_boards=True)
    want = jops.walk_chunk_fused_batched(
        *map(jnp.asarray, (curr, query, feat, slot, qid, rbits)),
        *_csr(g, jnp.asarray), use_kernel=True, **kw)
    got = tops.walk_chunk_words_batched_plain(
        *map(_torch, (curr, query, feat, slot, qid)), _torch(rbits.view(np.int32)),
        *_csr(g, _torch), **kw)
    _assert_lanes_equal(got, want)


def _events(seed, m, n_queries, n_slots, n_dim):
    """Random wide lanes with sentinels and out-of-range values mixed in."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, n_queries + 1, m).astype(np.int32)   # n_queries = sentinel
    s = rng.integers(0, n_slots + 1, m).astype(np.int32)     # n_slots = sentinel
    i = rng.integers(0, n_dim, m).astype(np.int32)
    s[:5] = -1
    i[5:10] = n_dim
    # hot bins so counts cross n_v within one update
    i[10:200] = rng.integers(0, 4, 190)
    return q, s, i


@pytest.mark.parametrize("with_query", [False, True])
def test_update_high_twin_matches_reference(with_query):
    n_queries, n_slots, n_pins, n_v = 3, 2, 40, 4
    q, s, p = _events(1, 900, n_queries, n_slots, n_pins)
    n_rows = n_queries * n_slots if with_query else n_slots
    prior = np.random.default_rng(2).integers(0, 6, n_rows * n_pins).astype(np.int32)
    qe = q if with_query else None
    nq = n_queries if with_query else 0
    want_c, want_d = ref.visit_counter_update_high_ref(
        jnp.asarray(prior), jnp.asarray(s), jnp.asarray(p), n_slots, n_pins, n_v,
        None if qe is None else jnp.asarray(qe), nq)
    counts = _torch(prior.copy())
    delta = tvc.visit_counter_update_high_plain(
        counts, _torch(s), _torch(p), None if qe is None else _torch(qe),
        n_slots=n_slots, n_pins=n_pins, n_v=n_v, n_queries=nq)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(delta.numpy(), np.asarray(want_d))
    assert delta.dtype == torch.int32 and int(delta.sum()) > 0


@pytest.mark.parametrize("with_query", [False, True])
def test_wide_twin_matches_reference(with_query):
    n_queries, n_slots, n_dim = 3, 2, 30
    q, s, i = _events(5, 700, n_queries, n_slots, n_dim)
    qe = q if with_query else None
    nq = n_queries if with_query else 0
    n_rows = n_queries * n_slots if with_query else n_slots
    want = ref.visit_counter_wide_ref(
        jnp.asarray(s), jnp.asarray(i), n_slots, n_dim,
        None if qe is None else jnp.asarray(qe), nq)
    base = np.arange(n_rows * n_dim, dtype=np.int32)
    counts = _torch(base.copy())
    out = tvc.visit_counter_wide_plain(
        counts, _torch(s), _torch(i), None if qe is None else _torch(qe),
        n_slots=n_slots, n_dim=n_dim, n_queries=nq)
    assert out is counts  # in place
    np.testing.assert_array_equal(counts.numpy(), base + np.asarray(want))


def test_counter_twins_match_pallas_kernels_in_interpret_mode():
    n_queries, n_slots, n_pins, n_v = 2, 2, 48, 3
    q, s, p = _events(7, 600, n_queries, n_slots, n_pins)
    prior = np.random.default_rng(3).integers(0, 4, n_queries * n_slots * n_pins)
    prior = prior.astype(np.int32)
    want_c, want_d = jvc.visit_counter_update_high(
        jnp.asarray(prior), jnp.asarray(s), jnp.asarray(p), jnp.asarray(q),
        n_slots=n_slots, n_pins=n_pins, n_v=n_v, n_queries=n_queries)
    counts = _torch(prior.copy())
    delta = tops.visit_counts_update_high(
        counts, _torch(s), _torch(p), _torch(q), n_slots=n_slots,
        n_pins=n_pins, n_v=n_v, n_queries=n_queries, use_kernel=True)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(delta.numpy(), np.asarray(want_d))

    want_w = jvc.visit_counter_wide(
        jnp.asarray(s), jnp.asarray(p), jnp.asarray(q),
        n_slots=n_slots, n_dim=n_pins, n_queries=n_queries)
    wide = torch.zeros(n_queries * n_slots * n_pins, dtype=torch.int32)
    tops.visit_counts_wide(wide, _torch(s), _torch(p), _torch(q), n_slots=n_slots,
                           n_dim=n_pins, n_queries=n_queries, use_kernel=True)
    np.testing.assert_array_equal(wide.numpy(), np.asarray(want_w))


def test_dense_bin_rule_is_enforced():
    z = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        tvc.visit_counter_wide_plain(z, z, z, n_slots=8, n_dim=2**28)
    with pytest.raises(ValueError, match="n_v must be >= 1"):
        tvc.visit_counter_update_high_plain(z, z, z, n_slots=1, n_pins=1, n_v=0)


# ---------------------------------------------------------------------------
# Counter layer: accumulate + tally, Eq. 3 booster, top-k ties
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_accumulate_with_high_matches_reference_counter(backend):
    n_queries, n_slots, n_pins, n_v = 3, 2, 40, 3
    q, s, p = _events(11, 1000, n_queries, n_slots, n_pins)
    counts0 = np.zeros(n_queries * n_slots * n_pins, np.int32)
    high0 = np.zeros(n_queries * n_slots, np.int32)
    jc, jh = jnp.asarray(counts0), jnp.asarray(high0)
    tc, th = _torch(counts0.copy()), _torch(high0.copy())
    for chunk in np.array_split(np.arange(1000), 4):
        jc, jh = jcounter.accumulate_packed_events_with_high(
            jc, jh, jnp.asarray(s[chunk]), jnp.asarray(p[chunk]), n_slots,
            n_pins, n_v, "xla", query_events=jnp.asarray(q[chunk]),
            n_queries=n_queries)
        tc, th = tcounter.accumulate_packed_events_with_high(
            tc, th, _torch(s[chunk]), _torch(p[chunk]), n_slots, n_pins, n_v,
            backend, query_events=_torch(q[chunk]), n_queries=n_queries)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


@pytest.mark.parametrize("n_slots", [1, 3, 8, 16])
@pytest.mark.parametrize("weighted", [False, True])
def test_boost_combine_matches_reference(n_slots, weighted):
    rng = np.random.default_rng(n_slots)
    counts = rng.integers(0, 5000, (4, n_slots, 700)).astype(np.int32)
    counts[:, :, :50] = rng.integers(0, 3, (4, n_slots, 50))
    weights = rng.uniform(0.1, 2.0, (4, n_slots)).astype(np.float32)
    if weighted:
        want = jax.vmap(jcounter.boost_combine)(jnp.asarray(counts), jnp.asarray(weights))
        got = tcounter.boost_combine(_torch(counts), _torch(weights))
    else:
        want = jax.vmap(jcounter.boost_combine)(jnp.asarray(counts))
        got = tcounter.boost_combine(_torch(counts))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_boost_sqrt_is_correctly_rounded():
    """torch's float32 CPU sqrt is not correctly rounded for integers from
    267 up; the booster's float64 route is, like jnp.sqrt.  One slot makes
    Eq. 3 the squared root, so the check sees every rounding."""
    x = np.arange(0, 1_000_000, dtype=np.int32)
    root = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = tcounter.boost_combine(_torch(x)[None, :])
    np.testing.assert_array_equal(got.numpy(), root * root)
    np.testing.assert_array_equal(
        np.asarray(jcounter.boost_combine(jnp.asarray(x)[None, :])), root * root)


@pytest.mark.parametrize("k", [1, 7, 100, 400])
def test_topk_dense_reproduces_lax_top_k_ties(k):
    rng = np.random.default_rng(k)
    x = rng.integers(0, 4, (3, 400)).astype(np.float32)  # heavy ties
    x[1] = 0.0                                            # an all-tie row
    want_v, want_i = jax.vmap(lambda r: jcounter.topk_dense(r, k))(jnp.asarray(x))
    got_v, got_i = tcounter.topk_dense(_torch(x), k)
    assert got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    with pytest.raises(ValueError, match="top_k"):
        tcounter.topk_dense(_torch(x), 401)


def test_n_high_visited_matches():
    counts = np.random.default_rng(0).integers(0, 8, (2, 3, 50)).astype(np.int32)
    np.testing.assert_array_equal(
        tcounter.n_high_visited(_torch(counts), 4).numpy(),
        np.asarray(jcounter.n_high_visited(jnp.asarray(counts), 4)))
