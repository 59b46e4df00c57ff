"""The port's host-side paper features against the reference, on the CPU.

* Content baselines (``core/baselines.py``, Table 1): the embeddings bit
  for bit (the same ``default_rng`` draws); Hamming and combined scores
  bit for bit; cosine scores bit for bit at the reference's width (64
  columns: the row norm and the product with the query are written in
  XLA's CPU order), and within 2e-6 absolute at a width where that order
  is not reproduced; ``hit_rate_at_k`` on the port's scores equal to the
  reference's.
* The sequential oracle (``core/reference.py``): Algorithms 1-3 and Eq. 1
  bit for bit for the same seeds, read from the port's graph; and the
  port's vectorized walk against it statistically, as the reference's
  ``tests/test_walk.py`` holds the JAX engine (total-variation distance
  under 0.15 unbiased, 0.2 biased).
* ``graphs/sampler.py`` and ``graphs/gnn_data.py``: every array bit for
  bit for the same seed (and sampling step).
* ``sampling.restart_mask`` / ``step_key`` and ``counter.dense_accumulate``
  / ``dense_accumulate_flat``: bit for bit, negative and past-the-end ids
  included (the reference's ``mode="drop"`` wraps a negative id once,
  then drops what is still out of range).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import counter as jcounter
from repro.core import graph as jgraph
from repro.core import reference as jref
from repro.core import sampling as jsampling
from repro.graphs import gnn_data as jgnn
from repro.graphs import sampler as jsampler
from repro.graphs import synthetic as jsyn
from repro_torch.core import baselines, counter, prng, reference, sampling, walk
from repro_torch.core import graph as tgraph
from repro_torch.graphs import gnn_data, sampler

COSINE_TOL = 2e-6


@pytest.fixture(scope="module")
def sg():
    return jsyn.small_test_graph(0)


@pytest.fixture(scope="module")
def both(sg):
    """The small graph compiled by both packages from one edge list."""
    pins, boards = jgraph.edge_list(sg.graph)
    kw = dict(edge_feat=sg.board_lang[boards], n_feats=3,
              edge_feat_b2p=sg.pin_lang[pins])
    n = (sg.graph.n_pins, sg.graph.n_boards)
    return (jgraph.build_graph(pins, boards, *n, **kw),
            tgraph.build_graph(pins, boards, *n, **kw))


def _topics(n, nt=16, seed=0):
    rng = np.random.default_rng(seed)
    return rng.dirichlet(np.full(nt, 0.1), n).astype(np.float32)


# ---------------------------------------------------------------------------
# content baselines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def embeddings():
    topics = _topics(20_000)
    return {
        "port": baselines.make_content_embeddings(topics, seed=0),
        "ref": jbase.make_content_embeddings(topics, seed=0),
    }


def test_content_embeddings_match_reference(embeddings):
    for a, b in zip(embeddings["port"], embeddings["ref"]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("query", [0, 1, 4_321, 19_999])
def test_rank_scores_match_reference(embeddings, query):
    text, vis = (torch.as_tensor(a) for a in embeddings["port"])
    jt, jv = (jnp.asarray(a) for a in embeddings["ref"])
    pairs = {
        "cosine": (baselines.cosine_rank_scores(text, query),
                   jbase.cosine_rank_scores(jt, query)),
        "hamming": (baselines.hamming_rank_scores(vis, query),
                    jbase.hamming_rank_scores(jv, query)),
        "combined": (baselines.combined_rank_scores(text, vis, query),
                     jbase.combined_rank_scores(jt, jv, query)),
    }
    for name, (got, want) in pairs.items():
        assert got.dtype == torch.float32, name
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        hits = baselines.hit_rate_at_k(got.numpy(), (query + 7) % 20_000)
        assert hits == jbase.hit_rate_at_k(np.asarray(want), (query + 7) % 20_000)


@pytest.mark.parametrize("dim", [20, 100])
def test_cosine_scores_within_tolerance_at_other_widths(dim):
    """At widths off the 32-multiple the XLA order is not reproduced: the
    scores agree to float32 rounding, within COSINE_TOL."""
    text, _ = jbase.make_content_embeddings(_topics(3_000, seed=dim), dim=dim)
    got = baselines.cosine_rank_scores(torch.as_tensor(text), 11).numpy()
    want = np.asarray(jbase.cosine_rank_scores(jnp.asarray(text), 11))
    assert np.abs(got - want).max() <= COSINE_TOL


def test_combined_ranks_ties_break_by_index():
    """Hamming scores are small integers with many ties: the fused rank
    sums follow a stable sort (jnp.argsort's), zero scores included."""
    rng = np.random.default_rng(5)
    text = rng.normal(size=(500, 64)).astype(np.float32)
    vis = np.sign(rng.normal(size=(500, 64))).astype(np.float32)
    vis[100:140] = vis[3]                      # exact Hamming ties with the query
    text[200] = 0.0                            # a zero row (norm floor)
    got = baselines.combined_rank_scores(torch.as_tensor(text), torch.as_tensor(vis), 3)
    want = jbase.combined_rank_scores(jnp.asarray(text), jnp.asarray(vis), 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the sequential oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_oracle_walks_match_reference(both, seed):
    jg, tg = both
    q = 5
    np.testing.assert_array_equal(
        reference.basic_random_walk_ref(tg, q, 0.5, 3_000, seed=seed),
        jref.basic_random_walk_ref(jg, q, 0.5, 3_000, seed=seed))
    for feat in (None, 1):
        np.testing.assert_array_equal(
            reference.pixie_random_walk_ref(tg, q, feat, 0.5, 3_000, 20, 4, seed=seed),
            jref.pixie_random_walk_ref(jg, q, feat, 0.5, 3_000, 20, 4, seed=seed))
    query = {5: 1.0, 17: 0.5, 80: 2.0}
    np.testing.assert_array_equal(
        reference.pixie_random_walk_multiple_ref(tg, query, 2, 0.5, 4_000, 20, 4, seed=seed),
        jref.pixie_random_walk_multiple_ref(jg, query, 2, 0.5, 4_000, 20, 4, seed=seed))
    rng_a, rng_b = np.random.default_rng(seed), np.random.default_rng(seed)
    assert [reference.sample_walk_length(rng_a, 0.3) for _ in range(50)] == [
        jref.sample_walk_length(rng_b, 0.3) for _ in range(50)]
    for deg in (0, 1, 7, jg.max_pin_degree):
        assert reference.scaling_factor_ref(deg, jg.max_pin_degree) == \
            jref.scaling_factor_ref(deg, jg.max_pin_degree)


def _tv(a, b) -> float:
    pa = a / max(a.sum(), 1)
    pb = b / max(b.sum(), 1)
    return 0.5 * float(np.abs(pa - pb).sum())


def _top_pin(tg) -> int:
    return int(np.argmax(tg.p2b.degrees().numpy()))


def test_port_basic_walk_matches_oracle_distribution(both):
    _, tg = both
    q = _top_pin(tg)
    v_ref = reference.basic_random_walk_ref(tg, q, alpha=0.5, n_steps=40_000, seed=3)
    cfg = walk.WalkConfig(n_steps=40_000, n_walkers=512, bias_beta=0.0,
                          n_p=10**9, n_v=10**9)
    v = walk.basic_random_walk(tg, q, prng.key(0, "cpu"), cfg).numpy()
    assert _tv(v_ref, v) < 0.15


def test_port_biased_walk_matches_biased_oracle(both):
    _, tg = both
    q = _top_pin(tg)
    v_ref = reference.pixie_random_walk_ref(
        tg, q, user_feat=1, alpha=0.5, n_steps=30_000, n_p=10**9, n_v=10**9,
        beta=0.9, seed=5)
    cfg = walk.WalkConfig(n_steps=30_000, n_walkers=512, bias_beta=0.9,
                          n_p=10**9, n_v=10**9)
    res = walk.pixie_random_walk(
        tg, torch.tensor([q], dtype=torch.int32), torch.ones(1), 1,
        prng.key(1, "cpu"), cfg)
    assert _tv(v_ref, res.counts[0].numpy()) < 0.2


# ---------------------------------------------------------------------------
# sampler and GNN data
# ---------------------------------------------------------------------------


def _assert_tuples_equal(a, b):
    assert type(a).__name__ == type(b).__name__
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("make,kw", [
    ("planted_partition", dict(n_nodes=500, n_edges=3_000, d_feat=12, n_classes=5,
                               seed=4, p_intra=0.6)),
    ("cora_like", dict(scale=0.05, seed=1)),
    ("reddit_like", dict(scale=1e-4)),
    ("products_like", dict(scale=1e-4, seed=2)),
    ("molecule_batch", dict(batch=6, nodes_per=12, edges_per=20, seed=3)),
])
def test_gnn_data_matches_reference(make, kw):
    _assert_tuples_equal(getattr(gnn_data, make)(**kw), getattr(jgnn, make)(**kw))


def test_fanout_sampler_matches_reference():
    g = jgnn.cora_like(scale=0.1)
    n = g.feats.shape[0]
    tcsr = sampler.csr_from_edges(g.edge_src, g.edge_dst, n)
    jcsr = jsampler.csr_from_edges(g.edge_src, g.edge_dst, n)
    _assert_tuples_equal(tcsr, jcsr)
    seeds = np.arange(0, 64, 3, dtype=np.int32)
    for fanouts, step in (((15, 10), 0), ((4, 3, 2), 7)):
        ts = sampler.FanoutSampler(tcsr, fanouts, seed=9)
        js = jsampler.FanoutSampler(jcsr, fanouts, seed=9)
        assert ts.max_nodes(len(seeds)) == js.max_nodes(len(seeds))
        assert ts.max_edges(len(seeds)) == js.max_edges(len(seeds))
        tb, jb = ts.sample(seeds, step), js.sample(seeds, step)
        _assert_tuples_equal(tb, jb)
        ta = sampler.block_to_arrays(tb, g.feats, g.labels)
        ja = jsampler.block_to_arrays(jb, g.feats, g.labels)
        assert ta.keys() == ja.keys()
        for k in ta:
            assert ta[k].dtype == ja[k].dtype, k
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)


# ---------------------------------------------------------------------------
# the helpers of sampling.py and counter.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (-5, 2**20)])
@pytest.mark.parametrize("alpha", [0.5, 0.15, 1e-7, 0.9999999])
def test_restart_mask_and_step_key_match_reference(seed, step, alpha):
    tk = sampling.step_key(prng.key(seed, "cpu"), step)
    jk = jsampling.step_key(jax.random.key(seed), step)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jax.random.key_data(jk)))
    for shape in ((1_000,), (7, 33), 5):
        got = sampling.restart_mask(tk, shape, alpha)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsampling.restart_mask(jk, shape, alpha)))


def test_dense_accumulate_drop_mode_contract():
    """ids [-1, 5, 2, -6] into 5 bins: -1 wraps to bin 4, 5 and -6 drop."""
    got = counter.dense_accumulate_flat(
        torch.zeros(5, dtype=torch.int32), torch.tensor([-1, 5, 2, -6]),
        torch.ones(4, dtype=torch.bool))
    assert got.tolist() == [0, 0, 1, 0, 1]


@pytest.mark.parametrize("n_slots,n_pins,m", [(1, 5, 4), (3, 17, 200), (4, 64, 1_000)])
def test_dense_accumulate_matches_reference(n_slots, n_pins, m):
    rng = np.random.default_rng(n_pins)
    counts = rng.integers(0, 9, (n_slots, n_pins)).astype(np.int32)
    pins = rng.integers(-2 * n_pins, 2 * n_pins, (n_slots, m)).astype(np.int32)
    valid = rng.random((n_slots, m)) < 0.7
    t = torch.as_tensor
    got = counter.dense_accumulate(t(counts), t(pins), t(valid))
    want = jcounter.dense_accumulate(jnp.asarray(counts), jnp.asarray(pins), jnp.asarray(valid))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    got = counter.dense_accumulate_flat(t(counts[0]), t(pins[0]), t(valid[0]))
    want = jcounter.dense_accumulate_flat(
        jnp.asarray(counts[0]), jnp.asarray(pins[0]), jnp.asarray(valid[0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
