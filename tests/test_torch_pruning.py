"""The port's graph pruning (``repro_torch/core/pruning.py``) against the
reference's (``repro/core/pruning.py``), on the CPU.

Both packages' ``build_graph`` compile one numpy edge list (with the edge
languages), on ``small_test_graph`` and on the benchmarks' 20k-pin graph
(``benchmarks/common.py`` ``bench_graph``: 20,000 pins, 2,000 boards, 16
topics, seed 7).  Held here:

* ``board_entropy`` and ``cosine_sim`` bit for bit (numpy's pairwise
  row sums, its correctly rounded float32 ``sqrt``; float64 ``log``
  from torch, whose agreement with ``np.log`` is measured and reported);
* ``prune_graph``'s CSR arrays and stats equal to the reference's, array
  for array, at delta 1.0 / 0.91 / 0.65 and board fraction 0 / 0.1, with
  and without languages, in one pass and in many small ones;
* the port's graph compiler, whose stable counting sort pruned graphs
  are compiled by, equal to the reference's when split into many passes;
* the reference's own pruning invariants
  (``tests/test_counters_and_pruning.py``), run on the port;
* no two boards tie at the entropy cut on these graphs (the port drops
  tied boards lowest index first; numpy's unstable sort picks its own);
* ``ceil(d**delta)`` for every degree 0..10,000 at each delta: the port's
  table (numpy's ``**``) and torch's ``pow`` on the CPU both equal the
  reference's.

The card's side (the card's prune equal to the CPU's) is in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import pruning as jpruning
from repro.graphs import synthetic as jsyn
from repro_torch.core import graph as tgraph
from repro_torch.core import pruning

DELTAS = (1.0, 0.91, 0.65)
FRACS = (0.0, 0.1)
SWEEP_DELTAS = (1.0, 0.95, 0.91, 0.9, 0.8, 0.7, 0.65, 0.6, 0.1)


def _bench_cfg():
    return jsyn.SyntheticGraphConfig(
        n_pins=20_000, n_boards=2_000, n_topics=16, n_langs=4, seed=7)


@pytest.fixture(scope="module")
def graphs():
    """name -> (reference synthetic graph, reference graph, port graph),
    both compiled from the reference graph's own edge list."""
    out = {}
    for name, sg, n_langs in (
        ("small", jsyn.small_test_graph(0), 3),
        ("bench20k", jsyn.generate(_bench_cfg()), 4),
    ):
        pins, boards = jgraph.edge_list(sg.graph)
        kw = dict(edge_feat=sg.board_lang[boards], n_feats=n_langs,
                  edge_feat_b2p=sg.pin_lang[pins])
        n = (sg.graph.n_pins, sg.graph.n_boards)
        out[name] = (sg, jgraph.build_graph(pins, boards, *n, **kw),
                     tgraph.build_graph(pins, boards, *n, **kw), n_langs)
    return out


def _same_graph(t, j):
    a = tgraph.graph_to_numpy(t)
    b = {"p2b_offsets": j.p2b.offsets, "p2b_targets": j.p2b.targets,
         "b2p_offsets": j.b2p.offsets, "b2p_targets": j.b2p.targets}
    if j.p2b.feat_bounds is not None:
        b["p2b_feat_bounds"] = j.p2b.feat_bounds
        b["b2p_feat_bounds"] = j.b2p.feat_bounds
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], np.asarray(b[k]), err_msg=k)
    assert (t.n_pins, t.n_boards, t.max_pin_degree) == (
        j.n_pins, j.n_boards, j.max_pin_degree)


@pytest.mark.parametrize("name", ["small", "bench20k"])
def test_board_entropy_matches_reference(graphs, name):
    sg, jg, _, _ = graphs[name]
    pins, boards = jgraph.edge_list(jg)
    want = jpruning.board_entropy(pins, boards, sg.pin_topics, jg.n_boards)
    got = pruning.board_entropy(pins, boards, sg.pin_topics, jg.n_boards)
    assert got.dtype == torch.float32
    diff = np.abs(got.numpy().astype(np.float64) - want)
    assert np.array_equal(got.numpy(), want), (
        f"{int((diff > 0).sum())} boards differ, by at most {diff.max()}")


def test_board_entropy_follows_the_edge_order_given():
    """An edge list in any order: each board sums in that order."""
    rng = np.random.default_rng(3)
    pins = rng.integers(0, 50, 400)
    boards = rng.integers(0, 9, 400)
    topics = rng.dirichlet(np.full(5, 0.05), 50).astype(np.float32)
    topics[::7] *= np.float32(1e-6)          # magnitudes that round apart
    np.testing.assert_array_equal(
        pruning.board_entropy(pins, boards, topics, 11).numpy(),
        jpruning.board_entropy(pins, boards, topics, 11))


@pytest.mark.parametrize("name", ["small", "bench20k"])
def test_float64_log_agrees_with_numpy(graphs, name):
    """The entropy's float64 log is torch's: count where it parts from
    np.log on these graphs' board distributions (0 on this host)."""
    sg, jg, _, _ = graphs[name]
    pins, boards = jgraph.edge_list(jg)
    sums = np.zeros((jg.n_boards, sg.pin_topics.shape[1]))
    np.add.at(sums, boards, sg.pin_topics[pins].astype(np.float64))
    dist = np.maximum(sums / np.maximum(sums.sum(1, keepdims=True), 1e-12), 1e-12)
    got = torch.log(torch.as_tensor(dist)).numpy()
    n_diff = int((got != np.log(dist)).sum())
    assert n_diff == 0, f"torch.log parts from np.log at {n_diff} values"


@pytest.mark.parametrize("nt", [1, 3, 6, 8, 15, 16, 17, 40, 200])
def test_cosine_sim_matches_reference(nt):
    """Every branch of numpy's pairwise sum (n < 8, 8..128, > 128)."""
    rng = np.random.default_rng(nt)
    a = rng.dirichlet(np.full(nt, 0.1), 4000).astype(np.float32)
    b = rng.dirichlet(np.full(nt, 0.1), 4000).astype(np.float32)
    a[:50] = 0.0                                    # the eps floor
    b[::9] *= np.float32(1e3)
    got = pruning.cosine_sim(a, b)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), jpruning.cosine_sim(a, b))


def _prune_both(graphs, name, frac, delta, langs):
    sg, jg, tg, n_langs = graphs[name]
    kw = (dict(board_lang=sg.board_lang, pin_lang=sg.pin_lang, n_langs=n_langs)
          if langs else {})
    if not langs:       # the same edges, compiled without languages
        pins, boards = jgraph.edge_list(jg)
        n = (jg.n_pins, jg.n_boards)
        jg, tg = jgraph.build_graph(pins, boards, *n), tgraph.build_graph(pins, boards, *n)
    want = jpruning.prune_graph(
        jg, sg.pin_topics, None, jpruning.PruneConfig(frac, delta), **kw)
    got = pruning.prune_graph(
        tg, sg.pin_topics, None, pruning.PruneConfig(frac, delta), **kw)
    return got, want


@pytest.mark.parametrize("langs", [True, False], ids=["langs", "no_langs"])
@pytest.mark.parametrize("frac", FRACS)
@pytest.mark.parametrize("delta", DELTAS)
@pytest.mark.parametrize("name,chunk_edges", [
    ("small", pruning.CHUNK_EDGES), ("small", 97), ("bench20k", 8192)])
def test_prune_graph_matches_reference(graphs, monkeypatch, name, chunk_edges,
                                      delta, frac, langs):
    monkeypatch.setattr(pruning, "CHUNK_EDGES", chunk_edges)
    (pt, st), (pj, sj) = _prune_both(graphs, name, frac, delta, langs)
    _same_graph(pt, pj)
    assert st == sj


def test_prune_graph_takes_given_board_topics_and_tensors(graphs):
    """Given board topics (the reference's third argument), and every
    input as a tensor."""
    sg, jg, tg, n_langs = graphs["small"]
    cfg = (0.2, 0.8)
    pj, sj = jpruning.prune_graph(jg, sg.pin_topics, sg.board_topics,
                                  jpruning.PruneConfig(*cfg), sg.board_lang,
                                  sg.pin_lang, n_langs)
    t = torch.as_tensor
    pt, st = pruning.prune_graph(tg, t(sg.pin_topics), t(sg.board_topics),
                                 pruning.PruneConfig(*cfg), t(sg.board_lang),
                                 t(sg.pin_lang), n_langs)
    _same_graph(pt, pj)
    assert st == sj


@pytest.mark.parametrize("chunk", [97, 4096])
def test_build_graph_in_small_passes_matches_reference(graphs, monkeypatch, chunk):
    """The compiler's counting sort split into many passes (pruned graphs
    are compiled by it) keeps the reference's stable order."""
    monkeypatch.setattr(tgraph, "BUILD_CHUNK", chunk)
    for sg, jg, _, n_langs in graphs.values():
        pins, boards = jgraph.edge_list(jg)
        order = np.random.default_rng(chunk).permutation(pins.shape[0])
        pins, boards = pins[order], boards[order]
        kw = dict(edge_feat=sg.board_lang[boards], n_feats=n_langs,
                  edge_feat_b2p=sg.pin_lang[pins])
        n = (jg.n_pins, jg.n_boards)
        _same_graph(tgraph.build_graph(pins, boards, *n, **kw),
                    jgraph.build_graph(pins, boards, *n, **kw))
        _same_graph(tgraph.build_graph(pins, boards, *n),
                    jgraph.build_graph(pins, boards, *n))


@pytest.mark.parametrize("name", ["small", "bench20k"])
def test_no_tie_at_the_entropy_cut(graphs, name):
    """Where boards tie at rank n_drop the two sorts may drop different
    boards; these graphs have no such tie, so parity is not luck."""
    sg, jg, _, _ = graphs[name]
    pins, boards = jgraph.edge_list(jg)
    ent = np.sort(jpruning.board_entropy(pins, boards, sg.pin_topics, jg.n_boards))[::-1]
    n_drop = int(0.1 * jg.n_boards)
    assert ent[n_drop - 1] > ent[n_drop]


@pytest.mark.parametrize("delta", SWEEP_DELTAS)
def test_degree_targets_equal_numpy_at_every_degree(graphs, delta):
    """max(ceil(d**delta), min(d, 2)) for d in 0..10,000 (past every test
    graph's largest degree): the port's table and torch.pow on the CPU."""
    top = max(10_000, *(g[1].max_pin_degree for g in graphs.values()))
    deg = np.arange(top + 1)
    want = np.maximum(np.ceil(deg.astype(np.float64) ** delta).astype(np.int64),
                      np.minimum(deg, 2))
    np.testing.assert_array_equal(pruning.degree_targets(top, delta, 2), want)
    ceil_pow = torch.ceil(torch.pow(torch.as_tensor(deg, dtype=torch.float64), delta))
    np.testing.assert_array_equal(ceil_pow.numpy(), np.ceil(deg.astype(np.float64) ** delta))


# ---------------------------------------------------------------------------
# The reference's pruning invariants (tests/test_counters_and_pruning.py),
# on the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small(graphs):
    sg, _, tg, _ = graphs["small"]
    return sg, tg


def _degrees(g):
    return g.p2b.degrees().numpy()


def test_entropy_pruning_targets_diverse_boards(small):
    sg, g = small
    pins, boards = tgraph.edge_list(g)
    ent = pruning.board_entropy(pins, boards, sg.pin_topics, g.n_boards).numpy()
    top_drop = np.argsort(-ent)[: int(0.1 * g.n_boards)]
    assert ent[top_drop].min() >= np.median(ent[ent > 0])


@pytest.mark.parametrize("delta", [1.0, 0.9, 0.7])
def test_degree_pruning_bounds(small, delta):
    sg, g = small
    cfg = pruning.PruneConfig(entropy_board_frac=0.0, delta=delta)
    pruned, stats = pruning.prune_graph(g, sg.pin_topics, None, cfg)
    before = _degrees(g)
    target = np.maximum(np.ceil(before.astype(np.float64) ** delta),
                        np.minimum(before, cfg.min_keep))
    assert (_degrees(pruned) <= target + 1e-9).all()
    if delta == 1.0:
        assert stats["edges_after"] == stats["edges_after_entropy"]


def test_pruning_monotone_in_delta(small):
    sg, g = small
    edges = [pruning.prune_graph(g, sg.pin_topics, None,
                                 pruning.PruneConfig(0.1, d))[1]["edges_after"]
             for d in (1.0, 0.9, 0.8, 0.6)]
    assert edges == sorted(edges, reverse=True)


def _tiny_edge_graph():
    """pin 0: degree 0; pin 1: one edge; pin 2: two; pin 3: six."""
    pins = np.asarray([1, 2, 2, 3, 3, 3, 3, 3, 3])
    boards = np.asarray([0, 0, 1, 0, 1, 2, 0, 1, 2])
    g = tgraph.build_graph(pins, boards, n_pins=4, n_boards=3)
    rng = np.random.default_rng(0)
    return g, rng.dirichlet(np.ones(4), size=4).astype(np.float32)


def test_prune_graph_degree_0_and_1_pins_with_min_keep():
    g, topics = _tiny_edge_graph()
    cfg = pruning.PruneConfig(entropy_board_frac=0.0, delta=0.1, min_keep=2)
    pruned, stats = pruning.prune_graph(g, topics, None, cfg)
    before, after = _degrees(g), _degrees(pruned)
    assert before.tolist() == [0, 1, 2, 6]
    assert after[:3].tolist() == [0, 1, 2]
    assert (after >= np.minimum(before, cfg.min_keep)).all()
    assert (after <= before).all()
    assert stats["edges_after"] <= stats["edges_before"]


def test_prune_graph_zero_entropy_frac_drops_no_boards():
    g, topics = _tiny_edge_graph()
    pruned, stats = pruning.prune_graph(g, topics, None, pruning.PruneConfig(0.0, 1.0))
    assert "boards_dropped" not in stats
    assert stats["edges_after_entropy"] == stats["edges_after"] == stats["edges_before"]
    np.testing.assert_array_equal(_degrees(pruned), _degrees(g))


@pytest.mark.parametrize("frac,delta", [(0.0, 0.9), (0.34, 0.7), (0.1, 1.0)])
def test_prune_graph_stats_invariants(small, frac, delta):
    sg, g = small
    _, stats = pruning.prune_graph(g, sg.pin_topics, None, pruning.PruneConfig(frac, delta))
    assert stats["edges_after"] <= stats["edges_after_entropy"] <= stats["edges_before"]
    assert 0.0 < stats["edge_keep_frac"] <= 1.0
    assert stats["bytes_after"] <= stats["bytes_before"]
    if frac > 0.0:
        assert stats["boards_dropped"] == int(frac * g.n_boards)


def test_pruning_keeps_topical_edges(small):
    sg, g = small
    pruned, _ = pruning.prune_graph(g, sg.pin_topics, None, pruning.PruneConfig(0.0, 0.7))
    pins, boards = tgraph.edge_list(g)
    sums = np.zeros((g.n_boards, sg.pin_topics.shape[1]))
    np.add.at(sums, boards, sg.pin_topics[pins])
    bt = (sums / np.maximum(np.bincount(boards, minlength=g.n_boards), 1)[:, None])

    def mean_sim(graph):
        p, b = tgraph.edge_list(graph)
        return pruning.cosine_sim(sg.pin_topics[p], bt[b].astype(np.float32)).mean()

    assert mean_sim(pruned) > mean_sim(g)
