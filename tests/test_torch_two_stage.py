"""The port's two-stage ranked serving against the JAX package.

Both sides run with identical weights (the reference's
``init_ranker_params`` arrays carried across by ``params_from_numpy``) on
``small_test_graph`` with the reference test's ranker shape
(``RankerConfig(d_model=16, n_neighbors=4, n_candidates=16, final_k=8)``).

Tolerances: the walk is integer-exact, so ids, ``steps_taken`` and
``n_high`` must be equal, as must every candidate neighborhood and every
bag (the port's bag twin adds in the reference twin's order).  Ranked
scores go through the scenario heads' matrix products, which XLA and
torch sum in different orders: each score is held within 2e-6 times the
largest score of its row (a few float32 ulps of the terms summed; the
measured gap is below 3e-7 of it), with ``-inf`` padding in the same
places.  The bound is relative to the row, not to each score, because a
score near zero is a sum of cancelling terms whose rounding is of the
terms' size.

The reference runs its ``"xla"`` walk backend (pinned bit-identical to
its Pallas engine), except one interpret-mode ``"pallas"`` case.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import service as jservice
from repro.core import walk as jwalk
from repro.graphs.synthetic import small_test_graph, top_degree_pins
from repro.kernels import ref as jref
from repro.serving import ranker as jranker
from repro.serving import recommend as jrecommend
from repro.serving.server import PixieServer as JServer
from repro_torch.core import prng
from repro_torch.core import service as tservice
from repro_torch.core import walk as twalk
from repro_torch.graphs import synthetic as tsyn
from repro_torch.kernels import ops
from repro_torch.serving import ranker as tranker
from repro_torch.serving import recommend as trecommend
from repro_torch.serving.server import PixieServer

RTOL = 2e-6


@pytest.fixture(scope="module")
def graphs():
    return small_test_graph(0), tsyn.small_test_graph(0, device="cpu").graph


@pytest.fixture(scope="module")
def ranks(graphs):
    sg, _ = graphs
    cfg = jranker.RankerConfig(
        n_items=sg.graph.n_pins, d_model=16, n_neighbors=4,
        n_candidates=16, final_k=8,
    )
    params = jranker.init_ranker_params(jax.random.key(7), cfg)
    tcfg = tranker.RankerConfig(**dataclasses.asdict(cfg))
    tparams = tranker.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), "cpu"
    )
    return jranker.RankRequest(params, cfg), tranker.RankRequest(tparams, tcfg)


def _cfg(**kw):
    base = dict(n_steps=1536, n_walkers=64, chunk_steps=4, top_k=20,
                n_p=40, n_v=3, backend="xla")
    base.update(kw)
    return jwalk.WalkConfig(**base)


def _port(cfg, backend="pallas"):
    return twalk.WalkConfig(**{**dataclasses.asdict(cfg), "backend": backend})


def _batch(sg, b):
    qs = top_degree_pins(sg, 32)
    pins = np.full((b, 2), -1, np.int32)
    weights = np.zeros((b, 2), np.float32)
    for i in range(b):
        pins[i] = [qs[(2 * i) % 32], qs[(2 * i + 1) % 32]]
        weights[i] = [1.0, 0.6]
    feats = (np.arange(b) % 3).astype(np.int32)
    scen = (np.arange(b) % 2).astype(np.int32)
    return pins, weights, feats, scen


def _assert_ranked_equal(got, want):
    """ids exactly, scores within RTOL of their row's largest score, -inf
    in the same places."""
    gs, gi = (np.atleast_2d(np.asarray(x)) for x in got[:2])
    ws, wi = (np.atleast_2d(np.asarray(x)) for x in want[:2])
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(np.isneginf(gs), np.isneginf(ws))
    fin = np.isfinite(ws)
    scale = np.max(np.abs(np.where(fin, ws, 0.0)), axis=-1, keepdims=True)
    gap = np.abs(np.where(fin, gs, 0.0) - np.where(fin, ws, 0.0))
    assert (gap <= RTOL * scale).all(), (gap / np.maximum(scale, 1e-30)).max()


@pytest.mark.parametrize("backend,batch", [
    ("xla", 1), ("xla", 4), ("xla", 16), ("pallas", 4),
])
def test_ranked_serve_batch_matches_reference(graphs, ranks, backend, batch):
    sg, tg = graphs
    jrank, trank = ranks
    pins, weights, feats, scen = _batch(sg, batch)
    cfg = _cfg()
    want = jservice.serve_batch(
        sg.graph, jnp.asarray(pins), jnp.asarray(weights), jnp.asarray(feats),
        jax.random.key(11), cfg, backend=backend, rank=jrank,
        scenario=jnp.asarray(scen), with_stats=True,
    )
    got = tservice.serve_batch(
        tg, torch.as_tensor(pins), torch.as_tensor(weights),
        torch.as_tensor(feats), prng.key(11, "cpu"), _port(cfg), rank=trank,
        scenario=torch.as_tensor(scen), with_stats=True,
    )
    assert got[1].shape == (batch, trank.cfg.final_k)
    _assert_ranked_equal(got, want)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    if batch != 4:
        return
    # both port walk backends share one stage 2: identical bits
    plain = tservice.serve_batch(
        tg, torch.as_tensor(pins), torch.as_tensor(weights),
        torch.as_tensor(feats), prng.key(11, "cpu"), _port(cfg, "xla"),
        rank=trank, scenario=torch.as_tensor(scen), with_stats=True,
    )
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_ranked_serve_underfull_and_empty_queries(graphs, ranks):
    """An all-padding query and an isolated query pin retrieve nothing and
    rank to all -1 / -inf; stage 2 fed fewer than final_k real candidates
    reports a -1 / -inf tail, as the reference does."""
    sg, tg = graphs
    jrank, trank = ranks
    degs = np.asarray(sg.graph.p2b.degrees())
    live = int(top_degree_pins(sg, 1)[0])
    isolated = int(np.argmin(degs)) if degs.min() == 0 else -1
    pins = np.array([[isolated, -1], [live, -1], [-1, -1], [live, isolated]],
                    np.int32)
    weights = np.array([[1.0, 0.0], [1.0, 0.0], [0.0, 0.0], [1.0, 0.5]],
                       np.float32)
    feats = np.zeros(4, np.int32)
    cfg = _cfg()
    want = jservice.serve_batch(
        sg.graph, jnp.asarray(pins), jnp.asarray(weights), jnp.asarray(feats),
        jax.random.key(3), cfg, rank=jrank, with_stats=True,
    )
    got = tservice.serve_batch(
        tg, torch.as_tensor(pins), torch.as_tensor(weights),
        torch.as_tensor(feats), prng.key(3, "cpu"), _port(cfg), rank=trank,
        with_stats=True,
    )
    _assert_ranked_equal(got, want)
    ids, scores = got[1].numpy(), got[0].numpy()
    assert (ids[2] == -1).all() and np.isneginf(scores[2]).all()
    assert (ids[0] == -1).all() == (isolated >= 0)
    assert (ids[1] >= 0).all()

    k = jrank.cfg.n_candidates
    cand = np.tile(np.arange(k, dtype=np.int32)[None], (2, 1))
    stats = np.stack([np.where(np.arange(k) < 3, 1.0, 0.0),
                      np.zeros(k)]).astype(np.float32)
    want = jranker.rank_candidates(
        jrank.params, jrank.cfg, sg.graph, jnp.asarray(cand),
        jnp.asarray(stats), jnp.zeros((2,), jnp.int32))
    got = tranker.rank_candidates(
        trank.params, trank.cfg, tg, torch.as_tensor(cand),
        torch.as_tensor(stats), torch.zeros(2, dtype=torch.int32))
    _assert_ranked_equal(got, want)
    ids, scores = got[1].numpy(), got[0].numpy()
    assert set(ids[0][:3]) == {0, 1, 2}
    assert (ids[0][3:] == -1).all() and np.isneginf(scores[0][3:]).all()
    assert (ids[1] == -1).all() and np.isneginf(scores[1]).all()


def test_candidate_neighborhoods_match_reference(graphs):
    sg, tg = graphs
    rng = np.random.default_rng(0)
    cand = rng.integers(0, sg.graph.n_pins, (5, 16)).astype(np.int32)
    valid = rng.random((5, 16)) < 0.8
    cand[~valid] = -1
    for n_nbr in (1, 4, 9):
        wi, ww = jranker.candidate_neighborhoods(
            sg.graph, jnp.asarray(cand), jnp.asarray(valid), n_nbr)
        gi, gw = tranker.candidate_neighborhoods(
            tg, torch.as_tensor(cand), torch.as_tensor(valid), n_nbr)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gw.numpy(), np.asarray(ww))
        assert (gi.numpy()[~valid] == -1).all()


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bag_twins_match_reference(mode, dtype):
    """Both entry points' twins against the reference twins, bit for bit:
    -1 padding, an all-padding bag, weights and no weights, d = 48.

    For a bf16 table the reference's ``embedding_bag_ref`` pools in bf16,
    unlike its kernel, which accumulates in float32; the port's twin
    follows the kernel, so there it is held to the reference's chain twin
    ``embedding_bag_batched_ref`` over the same bags."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((40, 48)).astype(np.float32)
    jt = jnp.asarray(table, dtype=jnp.dtype(dtype))
    tt = torch.as_tensor(table).to(getattr(torch, dtype))
    ids = rng.integers(-1, 40, (3, 5, 7)).astype(np.int32)
    ids[0, 0] = -1
    w = rng.uniform(0.0, 2.0, (3, 5, 7)).astype(np.float32)
    for weights in (w, None):
        jw = None if weights is None else jnp.asarray(weights)
        tw = None if weights is None else torch.as_tensor(weights)
        want = jref.embedding_bag_batched_ref(jt, jnp.asarray(ids), jw, mode=mode)
        got = ops.embedding_bag_batched(tt, torch.as_tensor(ids), tw, mode=mode)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))
        flat = ids.reshape(15, 7)
        jw2 = None if weights is None else jw.reshape(15, 7)
        tw2 = None if weights is None else tw.reshape(15, 7)
        if dtype == "float32":
            want = jref.embedding_bag_ref(jt, jnp.asarray(flat), jw2, mode=mode)
        else:
            want = jref.embedding_bag_batched_ref(
                jt, jnp.asarray(flat)[None], None if jw2 is None else jw2[None],
                mode=mode)[0]
        got = ops.embedding_bag(tt, torch.as_tensor(flat), tw2, mode=mode)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_rank_candidates_on_precomputed_stats(graphs, ranks):
    """Stage 2 alone, fed the reference's own retrieval output, and the
    fused port path equals rank_candidates on its own stage-1 output."""
    sg, tg = graphs
    jrank, trank = ranks
    pins, weights, feats, scen = _batch(sg, 4)
    cfg = _cfg(top_k=jrank.cfg.n_candidates)
    s, i = jservice.serve_batch(
        sg.graph, jnp.asarray(pins), jnp.asarray(weights), jnp.asarray(feats),
        jax.random.key(0), cfg)
    want = jranker.rank_candidates(jrank.params, jrank.cfg, sg.graph, i, s,
                                   jnp.asarray(scen))
    got = tranker.rank_candidates(
        trank.params, trank.cfg, tg, torch.as_tensor(np.array(i)),
        torch.as_tensor(np.array(s)), torch.as_tensor(scen))
    _assert_ranked_equal(got, want)
    fused = tservice.serve_batch(
        tg, torch.as_tensor(pins), torch.as_tensor(weights),
        torch.as_tensor(feats), prng.key(0, "cpu"), _port(cfg), rank=trank,
        scenario=torch.as_tensor(scen))
    for a, b in zip(fused, got):
        assert torch.equal(a, b)


def test_pixie_then_rank_is_walk_plus_rank_retrieved(graphs):
    sg, tg = graphs
    qs = top_degree_pins(sg, 2)
    qp, qw = np.asarray(qs[:2], np.int32), np.asarray([1.0, 0.6], np.float32)
    cfg = _cfg()
    ts = trecommend.TwoStageConfig(n_candidates=16, final_k=8)
    ranker = lambda cand: -cand.float()     # deterministic toy ranker
    key = prng.key(2, "cpu")
    a = trecommend.pixie_then_rank(
        tg, torch.as_tensor(qp), torch.as_tensor(qw), 0, key, _port(cfg),
        ranker, ts)
    walk_cfg = dataclasses.replace(_port(cfg), top_k=ts.n_candidates)
    ws, cand = twalk.recommend(tg, torch.as_tensor(qp), torch.as_tensor(qw),
                               0, key, walk_cfg)
    b = trecommend.rank_retrieved(ws, cand, ranker, ts.final_k)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    want = jrecommend.pixie_then_rank(
        sg.graph, jnp.asarray(qp), jnp.asarray(qw), jnp.asarray(0, jnp.int32),
        jax.random.key(2), cfg, lambda c: -c.astype(jnp.float32),
        jrecommend.TwoStageConfig(n_candidates=16, final_k=8))
    np.testing.assert_array_equal(a[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(a[1].numpy(), np.asarray(want[1]))


def test_recommend_two_stage_is_serve_batch(graphs, ranks):
    sg, tg = graphs
    _, trank = ranks
    pins, weights, feats, scen = _batch(sg, 4)
    args = (tg, torch.as_tensor(pins), torch.as_tensor(weights),
            torch.as_tensor(feats), prng.key(3, "cpu"), _port(_cfg()))
    a = trecommend.recommend_two_stage(*args, trank,
                                       scenario=torch.as_tensor(scen))
    b = tservice.serve_batch(*args, rank=trank, scenario=torch.as_tensor(scen))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_two_stage_validation(graphs, ranks):
    sg, tg = graphs
    _, trank = ranks
    pins, weights, feats, _ = _batch(sg, 2)
    with pytest.raises(ValueError, match="needs rank="):
        tservice.serve_batch(
            tg, torch.as_tensor(pins), torch.as_tensor(weights),
            torch.as_tensor(feats), prng.key(0, "cpu"), _port(_cfg()),
            scenario=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="final_k"):
        tranker.RankerConfig(n_items=10, n_candidates=4, final_k=8)
    with pytest.raises(ValueError, match="unique"):
        tranker.RankerConfig(n_items=10, scenarios=("a", "a"))
    with pytest.raises(ValueError, match="unknown scenario"):
        trank.cfg.scenario_id("shopping")
    assert trank.cfg.scenario_id("homefeed") == 1
    bad = tranker.RankerConfig(n_items=tg.n_pins + 1, n_candidates=16,
                               final_k=8)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="item table"):
        tranker.rank_candidates(
            tranker.init_ranker_params(gen, bad), bad, tg,
            torch.zeros((1, 16), dtype=torch.int32), torch.zeros((1, 16)),
            torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="batched"):
        tranker.rank_candidates(
            trank.params, trank.cfg, tg, torch.zeros(16, dtype=torch.int32),
            torch.zeros(16), 0)


def test_init_ranker_params_shapes_and_scales():
    cfg = tranker.RankerConfig(n_items=5000, d_model=16)
    p = tranker.init_ranker_params(torch.Generator().manual_seed(3), cfg)
    assert p["items"].shape == (5000, 16)
    assert abs(float(p["items"].std()) - 0.02) < 0.002
    for name in ("w_self", "w_neigh", "w_query"):
        assert p["heads"][name].shape == (2, 16, 16)
        assert abs(float(p["heads"][name].std()) - 0.25) < 0.05
    assert not p["heads"]["b"].any()
    q = tranker.init_ranker_params(torch.Generator().manual_seed(3), cfg)
    assert torch.equal(p["items"], q["items"])


def test_server_ranked_dispatch_matches_direct_serve(graphs, ranks):
    """A ranked replica's results equal serve_batch(rank=...) on the same
    fold_in keys and scenarios, and the reference replica's results (ids
    exactly, scores within RTOL)."""
    sg, tg = graphs
    jrank, trank = ranks
    cfg = _cfg(backend="pallas")
    qs = top_degree_pins(sg, 8)
    reqs = [[int(qs[2 * i]), int(qs[2 * i + 1])] for i in range(4)]
    scen = [0, 1, 1, 0]
    srv = PixieServer(tg, _port(cfg), batch_size=4, n_slots=2, seed=13,
                      ranker=trank)
    ref = JServer(sg.graph, cfg, batch_size=4, n_slots=2, seed=13,
                  ranker=jrank)
    for server in (srv, ref):
        for p, s in zip(reqs, scen):
            server.submit(p, [1.0, 0.6], scenario=s)
    got, want = srv.flush(), ref.flush()
    assert [r.req_id for r in got] == [0, 1, 2, 3]
    keys = torch.stack([prng.fold_in(prng.key(13, "cpu"), i) for i in range(4)])
    direct = tservice.serve_batch(
        tg, torch.as_tensor(reqs, dtype=torch.int32),
        torch.tensor([[1.0, 0.6]] * 4), torch.zeros(4, dtype=torch.int32),
        keys, _port(cfg), rank=trank, scenario=torch.as_tensor(scen))
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.scores, direct[0][i].numpy())
        np.testing.assert_array_equal(a.ids, direct[1][i].numpy())
        assert a.ids.shape == (trank.cfg.final_k,) and a.budget == cfg.n_steps
        _assert_ranked_equal((a.scores, a.ids), (b.scores, b.ids))


def test_server_scenario_validation(graphs, ranks):
    _, tg = graphs
    _, trank = ranks
    srv = PixieServer(tg, _port(_cfg()), batch_size=2, n_slots=2, ranker=trank)
    with pytest.raises(ValueError, match="out of range"):
        srv.submit([1, 2], [1.0, 1.0], scenario=trank.cfg.n_scenarios)
    with pytest.raises(ValueError, match="no budgets"):
        srv.submit([1, 2], [1.0, 1.0], budget=10)
    plain = PixieServer(tg, _port(_cfg()), batch_size=2, n_slots=2)
    with pytest.raises(ValueError, match="retrieval-only"):
        plain.submit([1, 2], [1.0, 1.0], scenario=1)


def test_server_ranked_partial_batch_padding(graphs, ranks):
    """What rides the other lanes of a batch, padding or real traffic,
    never changes a request's ranked result."""
    sg, tg = graphs
    _, trank = ranks
    qs = top_degree_pins(sg, 8)
    cfg = _port(_cfg())
    a = PixieServer(tg, cfg, batch_size=4, n_slots=2, seed=4, ranker=trank)
    a.submit([int(qs[0]), int(qs[1])], [1.0, 0.6], scenario=1)
    ra = a.flush()[0]
    b = PixieServer(tg, cfg, batch_size=4, n_slots=2, seed=4, ranker=trank)
    b.submit([int(qs[0]), int(qs[1])], [1.0, 0.6], scenario=1)
    for i in range(1, 4):
        b.submit([int(qs[2 * i]), int(qs[2 * i + 1])], [1.0, 0.6],
                 scenario=i % 2)
    rb = next(r for r in b.flush() if r.req_id == 0)
    np.testing.assert_array_equal(ra.scores, rb.scores)
    np.testing.assert_array_equal(ra.ids, rb.ids)
