"""The port's multi-interest users against the JAX package.

Histories sampled from the same seed, the clustering into interest lanes,
the lane batch, the Eq. 3 merge across clusters (ties included), the
fused ``recommend_multi_interest`` with and without ranking, the server's
``submit_user`` intake and open-loop user traffic: every id and every
retrieval score must equal the reference's bit for bit.  Ranked scores
pass through the scenario heads' matrix products and are held within
2e-6 of their row's largest score (see ``test_torch_two_stage.py``).

User features are drawn from the test graph's 3 edge languages: the port
refuses a feature outside the graph's range, where the reference's gather
clamps it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import service as jservice
from repro.core import walk as jwalk
from repro.graphs import synthetic as jsyn
from repro.serving import ranker as jranker
from repro.serving import recommend as jrecommend
from repro.serving import traffic as jtraffic
from repro.serving.server import PixieServer as JServer
from repro_torch.core import prng
from repro_torch.core import service as tservice
from repro_torch.core import walk as twalk
from repro_torch.graphs import synthetic as tsyn
from repro_torch.serving import ranker as tranker
from repro_torch.serving import recommend as trecommend
from repro_torch.serving import traffic as ttraffic
from repro_torch.serving.server import PixieServer

N_FEATS = 3   # small_test_graph's edge languages
HCFG = dict(n_users=16, n_interests=3, mean_actions=14, seed=5)


@pytest.fixture(scope="module")
def sgs():
    return jsyn.small_test_graph(0), tsyn.small_test_graph(0, device="cpu")


@pytest.fixture(scope="module")
def histories(sgs):
    jsg, tsg = sgs
    return (jsyn.sample_user_histories(jsg, jsyn.UserHistoryConfig(**HCFG)),
            tsyn.sample_user_histories(tsg, tsyn.UserHistoryConfig(**HCFG)))


def _cfg(**kw):
    base = dict(n_steps=512, n_walkers=32, chunk_steps=4, top_k=16, n_p=40,
                n_v=3, backend="xla")
    base.update(kw)
    return jwalk.WalkConfig(**base)


def _port(cfg, backend="pallas"):
    return twalk.WalkConfig(**{**dataclasses.asdict(cfg), "backend": backend})


def _actions(h):
    return [(a.pin, a.action, a.age_hours) for a in h.actions]


def _user_batches(sgs, histories, n_users, n_clusters, n_steps):
    jsg, tsg = sgs
    jh, th = histories
    juq = [jservice.build_user_query(h.actions, jsg.pin_topics, n_slots=8,
                                     n_clusters=n_clusters)
           for h in jh[:n_users]]
    tuq = [tservice.build_user_query(h.actions, tsg.pin_topics, n_slots=8,
                                     n_clusters=n_clusters)
           for h in th[:n_users]]
    return (jservice.batch_user_queries(juq, n_steps=n_steps),
            tservice.batch_user_queries(tuq, n_steps=n_steps, device="cpu"))


def test_sampled_histories_match_reference(sgs, histories):
    jh, th = histories
    assert len(jh) == len(th) == HCFG["n_users"]
    for a, b in zip(jh, th):
        assert _actions(a) == _actions(b)
        np.testing.assert_array_equal(a.topics, b.topics)
        np.testing.assert_array_equal(a.mixture, b.mixture)
    with pytest.raises(ValueError, match="n_interests"):
        tsyn.sample_user_histories(sgs[1], tsyn.UserHistoryConfig(
            n_interests=0))


@pytest.mark.parametrize("n_clusters", [1, 2, 3, 5])
def test_build_user_query_matches_reference(sgs, histories, n_clusters):
    jsg, tsg = sgs
    for jhist, thist in zip(*histories):
        want = jservice.build_user_query(jhist.actions, jsg.pin_topics,
                                         n_slots=8, n_clusters=n_clusters)
        got = tservice.build_user_query(thist.actions, tsg.pin_topics,
                                        n_slots=8, n_clusters=n_clusters)
        np.testing.assert_array_equal(got.cluster_pins, want.cluster_pins)
        np.testing.assert_array_equal(got.cluster_weights, want.cluster_weights)
        np.testing.assert_array_equal(got.importance, want.importance)
    np.testing.assert_array_equal(
        tservice.cluster_step_budgets(np.array([0.5, 0.3, 0.2, 0.0],
                                               np.float32), 777),
        jservice.cluster_step_budgets(np.array([0.5, 0.3, 0.2, 0.0],
                                               np.float32), 777))
    with pytest.raises(ValueError, match="n_clusters"):
        tservice.build_user_query(thist.actions, tsg.pin_topics, 8, 0)
    with pytest.raises(ValueError, match="at least one action"):
        tservice.build_user_query([], tsg.pin_topics, 8)


def test_batch_user_queries_matches_reference(sgs, histories):
    want, got = _user_batches(sgs, histories, 6, 3, n_steps=1000)
    for name in ("pins", "weights", "feats", "importance", "step_budgets"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.lane_user, want.lane_user)
    np.testing.assert_array_equal(got.lane_of_user, want.lane_of_user)
    assert got.n_users == want.n_users == 6
    uq = tservice.build_user_query(histories[1][0].actions,
                                   sgs[1].pin_topics, n_slots=4)
    uq8 = tservice.build_user_query(histories[1][0].actions,
                                    sgs[1].pin_topics, n_slots=8)
    with pytest.raises(ValueError, match="slots"):
        tservice.batch_user_queries([uq8, uq], 100, device="cpu")


def _merge_cases():
    """(scores, ids, importance) cases: shared pins across lanes, equal
    scores (ties broken by pin id), padding entries and padding lanes, a
    single live lane, and random lanes."""
    yield (np.array([[4.0, 1.0, 0.0], [4.0, 1.0, 0.0]], np.float32),
           np.array([[2, 5, -1], [7, 2, -1]], np.int32),
           np.array([0.5, 0.5], np.float32))
    yield (np.array([[2.0, 2.0, 2.0], [2.0, 2.0, 1.0]], np.float32),
           np.array([[9, 4, 6], [8, 3, 1]], np.int32),
           np.array([0.5, 0.5], np.float32))
    yield (np.array([[2.0, 1.5, 0.0], [5.0, 1.0, 1.0]], np.float32),
           np.array([[7, 3, -1], [1, 2, 3]], np.int32),
           np.array([1.0, 0.0], np.float32))
    rng = np.random.default_rng(3)
    for k in (1, 3, 4):
        for _ in range(4):
            scores = np.sort(rng.integers(0, 6, (k, 10)).astype(np.float32),
                             axis=1)[:, ::-1].copy()
            ids = np.stack([rng.choice(15, 10, replace=False)
                            for _ in range(k)]).astype(np.int32)
            ids[scores == 0] = -1
            imp = rng.dirichlet(np.ones(k)).astype(np.float32)
            if k > 1:
                imp[-1] = 0.0
            yield scores, ids, imp


def test_merge_interest_topk_matches_reference():
    """Per user and batched over users, bit for bit, and with a narrower
    ``top_k``."""
    cases = list(_merge_cases())
    for scores, ids, imp in cases:
        for top_k in (None, 4):
            want = jwalk.merge_interest_topk(
                jnp.asarray(scores), jnp.asarray(ids), jnp.asarray(imp),
                top_k=top_k)
            got = twalk.merge_interest_topk(
                torch.as_tensor(scores), torch.as_tensor(ids),
                torch.as_tensor(imp), top_k=top_k)
            np.testing.assert_array_equal(
                got[0].numpy().view(np.uint32),
                np.asarray(want[0]).view(np.uint32))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    same_k = [c for c in cases if c[0].shape == (3, 10)]
    s, i, imp = (np.stack(x) for x in zip(*same_k))
    got = twalk.merge_interest_topk(torch.as_tensor(s), torch.as_tensor(i),
                                    torch.as_tensor(imp))
    for u in range(len(same_k)):
        want = jwalk.merge_interest_topk(jnp.asarray(s[u]), jnp.asarray(i[u]),
                                         jnp.asarray(imp[u]))
        np.testing.assert_array_equal(got[0][u].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][u].numpy(), np.asarray(want[1]))
    ms, mi = twalk.merge_interest_topk(*(torch.as_tensor(x)
                                         for x in cases[0]))
    np.testing.assert_allclose(ms.numpy(), [2.25, 1.0, 0.25])
    np.testing.assert_array_equal(mi.numpy(), [2, 7, 5])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_recommend_multi_interest_matches_reference(sgs, histories, backend):
    jsg, tsg = sgs
    cfg = _cfg()
    jb, tb = _user_batches(sgs, histories, 4, 3, n_steps=cfg.n_steps)
    tb = tb._replace(feats=tb.feats % N_FEATS)
    jb = jb._replace(feats=jb.feats % N_FEATS)
    want = jrecommend.recommend_multi_interest(
        jsg.graph, jb, jax.random.key(17), cfg, with_stats=True)
    got = trecommend.recommend_multi_interest(
        tsg.graph, tb, prng.key(17, "cpu"), _port(cfg, backend),
        with_stats=True)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="scenario"):
        trecommend.recommend_multi_interest(
            tsg.graph, tb, prng.key(17, "cpu"), _port(cfg),
            scenario=torch.zeros(4, dtype=torch.int32))


def test_recommend_multi_interest_then_rank_matches_reference(sgs, histories):
    jsg, tsg = sgs
    rcfg = jranker.RankerConfig(n_items=jsg.graph.n_pins, d_model=16,
                                n_neighbors=4, n_candidates=16, final_k=6)
    params = jranker.init_ranker_params(jax.random.key(7), rcfg)
    trank = tranker.RankRequest(
        tranker.params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  "cpu"),
        tranker.RankerConfig(**dataclasses.asdict(rcfg)))
    cfg = _cfg(n_steps=256, top_k=4)       # top_k becomes n_candidates
    jb, tb = _user_batches(sgs, histories, 3, 2, n_steps=cfg.n_steps)
    scen = np.array([0, 1, 0], np.int32)
    want = jrecommend.recommend_multi_interest(
        jsg.graph, jb, jax.random.key(29), cfg,
        rank=jranker.RankRequest(params, rcfg), scenario=jnp.asarray(scen))
    got = trecommend.recommend_multi_interest(
        tsg.graph, tb, prng.key(29, "cpu"), _port(cfg), rank=trank,
        scenario=torch.as_tensor(scen))
    gs, gi = got[0].numpy(), got[1].numpy()
    ws, wi = np.asarray(want[0]), np.asarray(want[1])
    assert gs.shape == gi.shape == (3, rcfg.final_k)
    np.testing.assert_array_equal(gi, wi)
    fin = np.isfinite(ws)
    np.testing.assert_array_equal(np.isfinite(gs), fin)
    scale = np.abs(np.where(fin, ws, 0.0)).max(axis=1, keepdims=True)
    gap = np.abs(np.where(fin, gs, 0.0) - np.where(fin, ws, 0.0))
    assert (gap <= 2e-6 * scale).all()


def _drain(srv):
    while srv.pending():
        srv.pump(now=srv.next_deadline())
    return {r.req_id: r for r in srv.harvest()}


def test_submit_user_matches_reference_server(sgs, histories):
    """The port's server and the reference's, fed the same users with the
    same ids, merge the same lanes into the same results; flat requests
    share the replica."""
    jsg, tsg = sgs
    cfg = _cfg(backend="pallas", n_steps=256)
    skw = dict(buckets=[(4, 2), (4, 8)], seed=42, n_clusters=3)
    jsrv = JServer(jsg.graph, cfg, pin_topics=jsg.pin_topics, **skw)
    tsrv = PixieServer(tsg.graph, _port(cfg), pin_topics=tsg.pin_topics, **skw)
    for srv, hist in ((jsrv, histories[0]), (tsrv, histories[1])):
        for i, h in enumerate(hist[:5]):
            assert srv.submit_user(h.actions, user_feat=i % N_FEATS,
                                   now=0.001 * i, req_id=100 + i) == 100 + i
        srv.submit([int(hist[0].actions[0].pin)], [1.0], now=0.0, req_id=7)
    want, got = _drain(jsrv), _drain(tsrv)
    assert sorted(got) == sorted(want) == [7] + list(range(100, 105))
    for rid, r in got.items():
        np.testing.assert_array_equal(r.scores.view(np.uint32),
                                      np.asarray(want[rid].scores).view(np.uint32))
        np.testing.assert_array_equal(r.ids, np.asarray(want[rid].ids))
        assert (r.budget, r.batch_seq, r.generation) == (
            want[rid].budget, want[rid].batch_seq, want[rid].generation)
    assert tsrv.stats.queries == 6


def test_submit_user_admission_is_all_or_nothing(sgs, histories):
    _, tsg = sgs
    th = histories[1]
    srv = PixieServer(tsg.graph, _port(_cfg()), buckets=[(8, 8)],
                      pin_topics=tsg.pin_topics, n_clusters=3,
                      max_queue_per_bucket=4)
    assert srv.submit_user(th[0].actions, now=0.0) == 0   # 3 lanes
    assert srv.pending() == 3
    assert srv.submit_user(th[1].actions, now=0.0) is None
    assert srv.pending() == 3                      # no lane of it queued
    assert srv.stats.dropped == 1 and srv.stats.rejected == {8: 1}
    with pytest.raises(ValueError, match="pin_topics"):
        PixieServer(tsg.graph, _port(_cfg())).submit_user(th[0].actions)
    rcfg = tranker.RankerConfig(n_items=tsg.graph.n_pins, d_model=8,
                                n_candidates=16, final_k=8)
    rank = tranker.RankRequest(
        tranker.init_ranker_params(torch.Generator().manual_seed(0), rcfg),
        rcfg)
    with pytest.raises(ValueError, match="multi-interest replica can't rank"):
        PixieServer(tsg.graph, _port(_cfg()), ranker=rank,
                    pin_topics=tsg.pin_topics)


def test_open_loop_user_traffic_matches_reference(sgs, histories):
    jsg, tsg = sgs
    cfg = _cfg(backend="pallas", n_steps=256)
    ol = dict(offered_qps=500.0, n_requests=10, seed=5, n_feats=N_FEATS)
    jreqs = jtraffic.poisson_user_requests(histories[0][:4],
                                           jtraffic.OpenLoopConfig(**ol))
    treqs = ttraffic.poisson_user_requests(histories[1][:4],
                                           ttraffic.OpenLoopConfig(**ol))
    assert [(r.req_id, r.t_arrival, r.user_feat) for r in treqs] == [
        (r.req_id, r.t_arrival, r.user_feat) for r in jreqs]
    skw = dict(batch_size=4, n_slots=8, seed=9, n_clusters=2)
    want = jtraffic.run_open_loop(
        JServer(jsg.graph, cfg, pin_topics=jsg.pin_topics, **skw), jreqs)
    got = ttraffic.run_open_loop(
        PixieServer(tsg.graph, _port(cfg), pin_topics=tsg.pin_topics, **skw),
        treqs)
    assert got.n_served == want.n_served == 10
    assert got.budgets == want.budgets
    for rid, r in got.results.items():
        np.testing.assert_array_equal(r.scores, np.asarray(want.results[rid].scores))
        np.testing.assert_array_equal(r.ids, np.asarray(want.results[rid].ids))
        assert r.batch_seq == want.results[rid].batch_seq
