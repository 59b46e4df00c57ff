"""The port's degraded-mode serving and open-loop traffic against the JAX
package.

  * the pure pieces (``elastic_step_budget``, ``overlap_at_k``, the
    Poisson and fault-schedule draws, ``defer`` and the burst warp) equal
    the reference's outputs for the same inputs and seeds;
  * admission rejections are counted per bucket, a ranked replica refuses
    elastic shedding, a shed request equals an unloaded replica handed
    the same budget, and a zero-fault chaos run equals the plain run;
  * ``run_open_loop`` on one seeded request stream gives the reference's
    results: ids and scores exactly, the same dispatched budgets, the
    same batch composition and the same drop and rejection counts.

Everything compared is exact: budgets and batches follow the virtual
clock only, and the walks are bit-identical to the reference's.  Served
streams draw user features from the test graph's 3 edge languages: the
port refuses a feature outside the graph's range, where the reference's
gather clamps it.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import walk as jwalk
from repro.graphs.synthetic import small_test_graph, top_degree_pins
from repro.serving import resilience as jres
from repro.serving import traffic as jtraffic
from repro.serving.server import PixieServer as JServer
from repro_torch.core import walk as twalk
from repro_torch.graphs import synthetic as tsyn
from repro_torch.serving import ranker as tranker
from repro_torch.serving import resilience as tres
from repro_torch.serving import traffic as ttraffic
from repro_torch.serving.server import PixieServer


N_FEATS = 3   # small_test_graph's edge languages


@pytest.fixture(scope="module")
def graphs():
    return small_test_graph(0), tsyn.small_test_graph(0, device="cpu").graph


def _cfg(**kw):
    base = dict(n_steps=512, n_walkers=32, chunk_steps=8, top_k=20, n_p=60,
                n_v=3, backend="pallas")
    base.update(kw)
    return jwalk.WalkConfig(**base)


def _port(cfg):
    return twalk.WalkConfig(**dataclasses.asdict(cfg))


def _port_requests(reqs):
    return [ttraffic.Request(**dataclasses.asdict(r)) for r in reqs]


def test_elastic_step_budget_curve_matches_reference():
    for kw in (dict(), dict(deadline_ms=30.0, shed_start_ms=0.0,
                            min_budget_frac=0.5)):
        j, t = jres.ResilienceConfig(**kw), tres.ResilienceConfig(**kw)
        for n_steps in (1, 7, 512, 100_000):
            for wait in np.linspace(0.0, 90.0, 181):
                assert tres.elastic_step_budget(n_steps, wait, t) == (
                    jres.elastic_step_budget(n_steps, wait, j))
    rcfg = tres.ResilienceConfig(deadline_ms=60.0, shed_start_ms=10.0,
                                 min_budget_frac=0.25)
    assert tres.elastic_step_budget(1000, 10.0, rcfg) == 1000
    assert tres.elastic_step_budget(1000, 35.0, rcfg) == 500
    assert tres.elastic_step_budget(1000, 500.0, rcfg) == 250
    for bad, match in ((dict(deadline_ms=0.0), "deadline_ms"),
                       (dict(shed_start_ms=60.0), "shed_start_ms"),
                       (dict(min_budget_frac=0.0), "min_budget_frac")):
        with pytest.raises(ValueError, match=match):
            tres.ResilienceConfig(**bad)


def test_overlap_at_k_matches_reference():
    rng = np.random.default_rng(0)
    for _ in range(20):
        a = rng.integers(-1, 30, (4, 10))
        b = rng.integers(-1, 30, (4, 10))
        for k in (None, 3, 10):
            assert tres.overlap_at_k(a, b, k) == jres.overlap_at_k(a, b, k)
    assert tres.overlap_at_k([[-1, -1]], [[-1, -1]]) == 1.0
    assert tres.overlap_at_k([[1, -1]], [[-1, -1]]) == 0.0
    with pytest.raises(ValueError, match="rows"):
        tres.overlap_at_k(np.zeros((2, 3)), np.zeros((3, 3)))


def test_request_and_fault_draws_match_reference():
    candidates = np.arange(40, dtype=np.int32)
    for seed in (0, 5):
        ocfg = dict(offered_qps=250.0, n_requests=30, seed=seed, max_pins=6)
        want = jtraffic.poisson_requests(
            candidates, jtraffic.OpenLoopConfig(**ocfg))
        got = ttraffic.poisson_requests(
            candidates, ttraffic.OpenLoopConfig(**ocfg))
        assert [dataclasses.asdict(r) for r in got] == [
            dataclasses.asdict(r) for r in want]
        ccfg = dict(horizon_s=1.0, seed=seed, n_spikes=3, n_bursts=2,
                    n_shard_deaths=2, n_shards=4)
        want = jtraffic.sample_fault_schedule(jtraffic.ChaosConfig(**ccfg))
        got = ttraffic.sample_fault_schedule(ttraffic.ChaosConfig(**ccfg))
        assert [dataclasses.asdict(e) for e in got.events] == [
            dataclasses.asdict(e) for e in want.events]
    for bad, match in ((dict(horizon_s=0.0), "horizon_s"),
                       (dict(horizon_s=1.0, burst_factor=0.5), "burst_factor"),
                       (dict(horizon_s=1.0, n_shard_deaths=1), "n_shards")):
        with pytest.raises(ValueError, match=match):
            ttraffic.ChaosConfig(**bad)
    with pytest.raises(ValueError, match="offered_qps"):
        ttraffic.poisson_requests(candidates, ttraffic.OpenLoopConfig(
            offered_qps=0.0, n_requests=1))


def test_defer_and_burst_warp_match_reference():
    spikes = [dict(kind="latency_spike", t_start=1.0, duration_s=0.5),
              dict(kind="latency_spike", t_start=1.4, duration_s=0.5)]
    tf = ttraffic.FaultSchedule(tuple(ttraffic.FaultEvent(**e) for e in spikes))
    jf = jtraffic.FaultSchedule(tuple(jtraffic.FaultEvent(**e) for e in spikes))
    for t in (0.5, 1.0, 1.2, 1.45, 1.9, 3.0):
        assert tf.defer(t) == jf.defer(t)
    assert tf.defer(1.2) == 1.9 and ttraffic.FaultSchedule().defer(3.0) == 3.0

    reqs = jtraffic.poisson_requests(np.arange(50, dtype=np.int32),
                                     jtraffic.OpenLoopConfig(
                                         offered_qps=100.0, n_requests=20,
                                         seed=4, max_pins=4))
    burst = dict(kind="traffic_burst", t_start=0.05, duration_s=0.1,
                 factor=4.0)
    want = jtraffic.apply_traffic_bursts(
        reqs, jtraffic.FaultSchedule((jtraffic.FaultEvent(**burst),)))
    got = ttraffic.apply_traffic_bursts(
        _port_requests(reqs),
        ttraffic.FaultSchedule((ttraffic.FaultEvent(**burst),)))
    assert [r.t_arrival for r in got] == [r.t_arrival for r in want]
    ts = [r.t_arrival for r in got]
    assert ts == sorted(ts)
    assert any(g.t_arrival < r.t_arrival for g, r in zip(got, reqs))
    assert [(g.req_id, g.pins) for g in got] == [(r.req_id, r.pins) for r in reqs]


def test_rejections_accounted_per_bucket(graphs):
    sg, tg = graphs
    qs = top_degree_pins(sg, 6)
    small, large = [int(qs[0])], [int(q) for q in qs[:6]]
    servers = [
        PixieServer(tg, _port(_cfg(n_steps=256)), buckets=[(4, 2), (4, 8)],
                    max_queue_per_bucket=1),
        JServer(sg.graph, _cfg(n_steps=256), buckets=[(4, 2), (4, 8)],
                max_queue_per_bucket=1),
    ]
    for srv in servers:
        assert srv.submit(small, [1.0]) is not None
        assert srv.submit(small, [1.0]) is None
        assert srv.submit(small, [1.0]) is None
        assert srv.submit(large, [1.0] * 6) is not None
        assert srv.submit(large, [1.0] * 6) is None
        assert srv.stats.rejected == {2: 2, 8: 1}
        assert srv.stats.rejected_total == 3 and srv.stats.dropped == 3
    got, want = servers[0].flush(), servers[1].flush()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.ids, np.asarray(b.ids))
    with pytest.raises(ValueError, match="disagreeing"):
        PixieServer(tg, _port(_cfg()), max_queue_per_bucket=3,
                    resilience=tres.ResilienceConfig(max_queue_per_bucket=4))


def test_ranked_replica_rejects_elastic_resilience(graphs):
    _, tg = graphs
    rcfg = tranker.RankerConfig(n_items=tg.n_pins, d_model=16, n_neighbors=4,
                                n_candidates=16, final_k=8)
    rank = tranker.RankRequest(
        tranker.init_ranker_params(torch.Generator().manual_seed(7), rcfg),
        rcfg)
    with pytest.raises(ValueError, match="elastic"):
        PixieServer(tg, _port(_cfg()), ranker=rank,
                    resilience=tres.ResilienceConfig())
    srv = PixieServer(tg, _port(_cfg()), ranker=rank,
                      resilience=tres.ResilienceConfig(
                          elastic=False, max_queue_per_bucket=4))
    assert srv.max_queue_per_bucket == 4


def test_shed_budget_matches_submit_budget_oracle(graphs):
    """A request shed at dispatch equals an unloaded replica handed the
    same shrunk budget through ``submit(budget=...)``."""
    sg, tg = graphs
    cfg = _port(_cfg())
    qs = top_degree_pins(sg, 4)
    rcfg = tres.ResilienceConfig(deadline_ms=60.0, shed_start_ms=10.0,
                                 min_budget_frac=0.25)
    srv = PixieServer(tg, cfg, batch_size=2, n_slots=4, seed=7,
                      max_wait_ms=5.0, resilience=rcfg)
    srv.submit([int(qs[0]), int(qs[1])], [1.0, 0.6], now=0.0, req_id=0)
    srv.submit([int(qs[2])], [1.0], now=0.0, req_id=1)
    srv.pump(now=0.035)
    shed = {r.req_id: r for r in srv.harvest()}
    want = tres.elastic_step_budget(cfg.n_steps, 35.0, rcfg)
    assert want < cfg.n_steps
    assert shed[0].budget == want and shed[1].budget == want
    oracle = PixieServer(tg, cfg, batch_size=2, n_slots=4, seed=7)
    oracle.submit([int(qs[0]), int(qs[1])], [1.0, 0.6], req_id=0, budget=want)
    oracle.submit([int(qs[2])], [1.0], req_id=1, budget=want)
    for r in oracle.flush():
        np.testing.assert_array_equal(shed[r.req_id].scores, r.scores)
        np.testing.assert_array_equal(shed[r.req_id].ids, r.ids)


def test_zero_fault_chaos_run_is_bit_identical_to_plain(graphs):
    sg, tg = graphs
    cfg = _port(_cfg(n_steps=256))
    workload = ttraffic.poisson_requests(
        top_degree_pins(sg, 8).astype(np.int32),
        ttraffic.OpenLoopConfig(offered_qps=300.0, n_requests=8, seed=2,
                                max_pins=4, n_feats=N_FEATS))

    def serve(resilience, faults):
        srv = PixieServer(tg, cfg, seed=2, buckets=[(2, 2), (2, 4)],
                          max_wait_ms=3.0, resilience=resilience)
        return ttraffic.run_open_loop(srv, workload, faults=faults)

    plain = serve(None, None)
    idle = serve(tres.ResilienceConfig(deadline_ms=1e6, shed_start_ms=1e5),
                 ttraffic.FaultSchedule())
    assert len(plain.results) == len(idle.results) == len(workload)
    for rid, p in plain.results.items():
        np.testing.assert_array_equal(p.scores, idle.results[rid].scores)
        np.testing.assert_array_equal(p.ids, idle.results[rid].ids)
        assert p.batch_seq == idle.results[rid].batch_seq
    assert all(b == cfg.n_steps for b in idle.budgets.values())


def test_open_loop_report_carries_rejections_and_budgets(graphs):
    sg, tg = graphs
    workload = ttraffic.poisson_requests(
        top_degree_pins(sg, 8).astype(np.int32),
        ttraffic.OpenLoopConfig(offered_qps=100_000.0, n_requests=10, seed=0,
                                max_pins=2, n_feats=N_FEATS))
    srv = PixieServer(tg, _port(_cfg(n_steps=256)), buckets=[(4, 2)],
                      max_wait_ms=1.0, max_queue_per_bucket=2)
    report = ttraffic.run_open_loop(srv, workload)
    assert 0 < report.n_rejected <= report.n_dropped
    assert report.n_served + report.n_dropped == report.n_offered
    assert report.summary()["n_rejected"] == report.n_rejected
    assert set(report.budgets) == set(report.results)
    assert all(b == 256 for b in report.budgets.values())
    assert report.latency_ms.shape == (report.n_served,)
    assert (report.latency_ms >= report.compute_ms).all()


def test_open_loop_matches_reference_on_one_stream(graphs):
    """One seeded stream through both replicas, with admission bounds,
    elastic shedding and a seeded chaos schedule (spikes and a burst):
    the same requests served and refused, in the same batches, with the
    same budgets and bit-identical results."""
    sg, tg = graphs
    cfg = _cfg(n_steps=256)
    ocfg = dict(offered_qps=2000.0, n_requests=24, seed=3, max_pins=4,
                n_feats=N_FEATS)
    reqs = jtraffic.poisson_requests(top_degree_pins(sg, 12).astype(np.int32),
                                     jtraffic.OpenLoopConfig(**ocfg))
    horizon = reqs[-1].t_arrival
    ccfg = dict(horizon_s=horizon, seed=1, n_spikes=3, spike_duration_s=0.004,
                n_bursts=1, burst_duration_s=0.004)
    rkw = dict(deadline_ms=8.0, shed_start_ms=1.0, min_budget_frac=0.25,
               max_queue_per_bucket=2)
    skw = dict(seed=5, buckets=[(2, 2), (4, 4)], max_wait_ms=2.0)
    want = jtraffic.run_open_loop(
        JServer(sg.graph, cfg, resilience=jres.ResilienceConfig(**rkw), **skw),
        reqs, faults=jtraffic.sample_fault_schedule(
            jtraffic.ChaosConfig(**ccfg)))
    got = ttraffic.run_open_loop(
        PixieServer(tg, _port(cfg), resilience=tres.ResilienceConfig(**rkw),
                    **skw),
        _port_requests(reqs), faults=ttraffic.sample_fault_schedule(
            ttraffic.ChaosConfig(**ccfg)))
    assert (got.n_offered, got.n_served, got.n_dropped, got.n_rejected) == (
        want.n_offered, want.n_served, want.n_dropped, want.n_rejected)
    assert got.n_rejected > 0
    assert got.budgets == want.budgets
    assert min(got.budgets.values()) < cfg.n_steps      # shedding engaged
    assert sorted(got.results) == sorted(want.results)
    np.testing.assert_array_equal(got.wait_ms, want.wait_ms)
    for rid, a in got.results.items():
        b = want.results[rid]
        assert (a.batch_seq, a.generation, a.budget) == (
            b.batch_seq, b.generation, b.budget)
        np.testing.assert_array_equal(a.scores, np.asarray(b.scores))
        np.testing.assert_array_equal(a.ids, np.asarray(b.ids))


def test_kill_shard_needs_a_sharded_replica(graphs):
    _, tg = graphs
    srv = PixieServer(tg, _port(_cfg()))
    assert srv.dead_shards() == []
    with pytest.raises(ValueError, match="sharded replica"):
        srv.kill_shard(0)
    with pytest.raises(ValueError, match="sharded replica"):
        srv.revive_shards()
    deaths = ttraffic.FaultSchedule((ttraffic.FaultEvent(
        kind="shard_death", t_start=0.0, shard=0),))
    reqs = [ttraffic.Request(req_id=0, t_arrival=0.1, pins=(1,),
                             weights=(1.0,), user_feat=0)]
    with pytest.raises(ValueError, match="sharded replica"):
        ttraffic.run_open_loop(srv, reqs, faults=deaths)
