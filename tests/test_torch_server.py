"""The port's PixieServer against the JAX PixieServer, and its contracts.

Same seed, same buckets, same requests: the two replicas must return the
same ids and scores per request id, dispatch the same batches and report
the same budgets.  Bucketed, deadline-driven serving must equal the
single-bucket ``flush`` oracle (per-request fold_in keys make a result
independent of batch composition), and ``swap_graph`` keeps its
generation barrier.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import walk as jwalk
from repro.graphs.synthetic import small_test_graph, top_degree_pins
from repro.serving.server import PixieServer as JServer
from repro_torch.core import walk as twalk
from repro_torch.graphs import synthetic as tsyn
from repro_torch.serving.server import LatencyRing, PixieServer, ServerStats


@pytest.fixture(scope="module")
def graphs():
    return small_test_graph(0), tsyn.small_test_graph(0, device="cpu").graph


def _cfg(**kw):
    base = dict(n_steps=1000, n_walkers=64, chunk_steps=8, top_k=20, n_p=60,
                n_v=3)
    base.update(kw)
    return jwalk.WalkConfig(**base)


def _port(cfg):
    return twalk.WalkConfig(**dataclasses.asdict(cfg))


def _requests(sg, n=7):
    qs = top_degree_pins(sg, 24)
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        k = 1 + i % 4
        out.append(([int(p) for p in rng.choice(qs, k, replace=False)],
                    [float(x) for x in rng.uniform(0.2, 1.0, k)], i % 3))
    return out


def _drive(server, reqs, budgets=None):
    for i, (p, w, f) in enumerate(reqs):
        b = None if budgets is None else budgets.get(i)
        server.submit(p, w, user_feat=f, now=0.0, budget=b)
    server.pump(now=1.0)
    return sorted(server.harvest(), key=lambda r: r.req_id)


@pytest.mark.parametrize("count_boards", [False, True])
def test_server_matches_reference_server(graphs, count_boards):
    sg, tg = graphs
    cfg = _cfg(count_boards=count_boards)
    reqs = _requests(sg)
    budgets = {2: 300, 5: 900}
    buckets = [(2, 2), (4, 4)]
    want = _drive(JServer(sg.graph, cfg, buckets=buckets, seed=5,
                          backend="pallas"), reqs, budgets)
    got = _drive(PixieServer(tg, _port(cfg), buckets=buckets, seed=5,
                             backend="pallas"), reqs, budgets)
    assert [r.req_id for r in got] == [r.req_id for r in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.scores, np.asarray(b.scores))
        np.testing.assert_array_equal(a.ids, np.asarray(b.ids))
        assert (a.budget, a.batch_seq, a.generation) == (
            b.budget, b.batch_seq, b.generation)


def test_bucketed_serving_equals_flush_oracle(graphs):
    sg, tg = graphs
    cfg = _port(_cfg())
    reqs = _requests(sg, 9)
    bucketed = _drive(PixieServer(tg, cfg, buckets=[(2, 1), (3, 2), (2, 4)],
                                  seed=1, backend="pallas"), reqs)
    oracle = PixieServer(tg, cfg, buckets=[(4, 4)], seed=1, backend="xla")
    for p, w, f in reqs:
        oracle.submit(p, w, user_feat=f, now=0.0)
    flushed = oracle.flush(now=0.0)
    assert len(bucketed) == len(flushed) == len(reqs)
    for a, b in zip(bucketed, flushed):
        assert a.req_id == b.req_id
        np.testing.assert_array_equal(a.scores, b.scores)
        np.testing.assert_array_equal(a.ids, b.ids)


def test_deadline_batching_and_admission(graphs):
    _, tg = graphs
    server = PixieServer(tg, _port(_cfg()), buckets=[(3, 2)], max_wait_ms=5.0,
                         seed=0)
    assert server.submit([1], [1.0], now=0.0) == 0
    assert server.next_deadline() == pytest.approx(0.005)
    assert server.pump(now=0.004) == 0           # neither full nor late
    assert server.pump(now=server.next_deadline()) == 1
    assert [server.submit([2, 3], [1.0, 0.5], now=1.0) for _ in range(3)] == [1, 2, 3]
    assert server.pending() == 3
    assert server.pump(now=1.0) == 1            # full bucket dispatches
    out = server.harvest()
    assert [r.req_id for r in out] == [0, 1, 2, 3]
    assert out[0].wait_ms == pytest.approx(5.0)
    assert server.stats.queries == 4 and server.stats.batches == 2
    assert server.pending() == 0 and server.next_deadline() is None


def test_submit_validation(graphs):
    _, tg = graphs
    server = PixieServer(tg, _port(_cfg()), buckets=[(2, 4), (2, 8)])
    with pytest.raises(ValueError, match="9 pins.*8 slots"):
        server.submit(list(range(9)), [1.0] * 9)
    with pytest.raises(ValueError, match="2 pins but 1 weights"):
        server.submit([1, 2], [1.0])
    with pytest.raises(ValueError, match="budget=0"):
        server.submit([1], [1.0], budget=0)
    assert server.submit(list(range(6)), [1.0] * 6) is not None
    assert server.pending() == 1
    with pytest.raises(ValueError, match="share n_slots"):
        PixieServer(tg, _port(_cfg()), buckets=[(2, 4), (3, 4)])


def test_swap_graph_generation_barrier(graphs):
    sg, tg = graphs
    server = PixieServer(tg, _port(_cfg()), buckets=[(4, 2)], seed=2)
    server.submit([int(top_degree_pins(sg, 1)[0])], [1.0], now=0.0)
    new_graph = tsyn.small_test_graph(1, device="cpu").graph
    server.swap_graph(new_graph, now=0.0)       # drains the queue first
    assert server.pending() == 0 and server.stats.graph_generation == 1
    server.submit([3], [1.0], now=0.0)
    out = server.flush(now=0.0)
    assert [r.generation for r in out] == [0, 1]
    assert server.graph is new_graph


def test_latency_ring_is_bounded():
    ring = LatencyRing(capacity=8)
    ring.extend(float(i) for i in range(100))
    assert len(ring) == 8
    np.testing.assert_array_equal(ring.values(), np.arange(92, 100, dtype=np.float64))
    stats = ServerStats(capacity=8)
    assert stats.percentile(50) == 0.0
    stats.latencies_ms.extend(float(i) for i in range(100))
    assert stats.percentile(50) == pytest.approx(np.percentile(np.arange(92, 100), 50))
    with pytest.raises(ValueError):
        LatencyRing(capacity=0)
