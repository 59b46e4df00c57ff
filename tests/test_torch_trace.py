"""A served batch's record (``serving/batch_trace.py``) on the CPU.

Through ``PixieServer``: the spans nest inside ``pixie.batch`` in the
engine's order, every answer of a batch shares one record, the chunk
count equals the plain reference's (``pixiebench/reference.py``), each
host wait is counted at the site the code path implies (early stop
included), and the record changes no answer.  Outside the server no
record is current and nothing is recorded.
"""

import collections

import numpy as np
import pytest
import torch

from pixiebench import reference
from repro_torch.core import prng, service, walk
from repro_torch.graphs import synthetic
from repro_torch.serving import batch_trace
from repro_torch.serving.server import PixieServer

SEED = 11
BUCKETS = [(4, 1), (1, 4)]
LAYERS = ("pixie.walk", "pixie.boost", "pixie.topk")


@pytest.fixture(scope="module")
def sg():
    return synthetic.small_test_graph(0, device="cpu")


@pytest.fixture(scope="module")
def reqs(sg):
    """A full (4, 1) batch of one-pin queries, then a (1, 4) batch."""
    pins = [int(p) for p in synthetic.top_degree_pins(sg, 12)]
    one = [([p], [1.0], i % 3) for i, p in enumerate(pins[:4])]
    return one + [(pins[4:7], [0.5, 1.0, 0.3], 1)]


def _cfg(**kw):
    base = dict(n_steps=2048, n_walkers=64, chunk_steps=8, top_k=20,
                n_p=10**6, n_v=3, backend="pallas")
    base.update(kw)
    return walk.WalkConfig(**base)


def _serve(graph, cfg, reqs):
    server = PixieServer(graph, cfg, buckets=BUCKETS, seed=SEED)
    for rid, (pins, weights, feat) in enumerate(reqs):
        server.submit(pins, weights, feat, now=0.0, req_id=rid)
    assert server.pump(now=1.0) == 2
    return server, sorted(server.harvest(), key=lambda r: r.req_id)


def _batches(out):
    by_seq = collections.defaultdict(list)
    for r in out:
        by_seq[r.batch_seq].append(r)
    return [by_seq[s] for s in sorted(by_seq)]


def _reference_chunks(graph, cfg, reqs, rids, slots):
    """The most chunks the plain reference runs for any query of a batch:
    the batch-native loop runs while any of them walks."""
    host = reference.Graph(
        *(reference.Csr(c.offsets, c.targets, c.feat_bounds) for c in (graph.p2b, graph.b2p)),
        graph.n_pins, graph.n_boards, graph.max_pin_degree)
    rwalk = reference.Walk(cfg.n_steps, cfg.n_walkers, cfg.chunk_steps, cfg.alpha,
                           cfg.n_p, cfg.n_v, cfg.bias_beta, cfg.top_k)
    most = 0
    for rid in rids:
        pins, weights, feat = reqs[rid]
        p = np.full(slots, -1, np.int32)
        w = np.zeros(slots, np.float32)
        p[:len(pins)], w[:len(pins)] = pins, weights
        a = reference.recommend(host, p, w, feat, reference.request_key(SEED, rid, "cpu"),
                                rwalk, rank=False)
        most = max(most, len(a.chunks))
    return most


def _implied(chunks, max_chunks):
    """The batch-native path's host waits, by site."""
    return {"dispatch.h2d": 5,            # pins, weights, feats, keys, budgets
            "walk.plan": 2,               # Eq. 1's largest degree, the walker split
            "walk.feat_check": 2,         # the features' min and max
            "walk.live_rows": chunks + (chunks < max_chunks),
            "walk.debit": 1,              # the query pins' zero
            "topk.nonzero": 1,
            "harvest.done": 1,
            "harvest.d2h": 2}             # scores, ids


def test_spans_nest_in_order_and_a_batch_shares_one_record(sg, reqs):
    server, out = _serve(sg.graph, _cfg(), reqs)
    batches = _batches(out)
    assert [len(b) for b in batches] == [4, 1]
    for batch in batches:
        rec = batch[0].trace
        assert all(r.trace is rec for r in batch)
        assert set(rec.spans) == {batch_trace.BATCH, *LAYERS}
        whole = rec.spans[batch_trace.BATCH]
        assert whole.parent is None and whole.start_ms == 0.0
        edge = 0.0
        for name in LAYERS:
            s = rec.spans[name]
            assert s.parent == batch_trace.BATCH
            assert edge <= s.start_ms <= s.end_ms
            edge = s.end_ms
            assert all(type(t) is float for t in (s.start_ms, s.end_ms))
        assert edge <= whole.end_ms
        assert sum(rec.spans[n].ms for n in LAYERS) <= whole.ms
        assert rec.done is None
    assert batches[0][0].trace is not batches[1][0].trace
    for name in batch_trace.SPANS:
        assert len(server.stats.spans[name]) == 2
        assert server.stats.percentile(50, which=name) > 0.0


@pytest.mark.parametrize("early", [False, True], ids=["every_chunk", "early_stop"])
def test_chunks_match_the_reference_and_syncs_the_code_path(sg, reqs, early):
    cfg = _cfg(n_steps=8192, n_p=4, n_v=1) if early else _cfg()
    _, out = _serve(sg.graph, cfg, reqs)
    for batch in _batches(out):
        rec = batch[0].trace
        slots = 1 if len(batch) == 4 else 4
        want = _reference_chunks(sg.graph, cfg, reqs, [r.req_id for r in batch], slots)
        assert rec.chunks == want
        assert (rec.chunks < cfg.max_chunks()) == early
        assert rec.host_syncs == _implied(rec.chunks, cfg.max_chunks())


def test_the_per_query_engine_records_the_batch_and_its_sites(sg, reqs):
    cfg = _cfg(backend="xla")
    _, out = _serve(sg.graph, cfg, reqs)
    for batch in _batches(out):
        rec = batch[0].trace
        n = len(batch)
        assert set(rec.spans) == {batch_trace.BATCH}
        assert rec.host_syncs["topk.nonzero"] == n
        assert rec.host_syncs["walk.debit"] == n
        assert rec.host_syncs["dispatch.h2d"] == 5
        per_query = [_reference_chunks(sg.graph, cfg, reqs, [r.req_id], 1 if n == 4 else 4)
                     for r in batch]
        assert rec.chunks == sum(per_query)


def test_direct_serve_batch_records_nothing(sg, reqs):
    cfg = _cfg()
    pins = torch.tensor([[p[0]] for p, _, _ in reqs[:4]], dtype=torch.int32)
    keys = torch.stack([prng.fold_in(prng.key(SEED, "cpu"), r) for r in range(4)])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        service.serve_batch(sg.graph, pins, torch.ones((4, 1)),
                            torch.tensor([0, 1, 2, 0], dtype=torch.int32), keys, cfg)
    assert not [e.name for e in prof.events() if e.name.startswith("pixie.")]


def test_a_profile_holds_each_range_once_a_batch(sg, reqs):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(sg.graph, _cfg(), reqs)
    ranges = collections.Counter(e.name for e in prof.events() if e.name.startswith("pixie."))
    assert ranges == {name: 2 for name in batch_trace.SPANS}


def test_the_record_changes_no_answer(sg, reqs):
    cfg = _cfg()
    _, out = _serve(sg.graph, cfg, reqs)
    key = prng.key(SEED, "cpu")
    for batch in _batches(out):
        rids = [r.req_id for r in batch]
        slots = 1 if len(batch) == 4 else 4
        pins = np.full((len(rids), slots), -1, np.int32)
        weights = np.zeros((len(rids), slots), np.float32)
        for i, rid in enumerate(rids):
            p, w, _ = reqs[rid]
            pins[i, :len(p)], weights[i, :len(p)] = p, w
        scores, ids = service.serve_batch(
            sg.graph, torch.from_numpy(pins), torch.from_numpy(weights),
            torch.tensor([reqs[r][2] for r in rids], dtype=torch.int32),
            torch.stack([prng.fold_in(key, r) for r in rids]), cfg,
            step_budgets=torch.full((len(rids),), cfg.n_steps, dtype=torch.int32))
        for i, r in enumerate(batch):
            np.testing.assert_array_equal(r.scores, scores[i].numpy())
            np.testing.assert_array_equal(r.ids, ids[i].numpy())
