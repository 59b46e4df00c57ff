"""The frozen reference against the port's plain twins, bit for bit."""

import numpy as np
import pytest
import torch

from pixiebench import graphgen, reference
from repro_torch.configs.pixie import SMOKE
from repro_torch.core import graph as graph_lib
from repro_torch.core import prng, service, walk
from repro_torch.graphs import synthetic


def as_reference(g) -> reference.Graph:
    side = lambda c: reference.Csr(c.offsets, c.targets, c.feat_bounds)
    return reference.Graph(side(g.p2b), side(g.b2p), g.n_pins, g.n_boards, g.max_pin_degree)


def assert_csr_equal(program, ref):
    for mine, theirs in ((program.p2b, ref.p2b), (program.b2p, ref.b2p)):
        for a, b in ((mine.offsets, theirs.offsets), (mine.targets, theirs.targets),
                     (mine.feat_bounds, theirs.feat_bounds)):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert program.max_pin_degree == ref.max_pin_degree


@pytest.fixture(scope="module")
def small():
    return synthetic.small_test_graph(seed=3, device="cpu")


def test_compile_matches_build_graph_on_uniform_edges():
    config = {"generator": "uniform", "n_pins": 500, "n_boards": 120, "n_edges": 6000,
              "n_langs": 4}
    e = graphgen.draw(config, 2**40 + 17, "cpu")
    program = graph_lib.build_graph(
        e.pins, e.boards, 500, 120, edge_feat=e.board_lang[e.boards.long()], n_feats=4,
        edge_feat_b2p=e.pin_lang[e.pins.long()])
    ref = reference.compile_graph(e.pins, e.boards, e.pin_lang, e.board_lang, 500, 120, 4)
    assert_csr_equal(program, ref)


def test_compile_matches_small_test_graph(small):
    pins, boards = graph_lib.edge_list(small.graph)
    pin_lang = torch.as_tensor(small.pin_lang).to(torch.int8)
    board_lang = torch.as_tensor(small.board_lang).to(torch.int8)
    pins, boards = torch.as_tensor(pins).int(), torch.as_tensor(boards).int()
    program = graph_lib.build_graph(
        pins, boards, small.graph.n_pins, small.graph.n_boards,
        edge_feat=board_lang[boards.long()], n_feats=3, edge_feat_b2p=pin_lang[pins.long()])
    ref = reference.compile_graph(pins, boards, pin_lang, board_lang,
                                  small.graph.n_pins, small.graph.n_boards, 3)
    assert_csr_equal(program, ref)


QUERIES = [  # (pins, weights, user language)
    ([5, 17, 230, -1], [1.0, 0.5, 0.25, 0.0], 0),
    ([42, -1, -1, -1], [1.0, 0.0, 0.0, 0.0], 2),
    ([7, 8, 9, 299], [0.3, 0.9, 0.1, 0.6], 1),
]


@pytest.mark.parametrize("n_p", [2000, 10])
@pytest.mark.parametrize("alpha", [0.3, 0.65])
def test_walk_boost_topk_match_the_port(small, alpha, n_p):
    cfg = walk.WalkConfig(n_steps=SMOKE.walk.n_steps, n_walkers=SMOKE.walk.n_walkers,
                          top_k=SMOKE.walk.top_k, alpha=alpha, n_p=n_p)
    ref_cfg = reference.Walk(cfg.n_steps, cfg.n_walkers, cfg.chunk_steps, cfg.alpha,
                             cfg.n_p, cfg.n_v, cfg.bias_beta, cfg.top_k)
    g = small.graph
    ref_graph = as_reference(g)
    server_seed = 2**33 + 5
    pins = torch.tensor([q[0] for q in QUERIES], dtype=torch.int32)
    weights = torch.tensor([q[1] for q in QUERIES], dtype=torch.float32)
    feats = torch.tensor([q[2] for q in QUERIES], dtype=torch.int32)
    keys = torch.stack([prng.fold_in(prng.key(server_seed, "cpu"), rid) for rid in (0, 1, 9)])
    served = service.serve_batch(g, pins, weights, feats, keys, cfg, backend="pallas",
                                 with_stats=True)
    for i, rid in enumerate((0, 1, 9)):
        k = reference.request_key(server_seed, rid, "cpu")
        assert torch.equal(k, keys[i])
        a = reference.recommend(ref_graph, pins[i], weights[i], int(feats[i]), k, ref_cfg)
        assert torch.equal(a.ids, served[1][i])
        assert torch.equal(a.scores.view(torch.int32), served[0][i].view(torch.int32))
        assert torch.equal(a.steps_taken, served[2][i])
        assert torch.equal(a.n_high, served[3][i])
        assert sum(s for s, _ in a.chunks) > 0


def test_chunk_counts_match_the_counter_twin():
    from repro_torch.kernels import visit_counter as vc

    g = torch.Generator().manual_seed(7)
    sev = torch.randint(0, 4, (8, 64), generator=g, dtype=torch.int32)   # 3 = invalid
    pev = torch.randint(0, 50, (8, 64), generator=g, dtype=torch.int32)
    counts = torch.randint(0, 5, (3 * 50,), generator=g, dtype=torch.int32)
    twin_counts = counts.clone()
    high = torch.zeros(3, dtype=torch.int32)
    events, distinct = reference.count_chunk(counts, high, sev, pev, 3, 50, 4)
    twin_high = vc.visit_counter_update_high_plain(
        twin_counts, sev.reshape(-1), pev.reshape(-1), n_slots=3, n_pins=50, n_v=4)
    assert torch.equal(counts, twin_counts) and torch.equal(high, twin_high)
    valid = sev < 3
    assert events == int(valid.sum())
    assert distinct == len(set((sev[valid] * 50 + pev[valid]).tolist()))


def test_control_boost_is_one_precision_lower():
    rows = torch.tensor([[0, 1, 2, 3, 7], [5, 0, 2, 0, 11]], dtype=torch.int32)
    exact = reference.boost(rows)
    lower = reference.boost(rows, torch.bfloat16)
    want = (np.sqrt(rows[0].double().numpy()).astype(np.float32)
            + np.sqrt(rows[1].double().numpy()).astype(np.float32)) ** 2
    assert np.array_equal(exact.numpy(), want.astype(np.float32))
    assert not torch.equal(exact, lower)
