"""Each CUDA kernel of the port against its plain PyTorch twin, on the card.

Marked ``cuda``: every test here skips on a host without a CUDA device
(the decision is made inside the ``cuda_device`` fixture).  The file
imports no jax, because the machine with the card has none; run it there
with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer outputs must match exactly: the kernels and the twins do the same
integer arithmetic on the same random bits, and every count increment is
1, so the atomics' order cannot show.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import prng, service, walk
from repro_torch.graphs import synthetic
from repro_torch.kernels import _build
from repro_torch.kernels import visit_counter as vc
from repro_torch.kernels import walk_step as ws

pytestmark = pytest.mark.cuda

ALPHA_U32 = walk._prob_u32(0.5)
BETA_U32 = walk._prob_u32(0.9)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sg(cuda_device):
    return synthetic.small_test_graph(0, device=cuda_device)


@pytest.fixture(scope="module")
def graph(sg):
    return sg.graph


def _walkers(graph, n_queries, w, chunk_steps, seed):
    dev = graph.device
    rng = np.random.default_rng(seed)
    n = n_queries * w
    degs = graph.p2b.degrees().cpu().numpy()
    live = np.nonzero(degs > 0)[0]
    curr = rng.choice(live, n).astype(np.int32)
    dead = np.nonzero(degs == 0)[0]
    if dead.size:  # dead-end starts exercise the invalid-event path
        curr[:3] = dead[0]
    t = lambda a: torch.as_tensor(a, device=dev)
    rbits = rng.integers(0, 2**32, (chunk_steps, n, 4), dtype=np.uint64)
    return dict(
        curr=t(curr), query=t(rng.choice(live, n).astype(np.int32)),
        feat=t(rng.integers(0, 3, n).astype(np.int32)),
        slot=t(rng.integers(0, 3, n).astype(np.int32)),
        qid=t(np.repeat(np.arange(n_queries, dtype=np.int32), w)),
        rbits=t(rbits.astype(np.uint32).view(np.int32)),
    )


def _csr(graph):
    return (graph.p2b.offsets, graph.p2b.targets, graph.b2p.offsets,
            graph.b2p.targets, graph.p2b.feat_bounds, graph.b2p.feat_bounds)


def _assert_lanes_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == torch.int32 and torch.equal(a, b)


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("count_boards", [False, True])
@pytest.mark.parametrize("mode", ["per_query", "batched"])
def test_walk_kernel_matches_twin(graph, mode, count_boards, bias):
    n_queries = 1 if mode == "per_query" else 5
    x = _walkers(graph, n_queries, 300, 6, seed=8)
    kw = dict(n_pins=graph.n_pins, n_slots=3, n_boards=graph.n_boards,
              alpha_u32=ALPHA_U32, beta_u32=BETA_U32 if bias else 0,
              count_boards=count_boards)
    a = (x["curr"], x["query"], x["feat"], x["slot"])
    if mode == "per_query":
        got = ws.walk_steps_fused(*a, x["rbits"], *_csr(graph), **kw)
        want = ws.walk_chunk_plain(*a, x["rbits"], *_csr(graph), **kw)
    else:
        got = ws.walk_steps_fused(*a, x["rbits"], *_csr(graph), x["qid"],
                                  n_queries=n_queries, **kw)
        want = ws.walk_chunk_batched_plain(*a, x["qid"], x["rbits"],
                                           *_csr(graph), n_queries=n_queries,
                                           **kw)
    torch.cuda.synchronize()
    _assert_lanes_equal(got, want)
    sev = got[-3]
    assert bool((sev == 3).any()) and bool((sev < 3).any())


def _events(dev, seed, m, n_queries, n_slots, n_dim):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, n_queries + 1, m).astype(np.int32)
    s = rng.integers(0, n_slots + 1, m).astype(np.int32)
    i = rng.integers(0, n_dim, m).astype(np.int32)
    s[:5] = -1
    i[5:10] = n_dim
    i[10:5000] = rng.integers(0, 8, 4990)   # hot bins cross n_v
    t = lambda a: torch.as_tensor(a, device=dev)
    return t(q), t(s), t(i)


@pytest.mark.parametrize("with_query", [False, True])
def test_counter_kernels_match_twins(cuda_device, with_query):
    n_queries, n_slots, n_pins, n_v = 4, 3, 5000, 4
    q, s, p = _events(cuda_device, 13, 200_000, n_queries, n_slots, n_pins)
    qe = q if with_query else None
    nq = n_queries if with_query else 0
    n_rows = n_queries * n_slots if with_query else n_slots
    prior = torch.as_tensor(
        np.random.default_rng(4).integers(0, 5, n_rows * n_pins).astype(np.int32),
        device=cuda_device)
    ck, cp = prior.clone(), prior.clone()
    dk = vc.visit_counter_update_high(ck, s, p, qe, n_slots=n_slots,
                                      n_pins=n_pins, n_v=n_v, n_queries=nq)
    dp = vc.visit_counter_update_high_plain(cp, s, p, qe, n_slots=n_slots,
                                            n_pins=n_pins, n_v=n_v,
                                            n_queries=nq)
    assert torch.equal(ck, cp) and torch.equal(dk, dp)
    assert int(dk.sum()) > 0
    wk, wp = prior.clone(), prior.clone()
    vc.visit_counter_wide(wk, s, p, qe, n_slots=n_slots, n_dim=n_pins,
                          n_queries=nq)
    vc.visit_counter_wide_plain(wp, s, p, qe, n_slots=n_slots, n_dim=n_pins,
                                n_queries=nq)
    assert torch.equal(wk, wp)


def test_wrappers_count_launches_and_check_inputs(graph, cuda_device):
    _build.reset_launches()
    z = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    vc.visit_counter_wide(z, z, z, n_slots=1, n_dim=8)
    assert _build.launches["visit_counter_wide"] == 1
    with pytest.raises(TypeError, match="int32"):
        vc.visit_counter_wide(z, z.long(), z, n_slots=1, n_dim=8)
    with pytest.raises(ValueError, match="bins"):
        vc.visit_counter_wide(z[:4], z, z, n_slots=1, n_dim=8)
    x = _walkers(graph, 1, 16, 2, seed=1)
    with pytest.raises(ValueError, match="aligned"):
        rb = torch.empty(2 * 16 * 4 + 1, dtype=torch.int32, device=cuda_device)
        ws.walk_steps_fused(x["curr"], x["query"], x["feat"], x["slot"],
                            rb[1:].view(2, 16, 4), *_csr(graph)[:4],
                            n_pins=graph.n_pins, n_slots=3,
                            n_boards=graph.n_boards, alpha_u32=ALPHA_U32,
                            beta_u32=0)
    assert _build.launches["walk_steps_fused"] == 0


@pytest.mark.parametrize("count_boards", [False, True])
def test_serve_batch_kernel_path_matches_plain_path(sg, count_boards):
    graph = sg.graph
    cfg = walk.WalkConfig(n_steps=3000, n_walkers=256, chunk_steps=4,
                          top_k=20, n_p=40, n_v=3, count_boards=count_boards)
    qs = synthetic.top_degree_pins(sg, 24)
    pins = torch.full((6, 4), -1, dtype=torch.int32)
    weights = torch.zeros((6, 4))
    rng = np.random.default_rng(2)
    for i in range(6):
        k = 1 + i % 4
        pins[i, :k] = torch.as_tensor(rng.choice(qs, k, replace=False))
        weights[i, :k] = torch.as_tensor(rng.uniform(0.2, 1.0, k).astype(np.float32))
    feats = torch.arange(6, dtype=torch.int32) % 3
    dev = graph.device
    args = (graph, pins.to(dev), weights.to(dev), feats.to(dev),
            prng.key(5, dev), cfg)
    _build.reset_launches()
    got = service.serve_batch(*args, backend="pallas", with_stats=True)
    assert _build.launches["walk_steps_fused"] > 0
    assert (_build.launches["visit_counter_wide"] > 0) == count_boards
    _build.reset_launches()
    want = service.serve_batch(*args, backend="xla", with_stats=True)
    assert not any(_build.launches.values())
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    cpu = service.serve_batch(graph.to("cpu"), pins, weights, feats,
                              prng.key(5, "cpu"),
                              dataclasses.replace(cfg, backend="pallas"),
                              with_stats=True)
    for a, b in zip(got, cpu):
        assert torch.equal(a.cpu(), b)
