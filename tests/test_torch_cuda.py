"""Each CUDA kernel of the port against its plain PyTorch twin, on the card.

Marked ``cuda``: every test here skips on a host without a CUDA device
(the decision is made inside the ``cuda_device`` fixture).  The file
imports no jax, because the machine with the card has none; run it there
with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer outputs must match exactly: the kernels and the twins do the same
integer arithmetic on the same random bits, and every count increment is
1, so the atomics' order cannot show.  The embedding bag must match its
twin bit for bit too: both round every multiply, add and divide in the
same order (the kernel with ``_rn`` intrinsics, so nothing becomes an
FMA), and ranked serving through it must equal the plain path.  The
sharded engine's hop kernel must equal its twin at every shape, gated-off
lanes, degree-0 rows and a shard's last row included, and the sharded
walk's kernel path must equal its plain path.  The decode-attention
kernel runs an online softmax where its twin runs two passes, so the two
agree to float32 rounding: within 2e-6 absolute on the float32 output
(edge lengths, ragged batches, head dims that are not multiples of 32,
float32 and bf16 caches); the LM decode step's kernel path must give the
plain path's greedy tokens.  The kernel splits the sequence across CTAs:
rows that end at, just before or just after a split's edge, or leave
splits empty, agree with the twin too, and two runs give the same bits.
The counter adds its crossing tally into the caller's tally in place, one
launch, equal to the twin's prior tally plus its delta (one bin hit by
every event, n_v 1, many rows, the row cap).  The legacy flat histogram
and one-superstep walk must equal their twins exactly (no events,
out-of-range ids, dead ends on each CSR's last row, high-bit words,
walker counts off the 256-multiple), and event mode's kernel path its
plain path and the CPU run, every field.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import qwen2_5_3b
from repro_torch.core import counter, distributed, prng, service, walk
from repro_torch.graphs import synthetic
from repro_torch.models import transformer
from repro_torch.serving import decode, ranker
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import embedding_bag as eb
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


@pytest.mark.parametrize("with_query", [False, True])
def test_update_high_adds_into_a_prefilled_tally(cuda_device, with_query):
    """One launch: the crossings land in the caller's tally, added to what
    it held, bit for bit the twin's prior tally plus its fresh delta."""
    n_queries, n_slots, n_pins, n_v = 4, 3, 5000, 4
    q, s, p = _events(cuda_device, 21, 200_000, n_queries, n_slots, n_pins)
    qe = q if with_query else None
    nq = n_queries if with_query else 0
    n_rows = n_queries * n_slots if with_query else n_slots
    rng = np.random.default_rng(6)
    prior = torch.as_tensor(rng.integers(0, 5, n_rows * n_pins).astype(np.int32),
                            device=cuda_device)
    tally = torch.as_tensor(rng.integers(0, 100, n_rows).astype(np.int32),
                            device=cuda_device)
    ck, cp, hk = prior.clone(), prior.clone(), tally.clone()
    _build.reset_launches()
    out = vc.visit_counter_update_high(ck, s, p, qe, n_slots=n_slots, n_pins=n_pins,
                                       n_v=n_v, n_queries=nq, high=hk)
    assert out is hk and _build.launches["visit_counter_update_high"] == 1
    dp = vc.visit_counter_update_high_plain(cp, s, p, qe, n_slots=n_slots,
                                            n_pins=n_pins, n_v=n_v, n_queries=nq)
    assert torch.equal(ck, cp) and torch.equal(hk, tally + dp)
    assert int(dp.sum()) > 0


@pytest.mark.parametrize("case", ["one_bin", "n_v_1", "many_rows", "row_cap"])
def test_update_high_edge_cases_match_twin(cuda_device, case):
    rng = np.random.default_rng(len(case))
    n_queries, n_slots, n_pins, n_v, m = 2, 4, 300, 3, 50_000
    if case == "many_rows":
        n_queries, n_slots = 128, 16
    if case == "row_cap":
        n_queries, n_slots, n_pins = vc.MAX_HIGH_ROWS // 8, 8, 64
    if case == "n_v_1":
        n_v = 1
    q = rng.integers(0, n_queries, m).astype(np.int32)
    s = rng.integers(0, n_slots, m).astype(np.int32)
    p = rng.integers(0, n_pins, m).astype(np.int32)
    if case == "one_bin":
        q[:], s[:], p[:], n_v = 1, 2, 7, 20_000
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    n_rows = n_queries * n_slots
    ck = torch.zeros(n_rows * n_pins, dtype=torch.int32, device=cuda_device)
    cp = ck.clone()
    hk = torch.full((n_rows,), 5, dtype=torch.int32, device=cuda_device)
    kw = dict(n_slots=n_slots, n_pins=n_pins, n_v=n_v, n_queries=n_queries)
    vc.visit_counter_update_high(ck, t(s), t(p), t(q), high=hk, **kw)
    dp = vc.visit_counter_update_high_plain(cp, t(s), t(p), t(q), **kw)
    assert torch.equal(ck, cp) and torch.equal(hk, 5 + dp)
    if case == "one_bin":
        assert int(dp.sum()) == 1 and int(dp[1 * n_slots + 2]) == 1
    if case == "n_v_1":
        assert int(dp.sum()) == int((cp > 0).sum())
    if case == "row_cap":
        with pytest.raises(ValueError, match="at most"):
            vc.visit_counter_update_high(
                torch.zeros((n_rows + 8) * n_pins, dtype=torch.int32,
                            device=cuda_device), t(s), t(p), t(q),
                n_slots=n_slots, n_pins=n_pins, n_v=n_v, n_queries=n_queries + 1)


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


# the bag shapes of chip_smoke.py's kernel check: the ranked main path's
# neighbor bag (1, 64, 8) and query bag (1, 1, 64), then edge shapes
BAG_CASES = [
    ("float32", 32, (1, 64, 8)),
    ("float32", 32, (1, 1, 64)),
    ("bfloat16", 32, (4, 16, 8)),
    ("float32", 48, (3, 7, 5)),
    ("float32", 32, (37, 1)),
    ("bfloat16", 48, (13, 3)),
]


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype,d,shape", BAG_CASES)
def test_embedding_bag_kernel_matches_twin(cuda_device, dtype, d, shape, mode):
    rng = np.random.default_rng(len(shape) * 100 + d)
    v = 1000
    table = torch.as_tensor(rng.standard_normal((v, d)).astype(np.float32),
                            device=cuda_device).to(getattr(torch, dtype))
    ids = rng.integers(-1, v, shape).astype(np.int32)
    ids.reshape(-1, shape[-1])[0] = -1                # an all-padding bag
    w = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    ids_t = torch.as_tensor(ids, device=cuda_device)
    for weights in (torch.as_tensor(w, device=cuda_device), None):
        if len(shape) == 3:
            got = eb.embedding_bag_batched(table, ids_t, weights, mode=mode)
            want = eb.embedding_bag_batched_plain(table, ids_t, weights,
                                                  mode=mode)
        else:
            got = eb.embedding_bag(table, ids_t, weights, mode=mode)
            want = eb.embedding_bag_plain(table, ids_t, weights, mode=mode)
        torch.cuda.synchronize()
        assert got.dtype == table.dtype and got.shape == want.shape
        assert torch.equal(got, want)
        assert not got.reshape(-1, d)[0].any()


def test_embedding_bag_wrapper_counts_launches_and_checks_inputs(cuda_device):
    _build.reset_launches()
    table = torch.zeros((10, 8), device=cuda_device)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=cuda_device)
    eb.embedding_bag(table, ids)
    eb.embedding_bag_batched(table, ids[None])
    assert _build.launches["embedding_bag"] == 2
    with pytest.raises(TypeError, match="int32"):
        eb.embedding_bag(table, ids.long())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        eb.embedding_bag(table.double(), ids)
    with pytest.raises(ValueError, match="mode"):
        eb.embedding_bag(table, ids, mode="max")
    with pytest.raises(ValueError, match="is on cpu"):
        eb.embedding_bag(table, ids.cpu())
    assert _build.launches["embedding_bag"] == 2


def test_ranked_serve_batch_kernel_path_matches_plain_path(sg):
    graph = sg.graph
    dev = graph.device
    rcfg = ranker.RankerConfig(n_items=graph.n_pins, d_model=32,
                               n_neighbors=8, n_candidates=32, final_k=8)
    params = ranker.init_ranker_params(
        torch.Generator(device=dev).manual_seed(1), rcfg)
    rank = ranker.RankRequest(params, rcfg)
    cfg = walk.WalkConfig(n_steps=3000, n_walkers=256, chunk_steps=4,
                          top_k=20, n_p=40, n_v=3)
    qs = synthetic.top_degree_pins(sg, 24)
    pins = torch.full((6, 4), -1, dtype=torch.int32)
    weights = torch.zeros((6, 4))
    rng = np.random.default_rng(3)
    for i in range(6):
        k = 1 + i % 4
        pins[i, :k] = torch.as_tensor(rng.choice(qs, k, replace=False))
        weights[i, :k] = torch.as_tensor(rng.uniform(0.2, 1.0, k).astype(np.float32))
    feats = torch.arange(6, dtype=torch.int32) % 3
    scen = torch.arange(6, dtype=torch.int32, device=dev) % 2
    args = (graph, pins.to(dev), weights.to(dev), feats.to(dev),
            prng.key(5, dev))
    _build.reset_launches()
    got = service.serve_batch(*args, cfg, backend="pallas", rank=rank,
                              scenario=scen, with_stats=True)
    assert _build.launches["embedding_bag"] == 2
    retrieval = dataclasses.replace(cfg, top_k=rcfg.n_candidates)
    s, i, st, nh = service.serve_batch(*args, retrieval, backend="xla",
                                       with_stats=True)
    want = ranker.rank_candidates(params, rcfg, graph, i, s, scen,
                                  use_kernel=False)
    for a, b in zip(got, (*want, st, nh)):
        assert torch.equal(a, b)
    assert torch.backends.cuda.matmul.allow_tf32 is False


# ---------------------------------------------------------------------------
# the sharded engine's hop kernel
# ---------------------------------------------------------------------------


def _hop_lanes(dev, n_shards, l, rows, seed, gate_frac=0.7):
    """Stacked CSR slices with degree-0 rows, lanes at random rows plus
    each shard's last row and its degree-0 rows, gated-off lanes holding
    garbage positions; row_base = 11 + shard * rows."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 6, (n_shards, rows))
    deg[:, rng.integers(0, rows, max(1, rows // 8))] = 0
    off = np.concatenate([np.zeros((n_shards, 1), np.int64),
                          np.cumsum(deg, 1)], 1).astype(np.int32)
    e_max = max(1, int(off[:, -1].max()))
    tgt = rng.integers(0, 10**6, (n_shards, e_max)).astype(np.int32)
    base = (11 + np.arange(n_shards) * rows).astype(np.int32)
    local = rng.integers(0, rows, (n_shards, l))
    local[:, -1] = rows - 1
    zero = np.nonzero(deg[0] == 0)[0]
    local[:, :min(len(zero), l // 2)] = zero[:l // 2]
    gate = rng.random((n_shards, l)) < gate_frac
    pos = np.where(gate, base[:, None] + local,
                   rng.integers(-5, 10**7, (n_shards, l))).astype(np.int32)
    r = rng.integers(0, 2**32, (n_shards, l), dtype=np.uint64)
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(pos), t(gate), t(r.astype(np.uint32).view(np.int32)),
            t(base), t(off), t(tgt))


@pytest.mark.parametrize("n_shards,l,rows,gate_frac", [
    (1, 64, 20, 0.7), (3, 1000, 50, 0.7), (16, 1024, 4096, 0.9),
    (16, 16384, 100, 0.5), (4, 333, 30, 0.0), (2, 128, 40, 1.0),
])
def test_walk_hop_kernel_matches_twin(cuda_device, n_shards, l, rows,
                                      gate_frac):
    pos, gate, r, base, off, tgt = _hop_lanes(cuda_device, n_shards, l, rows,
                                              seed=n_shards * 7 + l,
                                              gate_frac=gate_frac)
    _build.reset_launches()
    got = ws.walk_hop_fused(pos, gate, r, base, off, tgt)
    torch.cuda.synchronize()
    assert _build.launches["walk_hop_fused"] == 1
    want = ws.walk_hop_ref(pos, gate, r, off, tgt, base)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[1].any()) == (gate_frac > 0)
    # one shard unstacked, at a row_base past 0
    one = ws.walk_hop_fused(pos[-1], gate[-1], r[-1], base[-1:], off[-1],
                            tgt[-1])
    assert torch.equal(one[0], want[0][-1]) and torch.equal(one[1], want[1][-1])


def test_walk_hop_wrapper_refuses_bad_inputs(cuda_device):
    pos, gate, r, base, off, tgt = _hop_lanes(cuda_device, 2, 32, 10, seed=3)
    with pytest.raises(ValueError, match="CUDA"):
        ws.walk_hop_fused(pos.cpu(), gate.cpu(), r.cpu(), base.cpu(),
                          off.cpu(), tgt.cpu())
    with pytest.raises(ValueError, match="is on cpu"):
        ws.walk_hop_fused(pos, gate, r, base.cpu(), off, tgt)
    with pytest.raises(TypeError, match="gate must be torch.bool"):
        ws.walk_hop_fused(pos, gate.int(), r, base, off, tgt)
    with pytest.raises(TypeError, match="r must be torch.int32"):
        ws.walk_hop_fused(pos, gate, r.long(), base, off, tgt)
    with pytest.raises(TypeError, match="targets must be torch.int32"):
        ws.walk_hop_fused(pos, gate, r, base, off, tgt.long())
    with pytest.raises(ValueError, match="row_base has shape"):
        ws.walk_hop_fused(pos, gate, r, base[:1], off, tgt)
    with pytest.raises(ValueError, match="stack 2 shard slices"):
        ws.walk_hop_fused(pos, gate, r, base, off[:1], tgt[:1])
    with pytest.raises(ValueError, match="contiguous"):
        ws.walk_hop_fused(pos.t().contiguous().t(), gate, r, base, off, tgt)
    # the dispatch hands int64 words to the kernel as their low 32 bits
    _build.reset_launches()
    a = ops.walk_hop(pos, gate, r.long() & 0xFFFFFFFF, off, tgt,
                                 base, use_kernel=True)
    b = ws.walk_hop_fused(pos, gate, r, base, off, tgt)
    assert _build.launches["walk_hop_fused"] == 2
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("slack,dead", [(8.0, None), (0.05, [2**31 - 1, 3, 2**31 - 1, 5])])
def test_sharded_walk_kernel_path_matches_plain_path(cuda_device, slack, dead):
    sg20 = synthetic.generate(
        synthetic.SyntheticGraphConfig(n_pins=20_000, n_boards=2_000,
                                       n_topics=16, n_langs=4, seed=7),
        device=cuda_device)
    shg = distributed.shard_graph(sg20.graph, 4)
    qs = synthetic.top_degree_pins(sg20, 16)
    pins = torch.as_tensor(qs[:12].reshape(3, 4).astype(np.int32),
                           device=cuda_device)
    pins[1, 3] = -1
    weights = torch.rand((3, 4), generator=torch.Generator().manual_seed(0))
    weights = weights.to(cuda_device)
    keys = prng.split(prng.key(9, cuda_device), 3)
    fabric = distributed.LocalFabric(4, device=cuda_device)
    dead_t = None if dead is None else torch.tensor(dead, device=cuda_device)
    out = {}
    for backend in ("pallas", "xla"):
        cfg = walk.WalkConfig(n_steps=20_000, n_walkers=512, chunk_steps=4,
                              n_p=300, n_v=3, bias_beta=0.0,
                              count_boards=True, backend=backend)
        _build.reset_launches()
        out[backend] = distributed.pixie_walk_sharded_batched(
            shg, pins, weights, keys, cfg, fabric, slack=slack,
            shard_dead_at=dead_t)
        torch.cuda.synchronize()
        launched = _build.launches["walk_hop_fused"]
        assert (launched > 0) == (backend == "pallas")
    for name, a in out["pallas"]._asdict().items():
        b = getattr(out["xla"], name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    if dead is None:
        flat = walk.pixie_random_walk_batched(
            sg20.graph, pins, weights, torch.zeros(3, dtype=torch.int32,
                                                   device=cuda_device),
            keys, cfg)
        assert int(out["pallas"].dropped) == 0
        fold = counter.fold_sharded_counts(out["pallas"].counts, 3, 4,
                                           shg.pins_per_shard)
        assert torch.equal(fold[..., :sg20.graph.n_pins], flat.counts)
    else:
        assert int(out["pallas"].dropped) > 0 and int(out["pallas"].killed) > 0


# (b, h, kh, dh, s, lengths): "ragged" draws each row's length, an int is
# one length for every row
ATTN_CASES = [
    (2, 8, 2, 64, 512, "ragged"),
    (1, 16, 16, 128, 300, "ragged"),
    (4, 4, 1, 128, 1024, "ragged"),
    (3, 16, 2, 128, 544, 1),          # length 1
    (2, 15, 5, 64, 200, 131),         # smollm's group 3; not a tile multiple
    (2, 6, 2, 16, 40, "ragged"),      # dh 16
    (2, 3, 1, 20, 70, 67),            # dh 20, not a multiple of 32
    (1, 64, 1, 256, 129, "ragged"),   # group 64, dh 256: large shared memory
]


def _attn_inputs(dev, b, h, kh, dh, s, lengths, kv_dtype, q_dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, dh), generator=g, device=dev).to(q_dtype)
    k = torch.randn((b, s, kh, dh), generator=g, device=dev).to(kv_dtype)
    v = torch.randn((b, s, kh, dh), generator=g, device=dev).to(kv_dtype)
    if lengths == "ragged":
        lengths = torch.randint(1, s + 1, (b,), generator=g, device=dev,
                                dtype=torch.int32)
        lengths[0] = s
    return q, k, v, lengths


@pytest.mark.parametrize("kv_dtype,q_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("b,h,kh,dh,s,lengths", ATTN_CASES)
def test_decode_attention_kernel_matches_twin(cuda_device, b, h, kh, dh, s,
                                              lengths, kv_dtype, q_dtype):
    q, k, v, lens = _attn_inputs(cuda_device, b, h, kh, dh, s, lengths,
                                 kv_dtype, q_dtype, b * s + dh)
    got = da.decode_attention(q, k, v, lens)
    want = da.decode_attention_plain(q, k, v, lens)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (b, h, dh)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-6


@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_split_boundaries(cuda_device, kv_dtype):
    """Rows of one ragged batch at 1, a split's length - 1, its length,
    + 1 and the whole cache: rows that fill one split and rows that fill
    them all, the rest of the splits empty."""
    b, h, kh, dh, s = 5, 16, 2, 128, 4096
    plan = da.plan(b, h, kh, dh, kv_dtype, s)
    sl = plan.split_len
    assert plan.n_splits > 1 and plan.ctas == plan.n_splits * b * kh
    q, k, v, _ = _attn_inputs(cuda_device, b, h, kh, dh, s, 1, kv_dtype,
                              kv_dtype, 31)
    lens = torch.tensor([1, sl - 1, sl, sl + 1, s], dtype=torch.int32,
                        device=cuda_device)
    got = da.decode_attention(q, k, v, lens)
    want = da.decode_attention_plain(q, k, v, lens)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 2e-6
    for length in (sl - 1, sl, sl + 1, s):     # one int length for every row
        got = da.decode_attention(q, k, v, length)
        want = da.decode_attention_plain(q, k, v, length)
        assert float((got - want).abs().max()) <= 2e-6


@pytest.mark.parametrize("b,kh,length", [(2, 2, 32768), (70, 2, 300), (3, 2, 100)])
def test_decode_attention_is_the_same_bits_run_to_run(cuda_device, b, kh, length):
    """The splits merge in a fixed order with no float atomics; (70, 2)
    fills the card and (3, 2, 100) is short: both take the one-split
    path, which writes the output with no merge."""
    h, dh = 8 * kh, 128
    q, k, v, _ = _attn_inputs(cuda_device, b, h, kh, dh, length, 1,
                              torch.bfloat16, torch.bfloat16, 3)
    plan = da.plan(b, h, kh, dh, torch.bfloat16, length)
    assert (plan.n_splits > 1) == (b * kh < 132 and length > 128)
    first = da.decode_attention(q, k, v, length)
    assert torch.equal(first, da.decode_attention(q, k, v, length))
    want = da.decode_attention_plain(q, k, v, length)
    assert float((first - want).abs().max()) <= 2e-6


def test_decode_attention_wrapper_counts_launches_and_checks_inputs(cuda_device):
    q, k, v, lens = _attn_inputs(cuda_device, 2, 4, 2, 32, 50, "ragged",
                                 torch.float32, torch.float32, 0)
    _build.reset_launches()
    da.decode_attention(q, k, v, lens)
    ops.decode_attention(q, k, v, 7, use_kernel=True)
    ops.decode_attention(q, k, v, 7, use_kernel=False)
    assert _build.launches["decode_attention"] == 2
    with pytest.raises(ValueError, match=r"\[1, 50\]"):
        da.decode_attention(q, k, v, 0)
    with pytest.raises(ValueError, match=r"\[1, 50\]"):
        da.decode_attention(q, k, v, torch.zeros_like(lens))
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, k[:, ::2], v[:, ::2], 3)
    with pytest.raises(ValueError, match="is on cpu"):
        da.decode_attention(q.cpu(), k, v, 3)
    wide = torch.zeros((1, 2, 1, 512), device=cuda_device)
    with pytest.raises(ValueError, match="head_dim"):
        da.decode_attention(torch.zeros((1, 1, 512), device=cuda_device),
                            wide, wide, 1)
    assert _build.launches["decode_attention"] == 2


@pytest.mark.parametrize("pad_heads", [False, True])
def test_decode_kernel_path_matches_plain_path(cuda_device, pad_heads):
    import dataclasses

    cfg = dataclasses.replace(qwen2_5_3b.SMOKE, cache_dtype=torch.float32)
    if pad_heads:
        cfg = dataclasses.replace(cfg, n_heads=6, n_kv_heads=2, pad_heads_to=8)
    params = transformer.init_params(
        torch.Generator(device=cuda_device).manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (3, 9), dtype=torch.int32,
                           generator=torch.Generator(device=cuda_device).manual_seed(1),
                           device=cuda_device)
    out = {}
    for backend in ("pallas", "xla"):
        _build.reset_launches()
        out[backend] = decode.generate(params, prompt, cfg, max_new_tokens=6,
                                       backend=backend)
        torch.cuda.synchronize()
        assert (_build.launches["decode_attention"] > 0) == (backend == "pallas")
    assert torch.equal(out["pallas"], out["xla"])
    logits = {}
    for backend in ("pallas", "xla"):
        _, cache = transformer.prefill(params, prompt, cfg, max_seq=12)
        logits[backend], _ = transformer.decode_step(
            params, cache, out["pallas"][:, 9], 9, cfg, backend=backend)
    assert float((logits["pallas"] - logits["xla"]).abs().max()) <= 2e-6


# ---------------------------------------------------------------------------
# the legacy kernels and event mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n_bins", [
    (0, 64), (1, 1), (5000, 1300), (777, 33), (200_000, 4099), (300, 0),
])
def test_visit_counter_kernel_matches_twin(cuda_device, m, n_bins):
    rng = np.random.default_rng(m + n_bins)
    ev = rng.integers(-5, n_bins + 20, m).astype(np.int32)
    if m >= 4:
        ev[:4] = [-(2**31), 2**31 - 1, n_bins, -1]
    ev = torch.as_tensor(ev, device=cuda_device)
    _build.reset_launches()
    got = vc.visit_counter(ev, n_bins)
    assert _build.launches["visit_counter"] == (1 if m and n_bins else 0)
    assert torch.equal(got, vc.visit_counter_plain(ev, n_bins))
    assert torch.equal(ops.visit_counts(ev, n_bins), got)
    with pytest.raises(TypeError, match="int32"):
        vc.visit_counter(ev.long(), n_bins)


def _dead_end_csr(dev):
    """6 pins, 4 boards (global ids 6..9): pins 0 and 5 (the last row)
    have no boards, boards 2 and 3 (the last row) no pins, and pins 3 and
    1 point at them."""
    t = lambda a: torch.tensor(a, dtype=torch.int32, device=dev)
    return (t([0, 0, 2, 3, 4, 6, 6]), t([6, 9, 7, 8, 6, 7]),
            t([0, 2, 4, 4, 4]), t([1, 4, 2, 4]), 6)


@pytest.mark.parametrize("w", [1, 100, 256, 4096])
@pytest.mark.parametrize("alpha_u32", [0, 2**31, 2**32 - 1])
@pytest.mark.parametrize("which", ["small_test_graph", "dead_ends"])
def test_walk_step_kernel_matches_twin(graph, cuda_device, which, alpha_u32, w):
    if which == "dead_ends":
        *csr, n_pins = _dead_end_csr(cuda_device)
    else:
        csr, n_pins = list(_csr(graph)[:4]), graph.n_pins
    rng = np.random.default_rng(w + alpha_u32 % 97)
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    curr = t(rng.integers(0, n_pins, w).astype(np.int32))
    query = t(rng.integers(0, n_pins, w).astype(np.int32))
    words = rng.integers(0, 2**32, (w, 3), dtype=np.uint64).astype(np.uint32)
    words[::2] |= np.uint32(2**31)          # high-bit draws
    rbits = t(words.view(np.int32))
    _build.reset_launches()
    got = ws.walk_step(curr, query, rbits, *csr, n_pins=n_pins,
                       alpha_u32=alpha_u32)
    assert _build.launches["walk_step"] == 1
    want = ws.walk_step_plain(curr, query, rbits, *csr, n_pins=n_pins,
                              alpha_u32=alpha_u32)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    via_ops = ops.walk_step(curr, query, t(words.astype(np.int64)), *csr,
                            n_pins=n_pins, alpha_u32=alpha_u32)
    for a, b in zip(via_ops, got):
        assert torch.equal(a, b)


def test_walk_step_wrapper_checks_inputs(graph, cuda_device):
    csr = _csr(graph)[:4]
    z = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        ws.walk_step(z, z, torch.zeros((8, 4), dtype=torch.int32,
                                       device=cuda_device),
                     *csr, n_pins=graph.n_pins, alpha_u32=0)
    with pytest.raises(ValueError, match="uint32"):
        ws.walk_step(z, z, torch.zeros((8, 3), dtype=torch.int32,
                                       device=cuda_device),
                     *csr, n_pins=graph.n_pins, alpha_u32=2**32)


@pytest.mark.parametrize("check_mode", ["incremental", "full"])
@pytest.mark.parametrize("early_stop", [True, False])
def test_event_walk_kernel_path_matches_plain_path(sg, check_mode, early_stop):
    """pixie_walk_events + recommend_from_events: the kernel path equals the
    twin path on the card and the CPU run, every field bit for bit."""
    graph = sg.graph
    cfg = walk.WalkConfig(n_steps=20_000, n_walkers=256, chunk_steps=4,
                          top_k=50, n_p=30, n_v=3)
    if not early_stop:
        cfg = cfg.without_early_stop()
    qs = synthetic.top_degree_pins(sg, 20)
    pins = torch.tensor([qs[0], qs[3], -1, qs[5]], dtype=torch.int32)
    weights = torch.tensor([1.0, 0.5, 0.0, 0.3])

    def run(g, backend):
        c = dataclasses.replace(cfg, backend=backend)
        dev = g.device
        r = walk.pixie_walk_events(g, pins.to(dev), weights.to(dev), 1,
                                   prng.key(5, dev), c, check_every=2,
                                   check_mode=check_mode)
        return (*r, *walk.recommend_from_events(r, 4, g.n_pins, pins.to(dev),
                                                c.top_k))

    _build.reset_launches()
    got = run(graph, "pallas")
    torch.cuda.synchronize()
    assert _build.launches["walk_steps_fused"] == int(got[3])
    _build.reset_launches()
    want = run(graph, "xla")
    assert not any(_build.launches.values())
    cpu = run(graph.to("cpu"), "pallas")
    for a, b, c in zip(got, want, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)
