"""Each CUDA kernel of the port against its plain PyTorch twin, on the card.

Marked ``cuda``: every test here skips on a host without a CUDA device
(the decision is made inside the ``cuda_device`` fixture).  The file
imports no jax, because the machine with the card has none; run it there
with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Integer outputs must match exactly: the kernels and the twins do the same
integer arithmetic on the same random bits, and every count increment is
1, so the atomics' order cannot show.  The walk kernel draws its threefry
words from the keys and the word-table kernel writes them: both must give
``walk._chunk_rbits``'s words bit for bit (step bases past 2**16), and on
the kernel path the dense, event and sharded walks call no torch
threefry for their words.  The embedding bag must match its
twin bit for bit too: both round every multiply, add and divide in the
same order (the kernel with ``_rn`` intrinsics, so nothing becomes an
FMA), and ranked serving through it must equal the plain path.  The
sharded engine's hop kernel, which reads each lane's word from the
chunk's table by walker id, must equal its twin on the gathered words at
every shape, gated-off lanes with garbage positions and walker ids,
degree-0 rows and a shard's last row included, and the sharded
walk's kernel path must equal its plain path.  The decode-attention
kernel runs an online softmax where its twin runs two passes, so the two
agree to float32 rounding: within 2e-6 absolute on the float32 output
(edge lengths, ragged batches, head dims that are not multiples of 32,
float32 and bf16 caches); the LM decode step's kernel path must give the
plain path's greedy tokens.  The kernel splits the sequence across CTAs:
rows that end at, just before or just after a split's edge, or leave
splits empty, agree with the twin too, and two runs give the same bits.
The wide counter must equal its twin where a tile's bins fit the block's
shared window and where they do not (hot bins, sentinels, no events, no
query lane); the embedding bag at the edge lengths of its staging (1 to
300 elements, bf16 rows of odd width) and the ranked request's pair of
bag sets, one launch, equal to two calls.
The counter adds its crossing tally into the caller's tally in place, one
launch, equal to the twin's prior tally plus its delta (one bin hit by
every event, n_v 1, many rows, past the old row cap).  The legacy flat histogram
and one-superstep walk must equal their twins exactly (no events,
out-of-range ids, dead ends on each CSR's last row, high-bit words,
walker counts off the 256-multiple and on both sides of the launcher's
block sizes), and event mode's kernel path its plain path and the CPU
run, every field.  The counter takes any row count: past 12,288 rows (the
shared-memory tally's old cap) it equals its twin, with a query lane and
without, n_v 1 included, and a sharded batch past it serves on the
kernel path as on the plain path.  Graph pruning runs on the card and
must give the CPU's pruned graph array for array on the benchmarks' 20k
graph (its entropies within 1e-6 of the CPU's: the float64 log is the
card's), the content baselines' scores the CPU's (Hamming and combined
exactly, cosine within 2e-6), and ``ceil(d**delta)`` from the card's
``pow`` numpy's at every degree to 10,000.  The recsys models at their
SMOKE widths (SASRec, BST, both DLRMs) give the CPU port's user states,
scores, logits and losses within 2e-6 and its top-k ids exactly, with
float32 matmuls (no TF32); ``jnp.take``'s id table (NaN rows past the
table, no host sync), ``topk_total``'s NaN order and ``lookup_sharded``
over ``LocalFabric(1, 2, 4)`` hold on the card as on the CPU.  The MoE
SMOKE configs give the CPU port's hidden states, logits and caches within
2e-6 times max(1, the largest magnitude) and its greedy tokens on both
decode paths; the card's gumbel noise is the CPU's bit for bit and its
temperature samples the CPU's tokens; the expert products'
``bmm(out_dtype=float32)`` and the CPU's upcast product each lie within
the float32 dot-product error bound of the float64 product; GIN on the
card gives the CPU's logits and losses within the same bound, and the
same bits on a second call.  Training at SMOKE widths: three LM train
steps (qwen and granite, two microbatches, remat), two recsys hybrid
steps (rowwise AdaGrad on the table, AdamW on the rest) and three GIN
steps give the CPU port's state within 2e-6 times max(1, the CPU's
largest magnitude) and the same bits on a second card run;
``rowwise_adagrad_update`` likewise; ``embedding.gather_rows``' backward
on hot ids is the same bits twice and within the float32 summation bound
of the float64 sums.  The distribution layer: expert-parallel decode on a
local (1, 4) and (2, 2) mesh on the card gives the unsharded greedy
tokens (the attention kernel launched) and the CPU mesh run's hidden
states within the same bound; ``compressed_psum`` over four local shards
gives the CPU port's reduced values and residuals bit for bit.  Routing
over the global batch (``moe.moe_ffn_global`` over 2 and 4 local data
blocks) gives ``moe_ffn``'s output, aux and gradients of the whole batch
on the card within 2e-6 times max(1, magnitude), a NaN token kept to its
own row.
A served batch's record (``serving/batch_trace.py``): under
``torch.cuda.set_sync_debug_mode("warn")`` the batch warns once for each
host wait the record counts but ``harvest.done``, an event wait, which
that mode cannot see; a profiled batch's chrome trace holds each
``pixie.*`` range once, the walk kernel's launches inside ``pixie.walk``;
the record's own host cost a batch, timed over 1,000 records, is
printed (``batch_record_host_us``) and held under 1 ms.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import qwen2_5_3b
from repro_torch.core import baselines, counter, distributed, prng, pruning
from repro_torch.core import graph as graph_lib
from repro_torch.core import service, walk
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


def _walkers(graph, n_queries, w, seed):
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
    query = rng.choice(live, n).astype(np.int32)
    query[-2:] = curr[-2:]                 # walkers that start on their query
    return dict(
        curr=t(curr), query=t(query),
        feat=t(rng.integers(0, 3, n).astype(np.int32)),
        slot=t(rng.integers(0, 3, n).astype(np.int32)),
        qid=t(np.repeat(np.arange(n_queries, dtype=np.int32), w)),
        keys=prng.split(prng.key(seed, dev), n_queries),
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
    """The kernel draws its words from the keys; the twins take the table
    of walk._chunk_rbits for the same keys (dead-end starts, walkers on
    their query pin, a step_base past 2**16)."""
    n_queries = 1 if mode == "per_query" else 5
    w, chunk, step_base = 300, 6, 70_000
    x = _walkers(graph, n_queries, w, seed=8)
    kw = dict(n_pins=graph.n_pins, n_slots=3, n_boards=graph.n_boards,
              alpha_u32=ALPHA_U32, beta_u32=BETA_U32 if bias else 0,
              count_boards=count_boards)
    a = (x["curr"], x["query"], x["feat"], x["slot"])
    keys = x["keys"][0] if mode == "per_query" else x["keys"]
    kbits = ws.u32_bits_as_int32(keys).contiguous()
    rbits = walk._chunk_rbits(keys, step_base, chunk, w)
    steps = dict(step_base=step_base, chunk_steps=chunk)
    _build.reset_launches()
    if mode == "per_query":
        got = ws.walk_steps_fused(*a, kbits, *_csr(graph), **steps, **kw)
        want = ws.walk_chunk_plain(*a, rbits, *_csr(graph), **kw)
    else:
        got = ws.walk_steps_fused(*a, kbits, *_csr(graph), x["qid"],
                                  n_queries=n_queries, **steps, **kw)
        want = ws.walk_chunk_batched_plain(*a, x["qid"], rbits,
                                           *_csr(graph), n_queries=n_queries,
                                           **kw)
    torch.cuda.synchronize()
    assert _build.launches["walk_steps_fused"] == 1
    _assert_lanes_equal(got, want)
    sev = got[-3]
    assert bool((sev == 3).any()) and bool((sev < 3).any())


@pytest.mark.parametrize("n_keys,w,chunk,step_base", [
    (1, 8192, 8, 0), (8, 1024, 8, 8), (3, 333, 5, 70_000),
    (1, 1, 1, 2**32 - 2), (16, 512, 24, 1_000_000),
])
def test_walk_bits_kernel_matches_chunk_rbits(cuda_device, n_keys, w, chunk,
                                              step_base):
    keys = prng.split(prng.key(n_keys + w, cuda_device), n_keys)
    if n_keys == 1:
        keys = keys[0]
    _build.reset_launches()
    got = ops.walk_bits(keys, step_base, chunk, w, use_kernel=True)
    torch.cuda.synchronize()
    assert _build.launches["walk_bits"] == 1
    want = walk._chunk_rbits(keys, step_base, chunk, w)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(ops.walk_bits(keys, step_base, chunk, w,
                                     use_kernel=False), want)


def test_walk_kernel_path_draws_no_threefry_in_torch(sg, monkeypatch):
    """The dense, event and sharded walks on the kernel path call no torch
    threefry for their words (prng.bits); the plain path does."""
    graph = sg.graph
    dev = graph.device
    calls = []
    real_bits = prng.bits
    monkeypatch.setattr(prng, "bits", lambda *a, **k: calls.append(1) or real_bits(*a, **k))
    cfg = walk.WalkConfig(n_steps=3000, n_walkers=256, chunk_steps=4,
                          top_k=20, n_p=40, n_v=3, bias_beta=0.0)
    qs = synthetic.top_degree_pins(sg, 8)
    pins = torch.as_tensor(qs[:8].reshape(2, 4).astype(np.int32), device=dev)
    weights = torch.ones((2, 4), device=dev)
    feats = torch.zeros(2, dtype=torch.int32, device=dev)
    keys = prng.split(prng.key(1, dev), 2)
    shg = distributed.shard_graph(graph, 2)
    fabric = distributed.LocalFabric(2, device=dev)
    for backend, drawn in (("pallas", False), ("xla", True)):
        c = dataclasses.replace(cfg, backend=backend)
        for run in (
            lambda: walk.pixie_random_walk_batched(graph, pins, weights, feats,
                                                   keys, c),
            lambda: walk.pixie_walk_events(graph, pins[0], weights[0], 0,
                                           keys[0], c),
            lambda: distributed.pixie_walk_sharded_batched(
                shg, pins, weights, keys, c, fabric, slack=8.0),
        ):
            calls.clear()
            run()
            assert bool(calls) == drawn, backend


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


def _query_major_lanes(dev, seed, n_queries, w, steps, n_slots, n_dim):
    """Wide lanes laid out as the walk writes them: (steps, n_queries * w),
    walkers query-major, so a tile of one step's walkers lies in one
    query's n_slots * n_dim window; sentinels and out-of-range ids mixed in,
    and a few hot bins."""
    rng = np.random.default_rng(seed)
    q = np.repeat(np.arange(n_queries, dtype=np.int32), w)[None].repeat(steps, 0)
    s = rng.integers(0, n_slots, q.shape).astype(np.int32)
    i = rng.integers(0, n_dim, q.shape).astype(np.int32)
    hot = rng.random(q.shape) < 0.3
    i[hot] = rng.integers(0, 4, int(hot.sum()))
    q[0, :7] = n_queries                      # query sentinel
    s[1, :7] = n_slots                        # slot sentinel
    s[2, :3] = -1
    i[3, :3] = n_dim
    i[4, 5:9] = -5
    t = lambda a: torch.as_tensor(a.reshape(-1).copy(), device=dev)
    return t(q), t(s), t(i)


@pytest.mark.parametrize("case", [
    "window", "window_small_m", "global", "global_small_m", "one_bin",
    "no_query_lane", "no_query_lane_global", "no_events", "all_invalid"])
def test_wide_kernel_matches_twin(cuda_device, case):
    """The wide counter's two paths inside one kernel: tiles whose bins fit
    the block's shared window (the board-rec bucket's layout) and tiles
    that do not (one query's window of millions of bins); hot bins,
    sentinels, no events and no query lane.  Bit-identical to the twin,
    on a prefilled buffer, one launch (none for no events)."""
    n_queries, w, steps, n_slots, n_dim = 16, 8192, 8, 4, 2000
    if case in ("global", "global_small_m", "no_query_lane_global"):
        n_queries, n_dim = 2, 3_000_000
    if case.endswith("small_m"):
        # a few thousand events: 512-event tiles, which span two queries'
        # windows (800 bins at n_dim 100, inside the 4-bins-an-event cap)
        w, steps = 256, 5
        n_dim = 100 if case == "window_small_m" else n_dim
    q, s, i = _query_major_lanes(cuda_device, len(case), n_queries, w, steps,
                                 n_slots, n_dim)
    if case == "one_bin":
        q.fill_(3), s.fill_(1), i.fill_(17)
    if case == "no_events":
        q, s, i = q[:0], s[:0], i[:0]
    if case == "all_invalid":
        s.fill_(n_slots)
    with_query = not case.startswith("no_query_lane")
    qe, nq = (q, n_queries) if with_query else (None, 0)
    n_rows = n_queries * n_slots if with_query else n_slots
    rng = np.random.default_rng(8)
    prior = torch.as_tensor(rng.integers(0, 3, n_rows * n_dim).astype(np.int32),
                            device=cuda_device)
    ck, cp = prior.clone(), prior.clone()
    kw = dict(n_slots=n_slots, n_dim=n_dim, n_queries=nq)
    _build.reset_launches()
    out = vc.visit_counter_wide(ck, s, i, qe, **kw)
    torch.cuda.synchronize()
    assert out is ck
    assert _build.launches["visit_counter_wide"] == (0 if case == "no_events" else 1)
    vc.visit_counter_wide_plain(cp, s, i, qe, **kw)
    assert torch.equal(ck, cp)
    added = int((ck.long() - prior.long()).sum())
    if case in ("no_events", "all_invalid"):
        assert added == 0
    else:
        assert added > 0
    if case == "one_bin":
        assert added == s.shape[0]


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


# past 12,288 rows the kernel tallies crossings with global atomics, below
# it in shared memory: (rows, with a query lane, n_v) on both sides of it
ROW_CAP_CASES = {
    "row_cap": (12_289, True, 3),
    "row_cap_16384": (16_384, True, 3),
    "row_cap_n_v_1": (16_384, True, 1),
    "row_cap_no_query_lane": (12_289, False, 3),
    "row_cap_no_query_lane_16384": (16_384, False, 1),
}


@pytest.mark.parametrize("case", ["one_bin", "n_v_1", "many_rows", *ROW_CAP_CASES])
def test_update_high_edge_cases_match_twin(cuda_device, case):
    """Every row count is taken: past the old 12,288-row cap the kernel
    equals its twin too, into a prefilled tally."""
    rng = np.random.default_rng(len(case))
    n_queries, n_slots, n_pins, n_v, m = 2, 4, 300, 3, 50_000
    with_query = True
    if case == "many_rows":
        n_queries, n_slots = 128, 16
    if case in ROW_CAP_CASES:
        n_rows, with_query, n_v = ROW_CAP_CASES[case]
        n_pins, m = 64, 200_000
        n_slots = (8 if n_rows % 8 == 0 else 1) if with_query else n_rows
        n_queries = n_rows // n_slots
    if case == "n_v_1":
        n_v = 1
    q = rng.integers(0, n_queries, m).astype(np.int32)
    s = rng.integers(0, n_slots, m).astype(np.int32)
    p = rng.integers(0, n_pins, m).astype(np.int32)
    if case == "one_bin":
        q[:], s[:], p[:], n_v = 1, 2, 7, 20_000
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    n_rows = n_queries * n_slots
    ck = torch.as_tensor(rng.integers(0, 2, n_rows * n_pins).astype(np.int32),
                         device=cuda_device)
    if n_v == 1:
        ck.zero_()                       # every touched bin crosses
    cp = ck.clone()
    hk = torch.full((n_rows,), 5, dtype=torch.int32, device=cuda_device)
    kw = dict(n_slots=n_slots, n_pins=n_pins, n_v=n_v,
              n_queries=n_queries if with_query else 0)
    qe = t(q) if with_query else None
    _build.reset_launches()
    vc.visit_counter_update_high(ck, t(s), t(p), qe, high=hk, **kw)
    assert _build.launches["visit_counter_update_high"] == 1
    dp = vc.visit_counter_update_high_plain(cp, t(s), t(p), qe, **kw)
    assert torch.equal(ck, cp) and torch.equal(hk, 5 + dp)
    assert int(dp.sum()) > 0
    if case == "one_bin":
        assert int(dp.sum()) == 1 and int(dp[1 * n_slots + 2]) == 1
    if n_v == 1:
        assert int(dp.sum()) == int((cp > 0).sum())


def test_wrappers_count_launches_and_check_inputs(graph, cuda_device):
    _build.reset_launches()
    z = torch.zeros(8, dtype=torch.int32, device=cuda_device)
    vc.visit_counter_wide(z, z, z, n_slots=1, n_dim=8)
    assert _build.launches["visit_counter_wide"] == 1
    with pytest.raises(TypeError, match="int32"):
        vc.visit_counter_wide(z, z.long(), z, n_slots=1, n_dim=8)
    with pytest.raises(ValueError, match="bins"):
        vc.visit_counter_wide(z[:4], z, z, n_slots=1, n_dim=8)
    x = _walkers(graph, 1, 16, seed=1)
    a = (x["curr"], x["query"], x["feat"], x["slot"])
    kw = dict(step_base=0, chunk_steps=2, n_pins=graph.n_pins, n_slots=3,
              n_boards=graph.n_boards, alpha_u32=ALPHA_U32, beta_u32=0)
    kb = ws.u32_bits_as_int32(x["keys"]).contiguous()
    with pytest.raises(ValueError, match="aligned"):
        k = torch.empty(5, dtype=torch.int32, device=cuda_device)
        ws.walk_steps_fused(*a, k[1:3], *_csr(graph)[:4], **kw)
    with pytest.raises(TypeError, match="keys must be torch.int32"):
        ws.walk_steps_fused(*a, x["keys"], *_csr(graph)[:4], **kw)
    with pytest.raises(ValueError, match="split evenly"):
        ws.walk_steps_fused(*a, torch.cat([kb, kb, kb]), *_csr(graph)[:4], **kw)
    with pytest.raises(ValueError, match="keys must be"):
        ws.walk_steps_fused(*a, kb.reshape(-1)[:1], *_csr(graph)[:4], **kw)
    # the dispatch draws on the card from keys only, never from a table
    with pytest.raises(ValueError, match="draws its own words"):
        ops.walk_chunk_fused(*a, walk._chunk_rbits(x["keys"], 0, 2, 16),
                             *_csr(graph)[:4], use_kernel=True, **kw)
    assert _build.launches["walk_steps_fused"] == 0
    # no steps: the walkers stay where they are and no lane is written
    got = ws.walk_steps_fused(*a, kb, *_csr(graph)[:4],
                              **{**kw, "chunk_steps": 0})
    assert torch.equal(got[0], x["curr"]) and got[1].shape == (0, 16)
    assert _build.launches["walk_steps_fused"] == 1
    with pytest.raises(ValueError, match="chunk_steps"):
        ws.walk_bits(kb[0], 0, 70_000, 4)
    assert _build.launches["walk_bits"] == 0


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
    # no walk kernel; the top-k's selection is the kernel on any CUDA tensor
    assert {n for n, v in _build.launches.items() if v} == {"topk_select"}
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
# bag lengths at the kernel's edges: one warp a bag up to 16 elements, two
# up to 48, eight beyond; 32 rows staged a warp, so an eight-warp bag
# longer than 256 runs in tiles; bf16 rows of odd width are not 4-byte
# aligned
BAG_EDGE_LENGTHS = [1, 31, 32, 33, 64, 65, 300]
BAG_EDGE_TABLES = [("float32", 32), ("bfloat16", 32), ("float32", 48),
                   ("bfloat16", 33)]


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


def _bag_table(dev, dtype, d, seed, v=1000):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal((v, d)).astype(np.float32),
                           device=dev).to(getattr(torch, dtype))


def _bag_ids(dev, shape, seed, v=1000):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, v, shape).astype(np.int32)
    ids.reshape(-1, shape[-1])[0] = -1                # an all-padding bag
    w = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    return (torch.as_tensor(ids, device=dev), torch.as_tensor(w, device=dev))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype,d", BAG_EDGE_TABLES)
@pytest.mark.parametrize("l", BAG_EDGE_LENGTHS)
def test_embedding_bag_kernel_at_edge_lengths(cuda_device, l, dtype, d, mode):
    table = _bag_table(cuda_device, dtype, d, seed=l + d)
    ids, w = _bag_ids(cuda_device, (3, 5, l), seed=l)
    for weights in (w, None):
        got = eb.embedding_bag_batched(table, ids, weights, mode=mode)
        want = eb.embedding_bag_batched_plain(table, ids, weights, mode=mode)
        torch.cuda.synchronize()
        assert got.dtype == table.dtype and torch.equal(got, want)
        assert not got.reshape(-1, d)[0].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype,d", BAG_EDGE_TABLES)
@pytest.mark.parametrize("l_a,l_b", [(8, 64), (1, 300), (33, 65), (64, 31),
                                     (32, 0)])
def test_embedding_bag_pair_is_one_launch_equal_to_two_calls(
        cuda_device, l_a, l_b, dtype, d, mode):
    """The ranked request's pair: ONE launch, each output bit-identical to
    its own embedding_bag_batched call and to the twin."""
    table = _bag_table(cuda_device, dtype, d, seed=d)
    ia, wa = _bag_ids(cuda_device, (2, 64, l_a), seed=l_a)
    ib, wb = _bag_ids(cuda_device, (2, 1, l_b), seed=l_b + 1) if l_b else (
        torch.zeros((0, 1, 4), dtype=torch.int32, device=cuda_device), None)
    _build.reset_launches()
    got = eb.embedding_bag_pair(table, ia, wa, ib, wb, mode=mode)
    torch.cuda.synchronize()
    assert _build.launches["embedding_bag"] == 1
    singles = (eb.embedding_bag_batched(table, ia, wa, mode=mode),
               eb.embedding_bag_batched(table, ib, wb, mode=mode))
    twins = eb.embedding_bag_pair_plain(table, ia, wa, ib, wb, mode=mode)
    for g, one, twin in zip(got, singles, twins):
        assert g.dtype == table.dtype and g.shape == twin.shape
        assert torch.equal(g, one) and torch.equal(g, twin)
    _build.reset_launches()
    via_ops = ops.embedding_bag_pair(table, ia, wa, ib, wb, mode=mode)
    assert _build.launches["embedding_bag"] == 1
    assert all(torch.equal(a, b) for a, b in zip(via_ops, twins))


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
    assert _build.launches["embedding_bag"] == 1       # both bags, one launch
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


def _hop_lanes(dev, n_shards, l, rows, seed, gate_frac=0.7, n_walkers=4096,
               chunk=3):
    """Stacked CSR slices with degree-0 rows, lanes at random rows plus
    each shard's last row and its degree-0 rows, a (chunk, n_walkers, 4)
    word table and the lanes' walker ids; gated-off lanes hold garbage
    positions and walker ids; row_base = 11 + shard * rows."""
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
    walker = np.where(gate, rng.integers(0, n_walkers, (n_shards, l)),
                      rng.integers(-2**31, 2**31 - 1, (n_shards, l)))
    walker[:, 0] = np.where(gate[:, 0], n_walkers - 1, walker[:, 0])
    table = rng.integers(0, 2**32, (chunk, n_walkers, 4), dtype=np.uint64)
    t = lambda a: torch.as_tensor(a, device=dev)
    return (t(pos), t(gate), t(table.astype(np.uint32).view(np.int32)),
            t(walker.astype(np.int32)), t(base), t(off), t(tgt))


def _gathered(table, step, column, gate, walker):
    """The words the hop's plain route gathers from the table."""
    return table[step, :, column][torch.where(gate, walker, 0).long()]


@pytest.mark.parametrize("n_shards,l,rows,gate_frac", [
    (1, 64, 20, 0.7), (3, 1000, 50, 0.7), (16, 1024, 4096, 0.9),
    (16, 16384, 100, 0.5), (4, 333, 30, 0.0), (2, 128, 40, 1.0),
])
def test_walk_hop_kernel_matches_twin(cuda_device, n_shards, l, rows,
                                      gate_frac):
    """The kernel reads each gated lane's word from the table by its walker
    id; the twin takes the words gathered (garbage walker ids and
    positions on gated-off lanes)."""
    pos, gate, table, walker, base, off, tgt = _hop_lanes(
        cuda_device, n_shards, l, rows, seed=n_shards * 7 + l,
        gate_frac=gate_frac)
    for step, column in ((0, 2), (2, 3)):
        _build.reset_launches()
        got = ws.walk_hop_fused(pos, gate, table, step, column, walker, base,
                                off, tgt)
        torch.cuda.synchronize()
        assert _build.launches["walk_hop_fused"] == 1
        r = _gathered(table, step, column, gate, walker)
        want = ws.walk_hop_ref(pos, gate, r, off, tgt, base)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool(got[1].any()) == (gate_frac > 0)
        via_ops = ops.walk_hop(pos, gate, table, off, tgt, base, step=step,
                               column=column, walker=walker, use_kernel=True)
        assert torch.equal(via_ops[0], want[0]) and torch.equal(via_ops[1], want[1])
        # one shard unstacked, at a row_base past 0
        one = ws.walk_hop_fused(pos[-1], gate[-1], table, step, column,
                                walker[-1], base[-1:], off[-1], tgt[-1])
        assert torch.equal(one[0], want[0][-1]) and torch.equal(one[1], want[1][-1])


def test_walk_hop_wrapper_refuses_bad_inputs(cuda_device):
    pos, gate, table, walker, base, off, tgt = _hop_lanes(cuda_device, 2, 32,
                                                          10, seed=3)
    hop = ws.walk_hop_fused
    with pytest.raises(ValueError, match="CUDA"):
        hop(pos.cpu(), gate.cpu(), table.cpu(), 0, 2, walker.cpu(),
            base.cpu(), off.cpu(), tgt.cpu())
    with pytest.raises(ValueError, match="is on cpu"):
        hop(pos, gate, table, 0, 2, walker, base.cpu(), off, tgt)
    with pytest.raises(TypeError, match="gate must be torch.bool"):
        hop(pos, gate.int(), table, 0, 2, walker, base, off, tgt)
    with pytest.raises(TypeError, match="walker must be torch.int32"):
        hop(pos, gate, table, 0, 2, walker.long(), base, off, tgt)
    with pytest.raises(TypeError, match="table must be torch.int32"):
        hop(pos, gate, table.long(), 0, 2, walker, base, off, tgt)
    with pytest.raises(ValueError, match="table must be"):
        hop(pos, gate, table[..., :3], 0, 2, walker, base, off, tgt)
    with pytest.raises(ValueError, match="outside"):
        hop(pos, gate, table, table.shape[0], 2, walker, base, off, tgt)
    with pytest.raises(ValueError, match="outside"):
        hop(pos, gate, table, 0, 4, walker, base, off, tgt)
    with pytest.raises(TypeError, match="targets must be torch.int32"):
        hop(pos, gate, table, 0, 2, walker, base, off, tgt.long())
    with pytest.raises(ValueError, match="row_base has shape"):
        hop(pos, gate, table, 0, 2, walker, base[:1], off, tgt)
    with pytest.raises(ValueError, match="stack 2 shard slices"):
        hop(pos, gate, table, 0, 2, walker, base, off[:1], tgt[:1])
    with pytest.raises(ValueError, match="contiguous"):
        hop(pos.t().contiguous().t(), gate, table, 0, 2, walker, base, off,
            tgt)
    # the dispatch reads the table: pre-gathered words are the contract of
    # walk_hop_words_plain only
    with pytest.raises(ValueError, match="word table"):
        ops.walk_hop(pos, gate, _gathered(table, 0, 2, gate, walker), off,
                     tgt, base, step=0, column=2, walker=walker,
                     use_kernel=True)


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


def test_sharded_serve_batch_past_the_row_cap_matches_plain_path(cuda_device):
    """1,600 queries x 8 slots: each of two shards counts 12,800 rows, past
    the old 12,288-row cap of the counter kernel; the kernel path equals
    the plain path, drops included."""
    sg20 = synthetic.generate(
        synthetic.SyntheticGraphConfig(n_pins=20_000, n_boards=2_000,
                                       n_topics=16, n_langs=4, seed=7),
        device=cuda_device)
    shg = distributed.shard_graph(sg20.graph, 2)
    n_queries, n_slots = 1_600, 8
    rng = np.random.default_rng(12)
    qs = synthetic.top_degree_pins(sg20, 256)
    pins = np.full((n_queries, n_slots), -1, np.int32)
    weights = np.zeros((n_queries, n_slots), np.float32)
    for i in range(n_queries):
        k = 1 + i % n_slots
        pins[i, :k] = rng.choice(qs, k, replace=False)
        weights[i, :k] = rng.uniform(0.2, 1.0, k)
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    args = (shg, t(pins), t(weights), torch.zeros(n_queries, dtype=torch.int32,
                                                  device=cuda_device),
            prng.split(prng.key(13, cuda_device), n_queries))
    fabric = distributed.LocalFabric(2, device=cuda_device)
    cfg = walk.WalkConfig(n_steps=2_000, n_walkers=64, chunk_steps=4, top_k=20,
                          n_p=30, n_v=2, bias_beta=0.0)
    out = {}
    for backend in ("pallas", "xla"):
        _build.reset_launches()
        out[backend] = service.serve_batch(*args, cfg, backend=backend,
                                           with_stats=True, fabric=fabric)
        torch.cuda.synchronize()
        launched = _build.launches["visit_counter_update_high"]
        assert (launched > 0) == (backend == "pallas")
    assert len(out["pallas"]) == 5
    for a, b in zip(out["pallas"], out["xla"]):
        assert torch.equal(a, b)
    assert int(out["pallas"][3].sum()) > 0


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


# walker counts around the launcher's block sizes (32 to 256 threads,
# sized so that every SM gets a block) and the TPU kernel's 256
STEP_WALKERS = [1, 31, 33, 100, 256, 4096, 8191, 8193]


@pytest.mark.parametrize("w", STEP_WALKERS)
@pytest.mark.parametrize("alpha_u32", [0, 2**31, 2**32 - 1])
@pytest.mark.parametrize("which", ["small_test_graph", "dead_ends"])
def test_walk_step_kernel_matches_twin(graph, cuda_device, which, alpha_u32, w):
    if which == "dead_ends":
        *csr, n_pins = _dead_end_csr(cuda_device)
    else:
        csr, n_pins = list(_csr(graph)[:4]), graph.n_pins
    rng = np.random.default_rng(w + alpha_u32 % 97)
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    curr = rng.integers(0, n_pins, w).astype(np.int32)
    query = rng.integers(0, n_pins, w).astype(np.int32)
    if which == "dead_ends":
        # every walker's restart or not: the last pin (no boards) and pin 3,
        # whose one board is the last board row (no pins)
        curr[:2] = query[:2] = [n_pins - 1, 3][:w]
    curr, query = t(curr), t(query)
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
    # no walk kernel; the top-k's selection is the kernel on any CUDA tensor
    assert {n for n, v in _build.launches.items() if v} == {"topk_select"}
    cpu = run(graph.to("cpu"), "pallas")
    for a, b, c in zip(got, want, cpu):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


# ---------------------------------------------------------------------------
# Graph pruning and the content baselines, on the card against the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sg20k_cpu(cuda_device):
    """The benchmarks' 20k graph (benchmarks/common.py bench_graph)."""
    return synthetic.generate(synthetic.SyntheticGraphConfig(
        n_pins=20_000, n_boards=2_000, n_topics=16, n_langs=4, seed=7),
        device="cpu")


@pytest.mark.parametrize("delta", [0.91, 0.65])
def test_prune_on_card_equals_cpu(sg20k_cpu, cuda_device, monkeypatch, delta):
    """In passes of 8,192 edges on the card, of one pass on the CPU."""
    sg = sg20k_cpu
    cfg = pruning.PruneConfig(entropy_board_frac=0.1, delta=delta)
    kw = dict(board_lang=sg.board_lang, pin_lang=sg.pin_lang, n_langs=4)
    host, host_stats = pruning.prune_graph(sg.graph, sg.pin_topics, None, cfg, **kw)
    monkeypatch.setattr(pruning, "CHUNK_EDGES", 8192)
    card, card_stats = pruning.prune_graph(
        sg.graph.to(cuda_device), sg.pin_topics, None, cfg, **kw)
    assert card.device.type == "cuda"
    assert card_stats == host_stats
    a, b = graph_lib.graph_to_numpy(card), graph_lib.graph_to_numpy(host)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_entropy_and_cosine_on_card_match_cpu(sg20k_cpu, cuda_device):
    sg = sg20k_cpu
    pins, boards = graph_lib.edge_list(sg.graph)
    host = pruning.board_entropy(pins, boards, sg.pin_topics, sg.graph.n_boards)
    card = pruning.board_entropy(
        torch.as_tensor(pins, device=cuda_device), torch.as_tensor(boards, device=cuda_device),
        torch.as_tensor(sg.pin_topics, device=cuda_device), sg.graph.n_boards)
    diff = (card.cpu() - host).abs()
    assert float(diff.max()) <= 1e-6, f"{int((diff > 0).sum())} boards, {float(diff.max())}"
    rng = np.random.default_rng(0)
    a = rng.dirichlet(np.full(16, 0.1), 50_000).astype(np.float32)
    b = rng.dirichlet(np.full(16, 0.1), 50_000).astype(np.float32)
    want = pruning.cosine_sim(a, b)
    got = pruning.cosine_sim(torch.as_tensor(a, device=cuda_device),
                             torch.as_tensor(b, device=cuda_device))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("query", [0, 777, 19_999])
def test_rank_scores_on_card_match_cpu(cuda_device, query):
    topics = np.random.default_rng(1).dirichlet(np.full(16, 0.1), 20_000)
    text, vis = baselines.make_content_embeddings(topics.astype(np.float32))
    host = [torch.as_tensor(text), torch.as_tensor(vis)]
    card = [t.to(cuda_device) for t in host]
    cos = baselines.cosine_rank_scores(card[0], query).cpu()
    assert float((cos - baselines.cosine_rank_scores(host[0], query)).abs().max()) <= 2e-6
    assert torch.equal(baselines.hamming_rank_scores(card[1], query).cpu(),
                       baselines.hamming_rank_scores(host[1], query))
    assert torch.equal(baselines.combined_rank_scores(*card, query).cpu(),
                       baselines.combined_rank_scores(*host, query))


@pytest.mark.parametrize("delta", [1.0, 0.95, 0.91, 0.9, 0.8, 0.7, 0.65, 0.6, 0.1])
def test_ceil_pow_on_card_equals_numpy(cuda_device, delta):
    deg = np.arange(10_001)
    want = np.ceil(deg.astype(np.float64) ** delta)
    got = torch.ceil(torch.pow(torch.as_tensor(deg, dtype=torch.float64,
                                               device=cuda_device), delta))
    bad = deg[got.cpu().numpy() != want]
    assert bad.size == 0, f"torch.pow on the card parts from numpy at degrees {bad[:20]}"
    table = torch.as_tensor(pruning.degree_targets(10_000, delta, 2), device=cuda_device)
    assert torch.equal(table.cpu(), torch.as_tensor(
        np.maximum(want.astype(np.int64), np.minimum(deg, 2))))


# ---------------------------------------------------------------------------
# The recsys models: SMOKE widths on the card against the CPU port
# ---------------------------------------------------------------------------

def _chip_smoke():
    """``chip_smoke.py``, at the repo's root: its SMOKE-output builder and
    card-vs-CPU check serve both the script's phase 29 and this test."""
    import importlib
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("name", ["sasrec", "bst", "dlrm_rm2", "dlrm_mlperf"])
def test_recsys_smoke_models_on_card_match_cpu(cuda_device, name):
    """User states, scores, logits and losses within 2e-6 of the CPU port
    (float32 matmuls, no TF32); top-k ids exact."""
    cs = _chip_smoke()
    assert cs.RECSYS_TOL == 2e-6
    errs = cs.recsys_smoke_parity(cuda_device, names=(name,))
    assert errs and max(errs.values()) <= cs.RECSYS_TOL, errs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_take_rows_id_table_on_card(cuda_device, dtype):
    """jnp.take's edges on the card: -1 wraps, ids past the table are NaN
    rows (no host sync, no raise); the sharded lookup gives zeros."""
    from repro_torch.models import embedding

    n = 16
    table = torch.randn((n, 5), generator=torch.Generator().manual_seed(0)).to(dtype)
    ids = torch.tensor([[-1], [0], [n - 1], [n], [n + 90], [-n], [-n - 1]], dtype=torch.int32)
    cfg = embedding.MegaTableConfig((13,), 5, pad_to_multiple=8)
    want = embedding.lookup(table, ids, cfg)
    got = embedding.lookup(table.to(cuda_device), ids.to(cuda_device), cfg).cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[[3, 4, 6]]).all() and torch.equal(got[0], table[[n - 1]])
    fin = ~torch.isnan(want)
    assert torch.equal(got[fin], want[fin])
    sharded = embedding.lookup_sharded(table.to(cuda_device), ids.to(cuda_device), cfg,
                                       distributed.LocalFabric(2, device=cuda_device)).cpu()
    assert (sharded[[0, 3, 4, 5, 6]] == 0).all() and torch.equal(sharded[[1, 2]], want[[1, 2]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_topk_total_nan_order_on_card(cuda_device, dtype):
    """NaN first (lowest index first), then +inf, ties by index, +0.0 above
    -0.0, a sign-bit NaN last: lax.top_k's order, as on the CPU."""
    nan, inf = float("nan"), float("inf")
    rows = torch.tensor([[1, nan, 3, -inf, nan, 3, 0.0, -0.0, 2],
                         [inf, -nan, nan, -inf, 1, nan, nan, nan, inf],
                         [2, 2, 2, 2, nan, 2, 2, -0.0, 0.0]], dtype=dtype)
    for k in (1, 4, 9):
        v_cpu, i_cpu = counter.topk_total(rows, k)
        v, i = counter.topk_total(rows.to(cuda_device), k)
        assert torch.equal(i.cpu(), i_cpu), k
        assert torch.equal(torch.isnan(v.cpu()), torch.isnan(v_cpu))
    _, i4 = counter.topk_total(rows.to(cuda_device), 4)
    assert i4[0].tolist() == [1, 4, 2, 5]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_lookup_sharded_on_card_equals_lookup(cuda_device, n_shards):
    from repro_torch.configs import dlrm_rm2
    from repro_torch.models import embedding

    cfg = dlrm_rm2.SMOKE.table
    table = embedding.init_table(torch.Generator(device=cuda_device).manual_seed(1), cfg)
    rng = np.random.default_rng(2)
    ids = torch.as_tensor(np.stack([rng.integers(0, r, 512) for r in cfg.feature_rows], 1)
                          .astype(np.int32), device=cuda_device)
    got = embedding.lookup_sharded(table, ids, cfg,
                                   distributed.LocalFabric(n_shards, device=cuda_device))
    assert torch.equal(got, embedding.lookup(table, ids, cfg))


# ---------------------------------------------------------------------------
# MoE serving, temperature sampling and GIN: the card against the CPU port
# ---------------------------------------------------------------------------


def _within(got, want, what, rel=2e-6):
    """Within 2e-6, or 2e-6 of the CPU's largest magnitude where it is
    larger than 1 (the CPU tests' bound on these models)."""
    got, want = got.detach().cpu().float(), want.detach().cpu().float()
    assert got.shape == want.shape, what
    bound = rel * max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    assert err <= bound, f"{what}: {err} > {bound}"
    return err


@pytest.mark.parametrize("name", ["granite_moe_3b_a800m", "deepseek_moe_16b"])
def test_moe_smoke_on_card_matches_cpu(cuda_device, name):
    """The MoE SMOKE configs in float32 (no TF32): forward, prefill and
    decode logits within the CPU tests' bound of the CPU port on the same
    weights; greedy tokens equal, on the kernel path and the plain path."""
    import dataclasses
    import importlib

    assert not torch.backends.cuda.matmul.allow_tf32
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = dataclasses.replace(mod.SMOKE, cache_dtype=torch.float32)
    host = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    card = _to(host, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 9)).astype(np.int32))
    h_cpu, aux_cpu = transformer.forward(host, toks, cfg)
    h_gpu, aux_gpu = transformer.forward(card, toks.to(cuda_device), cfg)
    _within(h_gpu, h_cpu, "hidden")
    _within(aux_gpu, aux_cpu, "aux")
    want = decode.generate(host, toks, cfg, max_new_tokens=6)
    for backend in ("pallas", "xla"):
        _build.reset_launches()
        got = decode.generate(card, toks.to(cuda_device), cfg, max_new_tokens=6,
                              backend=backend)
        torch.cuda.synchronize()
        assert (_build.launches["decode_attention"] > 0) == (backend == "pallas")
        assert torch.equal(got.cpu(), want), backend
    lc, cc = transformer.prefill(host, toks, cfg, max_seq=12)
    lg, cg = transformer.prefill(card, toks.to(cuda_device), cfg, max_seq=12)
    _within(lg, lc, "prefill logits")
    for i in range(9, 12):
        lc, cc = transformer.decode_step(host, cc, want[:, i], i, cfg)
        lg, cg = transformer.decode_step(card, cg, want[:, i].to(cuda_device), i, cfg)
        _within(lg, lc, f"decode step {i}")
        _within(cg["k"], cc["k"], f"cache k {i}")


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


@pytest.mark.parametrize("shape", [(4, 49168), (4, 102400), (3, 5, 7)])
def test_gumbel_on_card_equals_cpu_bits(cuda_device, shape):
    for seed, i in ((0, 0), (7, 31)):
        k = prng.fold_in(prng.key(seed, cuda_device), i)
        got = prng.gumbel(k, shape)
        want = prng.gumbel(prng.fold_in(prng.key(seed, "cpu"), i), shape)
        assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


def test_temperature_sample_on_card_equals_cpu(cuda_device):
    logits = torch.randn((4, 49168), generator=torch.Generator().manual_seed(2)) * 3
    for t in (0.7, 1.0):
        for i in range(4):
            want = decode._sample(logits, t, prng.key(5, "cpu"), i)
            got = decode._sample(logits.to(cuda_device), t, prng.key(5, cuda_device), i)
            assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("e,cap,d,ff", [(8, 8, 64, 64), (48, 8, 1536, 512),
                                        (64, 8, 2048, 1408)])
def test_expert_matmul_out_dtype_on_card_against_cpu_upcast(cuda_device, e, cap, d, ff):
    """bf16 in, float32 out: ``bmm(out_dtype=float32)`` on the card and the
    CPU's upcast product each within the float32 dot-product error bound
    gamma_K * sum|a_i b_i| of the float64 product (bf16 products are exact
    in both), K the contraction length."""
    from repro_torch.models import moe

    g = torch.Generator().manual_seed(e)
    a = torch.randn((e, cap, d), generator=g).to(torch.bfloat16)
    b = (torch.randn((e, d, ff), generator=g) * d ** -0.5).to(torch.bfloat16)
    exact = torch.bmm(a.double(), b.double())
    bound = torch.bmm(a.double().abs(), b.double().abs()) * (d * 2.0**-24 / (1 - d * 2.0**-24))
    host = moe.expert_matmul(a, b)
    card = moe.expert_matmul(a.to(cuda_device), b.to(cuda_device))
    assert host.dtype == card.dtype == torch.float32
    assert bool(((host.double() - exact).abs() <= bound).all())
    assert bool(((card.cpu().double() - exact).abs() <= bound).all())


def test_gin_on_card_matches_cpu_and_repeats(cuda_device):
    """gin-tu SMOKE on a planted-partition graph and on a molecule batch:
    logits and losses within the CPU tests' bound, two card calls the same
    bits (segment_sum adds without atomics)."""
    import dataclasses

    from repro_torch.configs import gin_tu
    from repro_torch.graphs import gnn_data
    from repro_torch.models import gnn

    node = gnn_data.planted_partition(600, 3000, 32, 3, seed=1)
    mol = gnn_data.molecule_batch(batch=16, d_feat=16, n_classes=2, seed=2)
    cases = [
        (gin_tu.SMOKE, node.feats, node.edge_src, node.edge_dst, {},
         lambda p, a, c, dev: gnn.node_classification_loss(
             p, *a, torch.as_tensor(node.labels, device=dev),
             torch.as_tensor(node.train_mask, device=dev), c)),
        (dataclasses.replace(gin_tu.SMOKE, d_in=16, n_classes=2, readout="sum"),
         mol.feats, mol.edge_src, mol.edge_dst,
         dict(graph_ids=mol.graph_ids, n_graphs=16),
         lambda p, a, c, dev: gnn.graph_classification_loss(
             p, *a, torch.as_tensor(mol.graph_ids, device=dev),
             torch.as_tensor(mol.labels, device=dev), c, 16)),
    ]
    for cfg, feats, src, dst, kw, loss in cases:
        host = gnn.init_params(torch.Generator().manual_seed(3), cfg)
        card = _to(host, cuda_device)
        t = lambda a, dev: torch.as_tensor(a, device=dev)
        args = lambda dev: (t(feats, dev), t(src, dev), t(dst, dev))
        kw_dev = lambda dev: {k: (t(v, dev) if isinstance(v, np.ndarray) else v)
                              for k, v in kw.items()}
        want = gnn.forward(host, *args("cpu"), cfg, **kw_dev("cpu"))
        got = gnn.forward(card, *args(cuda_device), cfg, **kw_dev(cuda_device))
        again = gnn.forward(card, *args(cuda_device), cfg, **kw_dev(cuda_device))
        assert torch.equal(got, again)
        _within(got, want, cfg.name)
        _within(loss(card, args(cuda_device), cfg, cuda_device),
                loss(host, args("cpu"), cfg, "cpu"), f"{cfg.name} loss")


# ---------------------------------------------------------------------------
# training on the card against the CPU port
# ---------------------------------------------------------------------------


def _train_state_within(got, want, what, rel=2e-6):
    from repro_torch.training import tree

    gn, gl = tree.flatten_with_names(got)
    wn, wl = tree.flatten_with_names(want)
    assert gn == wn, what
    for name, g, w in zip(gn, gl, wl):
        if not w.is_floating_point():
            assert torch.equal(g.cpu(), w), f"{what} {name}"
        else:
            _within(g, w, f"{what} {name}", rel=rel)


def _same_bits(a, b):
    from repro_torch.training import tree

    return all(torch.equal(x, y) for x, y in zip(tree.leaves(a), tree.leaves(b)))


def _lm_train(dev, cfg, params, n_steps=3, n_micro=2):
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.training import optim, train_loop

    pipe = TokenPipeline(cfg.vocab_size, 4, 32, seed=1)
    step = train_loop.make_train_step(
        lambda p, b: transformer.loss_fn(p, b["tokens"], b["labels"], b["mask"], cfg),
        train_loop.TrainStepConfig(n_micro=n_micro))
    state, metrics = (params, optim.init(params)), []
    for i in range(n_steps):
        state, m = step(state, {k: torch.as_tensor(v, device=dev)
                                for k, v in pipe(i).items()})
        metrics.append(m)
    return state, metrics


@pytest.mark.parametrize("name", ["qwen2_5_3b", "granite_moe_3b_a800m"])
def test_lm_train_steps_on_card_match_cpu(cuda_device, name):
    """Three make_train_step steps (two microbatches, remat on) on the
    card: parameters, moments, step and metrics within 2e-6 times max(1,
    the CPU's largest magnitude) of the CPU port's; a second card run
    gives the same bits (the backward's gathers add without atomics)."""
    import dataclasses
    import importlib

    assert not torch.backends.cuda.matmul.allow_tf32
    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = dataclasses.replace(mod.SMOKE, remat=True)
    host = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    want, want_m = _lm_train("cpu", cfg, host)
    got, got_m = _lm_train(cuda_device, cfg, _to(
        transformer.init_params(torch.Generator().manual_seed(0), cfg), cuda_device))
    again, _ = _lm_train(cuda_device, cfg, _to(
        transformer.init_params(torch.Generator().manual_seed(0), cfg), cuda_device))
    _train_state_within(got, want, name)
    for g, w in zip(got_m, want_m):
        for k in w:
            _within(g[k], w[k], k)
    assert _same_bits(got, again)


# the tensor-parallel training cases of tests/test_torch_tp_training.py
TP_TRAIN = {
    "qwen2_5_3b": {},
    "granite_moe_3b_a800m": dict(pad_heads_to=8, vocab_size=509, pad_vocab_to=512,
                                 moe=dict(pad_experts_to=12, ep_shard_map=True)),
    "deepseek_moe_16b": dict(moe=dict(ep_shard_map=True)),
    "minitron_4b": dict(pad_heads_to=8),
}


def _tp_loss_grads(dev, cfg, params, batch):
    """The tensor-parallel loss and its gradients on a local (1, 4) mesh
    on ``dev``, the gradients back in the whole tree's form."""
    from repro_torch.distribution import sharding
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.training import microbatch

    tp = sharding.TensorParallel(mesh_lib.local_mesh((1, 4), device=dev),
                                 sharding.LM_TRAIN_RULES)
    logical = transformer.param_logical(cfg)
    loss, grads = microbatch.value_and_grad(lambda p: transformer.loss_fn(
        p, batch["tokens"], batch["labels"], batch["mask"], cfg, tp=tp))(
            tp.local_form(params, logical))
    return loss, tp.whole_form(grads, logical)


@pytest.mark.parametrize("name", list(TP_TRAIN))
def test_tp_train_loss_grads_on_card_match_cpu(cuda_device, name):
    """The local (1, 4) tensor-parallel loss and gradients (SMOKE, float32,
    remat on, a ragged mask, labels -1, V and V_pad) on the card within 2e-6
    times max(1, the CPU's largest magnitude) of the CPU port's, leaf by
    leaf; a second card run gives the same bits."""
    import importlib

    from repro_torch.training import tree

    assert not torch.backends.cuda.matmul.allow_tf32
    over = dict(TP_TRAIN[name])
    cfg = importlib.import_module(f"repro_torch.configs.{name}").SMOKE
    if "moe" in over:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **over.pop("moe")))
    cfg = dataclasses.replace(cfg, remat=True, **over)
    host = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(2)
    labels = rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    labels[0, :3] = (-1, cfg.vocab_size, cfg.vocab_padded)
    mask = (rng.random((4, 32)) > 0.2).astype(np.float32)
    mask[0, 1] = 0.0
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 32)).astype(
        np.int32)), "labels": torch.from_numpy(labels), "mask": torch.from_numpy(mask)}
    want_loss, want = _tp_loss_grads(torch.device("cpu"), cfg, host, batch)
    card_batch = _to(batch, cuda_device)
    got_loss, got = _tp_loss_grads(cuda_device, cfg, _to(host, cuda_device), card_batch)
    again_loss, again = _tp_loss_grads(cuda_device, cfg, _to(host, cuda_device), card_batch)
    _within(got_loss, want_loss, f"{name} loss")
    for n, g, w in zip(tree.flatten_with_names(want)[0], tree.leaves(got),
                       tree.leaves(want)):
        _within(g, w, f"{name} grad {n}")
    assert torch.equal(got_loss, again_loss) and _same_bits(got, again)


def _hybrid_step(loss_fn, table_key):
    """The reference's dlrm train cell: rowwise AdaGrad (lr 0.01) on the
    table, AdamW on the rest."""
    from repro_torch.training import microbatch, optim

    grad_fn = microbatch.value_and_grad(loss_fn)

    def step(state, b):
        params, opt_state, accum = state
        loss, grads = grad_fn(params, b)
        table, accum = optim.rowwise_adagrad_update(params[table_key], grads[table_key],
                                                    accum, lr=0.01)
        dense, opt_state, metrics = optim.apply_updates(
            {k: v for k, v in params.items() if k != table_key},
            {k: v for k, v in grads.items() if k != table_key},
            opt_state, optim.AdamWConfig())
        metrics["loss"] = loss
        return (dict(dense, **{table_key: table}), opt_state, accum), metrics

    return step


def _recsys_train(dev, name, n_steps=2):
    import importlib

    from repro_torch.data import pipeline
    from repro_torch.models import dlrm, sequential_rec
    from repro_torch.training import optim

    cfg = importlib.import_module(f"repro_torch.configs.{name}").SMOKE
    gen = torch.Generator().manual_seed(5)
    t = lambda a: torch.as_tensor(a, device=dev)
    if name == "dlrm_rm2":
        params, key = dlrm.init_params(gen, cfg), "table"
        pipe = pipeline.ClickLogPipeline(cfg.n_dense, cfg.feature_rows, 16, seed=4)
        loss = lambda p, b: dlrm.bce_loss(p, t(b["dense"]), t(b["sparse"]), t(b["labels"]),
                                          cfg)
    elif cfg.kind == "bst":
        params, key = sequential_rec.init_params(gen, cfg), "items"
        pipe = pipeline.SeqRecPipeline(cfg.n_items, 6, cfg.seq_len, with_candidate=True,
                                       seed=5)
        loss = lambda p, b: sequential_rec.bst_loss(p, t(b["seq"]), t(b["candidate"]),
                                                    t(b["labels"]), cfg)
    else:
        params, key = sequential_rec.init_params(gen, cfg), "items"
        pipe = pipeline.SeqRecPipeline(cfg.n_items, 6, cfg.seq_len,
                                       n_negatives=cfg.n_negatives, seed=6)
        loss = lambda p, b: sequential_rec.sasrec_loss(p, t(b["seq"]), t(b["targets"]),
                                                       t(b["negatives"]), cfg)
    params = _to(params, dev)
    state = (params, optim.init({k: v for k, v in params.items() if k != key}),
             optim.rowwise_adagrad_init(params[key]))
    step = _hybrid_step(loss, key)
    for i in range(n_steps):
        state, _ = step(state, pipe(i))
    return state


@pytest.mark.parametrize("name", ["sasrec", "bst", "dlrm_rm2"])
def test_recsys_train_steps_on_card_match_cpu(cuda_device, name):
    """Two hybrid steps (rowwise AdaGrad on the table, AdamW on the rest)
    at SMOKE: the card's state within 2e-6 times max(1, the CPU's largest
    magnitude) of the CPU port's, and the same bits twice."""
    assert not torch.backends.cuda.matmul.allow_tf32
    got = _recsys_train(cuda_device, name)
    _train_state_within(got, _recsys_train("cpu", name), name)
    assert _same_bits(got, _recsys_train(cuda_device, name))


def _gin_train(dev, readout, n_steps=3):
    import dataclasses

    from repro_torch.configs import gin_tu
    from repro_torch.graphs import gnn_data
    from repro_torch.models import gnn
    from repro_torch.training import optim, train_loop

    t = lambda a: torch.as_tensor(a, device=dev)
    if readout:
        cfg = dataclasses.replace(gin_tu.SMOKE, d_in=16, n_classes=2, readout="sum")
        g = gnn_data.molecule_batch(batch=16, d_feat=16, n_classes=2, seed=2)
        loss = lambda p, b: gnn.graph_classification_loss(
            p, t(g.feats), t(g.edge_src), t(g.edge_dst), t(g.graph_ids), t(g.labels), cfg, 16)
    else:
        cfg = gin_tu.SMOKE
        g = gnn_data.planted_partition(600, 3000, 32, 3, seed=1)
        loss = lambda p, b: gnn.node_classification_loss(
            p, t(g.feats), t(g.edge_src), t(g.edge_dst), t(g.labels), t(g.train_mask), cfg)
    params = _to(gnn.init_params(torch.Generator().manual_seed(3), cfg), dev)
    step = train_loop.make_train_step(loss, train_loop.TrainStepConfig())
    state = (params, optim.init(params))
    for _ in range(n_steps):
        state, _ = step(state, None)
    return state


@pytest.mark.parametrize("readout", [False, True], ids=["node", "molecules"])
def test_gin_train_steps_on_card_match_cpu(cuda_device, readout):
    got = _gin_train(cuda_device, readout)
    _train_state_within(got, _gin_train("cpu", readout), "gin")
    assert _same_bits(got, _gin_train(cuda_device, readout))


def test_rowwise_adagrad_update_on_card_matches_cpu(cuda_device):
    from repro_torch.training import optim

    gen = torch.Generator().manual_seed(0)
    table = torch.randn((1000, 64), generator=gen)
    grads = [torch.randn((1000, 64), generator=gen) for _ in range(3)]
    grads[1][10:20] = 0.0
    host, card = (table, optim.rowwise_adagrad_init(table)), \
        (table.to(cuda_device), optim.rowwise_adagrad_init(table.to(cuda_device)))
    for g in grads:
        host = optim.rowwise_adagrad_update(*host[:1], g, host[1], lr=0.01)
        card = optim.rowwise_adagrad_update(card[0], g.to(cuda_device), card[1], lr=0.01)
    _within(card[0], host[0], "table")
    _within(card[1], host[1], "accumulator")


def test_gather_rows_backward_is_the_same_bits_on_card(cuda_device):
    """embedding.gather_rows' backward on heavily repeated ids: the same
    bits twice on the card, and each sum within the float32 bound of any
    summation order, (n - 1) 2**-24 sum |x| for a row of n terms, of the
    float64 sum."""
    from repro_torch.models import embedding

    gen = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 50, (200_000,), generator=gen)
    ids[:100_000] = 7                                   # one very hot row
    grad = torch.randn((200_000, 96), generator=gen)
    outs = []
    for _ in range(2):
        table = torch.zeros((50, 96), device=cuda_device, requires_grad=True)
        rows = embedding.gather_rows(table, ids.to(cuda_device))
        (g,) = torch.autograd.grad(rows, table, grad.to(cuda_device))
        outs.append(g)
    assert torch.equal(outs[0], outs[1])
    exact = torch.zeros((50, 96), dtype=torch.float64).index_add_(0, ids, grad.double())
    mags = torch.zeros((50, 96), dtype=torch.float64).index_add_(0, ids, grad.double().abs())
    n = torch.bincount(ids, minlength=50).double()[:, None]
    bound = (n - 1).clamp(min=0) * 2.0 ** -24 * mags
    assert bool(((outs[0].cpu().double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("name", ["granite_moe_3b_a800m", "deepseek_moe_16b"])
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)], ids=["1x4", "2x2"])
def test_ep_decode_on_card_equals_unsharded(cuda_device, name, shape):
    """Expert-parallel decode (``ep_shard_map``, a local mesh on the card)
    at SMOKE in float32, the attention kernel launched: on (1, 4) the
    greedy tokens of the unsharded path (one data shard routes and drops
    as the unsharded layer does); on (2, 2) each data shard has its own
    capacity, as in the reference, so the tokens are the CPU's (2, 2)
    run's; the mesh's hidden states within 2e-6 times max(1, magnitude)
    of the CPU's mesh run."""
    import importlib

    from repro_torch.launch import mesh as mesh_lib

    mod = importlib.import_module(f"repro_torch.configs.{name}")
    cfg = dataclasses.replace(mod.SMOKE, cache_dtype=torch.float32,
                              moe=dataclasses.replace(mod.SMOKE.moe, ep_shard_map=True))
    host = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    card = _to(host, cuda_device)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)).to(cuda_device)
    mesh = mesh_lib.local_mesh(shape, device=cuda_device)
    if shape[0] == 1:
        want = decode.generate(card, toks, cfg, max_new_tokens=6)
    else:
        want = decode.generate(host, toks.cpu(), cfg, max_new_tokens=6,
                               mesh=mesh_lib.local_mesh(shape, device="cpu"))
    _build.reset_launches()
    got = decode.generate(card, toks, cfg, max_new_tokens=6, mesh=mesh)
    torch.cuda.synchronize()
    assert _build.launches["decode_attention"] > 0
    assert torch.equal(got.cpu(), want.cpu())
    h_gpu, aux_gpu = transformer.forward(card, toks, cfg, mesh=mesh)
    h_cpu, aux_cpu = transformer.forward(host, toks.cpu(), cfg,
                                         mesh=mesh_lib.local_mesh(shape, device="cpu"))
    _within(h_gpu, h_cpu, "hidden")
    _within(aux_gpu, aux_cpu, "aux")


def test_compressed_psum_on_card_equals_cpu(cuda_device):
    """``compressed_psum`` over ``LocalFabric(4)`` on the card: the
    reduced values and residuals of the CPU port bit for bit (true float32
    divisions, the residual one rounding of a float64 difference)."""
    from repro_torch.training import compression

    gen = torch.Generator().manual_seed(3)
    grads = {"a": torch.randn((4, 1000), generator=gen) * 3,
             "b": torch.randn((4, 64, 33), generator=gen) * 1e-3,
             "c": torch.zeros((4, 7))}
    resid = {k: torch.randn(v.shape, generator=gen) * 1e-4 for k, v in grads.items()}
    red_c, res_c = compression.compressed_psum(
        grads, resid, distributed.LocalFabric(4, device="cpu"))
    red_g, res_g = compression.compressed_psum(
        _to(grads, cuda_device), _to(resid, cuda_device),
        distributed.LocalFabric(4, device=cuda_device))
    for k in grads:
        assert torch.equal(red_g[k].cpu(), red_c[k]), k
        assert torch.equal(res_g[k].cpu(), res_c[k]), k


@pytest.mark.parametrize("n_blocks", [2, 4])
@pytest.mark.parametrize("case", ["top2", "top3_padded", "dropping_padded"])
def test_global_route_local_form_on_card_equals_moe_ffn(cuda_device, case, n_blocks):
    """``moe.moe_ffn_global`` over ``LocalFabric(n_blocks)`` on the card
    (routing over the global batch, the data blocks one after another)
    against ``moe.moe_ffn`` of the whole batch on the card: the output,
    the aux and the gradients (router, experts, tokens) within 2e-6 times
    max(1, magnitude), the cut binding (``tests/test_torch_moe_global.py``'s
    cases); then a NaN token on the last block: its own row NaN, the aux
    NaN, the other rows within the same bound."""
    from repro_torch.models import moe
    from test_torch_moe_global import assert_global_cut_binds, moe_case

    cfg, params, x = moe_case(case, cuda_device)
    sel = moe.route(x, params["router"], cfg)[2].cpu()
    assert_global_cut_binds(cfg, [sel], n_blocks, case)
    outs = []
    for route in ("one", "blocks"):
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        xx = x.clone().requires_grad_(True)
        if route == "one":
            y, aux = moe.moe_ffn(xx, p, cfg)
        else:
            parts, aux = moe.moe_ffn_global(xx, p, cfg,
                                            distributed.LocalFabric(n_blocks, cuda_device))
            y = parts[0]
        loss = (y * torch.linspace(-1, 1, y.shape[1], device=cuda_device)).square().sum()
        leaves = [p["router"], p["w_gate"], p["w_up"], p["w_down"], xx]
        outs.append((y.detach(), aux.detach(),
                     torch.autograd.grad(loss + 50.0 * aux, leaves)))
    (y0, a0, g0), (y1, a1, g1) = outs
    _within(y1, y0, "output")
    _within(a1, a0, "aux")
    for n, a, b in zip(("router", "w_gate", "w_up", "w_down", "tokens"), g1, g0):
        _within(a, b, f"grad {n}")
    bad = x.shape[0] - x.shape[0] // n_blocks + 3
    x = x.clone()
    x[bad, 5] = float("nan")
    y0, a0 = moe.moe_ffn(x, params, cfg)
    parts, a1 = moe.moe_ffn_global(x, params, cfg,
                                   distributed.LocalFabric(n_blocks, cuda_device))
    assert bool(torch.isnan(a0)) and bool(torch.isnan(a1))
    assert torch.isnan(parts[0]).any(-1).nonzero().flatten().tolist() == [bad]
    ok = torch.arange(x.shape[0], device=cuda_device) != bad
    _within(parts[0][ok], y0[ok], "output beside the NaN token")


def _served_batches(graph, slots, n_batches=1):
    """One warm batch of the related-pins shape ((8, 1)) or the homefeed
    shape ((1, 8)), then ``n_batches`` more; returns the server and the
    last batch's answers."""
    from repro_torch.serving.server import PixieServer

    cfg = walk.WalkConfig(n_steps=2048, n_walkers=64, chunk_steps=8, top_k=20,
                          n_p=10**6, n_v=3, backend="pallas")
    server = PixieServer(graph, cfg, buckets=[(8, 1), (1, 8)], seed=3)
    out = None
    for _ in range(1 + n_batches):
        for i in range(8 if slots == 1 else 1):
            server.submit(list(range(5 + i, 5 + i + slots)), [1.0] * slots,
                          user_feat=i % 3, now=0.0)
        server.pump(now=1.0)
        out = server.harvest()
    return server, out


@pytest.mark.parametrize("slots", [1, 8])
def test_sync_debug_mode_sees_every_counted_wait_but_the_event(graph, slots):
    import warnings

    server, _ = _served_batches(graph, slots, n_batches=0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            for i in range(8 if slots == 1 else 1):
                server.submit(list(range(5 + i, 5 + i + slots)), [1.0] * slots,
                              user_feat=i % 3, now=0.0)
            server.pump(now=1.0)
            out = server.harvest()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    warned = sum("synchronizing CUDA operation" in str(w.message) for w in seen)
    rec = out[0].trace
    counted = sum(rec.host_syncs.values())
    # the top-k's selection is a kernel on the card: no topk.nonzero wait
    assert rec.chunks == 4 and counted == 17, rec.host_syncs
    assert "topk.nonzero" not in rec.host_syncs
    assert warned == counted - rec.host_syncs["harvest.done"]


def test_a_profiled_batch_holds_each_range_once_on_the_kernels_clock(graph, tmp_path):
    import collections
    import json

    from repro_torch.serving import batch_trace

    server, _ = _served_batches(graph, 1, n_batches=0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(8):
            server.submit([5 + i], [1.0], user_feat=i % 3, now=0.0)
        server.pump(now=1.0)
        out = server.harvest()
    path = tmp_path / "batch.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    ranges = [e for e in events
              if e.get("cat") == "user_annotation" and e["name"].startswith("pixie.")]
    assert collections.Counter(e["name"] for e in ranges) == {
        name: 1 for name in batch_trace.SPANS}
    walk_range = next(e for e in ranges if e["name"] == "pixie.walk")
    kernels = [e for e in events
               if e.get("cat") == "kernel" and "walk_steps_fused" in e["name"]]
    assert len(kernels) == out[0].trace.chunks == 4
    launch_at = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    for k in kernels:
        t = launch_at[k["args"]["correlation"]]
        assert walk_range["ts"] <= t <= walk_range["ts"] + walk_range["dur"]
    spans = out[0].trace.spans
    inner = sum(spans[n].ms for n in ("pixie.walk", "pixie.boost", "pixie.topk"))
    assert 0.0 < inner <= spans["pixie.batch"].ms


def test_the_batch_record_costs_little_host_time(cuda_device):
    import time

    from repro_torch.serving import batch_trace

    sites = (("dispatch.h2d", 5), ("walk.plan", 2), ("walk.feat_check", 2),
             ("walk.live_rows", 4), ("walk.debit", 1))
    n = 1000
    records = []
    t = time.perf_counter()
    for _ in range(n):
        with batch_trace.BatchTrace(cuda_device) as rec:
            for site, k in sites:
                for _ in range(k):
                    batch_trace.host_sync(site)
            for name in ("pixie.walk", "pixie.boost", "pixie.topk"):
                with batch_trace.span(name):
                    pass
            batch_trace.count_chunks(4)
        records.append(rec)
    open_s = time.perf_counter() - t
    torch.cuda.synchronize()        # the server's own wait, not the record's
    t = time.perf_counter()
    for rec in records:
        rec.count_sync("harvest.done")
        rec.resolve()
        rec.count_sync("harvest.d2h", 2)
    us = (open_s + time.perf_counter() - t) / n * 1e6
    print(f"batch_record_host_us={us:.2f} ({torch.cuda.get_device_name(cuda_device)})")
    assert all(sum(r.host_syncs.values()) == 17 for r in records)
    assert us < 1000.0
