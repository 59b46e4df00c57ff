"""The walk's threefry words as the CUDA kernels draw them, on the CPU.

On the card the walk kernel draws its words in registers from the keys
and the sharded hop reads its word from the chunk's table
(``csrc/threefry.cuh``, ``walk_bits.cu``, ``walk_steps_fused.cu``,
``walk_hop.cu``); no CUDA kernel runs here, so this file holds what the
kernels compute against the JAX package:

  * a Python mirror of the kernels' per-element formula, one word at a
    time (``walk_word(fold_in(keys[g // w], step_base + s), 4 * i + c)``,
    the rounds of ``threefry.cuh`` in uint32 arithmetic) equals
    ``walk._chunk_rbits`` and the reference's ``_chunk_rbits``;
  * the keys-in routing of ``ops.walk_chunk_fused[_batched]`` equals the
    words-in helpers (``ops.walk_chunk_words[_batched]_plain``) on the same
    words and the reference's twin on jax's words, biased and unbiased,
    with board lanes;
  * each walk dispatcher has one signature: the keys-in chunk refuses a
    word table and the table-and-walker hop refuses gathered words (on
    both routes), and the words-in helpers refuse keys and equal the
    reference's twins;
  * the table-and-walker route of ``ops.walk_hop`` equals ``walk_hop_ref``
    on the gathered words and the reference's twin, with garbage walker
    ids on gated-off lanes.

Everything is integer arithmetic and must match exactly.  The kernels
themselves are held against these routes on the card
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import walk as jwalk
from repro.graphs.synthetic import small_test_graph
from repro.kernels import ref
from repro_torch.core import prng
from repro_torch.core import walk as twalk
from repro_torch.kernels import ops as tops
from repro_torch.kernels import walk_step as tws

ALPHA_U32 = int(round(0.5 * 2**32))
BETA_U32 = int(round(0.9 * 2**32))
M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# The kernels' formula, one word at a time (threefry.cuh in Python)
# ---------------------------------------------------------------------------


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def _threefry(k, x0, x1):
    k0, k1 = k
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for group, rots in enumerate(((13, 15, 26, 6), (17, 29, 16, 24)) * 2
                                 + ((13, 15, 26, 6),)):
        for r in rots:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & M32
        x1 = (x1 + ks[(group + 2) % 3] + group + 1) & M32
    return x0, x1


def _fold_in(k, d):
    return _threefry(k, 0, d & M32)


def _walk_word(step_key, idx):
    y0, y1 = _threefry(step_key, idx >> 32, idx & M32)
    return y0 ^ y1


def _mirror(keys, step_base, chunk_steps, w):
    """(chunk_steps, n, 4) uint32 words as the kernels compute them: walker
    g uses keys[g // w] and element index g % w."""
    n = len(keys) * w
    out = np.zeros((chunk_steps, n, 4), np.uint64)
    for s in range(chunk_steps):
        step_keys = [_fold_in(k, step_base + s) for k in keys]
        for g in range(n):
            sk, i = step_keys[g // w], g % w
            for c in range(4):
                out[s, g, c] = _walk_word(sk, 4 * i + c)
    return out.astype(np.int64)


def _key_pairs(keys):
    return [tuple(int(v) for v in k) for k in np.asarray(keys).reshape(-1, 2)]


@pytest.mark.parametrize("w", [1, 33, 1024])
@pytest.mark.parametrize("step_base", [0, 8, 1_000_000])
@pytest.mark.parametrize("n_keys", [1, 3])
def test_kernel_formula_equals_chunk_rbits_and_reference(n_keys, step_base, w):
    chunk = 2
    if n_keys == 1:
        jkey = jax.random.key(5)
        tkeys = prng.key(5, "cpu")
        want = np.asarray(jwalk._chunk_rbits(jkey, jnp.int32(step_base), chunk, w))
    else:
        jkeys = jax.random.split(jax.random.key(2), n_keys)
        tkeys = prng.split(prng.key(2, "cpu"), n_keys)
        rq = jax.vmap(lambda k: jwalk._chunk_rbits(
            k, jnp.int32(step_base), chunk, w))(jkeys)
        want = np.asarray(jnp.moveaxis(rq, 0, 1).reshape(chunk, n_keys * w, 4))
    got = twalk._chunk_rbits(tkeys, step_base, chunk, w)
    mirror = _mirror(_key_pairs(tkeys.numpy()), step_base, chunk, w)
    np.testing.assert_array_equal(mirror, want.astype(np.int64))
    np.testing.assert_array_equal(prng.from_int32_bits(got).numpy(), mirror)
    # the keys as the kernels get them (int32 bit patterns) draw the same
    as_bits = tws.u32_bits_as_int32(tkeys)
    assert as_bits.dtype == torch.int32
    assert torch.equal(twalk._chunk_rbits(as_bits, step_base, chunk, w), got)
    assert torch.equal(
        tops.walk_bits(as_bits, step_base, chunk, w, use_kernel=True), got)


def test_kernel_formula_past_the_low_word():
    """A walker element index past 2**30 puts the word index past 2**32:
    the high word feeds threefry's first input, as jax's bits does."""
    sk = _fold_in(_key_pairs(prng.key(7, "cpu").numpy())[0], 3)
    i = 2**30 + 5
    words = [_walk_word(sk, 4 * i + c) for c in range(4)]
    k = torch.tensor(sk, dtype=torch.int64)
    y0, y1 = prng.threefry2x32(k[0], k[1], torch.tensor(1), torch.tensor(4 * 5))
    assert words[0] == int(y0 ^ y1)
    assert len(set(words)) == 4


# ---------------------------------------------------------------------------
# Keys-in routing of the fused walk
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def g():
    return small_test_graph(0).graph


def _csr(g, to):
    arrays = (g.p2b.offsets, g.p2b.targets, g.b2p.offsets, g.b2p.targets,
              g.p2b.feat_bounds, g.b2p.feat_bounds)
    return tuple(to(np.asarray(a)) for a in arrays)


def _torch(a):
    return torch.tensor(np.asarray(a))


def _lanes(g, n, seed):
    rng = np.random.default_rng(seed)
    degs = np.diff(np.asarray(g.p2b.offsets))
    live = np.nonzero(degs > 0)[0]
    dead = np.nonzero(degs == 0)[0]
    curr = rng.choice(live, n).astype(np.int32)
    if dead.size:  # dead-end starts exercise the invalid-event path
        curr[:3] = dead[0]
    query = rng.choice(live, n).astype(np.int32)
    query[-2:] = curr[-2:]                 # walkers that start on their query
    return (curr, query, rng.integers(0, 3, n).astype(np.int32),
            rng.integers(0, 3, n).astype(np.int32))


def _assert_lanes_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert (a is None) == (b is None), i
        if a is not None:
            assert a.dtype == torch.int32, i
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(i))


@pytest.mark.parametrize("count_boards", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("mode", ["per_query", "batched"])
def test_keys_in_walk_routing_equals_rbits_in_call(g, mode, bias, count_boards):
    n_queries, w, chunk, step_base = (1 if mode == "per_query" else 4), 96, 5, 40
    curr, query, feat, slot = _lanes(g, n_queries * w, seed=4)
    beta = BETA_U32 if bias else 0
    kw = dict(n_pins=g.n_pins, n_slots=3, n_boards=g.n_boards,
              alpha_u32=ALPHA_U32, beta_u32=beta, count_boards=count_boards)
    lanes = tuple(map(_torch, (curr, query, feat, slot)))
    tcsr = _csr(g, _torch)
    if mode == "per_query":
        jkeys, tkeys = jax.random.key(3), prng.key(3, "cpu")
        jbits = jwalk._chunk_rbits(jkeys, jnp.int32(step_base), chunk, w)
    else:
        jkeys = jax.random.split(jax.random.key(3), n_queries)
        tkeys = prng.split(prng.key(3, "cpu"), n_queries)
        rq = jax.vmap(lambda k: jwalk._chunk_rbits(
            k, jnp.int32(step_base), chunk, w))(jkeys)
        jbits = jnp.moveaxis(rq, 0, 1).reshape(chunk, n_queries * w, 4)
    rbits = twalk._chunk_rbits(tkeys, step_base, chunk, w)
    jargs = tuple(map(jnp.asarray, (curr, query, feat, slot)))
    if mode == "per_query":
        want = ref.walk_chunk_ref(*jargs, jbits, *_csr(g, jnp.asarray), **kw)
        old = tops.walk_chunk_words_plain(*lanes, rbits, *tcsr, **kw)
        calls = [tops.walk_chunk_fused(
            *lanes, keys, *tcsr, step_base=step_base, chunk_steps=chunk,
            use_kernel=use_kernel, **kw)
            for keys in (tkeys, tws.u32_bits_as_int32(tkeys))
            for use_kernel in (True, False)]
    else:
        qid = np.repeat(np.arange(n_queries, dtype=np.int32), w)
        want = ref.walk_chunk_batched_ref(
            *jargs, jnp.asarray(qid), jbits, *_csr(g, jnp.asarray),
            n_queries=n_queries, **kw)
        old = tops.walk_chunk_words_batched_plain(
            *lanes, _torch(qid), rbits, *tcsr, n_queries=n_queries, **kw)
        calls = [tops.walk_chunk_fused_batched(
            *lanes, _torch(qid), keys, *tcsr, step_base=step_base,
            chunk_steps=chunk, n_queries=n_queries, use_kernel=use_kernel, **kw)
            for keys in (tkeys, tws.u32_bits_as_int32(tkeys))
            for use_kernel in (True, False)]
    _assert_lanes_equal(old, want)
    for got in calls:
        _assert_lanes_equal(got, want)
    sev = old[-3].numpy()
    assert (sev == 3).any() and (sev < 3).any()  # valid and dead-end events


def test_keys_in_routing_needs_chunk_steps(g):
    curr, query, feat, slot = map(_torch, _lanes(g, 8, seed=1))
    with pytest.raises(TypeError, match="chunk_steps"):
        tops.walk_chunk_fused(
            curr, query, feat, slot, prng.key(0, "cpu"), *_csr(g, _torch),
            step_base=0, n_pins=g.n_pins, n_slots=3, n_boards=g.n_boards,
            alpha_u32=ALPHA_U32, beta_u32=0, use_kernel=True)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("mode", ["per_query", "batched"])
def test_keys_in_dispatch_refuses_a_word_table(g, mode, use_kernel):
    """The chunk dispatchers take keys only: a word table, with or without
    step_base, is the words-in helpers' contract."""
    n_queries, w, chunk = (1 if mode == "per_query" else 2), 8, 2
    lanes = tuple(map(_torch, _lanes(g, n_queries * w, seed=2)))
    keys = prng.split(prng.key(1, "cpu"), n_queries)
    table = twalk._chunk_rbits(keys if mode == "batched" else keys[0], 0,
                               chunk, w)
    kw = dict(n_pins=g.n_pins, n_slots=3, n_boards=g.n_boards,
              alpha_u32=ALPHA_U32, beta_u32=0, use_kernel=use_kernel)
    if mode == "per_query":
        call = lambda bits, **extra: tops.walk_chunk_fused(
            *lanes, bits, *_csr(g, _torch), **kw, **extra)
    else:
        qid = torch.arange(n_queries, dtype=torch.int32).repeat_interleave(w)
        call = lambda bits, **extra: tops.walk_chunk_fused_batched(
            *lanes, qid, bits, *_csr(g, _torch), n_queries=n_queries, **kw,
            **extra)
    with pytest.raises(ValueError, match="draws its own words"):
        call(table, step_base=0, chunk_steps=chunk)
    with pytest.raises(TypeError, match="step_base"):
        call(table)
    with pytest.raises(TypeError, match="chunk_steps"):
        call(keys if mode == "batched" else keys[0], step_base=0)


def test_words_in_helpers_refuse_keys_and_equal_the_reference(g):
    """The reference's words-in contracts live in the plain helpers only:
    given the same words they equal ``ref.walk_chunk_ref`` and
    ``ref.walk_chunk_batched_ref``; given keys they raise."""
    n_queries, w, chunk = 2, 16, 3
    curr, query, feat, slot = _lanes(g, n_queries * w, seed=6)
    rng = np.random.default_rng(6)
    words = rng.integers(0, 2**32, (chunk, n_queries * w, 4), dtype=np.uint64)
    words = words.astype(np.uint32)
    kw = dict(n_pins=g.n_pins, n_slots=3, n_boards=g.n_boards,
              alpha_u32=ALPHA_U32, beta_u32=BETA_U32, count_boards=True)
    lanes = tuple(map(_torch, (curr, query, feat, slot)))
    jargs = tuple(map(jnp.asarray, (curr, query, feat, slot)))
    qid = np.repeat(np.arange(n_queries, dtype=np.int32), w)
    tw = _torch(words.view(np.int32))
    got = tops.walk_chunk_words_plain(*lanes, tw, *_csr(g, _torch), **kw)
    want = ref.walk_chunk_ref(*jargs, jnp.asarray(words), *_csr(g, jnp.asarray),
                              **kw)
    _assert_lanes_equal(got, want)
    got = tops.walk_chunk_words_batched_plain(
        *lanes, _torch(qid), tw, *_csr(g, _torch), n_queries=n_queries, **kw)
    want = ref.walk_chunk_batched_ref(
        *jargs, jnp.asarray(qid), jnp.asarray(words), *_csr(g, jnp.asarray),
        n_queries=n_queries, **kw)
    _assert_lanes_equal(got, want)
    keys = prng.split(prng.key(1, "cpu"), n_queries)
    with pytest.raises(ValueError, match="word table"):
        tops.walk_chunk_words_plain(*lanes, keys[0], *_csr(g, _torch), **kw)
    with pytest.raises(ValueError, match="word table"):
        tops.walk_chunk_words_batched_plain(
            *lanes, _torch(qid), keys, *_csr(g, _torch), n_queries=n_queries,
            **kw)


# ---------------------------------------------------------------------------
# The table-and-walker route of the sharded hop
# ---------------------------------------------------------------------------


def _hop_case(seed, n_shards=3, l=200, rows=40, n_walkers=64, chunk=3):
    """Stacked CSR slices with degree-0 rows, a (chunk, n_walkers, 4) word
    table, lanes with walker ids, and garbage positions and walker ids on
    gated-off lanes."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 5, (n_shards, rows))
    deg[:, rng.integers(0, rows, rows // 6)] = 0
    off = np.concatenate([np.zeros((n_shards, 1), np.int64),
                          np.cumsum(deg, 1)], 1).astype(np.int32)
    tgt = rng.integers(0, 10**5, (n_shards, max(1, int(off[:, -1].max()))))
    base = (7 + np.arange(n_shards) * rows).astype(np.int32)
    gate = rng.random((n_shards, l)) < 0.6
    local = rng.integers(0, rows, (n_shards, l))
    local[:, -1] = rows - 1                       # each shard's last row
    pos = np.where(gate, base[:, None] + local,
                   rng.integers(-9, 10**6, (n_shards, l))).astype(np.int32)
    walker = np.where(gate, rng.integers(0, n_walkers, (n_shards, l)),
                      rng.integers(-2**31, 2**31 - 1, (n_shards, l)))
    table = rng.integers(0, 2**32, (chunk, n_walkers, 4), dtype=np.uint64)
    return (pos, gate, walker.astype(np.int32),
            table.astype(np.uint32).view(np.int32), off, tgt.astype(np.int32),
            base)


@pytest.mark.parametrize("column", [2, 3])
@pytest.mark.parametrize("seed", [0, 1])
def test_table_route_of_walk_hop_equals_twin_on_gathered_words(seed, column):
    pos, gate, walker, table, off, tgt, base = _hop_case(seed)
    t = torch.from_numpy
    for step in range(table.shape[0]):
        got = tops.walk_hop(t(pos), t(gate), t(table), t(off), t(tgt), t(base),
                            step=step, column=column, walker=t(walker),
                            use_kernel=True)
        plain = tops.walk_hop(t(pos), t(gate), t(table), t(off), t(tgt),
                              t(base), step=step, column=column,
                              walker=t(walker), use_kernel=False)
        r = table[step, np.where(gate, walker, 0), column]
        want = tws.walk_hop_ref(t(pos), t(gate), t(r), t(off), t(tgt), t(base))
        for a in (got, plain):
            assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])
        for s in range(pos.shape[0]):
            jt, jok = ref.walk_hop_ref(
                jnp.asarray(pos[s]), jnp.asarray(gate[s]),
                jnp.asarray(r[s].view(np.uint32)), jnp.asarray(off[s]),
                jnp.asarray(tgt[s]), jnp.asarray(base[s]))
            np.testing.assert_array_equal(got[0][s].numpy(), np.asarray(jt))
            np.testing.assert_array_equal(got[1][s].numpy(), np.asarray(jok))
        assert bool(got[1].any()) and not bool(got[1].all())


@pytest.mark.parametrize("use_kernel", [True, False])
def test_table_route_of_walk_hop_refuses_gathered_words(use_kernel):
    """The hop dispatcher takes the chunk's table with step, column and
    walker: gathered words (the reference's contract) go to
    ``walk_hop_words_plain``, which equals the reference's twin."""
    pos, gate, walker, table, off, tgt, base = _hop_case(3)
    t = torch.from_numpy
    r = table[1, np.where(gate, walker, 0), 2]
    with pytest.raises(ValueError, match="word table"):
        tops.walk_hop(t(pos), t(gate), t(r), t(off), t(tgt), t(base), step=1,
                      column=2, walker=t(walker), use_kernel=use_kernel)
    with pytest.raises(TypeError, match="walker"):
        tops.walk_hop(t(pos), t(gate), t(table), t(off), t(tgt), t(base),
                      step=1, column=2, use_kernel=use_kernel)
    got = tops.walk_hop_words_plain(t(pos), t(gate), t(r), t(off), t(tgt),
                                    t(base))
    via_table = tops.walk_hop(t(pos), t(gate), t(table), t(off), t(tgt),
                              t(base), step=1, column=2, walker=t(walker),
                              use_kernel=use_kernel)
    assert torch.equal(got[0], via_table[0]) and torch.equal(got[1], via_table[1])
    for s in range(pos.shape[0]):
        jt, jok = ref.walk_hop_ref(
            jnp.asarray(pos[s]), jnp.asarray(gate[s]),
            jnp.asarray(r[s].view(np.uint32)), jnp.asarray(off[s]),
            jnp.asarray(tgt[s]), jnp.asarray(base[s]))
        np.testing.assert_array_equal(got[0][s].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(got[1][s].numpy(), np.asarray(jok))
