"""The port's event mode against the JAX package, bit for bit.

Event mode is the reference's replicated serving path: per query,
``pixie_walk_events`` keeps the walk's wide (slot, pin) event lanes, and
``recommend_from_events`` aggregates them by sorting (Eq. 3 + top-k).
Here the port's event counters (``events_to_counts``,
``boosted_from_events``, ``topk_events``, ``events_n_high_per_slot``,
``events_high_fold``) and its walks (``pixie_walk_events`` in both check
modes, ``pixie_walk_events_fixed``, ``recommend_from_events``) are held
against ``repro.core.counter`` and ``repro.core.walk`` on the same numpy
inputs and the same graph: integer lanes, counts, ``steps_taken``,
``chunks_run``, ``n_high``, ids and float scores must be equal, no
tolerance.  Also: a packed id space past 2**31 (65,536 slots x 40,000
pins), the incremental early-stop tally equal to the full re-sort with
early stopping firing mid-walk, the sizes the port's loop sorts (the
reference pins them by jaxpr inspection), and event mode equal to the
port's dense engine with early stopping off.

Every reference call is jitted and run once, in a module fixture or a
jitted helper.  The port runs ``backend="pallas"``, which on CPU tensors
takes the kernels' twins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import counter as jcounter
from repro.core import walk as jwalk
from repro.graphs.synthetic import small_test_graph, top_degree_pins
from repro.graphs.synthetic import sparse_wide_graph as jsparse_wide_graph
from repro_torch.core import counter as tcounter
from repro_torch.core import prng
from repro_torch.core import walk as twalk
from repro_torch.graphs import synthetic as tsyn

INT32_MIN = -(2**31)

_ref_to_counts = jax.jit(jcounter.events_to_counts, static_argnums=(2, 3))
_ref_boost = jax.jit(jcounter.boosted_from_events, static_argnums=(3, 4, 5))
_ref_topk = jax.jit(jcounter.topk_events, static_argnums=2)
_ref_n_high = jax.jit(jcounter.events_n_high_per_slot,
                      static_argnums=(2, 3, 4, 5))
_ref_fold = jax.jit(jcounter.events_high_fold,
                    static_argnames=("n_slots", "n_pins", "n_v", "seg_cap"))


def _port_cfg(cfg, **kw):
    return dataclasses.replace(
        twalk.WalkConfig(**dataclasses.asdict(cfg)), backend="pallas", **kw)


def _np(xs):
    return [np.asarray(x) for x in xs]


def _assert_fields_equal(got, want, names):
    for name, a, b in zip(names, got, want):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, name
        if a.dtype == np.float32:   # bit for bit, signed zeros included
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=name)


def _lanes(seed, m, n_slots, n_pins, hot=8):
    """Random wide lanes: sentinel events (n_slots, 0), hot pins that
    repeat, and pins spread over the whole id space."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n_slots + 1, m).astype(np.int32)
    p = rng.integers(0, n_pins, m).astype(np.int32)
    p[: m // 2] = rng.integers(0, hot, m // 2)
    p[s == n_slots] = 0
    return s, p


# ---------------------------------------------------------------------------
# event counters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n_slots,n_pins,max_unique", [
    (500, 3, 40, 500), (4096, 8, 1000, 4096), (300, 2, 30, 100), (1, 1, 5, 1),
])
def test_events_to_counts_matches_reference(m, n_slots, n_pins, max_unique):
    s, p = _lanes(m, m, n_slots, n_pins)
    want = _ref_to_counts(jnp.asarray(s), jnp.asarray(p), n_slots, max_unique)
    got = tcounter.events_to_counts(torch.as_tensor(s), torch.as_tensor(p),
                                    n_slots, max_unique)
    _assert_fields_equal(got, want, ("uniq_slot", "uniq_pin", "counts"))


@pytest.mark.parametrize("n_slots,n_pins", [(3, 40), (8, 1000), (16, 50)])
def test_boosted_from_events_matches_reference_bit_for_bit(n_slots, n_pins):
    m = 3000
    s, p = _lanes(n_slots, m, n_slots, n_pins, hot=n_pins // 4)
    runs = _ref_to_counts(jnp.asarray(s), jnp.asarray(p), n_slots, m)
    want = _ref_boost(*runs, n_slots, n_pins, m)
    got = tcounter.boosted_from_events(
        *(torch.as_tensor(np.array(x)) for x in runs), n_slots, n_pins, m)
    _assert_fields_equal(got, want, ("rep_pin", "boosted"))
    rep_pin = got[0].numpy()
    assert (rep_pin == INT32_MIN).any()   # empty segments keep int32 min
    assert (rep_pin == n_pins).sum() == 1  # the one invalid run
    assert (got[1].numpy() > 0).sum() > 10


@pytest.mark.parametrize("k", [1, 5, 40, 200])
def test_topk_events_keeps_lax_top_k_ties(k):
    rng = np.random.default_rng(k)
    scores = rng.integers(0, 6, 200).astype(np.float32)   # many ties
    pins = rng.permutation(200).astype(np.int32)
    pins[150:] = INT32_MIN
    want = _ref_topk(jnp.asarray(pins), jnp.asarray(scores), k)
    got = tcounter.topk_events(torch.as_tensor(pins), torch.as_tensor(scores), k)
    _assert_fields_equal(got, want, ("scores", "ids"))


@pytest.mark.parametrize("n_v", [1, 3, 20])
def test_events_n_high_per_slot_matches_reference(n_v):
    s, p = _lanes(n_v, 2000, 4, 60)
    want = _ref_n_high(jnp.asarray(s), jnp.asarray(p), 4, 60, n_v, 2000)
    got = tcounter.events_n_high_per_slot(torch.as_tensor(s), torch.as_tensor(p),
                                          4, 60, n_v, 2000)
    _assert_fields_equal([got], [want], ("n_high",))


def test_events_high_fold_cross_window_crossing_counts_once():
    """Mirror of the reference's test_widepack: a key at n_v - 1 after
    window 1 crosses in window 3 and is tallied once, never again."""
    n_slots, n_pins, n_v, seg_cap = 2, 50, 4, 16
    state = tcounter.events_high_init(n_slots, 4, seg_cap)

    def fold(state, pairs):
        s = np.full((seg_cap,), n_slots, np.int32)
        p = np.zeros((seg_cap,), np.int32)
        for i, (sl, pi) in enumerate(pairs):
            s[i], p[i] = sl, pi
        return tcounter.events_high_fold(
            state, torch.as_tensor(s), torch.as_tensor(p), n_slots, n_pins,
            n_v, seg_cap=seg_cap)

    state = fold(state, [(1, 7)] * (n_v - 1))
    assert state.high.tolist() == [0, 0]
    state = fold(state, [(0, 3), (0, 4)])
    assert state.high.tolist() == [0, 0]
    state = fold(state, [(1, 7)] * 3)
    assert state.high.tolist() == [0, 1]
    state = fold(state, [(1, 7)])
    assert state.high.tolist() == [0, 1]
    assert state.n_checks == 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_events_high_fold_random_windows_match_oracle(seed):
    """After every window the port's fold equals the reference's fold and
    both full re-aggregations (the port's and the reference's)."""
    rng = np.random.default_rng(seed)
    n_slots, n_pins, n_v, seg_cap, n_windows = 3, 40, 3, 64, 5
    state = tcounter.events_high_init(n_slots, n_windows, seg_cap)
    jstate = jcounter.events_high_init(n_slots, n_windows, seg_cap)
    all_s, all_p = [], []
    for _ in range(n_windows):
        s = rng.integers(0, n_slots + 1, seg_cap).astype(np.int32)
        p = np.where(s < n_slots, rng.integers(0, 10, seg_cap), 0).astype(np.int32)
        all_s.append(s)
        all_p.append(p)
        state = tcounter.events_high_fold(
            state, torch.as_tensor(s), torch.as_tensor(p), n_slots, n_pins,
            n_v, seg_cap=seg_cap)
        jstate = _ref_fold(jstate, jnp.asarray(s), jnp.asarray(p),
                           n_slots=n_slots, n_pins=n_pins, n_v=n_v,
                           seg_cap=seg_cap)
        fs, fp = np.concatenate(all_s), np.concatenate(all_p)
        oracle = tcounter.events_n_high_per_slot(
            torch.as_tensor(fs), torch.as_tensor(fp), n_slots, n_pins, n_v,
            fs.shape[0])
        assert torch.equal(state.high, oracle)
        _assert_fields_equal(
            [state.seg_slot, state.seg_pin, state.seg_count, state.high],
            jstate[:4], ("seg_slot", "seg_pin", "seg_count", "high"))
    assert state.high.sum() > 0


def test_events_high_fold_rejects_wrong_window_size():
    state = tcounter.events_high_init(2, 2, 8)
    z = torch.zeros((4,), dtype=torch.int32)
    with pytest.raises(ValueError, match="seg_cap"):
        tcounter.events_high_fold(state, z, z, 2, 10, 2, seg_cap=8)


def test_events_high_fold_past_capacity_never_clobbers_a_segment():
    """A state sized for one window folds a second: the stored segment is
    kept, the second window's runs are dropped, and the tally still takes
    the second window's crossings, as the reference's does."""
    n_slots, seg_cap = 2, 8
    s = np.array([0, 0, 1, 2, 2, 2, 2, 2], np.int32)
    p = np.array([3, 3, 4, 0, 0, 0, 0, 0], np.int32)
    windows = [(s, p), (s[::-1].copy(), p[::-1] + 1)]
    state = tcounter.events_high_init(n_slots, 1, seg_cap)
    jstate = jcounter.events_high_init(n_slots, 1, seg_cap)
    stored = None
    for ws, wp in windows:
        state = tcounter.events_high_fold(
            state, torch.as_tensor(ws), torch.as_tensor(wp), n_slots, 10, 2,
            seg_cap=seg_cap)
        jstate = _ref_fold(jstate, jnp.asarray(ws), jnp.asarray(wp),
                           n_slots=n_slots, n_pins=10, n_v=2, seg_cap=seg_cap)
        if stored is None:
            stored = [t.clone() for t in state[:3]]
    for a, b in zip(stored, state[:3]):
        assert torch.equal(a, b)
    _assert_fields_equal(state[:4], jstate[:4],
                         ("seg_slot", "seg_pin", "seg_count", "high"))
    assert state.n_checks == 2 and state.high.tolist() == [2, 0]


# ---------------------------------------------------------------------------
# the walks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def graphs():
    sg = small_test_graph(0)
    return sg, tsyn.small_test_graph(0, device="cpu").graph


def _query(sg):
    qs = top_degree_pins(sg, 20)
    pins = np.array([qs[0], qs[3], -1, qs[5]], np.int32)
    weights = np.array([1.0, 0.5, 0.0, 0.3], np.float32)
    return pins, weights


CFG = jwalk.WalkConfig(n_steps=20_000, n_walkers=256, chunk_steps=4, top_k=50,
                       n_p=30, n_v=3)
WALK_CASES = [  # (check_mode, check_every, early stop)
    ("incremental", 1, True), ("incremental", 2, True), ("full", 3, True),
    ("incremental", 4, True), ("incremental", 4, False),
]
FIELDS = jwalk.EventWalkResult._fields + ("scores", "ids")


@pytest.fixture(scope="module")
def reference_walks(graphs):
    """Every reference walk of this file, jitted, run once."""
    sg, _ = graphs
    pins, weights = _query(sg)
    out = {}
    for mode, every, es in WALK_CASES:
        cfg = CFG if es else CFG.without_early_stop()

        @jax.jit
        def run(key, cfg=cfg, mode=mode, every=every):
            r = jwalk.pixie_walk_events(
                sg.graph, jnp.asarray(pins), jnp.asarray(weights),
                jnp.int32(1), key, cfg, check_every=every, check_mode=mode)
            return (*r, *jwalk.recommend_from_events(
                r, 4, sg.graph.n_pins, jnp.asarray(pins), cfg.top_k))

        out[mode, every, es] = _np(run(jax.random.key(5)))

    @jax.jit
    def fixed(key):
        r = jwalk.pixie_walk_events_fixed(
            sg.graph, jnp.asarray(pins), jnp.asarray(weights), jnp.int32(2),
            key, CFG, n_chunks=3)
        return (*r, *jwalk.recommend_from_events(
            r, 4, sg.graph.n_pins, jnp.asarray(pins), CFG.top_k))

    out["fixed"] = _np(fixed(jax.random.key(6)))
    return out


def _port_walk(tg, pins, weights, feat, seed, cfg, **kw):
    r = twalk.pixie_walk_events(tg, torch.as_tensor(pins),
                                torch.as_tensor(weights), feat,
                                prng.key(seed, "cpu"), cfg, **kw)
    return (*r, *twalk.recommend_from_events(r, len(pins), tg.n_pins,
                                             torch.as_tensor(pins), cfg.top_k))


@pytest.mark.parametrize("mode,every,early_stop", WALK_CASES)
def test_pixie_walk_events_bit_identical(graphs, reference_walks, mode, every,
                                         early_stop):
    sg, tg = graphs
    pins, weights = _query(sg)
    cfg = _port_cfg(CFG if early_stop else CFG.without_early_stop())
    got = _port_walk(tg, pins, weights, 1, 5, cfg, check_every=every,
                     check_mode=mode)
    want = reference_walks[mode, every, early_stop]
    _assert_fields_equal(got, want, FIELDS)
    chunks = int(want[3])
    if early_stop:   # early stopping fired before the budget ran out
        assert chunks < CFG.max_chunks() and want[4].max() > CFG.n_p
    else:
        assert chunks == CFG.max_chunks()
    # the twin backend ("xla") walks the same lanes
    plain = _port_walk(tg, pins, weights, 1, 5,
                       dataclasses.replace(cfg, backend="xla"),
                       check_every=every, check_mode=mode)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


def test_pixie_walk_events_fixed_bit_identical(graphs, reference_walks):
    sg, tg = graphs
    pins, weights = _query(sg)
    cfg = _port_cfg(CFG)
    r = twalk.pixie_walk_events_fixed(tg, torch.as_tensor(pins),
                                      torch.as_tensor(weights), 2,
                                      prng.key(6, "cpu"), cfg, n_chunks=3)
    got = (*r, *twalk.recommend_from_events(r, 4, tg.n_pins,
                                            torch.as_tensor(pins), cfg.top_k))
    _assert_fields_equal(got, reference_walks["fixed"], FIELDS)
    assert r.slot_events.shape == (3 * cfg.n_walkers * cfg.chunk_steps,)


def test_incremental_tally_equals_full_resort_mid_walk(graphs):
    """check_every 2 and 3 on a sparse graph where early stopping fires
    mid-walk: the incremental tally, every lane and the top-k equal the
    full re-sort's, and the tally equals the oracle over the events of
    the completed check windows."""
    _, _ = graphs
    g = tsyn.sparse_wide_graph(3, n_pins=500, n_boards=16, n_edges=600,
                               hot_pins=200, device="cpu")
    pins = np.array([0, 7], np.int32)
    weights = np.array([1.0, 1.0], np.float32)
    cfg = twalk.WalkConfig(n_steps=4096, n_walkers=32, chunk_steps=4, n_p=100,
                           n_v=3, bias_beta=0.0, top_k=20, backend="pallas")
    per_chunk = cfg.n_walkers * cfg.chunk_steps
    for every in (2, 3):
        inc = _port_walk(g, pins, weights, 0, 1, cfg, check_every=every)
        full = _port_walk(g, pins, weights, 0, 1, cfg, check_every=every,
                          check_mode="full")
        for a, b in zip(inc, full):
            assert torch.equal(a, b)
        chunks = int(inc[3])
        assert chunks < cfg.max_chunks() and chunks >= 2 * every
        cut = (chunks // every) * every * per_chunk
        sev = inc[0].clone()
        sev[cut:] = len(pins)
        want = tcounter.events_n_high_per_slot(sev, inc[1], len(pins), g.n_pins,
                                               cfg.n_v, sev.shape[0])
        assert torch.equal(inc[4], want)


@pytest.mark.parametrize("mode", ["incremental", "full"])
def test_event_loop_sorts_only_the_window(monkeypatch, mode):
    """The port's stand-in for the reference's jaxpr inspection: every
    ``torch.sort`` / ``torch.argsort`` the walk loop runs is recorded.  The
    incremental loop never sorts more than one window (``seg_cap``); the
    full re-sort sorts the whole buffer and is flagged (positive
    control)."""
    g = tsyn.sparse_wide_graph(3, n_pins=500, n_boards=16, n_edges=600,
                               hot_pins=200, device="cpu")
    cfg = twalk.WalkConfig(n_steps=4096, n_walkers=32, chunk_steps=4, n_p=100,
                           n_v=3, bias_beta=0.0, backend="pallas")
    check_every = 2
    per_chunk = cfg.n_walkers * cfg.chunk_steps
    seg_cap = check_every * per_chunk
    max_events = cfg.max_chunks() * per_chunk
    assert max_events >= 4 * seg_cap
    sizes = []
    for name in ("sort", "argsort"):
        real = getattr(torch, name)

        def spy(x, *a, _real=real, **kw):
            sizes.append(x.numel())
            return _real(x, *a, **kw)

        monkeypatch.setattr(torch, name, spy)
    r = twalk.pixie_walk_events(
        g, torch.tensor([0, 7], dtype=torch.int32), torch.ones(2), 0,
        prng.key(0, "cpu"), cfg, check_every=check_every, check_mode=mode)
    assert int(r.chunks_run) >= check_every and sizes
    if mode == "incremental":
        assert max(sizes) <= seg_cap
    else:
        assert max(sizes) == max_events


def test_event_walk_past_int32_packed_space_bit_identical():
    """65,536 slots x 40,000 pins = 2.6e9 packed ids (> 2**31), the
    reference's test_widepack shape: every output equals the reference's,
    and the dense engine refuses the shape, naming event mode."""
    n_slots, n_pins = 65_536, 40_000
    assert n_slots * n_pins >= 2**31
    jg = jsparse_wide_graph(0, n_pins=n_pins, n_boards=64, n_edges=4_000,
                            hot_pins=2_000)
    tg = tsyn.sparse_wide_graph(0, n_pins=n_pins, n_boards=64, n_edges=4_000,
                                hot_pins=2_000, device="cpu")
    for side in ("p2b", "b2p"):
        for arr in ("offsets", "targets"):
            np.testing.assert_array_equal(
                getattr(getattr(tg, side), arr).numpy(),
                np.asarray(getattr(getattr(jg, side), arr)))
    qp = np.full((n_slots,), -1, np.int32)
    qw = np.zeros((n_slots,), np.float32)
    qp[0], qp[1] = 3, 17
    qw[0], qw[1] = 1.0, 0.5
    cfg = jwalk.WalkConfig(n_steps=2_048, n_walkers=64, chunk_steps=4, n_p=500,
                           n_v=3, bias_beta=0.0, top_k=20)

    @jax.jit
    def run(key):
        r = jwalk.pixie_walk_events(jg, jnp.asarray(qp), jnp.asarray(qw),
                                    jnp.int32(0), key, cfg, check_every=2)
        return (*r, *jwalk.recommend_from_events(r, n_slots, n_pins,
                                                 jnp.asarray(qp), 20))

    want = _np(run(jax.random.key(1)))
    got = _port_walk(tg, qp, qw, 0, 1, _port_cfg(cfg), check_every=2)
    _assert_fields_equal(got, want, FIELDS)
    assert (got[0] < n_slots).sum() > 0 and (got[5][:5] > 0).all()
    assert twalk.packed_event_dtype(n_slots, n_pins) == torch.int32
    with pytest.raises(ValueError, match="pixie_walk_events"):
        twalk.select_count_engine("pallas", n_slots, n_pins)


def test_event_path_equals_dense_recommend_without_early_stop(graphs):
    """With early stopping off, event mode's (scores, ids) equal the port's
    dense walk.recommend on the same query and key, bit for bit, for a
    one-pin query.  With several pins the two reference engines mask query
    pins differently: dense debits each slot's own query pin, event mode
    drops every query pin from every slot.  Event mode then equals the
    dense engine's counts with every query pin's column zeroed, boosted
    and ranked by the dense booster; and the seeds below include one where
    a query pin visited from another slot makes the two recommends part."""
    sg, tg = graphs
    pins, weights = _query(sg)
    cfg = _port_cfg(CFG.without_early_stop())
    parted = 0
    for seed in (5, 9, 11):
        one = _port_walk(tg, pins[:1], weights[:1], 1, seed, cfg)
        dense = twalk.recommend(tg, torch.as_tensor(pins[:1]),
                                torch.as_tensor(weights[:1]), 1,
                                prng.key(seed, "cpu"), cfg)
        assert torch.equal(one[5], dense[0]) and torch.equal(one[6], dense[1])

        got = _port_walk(tg, pins, weights, 1, seed, cfg)
        res = twalk.pixie_random_walk(tg, torch.as_tensor(pins),
                                      torch.as_tensor(weights), 1,
                                      prng.key(seed, "cpu"), cfg)
        counts = res.counts.clone()
        counts[:, torch.as_tensor(pins[pins >= 0]).long()] = 0
        boosted = tcounter.boost_combine(counts)
        want = tcounter.topk_dense(boosted, cfg.top_k)
        assert torch.equal(got[5], want[0]) and torch.equal(got[6], want[1])
        dense = twalk.recommend(tg, torch.as_tensor(pins),
                                torch.as_tensor(weights), 1,
                                prng.key(seed, "cpu"), cfg)
        parted += not torch.equal(got[6], dense[1])
    assert parted


def test_event_walk_contract_errors_and_board_counting(graphs):
    sg, tg = graphs
    pins, weights = _query(sg)
    args = (tg, torch.as_tensor(pins), torch.as_tensor(weights), 0,
            prng.key(0, "cpu"))
    with pytest.raises(ValueError, match="n_v"):
        twalk.pixie_walk_events(*args, _port_cfg(CFG, n_v=0))
    with pytest.raises(ValueError, match="check_mode"):
        twalk.pixie_walk_events(*args, _port_cfg(CFG), check_mode="sometimes")
    # event mode buffers pins only: board counting is forced off
    a = twalk.pixie_walk_events(*args, _port_cfg(CFG, count_boards=True))
    b = twalk.pixie_walk_events(*args, _port_cfg(CFG))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
