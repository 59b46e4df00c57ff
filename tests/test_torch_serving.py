"""The port's walk engines and ``serve_batch`` against the JAX package.

The gate of the main path: on ``small_test_graph`` the port's
``serve_batch(with_stats=True)`` must equal the reference's, ids, scores,
``steps_taken`` and ``n_high`` alike, bit for bit (no tolerance), over
batch sizes {1, 4, 16} x ``count_boards`` x bias, with a scalar key, with
per-query keys and with per-query step budgets.  Before comparing walks
each case asserts that both sides' Eq. 2 budgets are equal, so a
log-rounding divergence would show up as itself, not as a walk mismatch.

The reference runs its ``"xla"`` backend (bit-identical to its Pallas
engine and much faster to run on the CPU); the port runs its main path,
``backend="pallas"``, which on CPU tensors takes the kernels' twins.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampling as jsamp
from repro.core import service as jservice
from repro.core import walk as jwalk
from repro.graphs.synthetic import small_test_graph, top_degree_pins
from repro_torch.core import prng
from repro_torch.core import service as tservice
from repro_torch.core import walk as twalk
from repro_torch.graphs import synthetic as tsyn


@pytest.fixture(scope="module")
def graphs():
    sg = small_test_graph(0)
    return sg, tsyn.small_test_graph(0, device="cpu").graph


def _cfg(**kw):
    base = dict(n_steps=2000, n_walkers=128, chunk_steps=4, top_k=20,
                n_p=40, n_v=3)
    base.update(kw)
    return jwalk.WalkConfig(**base)


def _port_cfg(cfg, **kw):
    return dataclasses.replace(twalk.WalkConfig(**dataclasses.asdict(cfg)), **kw)


def _batch(sg, b, n_slots=4, seed=0):
    rng = np.random.default_rng(seed)
    qs = top_degree_pins(sg, 40)
    pins = np.full((b, n_slots), -1, np.int32)
    weights = np.zeros((b, n_slots), np.float32)
    for i in range(b):
        k = 1 + (i % (n_slots - 1)) if n_slots > 1 else 1
        pins[i, :k] = rng.choice(qs, k, replace=False)
        weights[i, :k] = rng.uniform(0.2, 1.0, k)
    feats = (np.arange(b) % 3).astype(np.int32)
    return pins, weights, feats


def _ref_budgets(g, pins, weights, cfg, budgets=None):
    valid = (pins >= 0) & (weights > 0)
    safe = np.where(valid, pins, 0)
    degs = np.asarray(g.pin_degree(jnp.asarray(safe))) * valid
    totals = (np.full(len(pins), cfg.n_steps) if budgets is None
              else np.minimum(budgets, cfg.n_steps))
    return np.asarray(jax.vmap(
        lambda w, d, n: jsamp.allocate_steps(w, d, jnp.asarray(g.max_pin_degree), n)
    )(jnp.asarray(np.where(valid, weights, 0)), jnp.asarray(degs),
      jnp.asarray(totals, jnp.int32)))


def _assert_budgets_equal(sg, tg, pins, weights, cfg, budgets=None):
    want = _ref_budgets(sg.graph, pins, weights, cfg, budgets)
    plan = twalk._plan(tg, torch.as_tensor(pins), torch.as_tensor(weights),
                       _port_cfg(cfg),
                       None if budgets is None else torch.as_tensor(budgets))
    np.testing.assert_array_equal(plan.n_q.numpy(), want)


def _serve_both(sg, tg, pins, weights, feats, cfg, key_mode, budgets=None,
                port_backend="pallas"):
    b = len(pins)
    if key_mode == "scalar":
        jkey, tkey = jax.random.key(3), prng.key(3, "cpu")
    else:
        ids = np.arange(b) * 7 + 1
        jkey = jax.vmap(lambda i: jax.random.fold_in(jax.random.key(0), i))(
            jnp.asarray(ids))
        tkey = prng.fold_in(prng.key(0, "cpu"), torch.as_tensor(ids))
    want = jservice.serve_batch(
        sg.graph, jnp.asarray(pins), jnp.asarray(weights), jnp.asarray(feats),
        jkey, cfg, backend="xla", with_stats=True,
        step_budgets=None if budgets is None else jnp.asarray(budgets))
    got = tservice.serve_batch(
        tg, torch.as_tensor(pins), torch.as_tensor(weights),
        torch.as_tensor(feats), tkey, _port_cfg(cfg), backend=port_backend,
        with_stats=True,
        step_budgets=None if budgets is None else torch.as_tensor(budgets))
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


def _assert_served_equal(got, want):
    for name, a, b in zip(("scores", "ids", "steps_taken", "n_high"), got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert want[2].sum() > 0 and (want[0] > 0).any()  # it walked


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("count_boards", [False, True])
@pytest.mark.parametrize("batch", [1, 4, 16])
def test_serve_batch_bit_identical(graphs, batch, count_boards, bias):
    sg, tg = graphs
    cfg = _cfg(count_boards=count_boards, bias_beta=0.9 if bias else 0.0)
    pins, weights, feats = _batch(sg, batch, seed=batch)
    _assert_budgets_equal(sg, tg, pins, weights, cfg)
    want, got = _serve_both(sg, tg, pins, weights, feats, cfg, "scalar")
    _assert_served_equal(got, want)


@pytest.mark.parametrize("port_backend", ["pallas", "xla"])
def test_serve_batch_per_query_keys_and_budgets(graphs, port_backend):
    """Per-query keys (the server's fold_in streams) and per-query Eq. 2
    budgets as data, one budget above cfg.n_steps (clamped); ``"xla"``
    is the port's query-by-query oracle path."""
    sg, tg = graphs
    cfg = _cfg(count_boards=True)
    pins, weights, feats = _batch(sg, 4, seed=21)
    budgets = np.array([2000, 700, 50, 10_000], np.int32)
    _assert_budgets_equal(sg, tg, pins, weights, cfg, budgets)
    want, got = _serve_both(sg, tg, pins, weights, feats, cfg, "per_query",
                            budgets, port_backend=port_backend)
    _assert_served_equal(got, want)


def test_serve_batch_early_stop_at_different_chunks(graphs):
    """Tight thresholds stop some (query, slot) rows chunks before others:
    the shared loop must freeze them exactly as the reference does."""
    sg, tg = graphs
    cfg = _cfg(n_steps=6000, n_walkers=64, n_p=40, n_v=3)
    pins, weights, feats = _batch(sg, 4, seed=5)
    want, got = _serve_both(sg, tg, pins, weights, feats, cfg, "per_query")
    _assert_served_equal(got, want)
    steps = want[2][want[2] > 0]
    assert len(set(steps.tolist())) > 2  # rows stopped at different chunks


@pytest.mark.parametrize("count_boards", [False, True])
def test_batched_walk_counts_and_board_counts_match(graphs, count_boards):
    sg, tg = graphs
    cfg = _cfg(count_boards=count_boards, n_steps=1500)
    pins, weights, feats = _batch(sg, 3, seed=9)
    jkeys = jax.random.split(jax.random.key(4), 3)
    want = jwalk.pixie_random_walk_batched(
        sg.graph, jnp.asarray(pins), jnp.asarray(weights), jnp.asarray(feats),
        jkeys, cfg)
    got = twalk.pixie_random_walk_batched(
        tg, torch.as_tensor(pins), torch.as_tensor(weights),
        torch.as_tensor(feats), prng.split(prng.key(4, "cpu"), 3),
        _port_cfg(cfg, backend="pallas"))
    for name in ("counts", "board_counts", "steps_taken", "n_high"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_per_query_engine_and_recommend_match(graphs):
    sg, tg = graphs
    cfg = _cfg(count_boards=True)
    pins, weights, feats = _batch(sg, 1, seed=2)
    want = jwalk.pixie_random_walk(
        sg.graph, jnp.asarray(pins[0]), jnp.asarray(weights[0]),
        jnp.asarray(feats[0]), jax.random.key(8), cfg)
    got = twalk.pixie_random_walk(
        tg, torch.as_tensor(pins[0]), torch.as_tensor(weights[0]),
        int(feats[0]), prng.key(8, "cpu"), _port_cfg(cfg))
    for name in ("counts", "board_counts", "steps_taken", "n_high"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    js, ji = jwalk.recommend(sg.graph, jnp.asarray(pins[0]), jnp.asarray(weights[0]),
                             jnp.asarray(feats[0]), jax.random.key(8), cfg)
    ts, ti = twalk.recommend(tg, torch.as_tensor(pins[0]), torch.as_tensor(weights[0]),
                             int(feats[0]), prng.key(8, "cpu"), _port_cfg(cfg))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_basic_random_walk_matches(graphs):
    sg, tg = graphs
    cfg = _cfg(n_steps=1200, bias_beta=0.9)
    pin = int(top_degree_pins(sg, 1)[0])
    want = jwalk.basic_random_walk(sg.graph, pin, jax.random.key(6), cfg)
    got = twalk.basic_random_walk(tg, pin, prng.key(6, "cpu"), _port_cfg(cfg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) > 0


def test_tpu_knobs_change_no_bit(graphs):
    """gather_mode and pallas_block_w are accepted for config parity; the
    CUDA kernel has one design for every value."""
    _, tg = graphs
    pins = torch.tensor([[5, 17, -1]], dtype=torch.int32)
    weights = torch.tensor([[1.0, 0.5, 0.0]])
    feats = torch.tensor([1], dtype=torch.int32)
    key = prng.key(1, "cpu")
    outs = [
        tservice.serve_batch(tg, pins, weights, feats, key,
                             twalk.WalkConfig(n_steps=800, n_walkers=64, top_k=10,
                                              backend="pallas", **kw),
                             with_stats=True)
        for kw in ({}, dict(gather_mode="dma"), dict(pallas_block_w=32))
    ]
    for other in outs[1:]:
        for a, b in zip(outs[0], other):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="gather_mode"):
        tservice.serve_batch(tg, pins, weights, feats, key,
                             twalk.WalkConfig(gather_mode="vector"))


def test_engine_guards(graphs):
    _, tg = graphs
    pins = torch.tensor([[5, -1]], dtype=torch.int32)
    weights = torch.tensor([[1.0, 0.0]])
    key = prng.key(1, "cpu")
    with pytest.raises(ValueError, match="n_v must be >= 1"):
        tservice.serve_batch(tg, pins, weights, torch.tensor([0]), key,
                             twalk.WalkConfig(n_v=0, backend="pallas"))
    with pytest.raises(ValueError, match="user features"):
        tservice.serve_batch(tg, pins, weights, torch.tensor([7]), key,
                             twalk.WalkConfig(n_steps=100, n_walkers=8,
                                              top_k=5, backend="pallas"))
    with pytest.raises(ValueError, match="one key per query"):
        tservice.serve_batch(tg, pins, weights, torch.tensor([0]),
                             prng.split(key, 2), twalk.WalkConfig())
    assert twalk.batched_engine_fits(1, 8, 140_000_000)
    assert not twalk.batched_engine_fits(2, 8, 140_000_000)
    assert twalk.NO_EARLY_STOP_NV == int(jwalk.NO_EARLY_STOP_NV)
    for p in (0.0, 0.3, 0.5, 0.65, 0.9, 1.0):
        assert twalk._prob_u32(p) == jwalk._prob_u32(p)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_out_of_range_user_feature_is_refused_where_reference_clamps(
        graphs, backend):
    """A deliberate contract difference: the reference's gather clamps a
    user feature outside the graph's languages and walks anyway; the port
    refuses it, on both engines, and serves an in-range one."""
    sg, tg = graphs
    pins, weights, _ = _batch(sg, 2)
    cfg = _cfg(backend=backend)
    bad = np.asarray([0, tg.p2b.n_feats], np.int32)
    want = jservice.serve_batch(sg.graph, jnp.asarray(pins),
                                jnp.asarray(weights), jnp.asarray(bad),
                                jax.random.key(3), cfg)
    assert np.asarray(want[0]).shape == (2, cfg.top_k)
    args = (tg, torch.as_tensor(pins), torch.as_tensor(weights))
    with pytest.raises(ValueError, match="user features must lie in"):
        tservice.serve_batch(*args, torch.as_tensor(bad), prng.key(3, "cpu"),
                             _port_cfg(cfg))
    got = tservice.serve_batch(*args, torch.as_tensor(bad % tg.p2b.n_feats),
                               prng.key(3, "cpu"), _port_cfg(cfg))
    assert got[0].shape == (2, cfg.top_k)


def test_query_shaping_matches():
    from repro_torch.core.service import UserAction as TA

    actions = [("save", 3, 1.0), ("click", 5, 30.0), ("view", 3, 2.0),
               ("like", 9, 0.5), ("save", 11, 100.0)]
    jq = jservice.build_query(
        [jservice.UserAction(pin=p, action=a, age_hours=h) for a, p, h in actions], 4)
    tq = tservice.build_query([TA(pin=p, action=a, age_hours=h) for a, p, h in actions], 4)
    for a, b in zip(tq, jq):
        np.testing.assert_array_equal(a, b)
    base = twalk.WalkConfig()
    jbase = jwalk.WalkConfig()
    for tf, jf in ((tservice.homefeed_config, jservice.homefeed_config),
                   (tservice.related_pins_config, jservice.related_pins_config),
                   (tservice.board_rec_config, jservice.board_rec_config)):
        assert dataclasses.asdict(tf(base)) == dataclasses.asdict(jf(jbase))
    pins, weights, feats = tservice.batch_queries([tq, tq], [1, 2], device="cpu")
    assert pins.shape == (2, 4) and weights.dtype == torch.float32
    assert feats.tolist() == [1, 2]
    with pytest.raises(ValueError, match="ragged"):
        tservice.batch_queries([tq, (tq[0][:2], tq[1][:2])], [0, 0], device="cpu")


def test_full_walk_config_is_the_reference_full_walk():
    from repro.configs.pixie import FULL, PIXIE_SHAPES
    from repro_torch.configs import pixie as tpixie

    # every field but the backend: the port's production walk runs the
    # hand kernels, where the reference's default "xla" is a TPU lowering
    assert tpixie.FULL_WALK.backend == "pallas"
    assert dataclasses.asdict(dataclasses.replace(tpixie.FULL_WALK, backend=FULL.walk.backend)) == (
        dataclasses.asdict(FULL.walk))
    shape = {s.name: s for s in PIXIE_SHAPES}["serve_200m_replicated"].params
    port = tpixie.SERVE_200M_REPLICATED
    assert (port.n_pins, port.n_boards, port.n_edges, port.n_slots) == (
        shape["n_pins"], shape["n_boards"], shape["n_edges"], shape["n_slots"])
