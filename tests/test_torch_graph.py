"""The port's graph compiler, synthetic graphs and Eq. 1-2 sampling against
the JAX package, on the same numpy inputs.

CSR arrays, feature bounds and max degree must be equal array for array;
a graph written by either package's ``save_graph`` must load in the
other.  Step budgets and walker apportionment must be equal: the port's
``log`` reproduces XLA's CPU ``log`` bit for bit, including where that
``log`` is not correctly rounded (at 7, for one), which once moved a
budget by a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import sampling as jsamp
from repro.graphs import synthetic as jsyn
from repro_torch.core import graph as tgraph
from repro_torch.core import sampling as tsamp
from repro_torch.graphs import synthetic as tsyn


def _jarrays(g) -> dict:
    out = {
        "p2b_offsets": g.p2b.offsets, "p2b_targets": g.p2b.targets,
        "b2p_offsets": g.b2p.offsets, "b2p_targets": g.b2p.targets,
    }
    if g.p2b.feat_bounds is not None:
        out["p2b_feat_bounds"] = g.p2b.feat_bounds
        out["b2p_feat_bounds"] = g.b2p.feat_bounds
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_same_graph(tg, jg):
    a, b = tgraph.graph_to_numpy(tg), _jarrays(jg)
    assert set(a) == set(b)
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        assert a[name].dtype == np.int32, name
    assert (tg.n_pins, tg.n_boards, tg.max_pin_degree) == (
        jg.n_pins, jg.n_boards, jg.max_pin_degree
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_small_test_graph_matches(seed):
    j = jsyn.small_test_graph(seed)
    t = tsyn.small_test_graph(seed, device="cpu")
    _assert_same_graph(t.graph, j.graph)
    for name in ("pin_topics", "board_topics", "pin_lang", "board_lang",
                 "heldout_pins", "heldout_boards"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    np.testing.assert_array_equal(
        tsyn.top_degree_pins(t, 16), jsyn.top_degree_pins(j, 16)
    )


def test_sparse_wide_graph_matches():
    j = jsyn.sparse_wide_graph(3, n_pins=50_000, n_boards=64, n_edges=4000,
                               hot_pins=200)
    t = tsyn.sparse_wide_graph(3, n_pins=50_000, n_boards=64, n_edges=4000,
                               hot_pins=200, device="cpu")
    _assert_same_graph(t, j)


@pytest.mark.parametrize("feats", ["none", "given", "inferred", "two_sided"])
def test_build_graph_matches(feats):
    rng = np.random.default_rng(4)
    n_pins, n_boards, n_edges = 120, 30, 900
    pins = rng.integers(0, n_pins, n_edges)
    boards = rng.integers(0, n_boards, n_edges)
    f1 = rng.integers(0, 3, n_edges)
    f2 = rng.integers(0, 3, n_edges)
    kw = {
        "none": {},
        "given": dict(edge_feat=f1, n_feats=4),
        "inferred": dict(edge_feat=f1),
        "two_sided": dict(edge_feat=f1, n_feats=3, edge_feat_b2p=f2),
    }[feats]
    j = jgraph.build_graph(pins, boards, n_pins, n_boards, **kw)
    t = tgraph.build_graph(
        torch.as_tensor(pins, dtype=torch.int32),
        torch.as_tensor(boards, dtype=torch.int16),
        n_pins, n_boards,
        **{k: (torch.as_tensor(v, dtype=torch.int8) if k.startswith("edge")
               else v) for k, v in kw.items()},
    )
    _assert_same_graph(t, j)
    jp, jb = jgraph.edge_list(j)
    tp, tb = tgraph.edge_list(t)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tb, jb)


def test_build_graph_rejects_out_of_range_ids():
    with pytest.raises(ValueError, match="board_ids"):
        tgraph.build_graph(np.array([0, 1]), np.array([0, 5]), 2, 5)
    with pytest.raises(ValueError, match="edge_feat"):
        tgraph.build_graph(np.array([0, 1]), np.array([0, 1]), 2, 2,
                           edge_feat=np.array([0, 3]), n_feats=3)
    with pytest.raises(ValueError, match="align"):
        tgraph.build_graph(np.array([0, 1]), np.array([0]), 2, 2)


def test_reference_save_graph_loads_in_the_port(tmp_path):
    j = jsyn.small_test_graph(0).graph
    jgraph.save_graph(j, str(tmp_path / "ref"))
    t = tgraph.load_graph(str(tmp_path / "ref"), device="cpu")
    _assert_same_graph(t, j)
    # and back: the port writes the reference's format
    tgraph.save_graph(t, str(tmp_path / "port"))
    _assert_same_graph(t, jgraph.load_graph(str(tmp_path / "port")))


def test_graph_from_numpy_carries_the_reference_graph():
    j = jsyn.small_test_graph(0).graph
    t = tgraph.graph_from_numpy(
        _jarrays(j), j.n_pins, j.n_boards, j.max_pin_degree, device="cpu"
    )
    _assert_same_graph(t, j)
    one_sided = {k: v for k, v in _jarrays(j).items() if k != "b2p_feat_bounds"}
    with pytest.raises(ValueError, match="both CSR sides"):
        tgraph.graph_from_numpy(one_sided, j.n_pins, j.n_boards, 0, device="cpu")


def test_degrees_and_nbytes():
    j = jsyn.small_test_graph(0).graph
    t = tsyn.small_test_graph(0, device="cpu").graph
    q = np.array([0, 5, 17, 299], np.int32)
    np.testing.assert_array_equal(
        t.pin_degree(torch.as_tensor(q)).numpy(), np.asarray(j.pin_degree(q))
    )
    assert t.nbytes() == j.nbytes()


# ---------------------------------------------------------------------------
# Eq. 1-2: step budgets and walker apportionment
# ---------------------------------------------------------------------------


def _random_queries(seed, b=64):
    rng = np.random.default_rng(seed)
    s = int(rng.integers(1, 17))
    max_deg = int(rng.integers(8, 3000))
    deg = rng.integers(0, max_deg + 1, (b, s)).astype(np.int32)
    w = (rng.uniform(0, 1, (b, s)) * (rng.random((b, s)) > 0.2)).astype(np.float32)
    n = int(rng.integers(1, 300_000))
    return w, deg, max_deg, n


@pytest.mark.parametrize("seed", range(6))
def test_allocate_steps_and_walkers_match(seed):
    w, deg, max_deg, n = _random_queries(seed)
    want = np.asarray(jax.vmap(
        lambda ww, dd: jsamp.allocate_steps(ww, dd, jnp.asarray(max_deg), n)
    )(jnp.asarray(w), jnp.asarray(deg)))
    got = tsamp.allocate_steps(torch.as_tensor(w), torch.as_tensor(deg), max_deg, n)
    np.testing.assert_array_equal(got.numpy(), want)
    for n_walkers in (64, 256, 8192):
        js, jw = jax.vmap(lambda q: jsamp.allocate_walkers(q, n_walkers))(
            jnp.asarray(want))
        ts, tw = tsamp.allocate_walkers(torch.as_tensor(want.copy()), n_walkers)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_allocate_steps_budgets_as_data_match():
    w, deg, max_deg, _ = _random_queries(9, b=16)
    budgets = np.random.default_rng(1).integers(1, 50_000, 16).astype(np.int32)
    want = np.asarray(jax.vmap(
        lambda ww, dd, bt: jsamp.allocate_steps(ww, dd, jnp.asarray(max_deg), bt)
    )(jnp.asarray(w), jnp.asarray(deg), jnp.asarray(budgets)))
    got = tsamp.allocate_steps(torch.as_tensor(w), torch.as_tensor(deg), max_deg,
                               torch.as_tensor(budgets))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scaling_factor_on_the_test_graph_degrees_matches():
    deg = np.arange(0, 24, dtype=np.int32)
    want = np.asarray(jsamp.scaling_factor(jnp.asarray(deg), jnp.asarray(23)))
    got = tsamp.scaling_factor(torch.as_tensor(deg), 23)
    np.testing.assert_array_equal(got.numpy(), want)


def test_log_rounding_fault_moves_a_budget_by_one_step():
    """The fault (ROADMAP Queue 3, repaired): XLA's CPU float32 ``log(7)``
    is one ulp off the correctly rounded value, and with max degree 7,
    query pins of degree 7 and weights (1, 0.3), N = 13 steps split
    (9, 2) in the reference but (10, 3) under a correctly rounded log.
    The port's ``log_f32`` now reproduces XLA's ``log``, so its split is
    the reference's (9, 2)."""
    assert np.float32(jnp.log(jnp.float32(7.0))) != np.float32(np.log(7.0))
    assert tsamp.log_f32(torch.tensor([7.0])).item() == float(
        jnp.log(jnp.float32(7.0)))
    w = np.array([1.0, 0.3], np.float32)
    deg = np.array([7, 7], np.int32)
    ref = np.asarray(jsamp.allocate_steps(jnp.asarray(w), jnp.asarray(deg),
                                          jnp.asarray(7), 13))
    got = tsamp.allocate_steps(torch.as_tensor(w), torch.as_tensor(deg), 7, 13)
    f = np.float32
    s = f(7) * (f(7) - f(np.log(7.0)))
    ws = w * s
    correctly_rounded = np.floor(ws / (ws[0] + ws[1]) * f(13)).astype(np.int32)
    np.testing.assert_array_equal(correctly_rounded, [10, 3])
    np.testing.assert_array_equal(ref, [9, 2])
    np.testing.assert_array_equal(got.numpy(), ref)


def test_log_f32_is_correctly_rounded():
    """Name kept from when ``log_f32`` was the correctly rounded log; it
    now holds ``log_f32`` to ``jnp.log`` bit for bit at every integer in
    [1, 2**20] (8,757 of which ``jnp.log`` does not round correctly) and
    at float32 values spread over the normal range."""
    x = np.arange(1, 2**20 + 1, dtype=np.float32)
    want = np.asarray(jnp.log(jnp.asarray(x)))
    assert (want != np.log(x.astype(np.float64)).astype(np.float32)).sum() == 8757
    np.testing.assert_array_equal(tsamp.log_f32(torch.from_numpy(x)).numpy(), want)
    rng = np.random.default_rng(0)
    y = np.exp(rng.uniform(np.log(1e-37), np.log(1e38), 2**16)).astype(np.float32)
    y = np.concatenate([y, np.array([0.0, np.inf, 1.0, 0.5], np.float32)])
    np.testing.assert_array_equal(tsamp.log_f32(torch.from_numpy(y)).numpy(),
                                  np.asarray(jnp.log(jnp.asarray(y))))
