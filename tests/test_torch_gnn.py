"""The port's GIN against the JAX package.

``gnn.forward`` at node level on a planted-partition graph and on a
``FanoutSampler`` block (pad edges aimed at segment ``n`` and dropped),
and with the ``readout="sum"`` graph readout on a ``molecule_batch``; both
losses and ``layers.cross_entropy_logits``; ``segment_sum`` with ids out
of range; the ``gin_tu`` configs.  The weights are the reference's
``init_params`` arrays carried across by ``layers.params_from_reference``,
with random nonzero biases and eps (the reference starts them at zero,
which would hide those paths).  The data are the port's ``gnn_data`` and
``sampler`` arrays, which equal the reference's bit for bit
(``tests/test_torch_paper_features.py``).

Tolerance: 2e-6 absolute where the reference's values are O(1); where
they are larger (summed neighbourhoods grow layer by layer, and a graph
readout sums 30 nodes), 2e-6 times the tensor's largest magnitude, as the
ranked scores are held (ROADMAP "Ranked scores"): XLA and torch sum the
products in different orders.  ``segment_sum`` adds in the reference's
order, so it is held to the bits.  Permuting the edges moves the port's
sums by rounding only (held to the same bound).

Every reference call runs once, jitted, in the module fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gin_tu as jgin
from repro.models import gnn as jgnn
from repro.models import layers as jlayers
from repro_torch.configs import gin_tu as tgin
from repro_torch.graphs import gnn_data, sampler
from repro_torch.models import gnn as tgnn
from repro_torch.models import layers

ATOL = 2e-6
CPU = torch.device("cpu")
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_config(jcfg):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["compute_dtype"] = DTYPES[jnp.dtype(jcfg.compute_dtype).type]
    return tgnn.GINConfig(**fields)


def _close(got, want, what):
    want = np.asarray(want)
    bound = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().cpu().float().numpy(), want,
                               rtol=0, atol=bound, err_msg=what)


def _reference_params(cfg, seed):
    params = jax.tree_util.tree_map(np.asarray, jgnn.init_params(jax.random.key(seed), cfg))
    rng = np.random.default_rng(seed)
    for group, name in (("encoder", "b"), ("layers", "b1"), ("layers", "b2"),
                        ("layers", "eps"), ("head", "b")):
        a = params[group][name]
        params[group][name] = rng.normal(0.0, 0.3, a.shape).astype(np.float32)
    return params


def _cases():
    node = gnn_data.planted_partition(300, 1200, 32, 3, seed=1)
    big = gnn_data.planted_partition(2000, 9000, 24, 5, seed=2)
    block = sampler.FanoutSampler(
        sampler.csr_from_edges(big.edge_src, big.edge_dst, 2000), (5, 3), seed=3
    ).sample(np.arange(0, 2000, 50, dtype=np.int32), step=0)
    arr = sampler.block_to_arrays(block, big.feats, big.labels)
    mol = gnn_data.molecule_batch(batch=12, d_feat=16, n_classes=2, seed=4)
    smoke = jgin.SMOKE
    return {
        "node": (smoke, dict(feats=node.feats, edge_src=node.edge_src,
                             edge_dst=node.edge_dst, labels=node.labels,
                             mask=node.train_mask)),
        "block": (dataclasses.replace(smoke, d_in=24, n_classes=5), arr),
        "molecules": (dataclasses.replace(smoke, d_in=16, n_classes=2, readout="sum"),
                      dict(feats=mol.feats, edge_src=mol.edge_src,
                           edge_dst=mol.edge_dst, graph_ids=mol.graph_ids,
                           labels=mol.labels, n_graphs=12)),
    }


CASES = _cases()


@pytest.fixture(scope="module")
def reference():
    out = {}
    for seed, (case, (cfg, g)) in enumerate(CASES.items()):
        params = _reference_params(cfg, seed)
        args = (g["feats"], g["edge_src"], g["edge_dst"])
        if cfg.readout == "sum":
            n = g["n_graphs"]
            logits = jax.jit(lambda p: jgnn.forward(
                p, *args, cfg, graph_ids=g["graph_ids"], n_graphs=n))(params)
            loss = jax.jit(lambda p: jgnn.graph_classification_loss(
                p, *args, g["graph_ids"], g["labels"], cfg, n))(params)
        else:
            logits = jax.jit(lambda p: jgnn.forward(p, *args, cfg))(params)
            loss = jax.jit(lambda p: jgnn.node_classification_loss(
                p, *args, g["labels"], g["mask"], cfg))(params)
        out[case] = dict(params=params, logits=np.asarray(logits), loss=float(loss))
    return out


def _port_inputs(g):
    return {k: (torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v)
            for k, v in g.items()}


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_loss_match_reference(reference, case):
    cfg, g = CASES[case]
    r = reference[case]
    params = layers.params_from_reference(r["params"], CPU)
    t = _port_inputs(g)
    cfg_t = port_config(cfg)
    args = (t["feats"], t["edge_src"], t["edge_dst"])
    if cfg.readout == "sum":
        logits = tgnn.forward(params, *args, cfg_t, graph_ids=t["graph_ids"],
                              n_graphs=t["n_graphs"])
        loss = tgnn.graph_classification_loss(params, *args, t["graph_ids"],
                                              t["labels"], cfg_t, t["n_graphs"])
    else:
        logits = tgnn.forward(params, *args, cfg_t)
        loss = tgnn.node_classification_loss(params, *args, t["labels"],
                                             t["mask"], cfg_t)
    assert logits.dtype == torch.float32 and logits.shape == r["logits"].shape
    _close(logits, r["logits"], "logits")
    _close(loss, r["loss"], "loss")
    print(f"{case}: logits up to {np.abs(r['logits']).max():.3g}, max diff "
          f"{float((logits - torch.from_numpy(r['logits'])).abs().max()):.3g}")


def test_block_has_dropped_pad_edges():
    _, arr = CASES["block"]
    n = arr["feats"].shape[0]
    assert (arr["edge_dst"] == n).any() and (arr["edge_dst"] < n).any()


@pytest.mark.parametrize("case", ["node", "molecules"])
def test_edge_permutation_invariance(reference, case):
    cfg, g = CASES[case]
    params = layers.params_from_reference(reference[case]["params"], CPU)
    perm = np.random.default_rng(9).permutation(g["edge_src"].size)
    t = _port_inputs(g)
    kw = (dict(graph_ids=t["graph_ids"], n_graphs=t["n_graphs"])
          if cfg.readout == "sum" else {})
    a = tgnn.forward(params, t["feats"], t["edge_src"], t["edge_dst"],
                     port_config(cfg), **kw)
    b = tgnn.forward(params, t["feats"], t["edge_src"][perm], t["edge_dst"][perm],
                     port_config(cfg), **kw)
    _close(b, a.numpy(), "permuted edges")


@pytest.mark.parametrize("n_rows,n_seg,d", [(0, 5, 3), (1, 1, 4), (500, 37, 8),
                                             (2000, 3, 1)])
def test_segment_sum_matches_reference_bits(n_rows, n_seg, d):
    rng = np.random.default_rng(n_rows)
    data = rng.normal(size=(n_rows, d)).astype(np.float32) * 10
    ids = rng.integers(-3, n_seg + 3, n_rows).astype(np.int32)
    want = np.asarray(jax.jit(lambda x, i: jax.ops.segment_sum(
        x, i, num_segments=n_seg))(data, ids))
    got = tgnn.segment_sum(torch.from_numpy(data), torch.from_numpy(ids), n_seg)
    assert got.shape == (n_seg, d)
    np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


def test_cross_entropy_logits_matches_reference():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(3, 7, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    for mask in (rng.random((3, 7)) < 0.6, np.zeros((3, 7), bool)):
        mask = mask.astype(np.float32)
        want = float(jax.jit(jlayers.cross_entropy_logits)(logits, labels, mask))
        got = layers.cross_entropy_logits(torch.from_numpy(logits),
                                          torch.from_numpy(labels),
                                          torch.from_numpy(mask))
        assert got.dtype == torch.float32
        _close(got, want, "cross entropy")


def test_gin_configs_match_reference():
    for which in ("FULL", "SMOKE"):
        jcfg, tcfg = getattr(jgin, which), getattr(tgin, which)
        assert tcfg == port_config(jcfg), which
        assert tcfg.param_count() == jcfg.param_count()
    assert tgin.SOURCE == jgin.spec().source
    want = {f.name: f.default for f in dataclasses.fields(jgnn.GINConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tgnn.GINConfig)}
    assert got.keys() == want.keys()
    for name in want:
        if name != "compute_dtype":
            assert got[name] == want[name], name
    assert got["compute_dtype"] == torch.float32


def test_init_params_layout_matches_reference():
    cfg = jgin.FULL
    want = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                  jgnn.init_params(jax.random.key(0), cfg))
    got = tgnn.init_params(torch.Generator().manual_seed(0), port_config(cfg))
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got)
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in jax.tree_util.tree_leaves(
        want, is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[1], str))) == cfg.param_count()


def _nan_close(got, want, what):
    """NaN where the reference's is, the rest within the bound."""
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got)
    want = np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    ok = ~np.isnan(want)
    _close(torch.from_numpy(np.where(ok, got, 0)), np.where(ok, want, 0), what)


EDGE_LABELS = (-1, 0, "v", "-v-1")


@pytest.mark.parametrize("masked", [False, True], ids=["unmasked", "masked"])
@pytest.mark.parametrize("label", EDGE_LABELS)
def test_cross_entropy_logits_edge_labels_match_reference(label, masked):
    """take_along_axis' edges: -1 wraps to the last class, v and -v-1 are
    NaN picks, so their loss is NaN even under a zero mask (NaN * 0);
    label 0 is an ordinary pick.  The value and the gradient wrt the
    logits (finite: the NaN pick passes no gradient) as the reference's."""
    rng = np.random.default_rng(1)
    v = 5
    logits = rng.normal(size=(4, v)).astype(np.float32)
    labels = rng.integers(0, v, 4).astype(np.int32)
    labels[2] = {"v": v, "-v-1": -v - 1}.get(label, label)
    mask = np.ones(4, np.float32)
    if masked:
        mask[2] = 0.0
    want, want_g = jax.jit(jax.value_and_grad(jlayers.cross_entropy_logits))(
        logits, labels, mask)
    x = torch.from_numpy(logits).requires_grad_(True)
    got = layers.cross_entropy_logits(x, torch.from_numpy(labels), torch.from_numpy(mask))
    (g,) = torch.autograd.grad(got, x)
    _nan_close(got, float(want), "loss")
    _nan_close(g, np.asarray(want_g), "gradient")
    assert np.isnan(float(want)) == (label in ("v", "-v-1"))


@pytest.mark.parametrize("label", EDGE_LABELS)
@pytest.mark.parametrize("case", ["node", "molecules"])
def test_gin_losses_with_edge_labels_match_reference(reference, case, label):
    """Both GIN losses with one edge label (a -1 "ignore" label under a zero
    train mask included): the reference's value, NaN included."""
    cfg, g = CASES[case]
    g = dict(g)
    labels = np.asarray(g["labels"]).copy()
    at = 1 if case == "molecules" else int(np.flatnonzero(g["mask"] == 0)[0])
    labels[at] = {"v": cfg.n_classes, "-v-1": -cfg.n_classes - 1}.get(label, label)
    g["labels"] = labels
    params = reference[case]["params"]
    args = (g["feats"], g["edge_src"], g["edge_dst"])
    tcfg = port_config(cfg)
    tp = layers.params_from_reference(params, CPU)
    t = _port_inputs(g)
    targs = (t["feats"], t["edge_src"], t["edge_dst"])
    if cfg.readout == "sum":
        n = g["n_graphs"]
        want = jax.jit(lambda p: jgnn.graph_classification_loss(
            p, *args, g["graph_ids"], labels, cfg, n))(params)
        got = tgnn.graph_classification_loss(tp, *targs, t["graph_ids"], t["labels"],
                                             tcfg, n)
    else:
        want = jax.jit(lambda p: jgnn.node_classification_loss(
            p, *args, labels, g["mask"], cfg))(params)
        got = tgnn.node_classification_loss(tp, *targs, t["labels"], t["mask"], tcfg)
    _nan_close(got, float(want), f"{case} loss with label {label}")
