"""The port's losses and their gradients against ``jax.grad`` of the
reference.

  * ``layers.chunked_softmax_xent``: values and gradients wrt the hidden
    states and the head, a sequence padded to a multiple of the chunk, pad
    vocabulary columns, labels outside ``[0, v)`` (a one-hot pick of 0)
    and a label on a pad column; autograd keeps no ``(b, s, v)`` tensor;
  * ``transformer.loss_fn`` (CE plus the summed MoE aux) on dense and MoE
    SMOKE configs: tied and untied heads, padded heads and vocabulary, a
    dense layer 0 with shared experts, and padded experts (whose
    gradients are zero in both packages); ``remat`` on and off give the
    same gradient bits;
  * ``cross_entropy_logits``, ``layernorm``, both GIN losses,
    ``sasrec_loss``, ``bst_loss`` and ``dlrm.bce_loss`` wrt every
    parameter (and ``layernorm`` wrt its input).

The weights are the reference's ``init_params`` arrays carried across by
``layers.params_from_reference``, the batches the port's pipelines (equal
to the reference's, ``tests/test_torch_pipeline.py``).  Every reference
call runs once, jitted, in the module fixture.

Tolerance: 2e-6 times max(1, the reference's largest magnitude) per
tensor, for losses and gradients: XLA and torch sum in different orders.
The LM gradients add the port's own float32 rounding of each leaf (see
``test_lm_loss_and_grads_match_reference``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bst as jbst
from repro.configs import deepseek_moe_16b as jdeep
from repro.configs import dlrm_rm2 as jdlrm_cfg
from repro.configs import gin_tu as jgin
from repro.configs import granite_moe_3b_a800m as jgran
from repro.configs import qwen2_5_3b as jqwen
from repro.configs import sasrec as jsasrec
from repro.models import dlrm as jdlrm
from repro.models import gnn as jgnn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import sequential_rec as jseq
from repro.models import transformer as jtf
from repro_torch.configs import bst as tbst
from repro_torch.configs import dlrm_rm2 as tdlrm_cfg
from repro_torch.configs import gin_tu as tgin
from repro_torch.configs import sasrec as tsasrec
from repro_torch.data import pipeline
from repro_torch.graphs import gnn_data
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import gnn as tgnn
from repro_torch.models import layers
from repro_torch.models import sequential_rec as tseq
from repro_torch.models import transformer as ttf
from repro_torch.training import tree
from repro_torch.training.microbatch import value_and_grad
from test_torch_moe import port_config

TOL = 2e-6
CPU = torch.device("cpu")


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype=jnp.float32, cache_dtype=jnp.float32)


LM_CASES = {
    "qwen_smoke": _f32(jqwen.SMOKE),
    "granite_smoke": _f32(jgran.SMOKE),
    "deepseek_smoke": _f32(jdeep.SMOKE),
    # untied, heads, vocabulary and experts padded
    "padded_experts": _f32(jtf.LMConfig(
        name="moe-padded", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=500, pad_heads_to=8, pad_vocab_to=512,
        tie_embeddings=False, remat=False, loss_chunk=4,
        moe=jmoe.MoEConfig(n_experts=6, top_k=3, d_ff_expert=32, pad_experts_to=8))),
}
LM_BATCH = (2, 10)

# (b, s, d, v, chunk, n_valid_vocab)
XENT_CASES = {
    "padded_seq": (2, 10, 16, 40, 4, None),
    "one_chunk": (2, 8, 16, 40, 8, None),
    "pad_vocab": (3, 7, 8, 24, 3, 20),
}

SEQ_BATCH = 6


def _np(tree_):
    return jax.tree_util.tree_map(np.asarray, tree_)


def _t(a):
    return torch.from_numpy(np.require(np.asarray(a), requirements="W"))


def _xent_inputs(case):
    b, s, d, v, chunk, n_valid = XENT_CASES[case]
    rng = np.random.default_rng(len(case))
    hidden = rng.normal(size=(b, s, d)).astype(np.float32)
    head = (rng.normal(size=(d, v)) * 0.3).astype(np.float32)
    labels = rng.integers(0, n_valid or v, (b, s)).astype(np.int32)
    labels[0, :4] = [-1, v, v + 7, -v - 1]        # one-hot of nothing: ll = 0
    if n_valid is not None:
        labels[1, 0] = n_valid                    # a pad column: -1e30
    mask = (rng.random((b, s)) < 0.8).astype(np.float32)
    return hidden, head, labels, mask


def _lm_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, LM_BATCH).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, LM_BATCH).astype(np.int32)
    mask = (rng.random(LM_BATCH) < 0.8).astype(np.float32)
    return toks, labels, mask


def _gin_cases():
    node = gnn_data.planted_partition(200, 800, 32, 3, seed=1)
    mol = gnn_data.molecule_batch(batch=8, d_feat=16, n_classes=2, seed=2)
    return {
        "node": (jgin.SMOKE, dict(feats=node.feats, edge_src=node.edge_src,
                                  edge_dst=node.edge_dst, labels=node.labels,
                                  mask=node.train_mask)),
        "molecules": (dataclasses.replace(jgin.SMOKE, d_in=16, n_classes=2, readout="sum"),
                      dict(feats=mol.feats, edge_src=mol.edge_src, edge_dst=mol.edge_dst,
                           graph_ids=mol.graph_ids, labels=mol.labels, n_graphs=8)),
    }


GIN_CASES = _gin_cases()


def _gin_loss(mod, cfg, g, conv):
    a = {k: (conv(v) if isinstance(v, np.ndarray) else v) for k, v in g.items()}
    args = (a["feats"], a["edge_src"], a["edge_dst"])
    if cfg.readout == "sum":
        return lambda p: mod.graph_classification_loss(
            p, *args, a["graph_ids"], a["labels"], cfg, a["n_graphs"])
    return lambda p: mod.node_classification_loss(p, *args, a["labels"], a["mask"], cfg)


def _seq_batch(cfg, seed):
    if cfg.kind == "bst":
        return pipeline.SeqRecPipeline(cfg.n_items, SEQ_BATCH, cfg.seq_len,
                                       with_candidate=True, seed=seed)(0)
    b = pipeline.SeqRecPipeline(cfg.n_items, SEQ_BATCH, cfg.seq_len,
                                n_negatives=cfg.n_negatives, seed=seed)(0)
    b["seq"][0, :3] = -1                      # a padded history
    b["targets"][1, :2] = -1                  # positions with no loss
    return b


def _seq_loss(mod, cfg, b, conv):
    if cfg.kind == "bst":
        return lambda p: mod.bst_loss(p, conv(b["seq"]), conv(b["candidate"]),
                                      conv(b["labels"]), cfg)
    return lambda p: mod.sasrec_loss(p, conv(b["seq"]), conv(b["targets"]),
                                     conv(b["negatives"]), cfg)


def _click_batch(cfg, seed):
    return pipeline.ClickLogPipeline(cfg.n_dense, cfg.feature_rows, 16, seed=seed)(0)


def _init(mod, seed, cfg):
    """The reference's ``init_params``, jitted (eagerly it dispatches op
    by op)."""
    return _np(jax.jit(lambda k: mod.init_params(k, cfg))(jax.random.key(seed)))


def _value_and_grad(f, params):
    return (params, *jax.jit(jax.value_and_grad(f))(params))


def _reference_jobs():
    """``{key: thunk}``: every reference value and gradient the tests read."""
    jobs = {}
    for case in XENT_CASES:
        hidden, head, labels, mask = _xent_inputs(case)
        _, _, _, _, chunk, n_valid = XENT_CASES[case]
        f = lambda h, w, labels=labels, mask=mask, chunk=chunk, n_valid=n_valid: (
            jlayers.chunked_softmax_xent(h, w, labels, mask, chunk=chunk,
                                         n_valid_vocab=n_valid))
        jobs[f"xent/{case}"] = lambda f=f, h=hidden, w=head: (
            jax.jit(jax.value_and_grad(f, argnums=(0, 1)))(h, w))
    for seed, (case, cfg) in enumerate(LM_CASES.items()):
        toks, labels, mask = _lm_batch(cfg, seed)
        f = lambda p, cfg=cfg, toks=toks, labels=labels, mask=mask: (
            jtf.loss_fn(p, toks, labels, mask, cfg))
        jobs[f"lm/{case}"] = lambda f=f, i=(jtf, seed, cfg): _value_and_grad(f, _init(*i))
    rng = np.random.default_rng(5)
    x = (rng.normal(size=(4, 6, 32)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=32).astype(np.float32)
    bias = rng.normal(size=32).astype(np.float32)
    probe = rng.normal(size=(4, 6, 32)).astype(np.float32)
    ln = lambda x, w, b: jnp.sum(jlayers.layernorm(x, w, b) * probe)
    jobs["layernorm"] = lambda: ((x, w, bias, probe), *jax.jit(
        jax.value_and_grad(ln, argnums=(0, 1, 2)))(x, w, bias))
    for seed, (case, (cfg, g)) in enumerate(GIN_CASES.items()):
        f = _gin_loss(jgnn, cfg, g, jnp.asarray)
        jobs[f"gin/{case}"] = lambda f=f, i=(jgnn, 10 + seed, cfg): _value_and_grad(f, _init(*i))
    for seed, cfg in enumerate((jsasrec.SMOKE, jbst.SMOKE)):
        f = _seq_loss(jseq, cfg, _seq_batch(cfg, seed), jnp.asarray)
        jobs[f"seq/{cfg.kind}"] = lambda f=f, i=(jseq, 20 + seed, cfg): (
            _value_and_grad(f, _init(*i)))
    cfg = jdlrm_cfg.SMOKE
    b = _click_batch(cfg, 3)
    f = lambda p: jdlrm.bce_loss(p, b["dense"], b["sparse"], b["labels"], cfg)
    jobs["dlrm"] = lambda: _value_and_grad(f, _init(jdlrm, 30, cfg))
    return jobs


@pytest.fixture(scope="module")
def reference():
    """Every reference call, jitted, compiled side by side in a thread
    pool (XLA compiles outside the interpreter lock); numpy out."""
    from concurrent.futures import ThreadPoolExecutor

    jobs = _reference_jobs()
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        out = {k: f.result() for k, f in futures.items()}
    out = {k: _np(v) for k, v in out.items()}
    for k, v in out.items():
        if k.startswith("xent/"):
            out[k] = (float(v[0]), v[1])
        else:
            out[k] = (v[0], float(v[1]), v[2])
    return out


def _close(got, want, what):
    want = np.asarray(want)
    bound = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()
                                          if isinstance(got, torch.Tensor) else got),
                               want, rtol=0, atol=bound, err_msg=what)


def _grads_close(got, want, what):
    gn, gl = tree.flatten_with_names(got)
    wn, wl = tree.flatten_with_names(want)
    assert gn == wn, what
    for name, g, w in zip(gn, gl, wl):
        assert tuple(g.shape) == w.shape, name
        _close(g, w, f"{what} {name}")


# ---------------------------------------------------------------------------
# chunked softmax cross-entropy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(XENT_CASES))
def test_chunked_softmax_xent_matches_reference(reference, case):
    hidden, head, labels, mask = _xent_inputs(case)
    _, _, _, _, chunk, n_valid = XENT_CASES[case]
    want_loss, want_grads = reference[f"xent/{case}"]
    h, w = _t(hidden).requires_grad_(True), _t(head).requires_grad_(True)
    loss = layers.chunked_softmax_xent(h, w, _t(labels), _t(mask), chunk=chunk,
                                       n_valid_vocab=n_valid)
    gh, gw = torch.autograd.grad(loss, (h, w))
    _close(loss, want_loss, "loss")
    _close(gh, want_grads[0], "d hidden")
    _close(gw, want_grads[1], "d head")
    if n_valid is not None:
        assert want_loss > 1e28      # the pad-column label's -1e30 pick counts


def test_chunked_softmax_xent_keeps_no_full_logits():
    """Autograd saves each chunk's inputs, never a (b, s, v) tensor (nor a
    (b, chunk, v) one) for the backward pass."""
    b, s, d, v, chunk = 2, 12, 4, 96, 4
    rng = np.random.default_rng(0)
    h = _t(rng.normal(size=(b, s, d)).astype(np.float32)).requires_grad_(True)
    w = _t(rng.normal(size=(d, v)).astype(np.float32)).requires_grad_(True)
    labels = _t(rng.integers(0, v, (b, s)).astype(np.int32))
    mask = torch.ones((b, s))
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda x: saved.append(x.numel()) or x, lambda x: x):
        loss = layers.chunked_softmax_xent(h, w, labels, mask, chunk=chunk)
    assert saved and max(saved) < b * chunk * v
    loss.backward()
    assert h.grad.shape == (b, s, d) and w.grad.shape == (d, v)


# ---------------------------------------------------------------------------
# the LM loss
# ---------------------------------------------------------------------------


def _lm_port(reference, case, **kw):
    params, loss, grads = reference[f"lm/{case}"]
    cfg = dataclasses.replace(port_config(LM_CASES[case]), **kw)
    toks, labels, mask = _lm_batch(LM_CASES[case], list(LM_CASES).index(case))
    fn = lambda p: ttf.loss_fn(p, _t(toks), _t(labels), _t(mask), cfg)
    return cfg, layers.params_from_reference(params, CPU), fn, loss, grads


@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_loss_and_grads_match_reference(reference, case):
    """The loss within TOL; each gradient leaf within TOL times max(1, its
    largest reference magnitude) plus the port's own float32 rounding of
    that leaf, measured against the same port function on float64
    parameters and compute dtype.  The embedding's gradient needs that
    term: its rows sum each token's gradient through the first RMSNorm
    (the embeddings' std is 0.02, so 1/rms is ~50), where float32 rounding
    alone reaches the plain bound (deepseek SMOKE: the reference 0.86x
    and the port 1.08x of it from the float64 evaluation).  A wrong
    gradient is wrong in both precisions, so the term does not hide it."""
    cfg, params, fn, want_loss, want_grads = _lm_port(reference, case)
    loss, grads = value_and_grad(fn)(params)
    _close(loss, want_loss, "loss")
    cfg64 = dataclasses.replace(cfg, compute_dtype=torch.float64)
    toks, labels, mask = _lm_batch(LM_CASES[case], list(LM_CASES).index(case))
    _, grads64 = value_and_grad(lambda p: ttf.loss_fn(p, _t(toks), _t(labels), _t(mask),
                                                      cfg64))(
        tree.tree_map(lambda x: x.double(), params))
    gn, gl = tree.flatten_with_names(grads)
    wn, wl = tree.flatten_with_names(want_grads)
    assert gn == wn
    for name, g, g64, w in zip(gn, gl, tree.leaves(grads64), wl):
        own = float((g.double() - g64).abs().max())
        bound = TOL * max(1.0, float(np.abs(w).max())) + own
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=bound,
                                   err_msg=f"{case} {name}")
    if cfg.moe is not None and cfg.moe.n_experts_padded != cfg.moe.n_experts:
        e = cfg.moe.n_experts
        moe_g, moe_w = grads["blocks"]["moe"], want_grads["blocks"]["moe"]
        for name in ("w_gate", "w_up", "w_down"):
            assert (moe_w[name][:, e:] == 0).all() and (moe_g[name][:, e:] == 0).all()
        assert (moe_w["router"][..., e:] == 0).all()
        assert (moe_g["router"][..., e:] == 0).all()


@pytest.mark.parametrize("case", ["qwen_smoke", "deepseek_smoke", "padded_experts"])
def test_remat_gives_the_same_gradient_bits(reference, case):
    """remat is a memory knob: each block under torch.utils.checkpoint
    gives the same loss and gradient bits as without it."""
    _, params, off, _, _ = _lm_port(reference, case, remat=False)
    _, _, on, _, _ = _lm_port(reference, case, remat=True)
    l_off, g_off = value_and_grad(off)(params)
    l_on, g_on = value_and_grad(on)(params)
    assert torch.equal(l_off, l_on)
    for a, b in zip(tree.leaves(g_off), tree.leaves(g_on)):
        assert torch.equal(a, b)


def test_remat_checkpoints_each_block(reference, monkeypatch):
    """With remat the blocks run under torch.utils.checkpoint (one call a
    layer) when autograd records, and not when it does not."""
    calls = []
    real = ttf.checkpoint
    monkeypatch.setattr(ttf, "checkpoint", lambda *a, **k: calls.append(1) or real(*a, **k))
    cfg, params, fn, _, _ = _lm_port(reference, "deepseek_smoke", remat=True)
    value_and_grad(fn)(params)
    assert len(calls) == cfg.n_layers
    calls.clear()
    with torch.no_grad():
        fn(params)
    assert not calls


# ---------------------------------------------------------------------------
# the other losses
# ---------------------------------------------------------------------------


def test_cross_entropy_logits_grad_matches_reference():
    rng = np.random.default_rng(3)
    logits = (rng.normal(size=(3, 7, 11)) * 4).astype(np.float32)
    labels = rng.integers(0, 11, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    want, want_g = jax.jit(jax.value_and_grad(jlayers.cross_entropy_logits))(
        logits, labels, mask)
    x = _t(logits).requires_grad_(True)
    got = layers.cross_entropy_logits(x, _t(labels), _t(mask))
    (g,) = torch.autograd.grad(got, x)
    _close(got, float(want), "loss")
    _close(g, np.asarray(want_g), "gradient")


def test_layernorm_grads_match_reference(reference):
    (x, w, b, probe), want_loss, want_grads = reference["layernorm"]
    xs = [_t(a).requires_grad_(True) for a in (x, w, b)]
    loss = torch.sum(layers.layernorm(*xs) * _t(probe))
    grads = torch.autograd.grad(loss, xs)
    _close(loss, want_loss, "loss")
    for name, g, want in zip(("x", "weight", "bias"), grads, want_grads):
        _close(g, want, name)


@pytest.mark.parametrize("case", list(GIN_CASES))
def test_gin_loss_grads_match_reference(reference, case):
    cfg, g = GIN_CASES[case]
    params, want_loss, want_grads = reference[f"gin/{case}"]
    tcfg = tgin.SMOKE if cfg.readout is None else dataclasses.replace(
        tgin.SMOKE, d_in=cfg.d_in, n_classes=cfg.n_classes, readout=cfg.readout)
    loss, grads = value_and_grad(_gin_loss(tgnn, tcfg, g, _t))(
        layers.params_from_reference(params, CPU))
    _close(loss, want_loss, "loss")
    _grads_close(grads, want_grads, case)


@pytest.mark.parametrize("kind", ["sasrec", "bst"])
def test_seqrec_loss_grads_match_reference(reference, kind):
    jcfg, tcfg = {"sasrec": (jsasrec.SMOKE, tsasrec.SMOKE),
                  "bst": (jbst.SMOKE, tbst.SMOKE)}[kind]
    params, want_loss, want_grads = reference[f"seq/{kind}"]
    b = _seq_batch(jcfg, ["sasrec", "bst"].index(kind))
    loss, grads = value_and_grad(_seq_loss(tseq, tcfg, b, _t))(
        tseq.params_from_reference(params, CPU))
    _close(loss, want_loss, "loss")
    _grads_close(grads, want_grads, kind)


def test_dlrm_bce_loss_grads_match_reference(reference):
    params, want_loss, want_grads = reference["dlrm"]
    cfg = tdlrm_cfg.SMOKE
    b = _click_batch(cfg, 3)
    loss, grads = value_and_grad(lambda p: tdlrm.bce_loss(
        p, _t(b["dense"]), _t(b["sparse"]), _t(b["labels"]), cfg))(
        layers.params_from_reference(params, CPU))
    _close(loss, want_loss, "loss")
    _grads_close(grads, want_grads, "dlrm")
