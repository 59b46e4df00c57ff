"""The port's training stack against the JAX package.

  * the reference's behaviour contracts (``tests/test_training.py``),
    written for the port: AdamW on a quadratic, clipping, the schedule,
    microbatches equal to the full batch, the checkpoint round trip,
    keep-last and ``LATEST``, a mismatch refused, resilient replay bit for
    bit, the straggler hook, the quantisation error;
  * ``optim`` against the reference: ``schedule_lr`` (cosine, linear,
    constant), ``global_norm``, ``clip_by_global_norm``, one
    ``apply_updates`` (clipped and not, with and without weight decay),
    ``rowwise_adagrad_update``; ``compression.quantize`` bit for bit;
  * ``make_train_step``: one step and three, with ``n_micro`` 1 and 2, on
    qwen2.5-3b SMOKE and granite (MoE) SMOKE, batches from
    ``TokenPipeline``: parameters, ``m``, ``v``, ``step`` and the metrics;
  * checkpoints across packages: each restores the other's
    ``(params, OptState)``, and ``meta.json``'s names are equal;
  * the recsys and GIN steps: SASRec, BST and dlrm-rm2 as the reference's
    launch cells train dlrm (rowwise AdaGrad on the embedding table,
    AdamW on the dense layers; written out here in both packages), GIN
    with ``make_train_step``, two steps each;
  * ``run_resilient`` over ``make_train_step`` on an LM SMOKE: one failure
    at step 6 with a checkpoint every 4 steps ends on the bits of the
    uninterrupted run.

The weights are the reference's ``init_params`` arrays carried across by
``layers.params_from_reference``, the optimizer state by
``optim.state_from_reference``.  Every reference step runs jitted in the
module fixture (compiled side by side in a thread pool).

Tolerance: 2e-6 times max(1, the reference's largest magnitude) per
tensor for losses, metrics and parameters and moments after steps (XLA
and torch sum in different orders); integers, bits, names and batches
exact.
"""

import dataclasses
import json
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bst as jbst
from repro.configs import dlrm_rm2 as jdlrm_cfg
from repro.configs import gin_tu as jgin
from repro.configs import granite_moe_3b_a800m as jgran
from repro.configs import qwen2_5_3b as jqwen
from repro.configs import sasrec as jsasrec
from repro.models import dlrm as jdlrm
from repro.models import gnn as jgnn
from repro.models import sequential_rec as jseq
from repro.models import transformer as jtf
from repro.training import checkpoint as jckpt
from repro.training import compression as jcomp
from repro.training import optim as joptim
from repro.training import train_loop as jloop
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
from repro_torch.training import checkpoint, compression, microbatch, optim
from repro_torch.training import resilience, train_loop, tree
from test_torch_moe import port_config

TOL = 2e-6
CPU = torch.device("cpu")
LM_SEQ = (4, 16)       # batch, sequence
N_STEPS = 3
HYBRID_STEPS = 2
TABLE_LR = 0.01        # the launch cells' rowwise AdaGrad rate


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype=jnp.float32, cache_dtype=jnp.float32)


LM_CASES = {"qwen_smoke": _f32(jqwen.SMOKE), "granite_smoke": _f32(jgran.SMOKE)}
STEP_CASES = [(c, n) for c in LM_CASES for n in (1, 2)]


def _np(x):
    return jax.tree_util.tree_map(np.asarray, x)


def _t(a):
    return torch.from_numpy(np.require(np.asarray(a), requirements="W"))


def _init(mod, seed, cfg):
    return _np(jax.jit(lambda k: mod.init_params(k, cfg))(jax.random.key(seed)))


def _lm_pipe(cfg):
    return pipeline.TokenPipeline(cfg.vocab_size, *LM_SEQ, seed=1)


def _lm_loss(mod, cfg):
    return lambda p, b: mod.loss_fn(p, b["tokens"], b["labels"], b["mask"], cfg)


# --- the recsys and GIN steps, written out in both packages -----------------


def _gin_data():
    node = gnn_data.planted_partition(200, 800, 32, 3, seed=1)
    mol = gnn_data.molecule_batch(batch=8, d_feat=16, n_classes=2, seed=2)
    return {
        "gin_node": (jgin.SMOKE, tgin.SMOKE,
                     dict(feats=node.feats, edge_src=node.edge_src, edge_dst=node.edge_dst,
                          labels=node.labels, mask=node.train_mask)),
        "gin_molecules": (
            dataclasses.replace(jgin.SMOKE, d_in=16, n_classes=2, readout="sum"),
            dataclasses.replace(tgin.SMOKE, d_in=16, n_classes=2, readout="sum"),
            dict(feats=mol.feats, edge_src=mol.edge_src, edge_dst=mol.edge_dst,
                 graph_ids=mol.graph_ids, labels=mol.labels, n_graphs=8)),
    }


GIN = _gin_data()
# name -> (reference model, reference config, port model, port config, table key)
RECSYS = {
    "sasrec": (jseq, jsasrec.SMOKE, tseq, tsasrec.SMOKE, "items"),
    "bst": (jseq, jbst.SMOKE, tseq, tbst.SMOKE, "items"),
    "dlrm_rm2": (jdlrm, jdlrm_cfg.SMOKE, tdlrm, tdlrm_cfg.SMOKE, "table"),
}
HYBRID_CASES = list(RECSYS) + list(GIN)


def _recsys_batch(name, cfg, step):
    if name == "dlrm_rm2":
        return pipeline.ClickLogPipeline(cfg.n_dense, cfg.feature_rows, 16, seed=4)(step)
    if cfg.kind == "bst":
        return pipeline.SeqRecPipeline(cfg.n_items, 6, cfg.seq_len, with_candidate=True,
                                       seed=5)(step)
    return pipeline.SeqRecPipeline(cfg.n_items, 6, cfg.seq_len,
                                   n_negatives=cfg.n_negatives, seed=6)(step)


def _recsys_loss(name, mod, cfg, conv):
    if name == "dlrm_rm2":
        return lambda p, b: mod.bce_loss(p, conv(b["dense"]), conv(b["sparse"]),
                                         conv(b["labels"]), cfg)
    if cfg.kind == "bst":
        return lambda p, b: mod.bst_loss(p, conv(b["seq"]), conv(b["candidate"]),
                                         conv(b["labels"]), cfg)
    return lambda p, b: mod.sasrec_loss(p, conv(b["seq"]), conv(b["targets"]),
                                        conv(b["negatives"]), cfg)


def _gin_loss(mod, cfg, g, conv):
    a = {k: (conv(v) if isinstance(v, np.ndarray) else v) for k, v in g.items()}
    args = (a["feats"], a["edge_src"], a["edge_dst"])
    if cfg.readout == "sum":
        return lambda p, b: mod.graph_classification_loss(
            p, *args, a["graph_ids"], a["labels"], cfg, a["n_graphs"])
    return lambda p, b: mod.node_classification_loss(p, *args, a["labels"], a["mask"], cfg)


def _ref_hybrid_step(loss_fn, table_key):
    """The reference's dlrm train cell (``repro/launch/cells.py``): rowwise
    AdaGrad on the table, AdamW on the rest."""
    adamw = joptim.AdamWConfig()

    def step(state, b):
        params, opt_state, accum = state
        loss, grads = jax.value_and_grad(loss_fn)(params, b)
        table, t_accum = joptim.rowwise_adagrad_update(
            params[table_key], grads[table_key], accum, lr=TABLE_LR)
        dense_p = {k: v for k, v in params.items() if k != table_key}
        dense_g = {k: v for k, v in grads.items() if k != table_key}
        new_dense, new_opt, metrics = joptim.apply_updates(dense_p, dense_g, opt_state, adamw)
        new_params = dict(new_dense)
        new_params[table_key] = table
        metrics["loss"] = loss
        return (new_params, new_opt, t_accum), metrics

    return step


def _port_hybrid_step(loss_fn, table_key):
    """The same step in the port (``apply_updates`` in place)."""
    adamw = optim.AdamWConfig()
    grad_fn = microbatch.value_and_grad(loss_fn)

    def step(state, b):
        params, opt_state, accum = state
        loss, grads = grad_fn(params, b)
        table, t_accum = optim.rowwise_adagrad_update(
            params[table_key], grads[table_key], accum, lr=TABLE_LR)
        dense_p = {k: v for k, v in params.items() if k != table_key}
        dense_g = {k: v for k, v in grads.items() if k != table_key}
        new_dense, new_opt, metrics = optim.apply_updates(dense_p, dense_g, opt_state, adamw)
        new_params = dict(new_dense)
        new_params[table_key] = table
        metrics["loss"] = loss
        return (new_params, new_opt, t_accum), metrics

    return step


# --- the module fixture: every reference step, jitted ------------------------


def _lm_job(case, n_micro):
    cfg = LM_CASES[case]
    params = _init(jtf, list(LM_CASES).index(case), cfg)
    step = jax.jit(jloop.make_train_step(
        _lm_loss(jtf, cfg), jloop.TrainStepConfig(n_micro=n_micro)))
    state, pipe, out = (params, joptim.init(params)), _lm_pipe(cfg), []
    for i in range(N_STEPS):
        state, metrics = step(state, pipe(i))
        out.append((_np(state), _np(metrics)))
    return params, out


def _hybrid_job(name):
    if name in GIN:
        jcfg, _, g = GIN[name]
        params = _init(jgnn, 40 + HYBRID_CASES.index(name), jcfg)
        step = jax.jit(jloop.make_train_step(_gin_loss(jgnn, jcfg, g, jnp.asarray),
                                             jloop.TrainStepConfig()))
        state = (params, joptim.init(params))
        batch = lambda i: None
    else:
        jmod, jcfg, _, _, key = RECSYS[name]
        params = _init(jmod, 40 + HYBRID_CASES.index(name), jcfg)
        step = jax.jit(_ref_hybrid_step(_recsys_loss(name, jmod, jcfg, jnp.asarray), key))
        dense = {k: v for k, v in params.items() if k != key}
        state = (params, joptim.init(dense), joptim.rowwise_adagrad_init(params[key]))
        batch = lambda i: _recsys_batch(name, jcfg, i)
    out = []
    for i in range(HYBRID_STEPS):
        state, metrics = step(state, batch(i))
        out.append((_np(state), _np(metrics)))
    return params, out


@pytest.fixture(scope="module")
def reference():
    from concurrent.futures import ThreadPoolExecutor

    jobs = {f"lm/{c}/{n}": (lambda c=c, n=n: _lm_job(c, n)) for c, n in STEP_CASES}
    jobs.update({f"hybrid/{n}": (lambda n=n: _hybrid_job(n)) for n in HYBRID_CASES})
    with ThreadPoolExecutor(4) as pool:
        futures = {k: pool.submit(fn) for k, fn in jobs.items()}
        return {k: f.result() for k, f in futures.items()}


def _close(got, want, what):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    if want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    bound = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=bound, err_msg=what)


def _trees_close(got, want, what):
    gn, gl = tree.flatten_with_names(got)
    wn, wl = tree.flatten_with_names(_np(want))
    assert gn == wn, what
    for name, g, w in zip(gn, gl, wl):
        assert tuple(g.shape) == w.shape, f"{what} {name}"
        _close(g, w, f"{what} {name}")


# ---------------------------------------------------------------------------
# the reference's contracts, on the port
# ---------------------------------------------------------------------------


def test_adamw_converges_on_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    state = optim.init(params)
    cfg = optim.AdamWConfig(lr=0.3, weight_decay=0.0, warmup_steps=1, total_steps=200,
                            schedule="constant")
    grad_fn = microbatch.value_and_grad(lambda p: torch.sum(p["w"] ** 2))
    for _ in range(150):
        _, grads = grad_fn(params)
        params, state, _ = optim.apply_updates(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.05
    assert state.step.dtype == torch.int32 and int(state.step) == 150


def test_grad_clip_limits_norm():
    g = {"a": torch.full((10,), 100.0)}
    clipped, norm = optim.clip_by_global_norm(g, 1.0)
    assert float(optim.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)
    assert float(norm) == pytest.approx(np.sqrt(10 * 100.0 ** 2), rel=1e-5)


def test_schedule_warmup_and_decay():
    cfg = optim.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, schedule="cosine",
                            min_lr_frac=0.1)
    lr = lambda s: float(optim.schedule_lr(cfg, torch.tensor(s)))
    assert lr(5) == pytest.approx(0.5, rel=1e-3)
    assert lr(10) == pytest.approx(1.0, rel=1e-3)
    assert lr(100) == pytest.approx(0.1, rel=1e-2)


def test_microbatch_grads_match_full_batch():
    params = {"w": torch.arange(4.0)}
    batch = {"x": torch.arange(8.0).reshape(8, 1)}
    loss_fn = lambda p, b: torch.mean((b["x"][:, 0] - torch.sum(p["w"])) ** 2)
    l1, g1 = microbatch.accumulated_grads(loss_fn, params, batch, 1)
    l4, g4 = microbatch.accumulated_grads(loss_fn, params, batch, 4)
    assert float(l1) == pytest.approx(float(l4), rel=1e-6)
    np.testing.assert_allclose(g1["w"].numpy(), g4["w"].numpy(), rtol=1e-6)
    assert not params["w"].requires_grad and params["w"].grad is None
    with pytest.raises(ValueError, match="does not split"):
        microbatch.accumulated_grads(loss_fn, params, batch, 3)


def _tree(seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 3), generator=gen),
            "nested": {"b": torch.arange(5), "c": torch.tensor(2.5)}}


def test_checkpoint_roundtrip():
    with tempfile.TemporaryDirectory() as d:
        t = _tree()
        checkpoint.save(d, 7, t)
        restored, step = checkpoint.restore(d, t)
        assert step == 7
        for a, b in zip(tree.leaves(t), tree.leaves(restored)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_keep_last_and_latest_pointer():
    with tempfile.TemporaryDirectory() as d:
        for s in range(6):
            checkpoint.save(d, s, _tree(s), keep_last=2)
        steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
        assert steps == ["step_00000004", "step_00000005"]
        assert checkpoint.latest_step(d) == 5
        assert not [x for x in os.listdir(d) if x.endswith(".tmp")]


def test_checkpoint_structure_mismatch_rejected():
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 0, _tree())
        bad = {"a": torch.zeros((4, 3)), "nested": {"b": torch.arange(5)}}
        with pytest.raises(ValueError, match="structure mismatch"):
            checkpoint.restore(d, bad)
        bad = {"a": torch.zeros((4, 4)), "nested": {"b": torch.arange(5),
                                                    "c": torch.tensor(0.0)}}
        with pytest.raises(ValueError, match=r"shape mismatch for \['a'\]"):
            checkpoint.restore(d, bad)
        with pytest.raises(FileNotFoundError):
            checkpoint.restore(os.path.join(d, "empty"), bad)


def test_checkpoint_keeps_bf16_bits():
    """A bf16 leaf is stored as its 16 bits and read back bit for bit."""
    x = torch.randn((5, 7), generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    x[0, :3] = torch.tensor([float("nan"), -0.0, float("inf")])
    t = {"w": x, "f": torch.ones(3)}
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 1, t)
        with open(os.path.join(d, "step_00000001", "meta.json")) as f:
            assert json.load(f)["bfloat16"] == ["['w']"]
        restored, _ = checkpoint.restore(d, t)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16), x.view(torch.int16))


def _quadratic_step(cfg):
    def step(state, batch):
        p, o = state
        _, grads = microbatch.value_and_grad(
            lambda q: torch.mean((batch - torch.sum(q["w"])) ** 2))(p)
        p, o, m = optim.apply_updates(p, grads, o, cfg)
        return (p, o), m
    return step


def test_resilient_run_replays_bit_exact():
    """After injected failures the replayed run lands on the uninterrupted
    run's bits (step-indexed data, checkpoint restore)."""
    cfg = optim.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=50, schedule="constant")
    step = _quadratic_step(cfg)

    def run(failures):
        with tempfile.TemporaryDirectory() as d:
            rc = resilience.ResilienceConfig(ckpt_dir=d, ckpt_every=4)
            params = {"w": torch.zeros(3)}
            hook = resilience.make_scheduled_failures(failures)
            return resilience.run_resilient(
                step, lambda s: torch.tensor(float(s % 5)), (params, optim.init(params)),
                20, rc, failure_hook=hook)

    clean, rclean = run({})
    faulty, report = run({6: 1, 13: 2})
    assert report.restores == 3 and rclean.restores == 0
    assert report.steps_run == 20 + 2 + 1 + 1   # steps 4-5, then 12 twice, replayed
    for a, b in zip(tree.leaves(clean), tree.leaves(faulty)):
        assert torch.equal(a, b)
    assert set(report.final_metrics) == {"grad_norm", "lr"}


def test_resilient_run_gives_up_after_max_restores():
    cfg = optim.AdamWConfig(schedule="constant")
    with tempfile.TemporaryDirectory() as d:
        rc = resilience.ResilienceConfig(ckpt_dir=d, ckpt_every=4, max_restores=2)
        params = {"w": torch.zeros(3)}
        with pytest.raises(resilience.InjectedFailure):
            resilience.run_resilient(
                _quadratic_step(cfg), lambda s: torch.tensor(1.0),
                (params, optim.init(params)), 10, rc,
                failure_hook=resilience.make_scheduled_failures({3: 5}))


def test_straggler_hook_fires():
    calls = []

    def step(state, batch):
        time.sleep(0.25 if batch == 15 else 0.01)
        return state, {"loss": torch.tensor(0.0)}

    with tempfile.TemporaryDirectory() as d:
        rc = resilience.ResilienceConfig(ckpt_dir=d, ckpt_every=100, straggler_factor=5.0)
        _, report = resilience.run_resilient(
            step, lambda s: s, {"x": torch.zeros(())}, 20, rc,
            straggler_hook=lambda s, r: calls.append((s, r)))
    assert report.stragglers == [15]
    assert calls and calls[0][0] == 15 and calls[0][1] > 5.0


def test_resilience_config_defaults_match_reference():
    from repro.training import resilience as jres

    want = jres.ResilienceConfig()
    got = resilience.ResilienceConfig()
    for f in dataclasses.fields(want):
        if f.name != "ckpt_dir":
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert os.path.basename(got.ckpt_dir) == os.path.basename(want.ckpt_dir)


def test_quantize_dequantize_bounded_error():
    g = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    q, scale = compression.quantize(g)
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    err = (compression.dequantize(q, scale) - g).abs()
    assert float(err.max()) <= float(scale) / 2 + 1e-7


# ---------------------------------------------------------------------------
# optim and compression against the reference
# ---------------------------------------------------------------------------


def test_adamw_config_defaults_match_reference():
    assert dataclasses.asdict(optim.AdamWConfig()) == dataclasses.asdict(joptim.AdamWConfig())
    assert dataclasses.asdict(train_loop.TrainStepConfig(adamw=optim.AdamWConfig())) == \
        dataclasses.asdict(jloop.TrainStepConfig())
    assert optim.OptState._fields == joptim.OptState._fields


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_reference(schedule):
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=10_000, schedule=schedule,
               min_lr_frac=0.1)
    steps = np.array([0, 1, 5, 50, 99, 100, 101, 2_500, 9_999, 10_000, 20_000], np.int32)
    want = np.asarray(jax.vmap(lambda s: joptim.schedule_lr(
        joptim.AdamWConfig(**cfg), s))(jnp.asarray(steps)))
    got = np.array([float(optim.schedule_lr(optim.AdamWConfig(**cfg), torch.tensor(s)))
                    for s in steps], np.float32)
    _close(got, want, schedule)


def _rand_tree(seed):
    rng = np.random.default_rng(seed)
    return {"b": rng.normal(size=(7,)).astype(np.float32),
            "w": (rng.normal(size=(5, 6)) * 3).astype(np.float32),
            "deep": {"z": rng.normal(size=(2, 3, 4)).astype(np.float32)}}


@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.1), (100.0, 0.0)])
def test_apply_updates_matches_reference(clip, wd):
    """Two AdamW steps from a state with nonzero moments, in place."""
    cfg = dict(lr=1e-2, grad_clip=clip, weight_decay=wd, warmup_steps=3, total_steps=50)
    params, g1, g2 = _rand_tree(0), _rand_tree(1), _rand_tree(2)
    jstate = joptim.init(params)
    jp = params
    for g in (g1, g2):
        jp, jstate, jmet = joptim.apply_updates(jp, g, jstate, joptim.AdamWConfig(**cfg))
    tp = layers.params_from_reference(params, CPU)
    tstate = optim.init(tp)
    ids = [id(x) for x in tree.leaves((tp, tstate))]
    for g in (g1, g2):
        tp2, tstate, tmet = optim.apply_updates(tp, layers.params_from_reference(g, CPU),
                                                tstate, optim.AdamWConfig(**cfg))
    assert [id(x) for x in tree.leaves((tp2, tstate))] == ids   # in place
    _trees_close(tp2, jp, "params")
    _trees_close(tstate, jstate, "state")
    for k in ("grad_norm", "lr"):
        _close(tmet[k], jmet[k], k)


def test_global_norm_and_clip_match_reference():
    g = _rand_tree(3)
    want = joptim.clip_by_global_norm(g, 2.0)
    got = optim.clip_by_global_norm(layers.params_from_reference(g, CPU), 2.0)
    _trees_close(got[0], want[0], "clipped")
    _close(got[1], want[1], "norm")
    _close(optim.global_norm(layers.params_from_reference(g, CPU)), joptim.global_norm(g),
           "global norm")


def test_rowwise_adagrad_matches_reference():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(40, 8)).astype(np.float32)
    grads = [rng.normal(size=(40, 8)).astype(np.float32) for _ in range(3)]
    grads[1][5:9] = 0.0                                   # rows untouched this step
    jt, ja = table, joptim.rowwise_adagrad_init(table)
    tt, ta = _t(table), optim.rowwise_adagrad_init(_t(table))
    assert ta.dtype == torch.float32 and ta.shape == (40,)
    for g in grads:
        jt, ja = joptim.rowwise_adagrad_update(jt, g, ja, lr=0.01)
        tt, ta = optim.rowwise_adagrad_update(tt, _t(g), ta, lr=0.01)
    _close(tt, jt, "table")
    _close(ta, ja, "accumulator")
    bt, _ = optim.rowwise_adagrad_update(_t(table).to(torch.bfloat16), _t(grads[0]),
                                         optim.rowwise_adagrad_init(_t(table)), lr=0.01)
    assert bt.dtype == torch.bfloat16


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_matches_reference_bits(seed):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=(999,)) * 10 ** rng.uniform(-3, 3)).astype(np.float32)
    g[:4] = [0.0, -0.0, g[5] * 0.5, -np.abs(g).max()]
    jq, js = jcomp.quantize(jnp.asarray(g))       # eager, as the reference divides
    tq, ts = compression.quantize(_t(g))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.numpy().view(np.int32) == np.asarray(js).view(np.int32)
    np.testing.assert_array_equal(
        compression.dequantize(tq, ts).numpy().view(np.int32),
        np.asarray(jcomp.dequantize(jq, js)).view(np.int32))
    zero_q, zero_s = compression.quantize(torch.zeros(5))
    assert float(zero_s) == np.float32(1e-12) / np.float32(127) and not zero_q.any()
    r = compression.init_residual({"a": torch.ones((2, 3), dtype=torch.bfloat16)})
    assert r["a"].dtype == torch.float32 and not r["a"].any()


# ---------------------------------------------------------------------------
# make_train_step against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,n_micro", STEP_CASES)
def test_train_steps_match_reference(reference, case, n_micro):
    params, want = reference[f"lm/{case}/{n_micro}"]
    cfg = port_config(LM_CASES[case])
    tp = layers.params_from_reference(params, CPU)
    state = (tp, optim.init(tp))
    step = train_loop.make_train_step(_lm_loss(ttf, cfg),
                                      train_loop.TrainStepConfig(n_micro=n_micro))
    pipe = _lm_pipe(cfg)
    for i, (want_state, want_metrics) in enumerate(want):
        batch = {k: _t(v) for k, v in pipe(i).items()}
        state, metrics = step(state, batch)
        _trees_close(state, want_state, f"{case} step {i + 1}")
        assert set(metrics) == set(want_metrics)
        for k, v in metrics.items():
            _close(v, want_metrics[k], f"{case} step {i + 1} {k}")
    assert int(state[1].step) == N_STEPS


@pytest.mark.parametrize("name", HYBRID_CASES)
def test_recsys_and_gin_steps_match_reference(reference, name):
    params, want = reference[f"hybrid/{name}"]
    if name in GIN:
        _, tcfg, g = GIN[name]
        tp = layers.params_from_reference(params, CPU)
        state = (tp, optim.init(tp))
        step = train_loop.make_train_step(_gin_loss(tgnn, tcfg, g, _t),
                                          train_loop.TrainStepConfig())
        batch = lambda i: None
    else:
        _, jcfg, tmod, tcfg, key = RECSYS[name]
        tp = layers.params_from_reference(params, CPU)
        dense = {k: v for k, v in tp.items() if k != key}
        state = (tp, optim.init(dense), optim.rowwise_adagrad_init(tp[key]))
        step = _port_hybrid_step(_recsys_loss(name, tmod, tcfg, _t), key)
        batch = lambda i: _recsys_batch(name, jcfg, i)
    for i, (want_state, want_metrics) in enumerate(want):
        state, metrics = step(state, batch(i))
        _trees_close(state, want_state, f"{name} step {i + 1}")
        for k, v in metrics.items():
            _close(v, want_metrics[k], f"{name} step {i + 1} {k}")


# ---------------------------------------------------------------------------
# checkpoints across packages
# ---------------------------------------------------------------------------


def _lm_state(reference):
    params, want = reference["lm/qwen_smoke/1"]
    jstate = want[-1][0]                 # (params, OptState) after the steps
    tstate = (layers.params_from_reference(jstate[0], CPU),
              optim.state_from_reference(jstate[1], CPU))
    return jstate, tstate


def test_port_restores_reference_checkpoint(reference):
    jstate, tstate = _lm_state(reference)
    like = tree.tree_map(torch.zeros_like, tstate)
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(d, 3, jax.tree_util.tree_map(jnp.asarray, jstate))
        got, step = checkpoint.restore(d, like, device=CPU)
    assert step == 3
    names, leaves = tree.flatten_with_names(got)
    want_names, want_leaves = tree.flatten_with_names(tstate)
    assert names == want_names
    for a, b in zip(leaves, want_leaves):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[1].step.dtype == torch.int32 and int(got[1].step) == N_STEPS


def test_reference_restores_port_checkpoint(reference):
    jstate, tstate = _lm_state(reference)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 5, tstate)
        like = jax.tree_util.tree_map(jnp.zeros_like, jax.tree_util.tree_map(jnp.asarray,
                                                                              jstate))
        got, step = jckpt.restore(d, like)
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jstate)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_names_equal_reference(reference):
    jstate, tstate = _lm_state(reference)
    metas = []
    with tempfile.TemporaryDirectory() as d:
        jckpt.save(os.path.join(d, "ref"), 0, jax.tree_util.tree_map(jnp.asarray, jstate))
        checkpoint.save(os.path.join(d, "port"), 0, tstate)
        for which in ("ref", "port"):
            with open(os.path.join(d, which, "step_00000000", "meta.json")) as f:
                metas.append(json.load(f))
    assert metas[0] == metas[1]
    names = metas[0]["names"]
    assert names[0] == "[0]/['blocks']/['bk']" and names[-1] == "[1]/.step"
    assert "[1]/.m/['embed']" in names and "[1]/.v/['final_norm']" in names


# ---------------------------------------------------------------------------
# resilient replay of a real train step
# ---------------------------------------------------------------------------


def test_resilient_lm_training_replays_bit_exact(reference):
    """make_train_step on qwen SMOKE (remat on, two microbatches) under
    run_resilient: a failure at step 6 with a checkpoint every 4 steps
    replays steps 4-5 and ends on the uninterrupted run's bits."""
    params, _ = reference["lm/qwen_smoke/2"]
    cfg = dataclasses.replace(port_config(LM_CASES["qwen_smoke"]), remat=True)
    step = train_loop.make_train_step(_lm_loss(ttf, cfg),
                                      train_loop.TrainStepConfig(n_micro=2))
    pipe = _lm_pipe(cfg)
    batch_fn = lambda s: {k: _t(v) for k, v in pipe(s).items()}

    def run(failures):
        tp = layers.params_from_reference(params, CPU)
        with tempfile.TemporaryDirectory() as d:
            rc = resilience.ResilienceConfig(ckpt_dir=d, ckpt_every=4)
            return resilience.run_resilient(
                step, batch_fn, (tp, optim.init(tp)), 8, rc,
                failure_hook=resilience.make_scheduled_failures(failures))

    clean, _ = run({})
    faulty, report = run({6: 1})
    assert report.restores == 1 and report.steps_run == 10
    for a, b in zip(tree.leaves(clean), tree.leaves(faulty)):
        assert torch.equal(a, b)
    assert np.isfinite(report.final_metrics["loss"])


def test_tree_helpers_hold_no_reference_cycle():
    """``flatten_with_names``, ``leaves`` and ``unflatten`` release their
    leaves when the caller drops them, without the cyclic collector: a
    cycle would keep a training state's device memory alive (a card run
    measured 19 GB held that way, by ``compressed_psum``'s payloads)."""
    import gc
    import weakref

    gc.disable()
    try:
        a, b = torch.zeros(3), torch.ones(2)
        refs = [weakref.ref(a), weakref.ref(b)]
        state = ({"w": a, "x": [b, None]}, optim.OptState({"w": a}, {"w": a}, b))
        names, leaves = tree.flatten_with_names(state)
        rebuilt = tree.unflatten(state, [x.clone() for x in leaves])
        rebuilt_refs = [weakref.ref(x) for x in tree.leaves(rebuilt)]
        assert names[0] == "[0]/['w']" and len(tree.leaves(rebuilt)) == 5
        del a, b, state, names, leaves, rebuilt
        assert all(r() is None for r in refs + rebuilt_refs)
    finally:
        gc.enable()
