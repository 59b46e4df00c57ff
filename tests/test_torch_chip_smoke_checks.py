"""Checks ``chip_smoke.py`` makes on the card, held here on CPU inputs.

``trace_summary`` (the profile summed from kineto's chrome trace) must give
``key_averages()``' counts and times op for op: ``summary_check`` compares
them, here on CPU profiles of a decode step and of a MoE training step
(forward and autograd's backward thread).  ``tp_witness`` holds a float32
tensor-parallel lockstep run to what explains its gap; its three refusals
are driven with made-up pass reports.  ``LayerTrace(impose=True)``, which
phases 37 and 38 use, gives the tensor-parallel pass the unsharded pass's
expert selection and gate values bit for bit while the router's gradient
still flows through the tensor-parallel side's own gates (phase 38b's
``tt_grads`` on deepseek SMOKE, a local (1, 4) mesh on the CPU).
``tt_grads`` holds each leaf to its own largest gradient, so a leaf the
tensor-parallel side loses fails however small its gradient is.
"""

import importlib
import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import deepseek_moe_16b, qwen2_5_3b
from repro_torch.models import transformer
from repro_torch.training import tree


def _chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


def _decode_step():
    cfg = qwen2_5_3b.SMOKE
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.zeros((2, 8), dtype=torch.int32)
    with torch.no_grad():
        _, cache = transformer.prefill(params, tokens, cfg, max_seq=12)

    def step():
        with torch.no_grad():
            transformer.decode_step(params, cache, tokens[:, 0], 8, cfg)
    return step


def _train_step():
    cfg = deepseek_moe_16b.SMOKE
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    for x in tree.leaves(params):
        x.requires_grad_()
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))

    def step():
        loss = transformer.loss_fn(params, tokens, tokens.long(), torch.ones(tokens.shape), cfg)
        loss.backward()
    return step


@pytest.mark.parametrize("make", [_decode_step, _train_step], ids=["decode", "train"])
def test_trace_summary_equals_key_averages(make):
    cs = _chip_smoke()
    step = make()
    step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    device, host = cs.trace_summary(prof)
    out = cs.summary_check(prof, device, host)
    assert out["host_ops"] > 100 and out["device_ops"] == 0


def test_summary_check_refuses_a_wrong_count():
    cs = _chip_smoke()
    step = _decode_step()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step()
    device, host = cs.trace_summary(prof)
    name = max(host, key=lambda k: host[k][0])
    host[name][0] += 1
    with pytest.raises(AssertionError, match="trace_summary against key_averages"):
        cs.summary_check(prof, device, host)


def _passes(gaps, flips=()):
    """Two passes of three layers; ``flips`` by (pass, layer, margin)."""
    out = [dict(gaps=list(g), flips=[]) for g in gaps]
    for i, layer, margin in flips:
        out[i]["flips"].append(dict(layer=layer, tokens=1, margin=margin))
    return out


@pytest.mark.parametrize("case, passes, logits, error", [
    ("no flip, within", _passes([[1e-6] * 3, [2e-6] * 3]), [1e-5, 2e-5], None),
    ("no flip, logits over", _passes([[1e-6] * 3, [2e-6] * 3]), [1e-5, 2e-4],
     "with no routing flip"),
    ("no flip, a gap over", _passes([[1e-6] * 3, [1e-6, 2e-4, 1e-6]]), [1e-5, 1e-5],
     "before any routing flip"),
    ("near-tie flip", _passes([[1e-6, 1e-6, 5e-2], [3e-1] * 3], [(0, 2, 5e-7)]),
     [1e-3, 1e-3], None),
    ("flip at no tie", _passes([[1e-6, 1e-6, 5e-2], [3e-1] * 3], [(0, 2, 1e-3)]),
     [1e-3, 1e-3], "no near-tie"),
    ("gap over before the flip", _passes([[1e-6] * 3, [2e-4, 1e-6, 1e-1]], [(1, 2, 1e-7)]),
     [1e-5, 1e-3], "before any routing flip"),
])
def test_tp_witness(case, passes, logits, error):
    cs = _chip_smoke()
    out = dict(passes=passes, max_logit_diff_per_step=logits)
    if error is None:
        witness = cs.tp_witness(out, case)
        assert "passes" not in out
        assert (witness["first_flip"] is None) == (not any(p["flips"] for p in passes))
    else:
        with pytest.raises(AssertionError, match=error):
            cs.tp_witness(out, case)


def test_layer_trace_imposes_unsharded_gates_and_keeps_the_router_gradient(monkeypatch):
    import dataclasses

    cs = _chip_smoke()
    monkeypatch.setattr(cs, "TT_BATCH", 4)
    cpu = torch.device("cpu")
    base = deepseek_moe_16b.SMOKE
    cfg = dataclasses.replace(base, remat=True,
                              moe=dataclasses.replace(base.moe, ep_shard_map=True))
    tp, one, tpl, batches = cs.tt_setup(cpu, cfg, 16, 1)
    params = transformer.init_params(torch.Generator().manual_seed(1), cfg)
    free = cs.tt_grads(tp, cfg, one, tpl, params, batches[0])
    trace = cs.LayerTrace(impose=True)
    held = cs.tt_grads(tp, cfg, one, tpl, params, batches[0], trace)
    routes = trace.routes
    assert len(routes["u"]) == len(routes["t"]) >= cfg.n_scan
    for (_, gu, su), (_, gt, st) in zip(routes["u"], routes["t"]):
        assert torch.equal(su, st) and torch.equal(gu, gt)
    assert free["ok"] and held["ok"], (free, held)
    # the router's gradient is there on the imposed run, and matches
    router = held["grads"]["['blocks']/['moe']/['router']"]
    assert router["max_abs"] > 0 and router["rel"] <= cs.TT_GRAD_TOL
    report = trace.report(cfg)
    assert report["flips"] == [] and len(report["gaps"]) >= cfg.n_layers


def test_tt_grads_holds_each_leaf_to_its_own_largest_gradient(monkeypatch):
    """A leaf whose gradient the tensor-parallel side loses (``ln1`` read
    detached, as a missing ``copy_to`` path would lose it) fails
    ``tt_grads`` whatever that gradient's size."""
    cs = _chip_smoke()
    monkeypatch.setattr(cs, "TT_BATCH", 4)
    cpu = torch.device("cpu")
    cfg = qwen2_5_3b.SMOKE
    tp, one, tpl, batches = cs.tt_setup(cpu, cfg, 16, 1)
    params = transformer.init_params(torch.Generator().manual_seed(2), cfg)
    sound = cs.tt_grads(tp, cfg, one, tpl, params, batches[0])
    assert sound["ok"], sound
    whole_qkv = transformer._whole_qkv

    def lose_ln1(*args, **kwargs):
        w = whole_qkv(*args, **kwargs)
        return dict(w, ln1=w["ln1"].detach())

    monkeypatch.setattr(transformer, "_whole_qkv", lose_ln1)
    # the gradient scaled down: the old bound (1e-4 of max(1, largest)) passed a
    # lost leaf whose gradient stays under 1e-4
    small = cs.tt_grads(tp, cfg, lambda p, b: one(p, b) * 1e-6,
                        lambda p, b: tpl(p, b) * 1e-6, params, batches[0])
    ln1 = small["grads"]["['blocks']/['ln1']"]
    assert ln1["max_abs"] < 1e-4 and ln1["rel"] == 1.0
    assert not small["ok"]
