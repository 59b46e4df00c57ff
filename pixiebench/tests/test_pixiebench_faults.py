"""The check that decides ``correct`` fails what it must.

A whole run of each cell, cut to the CPU (``tinycell``), past the look for
a card: sound, it comes out correct; with the timed path broken
underneath, at the layer named, it comes out not correct.  The control,
the reference with its boost one precision lower, fails the comparison.
"""

import subprocess
import sys

import pytest
import torch

from pixiebench import checks, graphgen, harness, reference, traffic
from pixiebench.tests import tinycell
from repro_torch.core import counter, graph as graph_lib, service
from repro_torch.kernels import ops

CELLS = ["homefeed-8pin-open", "related-1pin-closed32"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    out = tinycell.run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(checks.LIMITS)


def walk_state_unchanged(monkeypatch):
    real = ops.walk_chunk_fused_batched

    def frozen(curr, *args, **kw):
        return (curr, *real(curr, *args, **kw)[1:])
    monkeypatch.setattr(ops, "walk_chunk_fused_batched", frozen)


def half_the_batch_left_out(monkeypatch):
    real = service.serve_batch

    def half(graph, pins, weights, feats, keys, cfg, **kw):
        n = pins.shape[0]
        keep = max(1, n // 2)
        if kw.get("step_budgets") is not None:
            kw["step_budgets"] = kw["step_budgets"][:keep]
        scores, ids = real(graph, pins[:keep], weights[:keep], feats[:keep], keys[:keep],
                           cfg, **kw)[:2]
        pad = lambda x, fill: torch.cat([x, torch.full((n - keep, x.shape[1]), fill,
                                                         dtype=x.dtype)])
        return pad(scores, 0.0), pad(ids, -1)
    monkeypatch.setattr(service, "serve_batch", half)


def answer_altered(monkeypatch):
    real = counter.topk_dense

    def altered(boosted, k):
        scores, ids = real(boosted, k)
        ids = ids.clone()
        ids[..., -1] = (ids[..., -1] + 1) % boosted.shape[-1]
        return scores, ids
    monkeypatch.setattr(counter, "topk_dense", altered)


def graph_compile_altered(monkeypatch):
    real = graph_lib.build_graph

    def altered(*args, **kw):
        g = real(*args, **kw)
        t = g.b2p.targets
        t[0], t[-1] = t[-1].clone(), t[0].clone()
        return g
    monkeypatch.setattr(graph_lib, "build_graph", altered)


FAULTS = {
    "walk_state_unchanged": (walk_state_unchanged, CELLS),
    "half_the_batch_left_out": (half_the_batch_left_out, ["related-1pin-closed32"]),
    "answer_altered": (answer_altered, CELLS),
    "graph_compile_altered": (graph_compile_altered, CELLS),
}


@pytest.mark.parametrize("fault,cell", [(f, c) for f, (_, cells) in FAULTS.items()
                                        for c in cells])
def test_a_broken_run_is_not_correct(monkeypatch, fault, cell):
    FAULTS[fault][0](monkeypatch)
    out = tinycell.run(cell)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_comparison(cell):
    """The reference in the program's place with its boost in bfloat16,
    against the reference: the number it fails is ``score_gap``."""
    c = tinycell.tiny(cell)
    config, mix = c.config, c.traffic
    seed = 77_000_000_001
    e = graphgen.draw(config, seed, "cpu")
    g = reference.compile_graph(e.pins, e.boards, e.pin_lang, e.board_lang,
                                config["n_pins"], config["n_boards"], config["n_langs"])
    pay = traffic.payloads(mix, 8, graphgen.pins_with_edges(e, config["n_pins"]),
                           config["n_langs"], seed)
    walk = reference.walk_from(config)
    slots = harness.slots_for(config, pay.pins.shape[1])
    exact, lower = {}, {}
    for rid in range(8):
        pins, weights = harness.padded(pay, rid, slots)
        k = reference.request_key(seed, rid, "cpu")
        for out, dtype in ((exact, torch.float32), (lower, torch.bfloat16)):
            a = reference.recommend(g, pins, weights, int(pay.feats[rid]), k, walk, dtype)
            out[rid] = (a.scores.numpy(), a.ids.numpy())
    sound = checks.compare(exact, exact)
    control = checks.compare(lower, exact)
    assert sound == {"id_mismatch": 0, "score_gap": 0.0}
    assert control["score_gap"] > checks.LIMITS["score_gap"]


def test_no_card_means_no_result(tmp_path):
    """Without a CUDA device the command exits non-zero and prints nothing."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible here")
    run = subprocess.run(
        [sys.executable, str(tinycell.manifest.ROOT / "pixiebench" / "run.py"),
         "--workload", CELLS[0], "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert run.returncode != 0 and run.stdout == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_kernel_path_is_correct_on_the_card(card, cell):
    out = tinycell.run(cell, device=card, trace=True)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
