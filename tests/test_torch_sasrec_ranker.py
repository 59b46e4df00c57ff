"""The port's ``sasrec_ranker`` inside ``pixie_then_rank`` against the JAX
package: the last piece of two-stage ranking.

Ports ``tests/test_serving.py::test_two_stage_recommendation_returns_walk_candidates``
and ``tests/test_two_stage.py::test_sasrec_ranker_masks_underfull_ids`` to
a parity check: the same graph (``small_test_graph``, and an 8-pin graph
whose walk reaches one candidate, so the tail is under-full), the same
walk key, and the reference's SASRec parameters carried across by
``sequential_rec.params_from_reference``.

The walk is integer-exact, so final ids must be equal; scores go through
the SASRec encoder and the candidate dots, which XLA and torch sum in
different orders: each is held within ``RTOL = 2e-6`` of its row's
largest finite score, with ``-inf`` (an under-full slot) and NaN in the
same places.  The reference side runs once per module in a subprocess,
every call jitted, and comes back as an ``.npz`` file.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.graphs.synthetic import small_test_graph, top_degree_pins
from repro_torch.core import prng
from repro_torch.core import walk as twalk
from repro_torch.core.graph import build_graph
from repro_torch.graphs import synthetic as tsyn
from repro_torch.models import sequential_rec as sr
from repro_torch.serving import recommend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 2e-6
WALK = dict(n_steps=8_000, n_walkers=128, n_p=10**9, n_v=10**9)
# the reference test's ranker, and a two-block variant
MODELS = {
    "reference_test": dict(embed_dim=16, seq_len=8, n_blocks=1, n_heads=1),
    "two_blocks": dict(embed_dim=16, seq_len=8, n_blocks=2, n_heads=2),
}
# (model, query pins, query weights, history kind, walk key, final_k)
CASES = {
    "one_pin_repeated_history": ("reference_test", 1, "repeat", 1, 10),
    "one_pin_padded_history": ("reference_test", 1, "padded", 2, 10),
    "two_pins_two_blocks": ("two_blocks", 2, "padded", 3, 20),
    "four_pins_seeded_history": ("two_blocks", 4, "seeded", 4, 20),
}
UNDERFULL_EDGES = ([0, 1, 2, 3, 4, 5, 6, 7], [0, 0, 1, 1, 1, 1, 1, 1])
MASK_CAND = [5, -1, 0, -1, 49, 50, 511, 512, 602, -512, -513]


def _queries(sg, n_pins):
    qs = [int(q) for q in top_degree_pins(sg, 4)]
    qp = np.full((4,), -1, np.int32)
    qw = np.zeros((4,), np.float32)
    qp[:n_pins] = qs[:n_pins]
    qw[:n_pins] = [1.0, 0.6, 0.8, 0.3][:n_pins]
    return qp, qw


def _history(kind, q, n_items, seq_len, seed):
    if kind == "repeat":
        return np.full((seq_len,), q, np.int32)
    rng = np.random.default_rng(seed)
    h = rng.integers(0, n_items, seq_len).astype(np.int32)
    if kind == "padded":
        h[: seq_len // 2] = -1
    return h


def _inputs(sg):
    x = {}
    for case, (_, n_pins, hist, _, _) in CASES.items():
        qp, qw = _queries(sg, n_pins)
        x[f"{case}/qp"], x[f"{case}/qw"] = qp, qw
        x[f"{case}/hist"] = _history(hist, int(qp[0]), sg.graph.n_pins, 8, len(case))
    x["underfull/hist"] = np.asarray([1, 0, -1, 1], np.int32)
    x["mask/hist"] = np.asarray([1, 2, 3, 4], np.int32)
    x["mask/cand"] = np.asarray(MASK_CAND, np.int32)
    return x


_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import walk as W
from repro.core.graph import build_graph
from repro.graphs.synthetic import small_test_graph
from repro.models import sequential_rec as SR
from repro.serving.recommend import TwoStageConfig, pixie_then_rank, sasrec_ranker

inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
out = {}
a = np.asarray


def flat(prefix, tree):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(prefix + k + "/", v)
        else:
            out[prefix + k] = a(v)


def two_stage(g, cfg, wcfg, ts):
    def run(p, hist, qp, qw, key):
        return pixie_then_rank(g, qp, qw, jnp.asarray(0, jnp.int32), key, wcfg,
                               sasrec_ranker(p, hist, cfg), ts)
    return jax.jit(run)


sg = small_test_graph(0)
wcfg = W.WalkConfig(**spec["walk"])
params = {}
for name, m in spec["models"].items():
    cfg = SR.SeqRecConfig(name=name, kind="sasrec", n_items=sg.graph.n_pins, **m)
    params[name] = (cfg, SR.init_params(jax.random.key(len(name)), cfg))
    flat(f"{name}/params/", params[name][1])
runs = {}
for case, (model, _, _, seed, final_k) in spec["cases"].items():
    cfg, p = params[model]
    if (model, final_k) not in runs:      # one compile a model and final_k
        runs[model, final_k] = two_stage(sg.graph, cfg, wcfg,
                                         TwoStageConfig(n_candidates=50, final_k=final_k))
    run = runs[model, final_k]
    v, i = run(p, jnp.asarray(inp[f"{case}/hist"]), jnp.asarray(inp[f"{case}/qp"]),
               jnp.asarray(inp[f"{case}/qw"]), jax.random.key(seed))
    out[f"{case}/scores"], out[f"{case}/ids"] = a(v), a(i)

pins, boards = spec["underfull"]
g8 = build_graph(np.asarray(pins), np.asarray(boards), 8, 2)
cfg8 = SR.SeqRecConfig(name="u", kind="sasrec", n_items=8, embed_dim=8, seq_len=4,
                       n_blocks=1, n_heads=1, n_negatives=2)
p8 = SR.init_params(jax.random.key(9), cfg8)
flat("underfull/params/", p8)
w8 = W.WalkConfig(n_steps=512, n_walkers=64, bias_beta=0.0, n_p=10**9, n_v=10**9)
v, i = two_stage(g8, cfg8, w8, TwoStageConfig(n_candidates=8, final_k=5))(
    p8, jnp.asarray(inp["underfull/hist"]), jnp.asarray([1, -1], jnp.int32),
    jnp.asarray([1.0, 0.0], jnp.float32), jax.random.key(4))
out["underfull/scores"], out["underfull/ids"] = a(v), a(i)

cfgm = SR.SeqRecConfig(name="r", kind="sasrec", n_items=50, embed_dim=8, seq_len=4,
                       n_blocks=1, n_heads=1, n_negatives=2)
pm = SR.init_params(jax.random.key(0), cfgm)
flat("mask/params/", pm)
out["mask/scores"] = a(sasrec_ranker(pm, jnp.asarray(inp["mask/hist"]), cfgm)(
    jnp.asarray(inp["mask/cand"])))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def io(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sasrec_ranker")
    x = _inputs(small_test_graph(0))
    np.savez(tmp / "in.npz", **x)
    spec = dict(walk=WALK, models=MODELS, cases=CASES, underfull=UNDERFULL_EDGES)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz"),
         json.dumps(spec)],
        capture_output=True, text=True, env=env, timeout=540)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return x, dict(np.load(tmp / "out.npz"))


@pytest.fixture(scope="module")
def graph():
    return tsyn.small_test_graph(0, device="cpu").graph


def _params(ref, prefix):
    tree = {}
    for key, v in ref.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return sr.params_from_reference(tree, "cpu")


def _t(a):
    return torch.as_tensor(np.require(a, requirements="W"))


def _assert_ranked_equal(scores, ids, want_scores, want_ids):
    """ids exactly; scores within RTOL of the row's largest finite score,
    -inf and NaN in the same places."""
    s, ws = scores.numpy(), np.asarray(want_scores)
    np.testing.assert_array_equal(ids.numpy(), want_ids)
    np.testing.assert_array_equal(np.isneginf(s), np.isneginf(ws))
    np.testing.assert_array_equal(np.isnan(s), np.isnan(ws))
    fin = np.isfinite(ws)
    scale = max(float(np.max(np.abs(ws[fin]), initial=0.0)), 1e-30)
    gap = float(np.max(np.abs(s[fin] - ws[fin]), initial=0.0))
    assert gap <= RTOL * scale, f"max gap {gap:.3e} = {gap / scale:.3e} of the row's scale"


def _seq_cfg(name, n_items):
    return sr.SeqRecConfig(name=name, kind="sasrec", n_items=n_items, **MODELS[name])


@pytest.mark.parametrize("case", list(CASES))
def test_sasrec_ranker_in_pixie_then_rank_matches_reference(io, graph, case):
    x, ref = io
    model, n_pins, _, seed, final_k = CASES[case]
    cfg = _seq_cfg(model, graph.n_pins)
    params = _params(ref, f"{model}/params/")
    ranker = recommend.sasrec_ranker(params, _t(x[f"{case}/hist"]), cfg)
    scores, ids = recommend.pixie_then_rank(
        graph, _t(x[f"{case}/qp"]), _t(x[f"{case}/qw"]), 0, prng.key(seed, "cpu"),
        twalk.WalkConfig(**WALK), ranker,
        recommend.TwoStageConfig(n_candidates=50, final_k=final_k))
    assert ids.shape == (final_k,) and ids.dtype == torch.int32
    _assert_ranked_equal(scores, ids, ref[f"{case}/scores"], ref[f"{case}/ids"])
    valid = np.isfinite(scores.numpy())
    assert valid.any()
    if n_pins == 1:      # a slot's own query pin is masked, not another's
        assert int(x[f"{case}/qp"][0]) not in ids.numpy()[valid]


def test_sasrec_ranker_underfull_tail_is_minus_one(io):
    """A walk that reaches one candidate: the tail's ids are -1 and its
    scores -inf, as the reference gives them."""
    x, ref = io
    g8 = build_graph(np.asarray(UNDERFULL_EDGES[0]), np.asarray(UNDERFULL_EDGES[1]), 8, 2)
    cfg8 = sr.SeqRecConfig(name="u", kind="sasrec", n_items=8, embed_dim=8,
                           seq_len=4, n_blocks=1, n_heads=1, n_negatives=2)
    ranker = recommend.sasrec_ranker(_params(ref, "underfull/params/"),
                                     _t(x["underfull/hist"]), cfg8)
    scores, ids = recommend.pixie_then_rank(
        g8, torch.tensor([1, -1], dtype=torch.int32), torch.tensor([1.0, 0.0]), 0,
        prng.key(4, "cpu"),
        twalk.WalkConfig(n_steps=512, n_walkers=64, bias_beta=0.0, n_p=10**9, n_v=10**9),
        ranker, recommend.TwoStageConfig(n_candidates=8, final_k=5))
    _assert_ranked_equal(scores, ids, ref["underfull/scores"], ref["underfull/ids"])
    finite = np.isfinite(scores.numpy())
    assert finite.sum() == 1 and ids.numpy()[finite][0] == 0
    assert (ids.numpy()[~finite] == -1).all()


def test_sasrec_ranker_masks_underfull_ids(io):
    """A -1 candidate scores -inf, not item 0's affinity; item 0's own score
    is untouched; every negative id is -inf, and the rest read as
    ``jnp.take`` reads them (512 and past are NaN, 50..511 are drawn
    padding rows)."""
    x, ref = io
    cfg = sr.SeqRecConfig(name="r", kind="sasrec", n_items=50, embed_dim=8,
                          seq_len=4, n_blocks=1, n_heads=1, n_negatives=2)
    score = recommend.sasrec_ranker(_params(ref, "mask/params/"), _t(x["mask/hist"]), cfg)
    s = score(_t(x["mask/cand"]))
    want = ref["mask/scores"]
    assert np.isneginf(want[[1, 3, 9, 10]]).all() and np.isnan(want[[7, 8]]).all()
    _assert_ranked_equal(s, torch.as_tensor(MASK_CAND), want, np.asarray(MASK_CAND))
    assert torch.equal(s[2], score(torch.tensor([0], dtype=torch.int32))[0])
