"""The port's recsys models against the JAX package.

``models/embedding.py``, ``models/sequential_rec.py`` (SASRec, BST),
``models/dlrm.py``, ``layers.layernorm``, the four recsys configs and
``counter.topk_total``'s NaN order, on the same numpy inputs (seeded
``default_rng`` draws and the reference's numpy-only
``data/pipeline.py``) with the reference's own parameters carried across
(``sequential_rec.params_from_reference``).

The reference side runs once per module in a subprocess: every reference
call of the file, the model calls jitted, its inputs and outputs passed
as ``.npz`` files, so floats, NaN and ``-0.0`` cross bit for bit.

Tolerances: gathers, ids and top-k ids are exact; every float output of
a matrix product, norm or reduction is held within ``TOL = 2e-6``
absolute (XLA's CPU backend and torch sum in different orders), NaN and
infinities in the same places, and the measured maximum is printed in
each assertion's message.  Out-of-range ids follow ``jnp.take``: a
negative id wraps once, an id still outside the table is a NaN row;
``lookup_sharded`` gives zeros for rows no shard owns.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import bst as jbst
from repro.configs import dlrm_mlperf as jmlperf
from repro.configs import dlrm_rm2 as jrm2
from repro.configs import registry as jregistry
from repro.configs import sasrec as jsasrec
from repro.data.pipeline import ClickLogPipeline, SeqRecPipeline
from repro_torch.configs import bst, dlrm_mlperf, dlrm_rm2, registry, sasrec
from repro_torch.core import counter
from repro_torch.core.distributed import LocalFabric
from repro_torch.models import dlrm, embedding, layers
from repro_torch.models import sequential_rec as sr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-6
CPU = "cpu"


def hazard_ids(n):
    """The id table of ``jnp.take``'s edges for an n-row table."""
    return [-1, 0, n - 1, n, n + 90, -n, -n - 1]


# small tables: padding to 8 rows leaves padded rows in play
TABLE = dict(feature_rows=(5, 3, 7), dim=4, pad_to_multiple=8)   # 16 rows
ONE_FEATURE = dict(feature_rows=(13,), dim=3, pad_to_multiple=8)  # 16 rows

SEQ_CASES = {
    "sasrec_smoke": dataclasses.asdict(jsasrec.SMOKE),
    "sasrec_1blk_2heads": dict(name="s1", kind="sasrec", n_items=40,
                               embed_dim=16, seq_len=6, n_blocks=1, n_heads=2,
                               n_negatives=4),
    "sasrec_2blk_4heads": dict(name="s2", kind="sasrec", n_items=70,
                               embed_dim=16, seq_len=10, n_blocks=2,
                               n_heads=4, n_negatives=3, d_ff=24),
    "bst_smoke": dataclasses.asdict(jbst.SMOKE),
    "bst_2blk_1head": dict(name="b1", kind="bst", n_items=30, embed_dim=8,
                           seq_len=5, n_blocks=2, n_heads=1, mlp_dims=(16,)),
    "bst_1blk_2heads_no_hidden": dict(name="b2", kind="bst", n_items=50,
                                      embed_dim=8, seq_len=4, n_blocks=1,
                                      n_heads=2, mlp_dims=()),
}
SASREC_CASES = [c for c in SEQ_CASES if c.startswith("sasrec")]
BST_CASES = [c for c in SEQ_CASES if c.startswith("bst")]
DLRM_CASES = {"dlrm_rm2_smoke": jrm2.SMOKE, "dlrm_mlperf_smoke": jmlperf.SMOKE}
CHUNKS = (None, 7, 16, 1000)   # None: dlrm.RETRIEVAL_CHUNK as it stands
TOPK_K = (1, 3, 7)


def _seq_cfg_dict(case):
    d = {k: v for k, v in SEQ_CASES[case].items() if k != "compute_dtype"}
    d["mlp_dims"] = tuple(d.get("mlp_dims", ()))
    return d


def _pad_rows(seq):
    """Left-pad some histories with -1: row 1 by 3, row 3 all but the last
    id, the last row entirely."""
    seq = seq.copy()
    seq[1, :3] = -1
    seq[3, :-1] = -1
    seq[-1, :] = -1
    return seq


def _topk_rows():
    negnan = np.frombuffer(np.uint32(0xFFC00000).tobytes(), np.float32)[0]
    rng = np.random.default_rng(5)
    ties = rng.integers(0, 4, (3, 9)).astype(np.float32)
    ties[0, [2, 6]] = np.nan
    ties[1, 4] = -np.inf
    ties[2, [0, 8]] = [-0.0, 0.0]
    edge = np.array([[1, np.nan, 3, -np.inf, np.nan, 3, 0.0, -0.0, 2],
                     [np.inf, negnan, np.nan, -np.inf, 1, np.nan, np.nan,
                      np.nan, np.inf]], np.float32)
    return np.concatenate([edge, ties])


def _inputs():
    """Every numpy input of the file, drawn once."""
    rng = np.random.default_rng(0)
    x = {}
    for d in (16, 50, 64):
        x[f"ln/{d}/x"] = (rng.normal(size=(4, 7, d)) * 3 + 1.5).astype(np.float32)
        x[f"ln/{d}/w"] = rng.normal(size=(d,)).astype(np.float32)
        x[f"ln/{d}/b"] = rng.normal(size=(d,)).astype(np.float32)
    rows = (np.arange(16, dtype=np.float32)[:, None] * 10
            + np.arange(4, dtype=np.float32)[None] + rng.normal(size=(16, 4)).astype(np.float32))
    x["emb/table"] = rows.astype(np.float32)
    x["emb/table_bf16"] = rows.astype(np.float32)        # cast on both sides
    x["emb/ids"] = np.stack([rng.integers(0, r, 9) for r in (5, 3, 7)], 1).astype(np.int32)
    multi = rng.integers(-1, 7, (4, 3, 5)).astype(np.int32)   # -1 pads, some past a feature
    multi[0, 1, :] = -1                                        # an empty bag
    multi[2, 2, 0] = 40                                        # past the table
    x["emb/multi"] = multi
    x["emb/one_table"] = rng.normal(size=(16, 3)).astype(np.float32)
    x["emb/hazard"] = np.asarray(hazard_ids(16), np.int32)[:, None]
    for case in SEQ_CASES:
        c = _seq_cfg_dict(case)
        n, s = c["n_items"], c["seq_len"]
        rows_n = -(-n // 512) * 512
        if c["kind"] == "sasrec":
            b = SeqRecPipeline(n, 6, s, n_negatives=c["n_negatives"], seed=1)(0)
            tg = b["targets"].copy()
            tg[0, :2] = -1
            neg = b["negatives"].copy()
            x[f"{case}/seq"] = _pad_rows(b["seq"])
            x[f"{case}/targets"] = tg
            x[f"{case}/negatives"] = neg
            hz = neg.copy()
            hz[2].reshape(-1)[:7] = hazard_ids(rows_n)
            x[f"{case}/negatives_hazard"] = hz
            x[f"{case}/cand"] = np.arange(n, dtype=np.int32)
            x[f"{case}/cand_hazard"] = np.concatenate(
                [np.arange(min(n, 60)), hazard_ids(rows_n), [n, n + 3]]).astype(np.int32)
        else:
            b = SeqRecPipeline(n, 7, s, with_candidate=True, seed=2)(0)
            x[f"{case}/seq"] = _pad_rows(b["seq"])
            x[f"{case}/candidate"] = b["candidate"]
            x[f"{case}/labels"] = b["labels"]
            x[f"{case}/candidate_hazard"] = np.asarray(hazard_ids(rows_n), np.int32)
    for case, cfg in DLRM_CASES.items():
        b = ClickLogPipeline(cfg.n_dense, cfg.feature_rows, 16, seed=3)(0)
        total = -(-sum(cfg.feature_rows) // 512) * 512
        sp = b["sparse"].copy()
        sp[:7, 0] = hazard_ids(total)          # feature 0 is global row 0
        sp[7, 0] = cfg.feature_rows[0] + 2      # reads feature 1's rows
        sp[8, 5] = cfg.feature_rows[5] + 6      # reads feature 6's rows
        x[f"{case}/dense"] = b["dense"]
        x[f"{case}/sparse"] = b["sparse"]
        x[f"{case}/sparse_hazard"] = sp
        x[f"{case}/labels"] = b["labels"]
        x[f"{case}/cand"] = np.concatenate(
            [np.arange(cfg.feature_rows[0]), hazard_ids(total),
             [cfg.feature_rows[0] + 5, 700]]).astype(np.int32)
        # at the table's scale (dim ** -0.5): dot products of O(1), not of
        # O(dim), whose float32 ulp alone would be near TOL
        sc = cfg.embed_dim ** -0.5
        x[f"{case}/bot"] = (rng.normal(size=(5, cfg.embed_dim)) * sc).astype(np.float32)
        x[f"{case}/emb"] = (rng.normal(size=(5, len(cfg.feature_rows), cfg.embed_dim))
                            * sc).astype(np.float32)
    x["topk/rows"] = _topk_rows()
    return x


_REFERENCE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro.core import counter as C
from repro.launch.mesh import make_mesh_compat
from repro.models import dlrm as DL, embedding as E, layers as L
from repro.models import sequential_rec as SR

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


for d in (16, 50, 64):
    out[f"ln/{d}"] = a(L.layernorm(*(jnp.asarray(inp[f"ln/{d}/{k}"]) for k in "xwb")))

tcfg = E.MegaTableConfig(**{**spec["table"], "feature_rows": tuple(spec["table"]["feature_rows"])})
ocfg = E.MegaTableConfig(**{**spec["one"], "feature_rows": tuple(spec["one"]["feature_rows"])})
table = jnp.asarray(inp["emb/table"])
out["emb/global_ids"] = a(E.global_ids(jnp.asarray(inp["emb/ids"]), tcfg))
out["emb/lookup"] = a(E.lookup(table, jnp.asarray(inp["emb/ids"]), tcfg))
for dt in ("float32", "bfloat16"):
    t = table.astype(dt)
    for mode in ("sum", "mean"):
        out[f"emb/pooled/{mode}/{dt}"] = a(
            E.pooled_lookup(t, jnp.asarray(inp["emb/multi"]), tcfg, mode).astype(jnp.float32))
one = jnp.asarray(inp["emb/one_table"])
hz = jnp.asarray(inp["emb/hazard"])
out["emb/hazard/lookup"] = a(E.lookup(one, hz, ocfg))
out["emb/hazard/pooled"] = a(E.pooled_lookup(one, hz[:, :, None], ocfg))
mesh = make_mesh_compat((1, 1), ("data", "model"))
out["emb/hazard/sharded"] = a(E.lookup_sharded(one, hz, ocfg, mesh))
out["emb/sharded_multi"] = a(E.lookup_sharded(table, jnp.asarray(inp["emb/ids"]), tcfg, mesh))

jit = jax.jit


def seq_case(case, c):
    c["mlp_dims"] = tuple(c["mlp_dims"])
    cfg = SR.SeqRecConfig(**c)
    p = jit(SR.init_params, static_argnums=1)(jax.random.key(len(case)), cfg)
    flat(f"{case}/params/", p)
    seq = jnp.asarray(inp[f"{case}/seq"])
    if cfg.kind == "sasrec":
        st = jit(SR.sasrec_user_state, static_argnums=2)(p, seq, cfg)
        out[f"{case}/state"] = a(st)
        score = jit(SR.score_candidates, static_argnums=(3, 4))
        for cand in ("cand", "cand_hazard"):
            v, i = score(p, st, jnp.asarray(inp[f"{case}/{cand}"]), cfg, 10)
            out[f"{case}/{cand}/vals"], out[f"{case}/{cand}/ids"] = a(v), a(i)
        loss = jit(SR.sasrec_loss, static_argnums=4)
        for neg in ("negatives", "negatives_hazard"):
            out[f"{case}/loss/{neg}"] = a(loss(
                p, seq, jnp.asarray(inp[f"{case}/targets"]), jnp.asarray(inp[f"{case}/{neg}"]), cfg))
    else:
        fwd = jit(SR.bst_forward, static_argnums=3)
        cand = jnp.asarray(inp[f"{case}/candidate"])
        out[f"{case}/logits"] = a(fwd(p, seq, cand, cfg))
        out[f"{case}/loss"] = a(jit(SR.bst_loss, static_argnums=4)(
            p, seq, cand, jnp.asarray(inp[f"{case}/labels"]), cfg))
        hzc = jnp.asarray(inp[f"{case}/candidate_hazard"])
        out[f"{case}/logits_hazard"] = a(fwd(p, seq[:hzc.shape[0]], hzc, cfg))


def dlrm_case(case, c):
    cfg = DL.DLRMConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in c.items()})
    p = jit(DL.init_params, static_argnums=1)(jax.random.key(len(case) + 7), cfg)
    flat(f"{case}/params/", p)
    dense = jnp.asarray(inp[f"{case}/dense"])
    fwd = jit(DL.forward, static_argnums=3)
    for sp in ("sparse", "sparse_hazard"):
        out[f"{case}/logits/{sp}"] = a(fwd(p, dense, jnp.asarray(inp[f"{case}/{sp}"]), cfg))
    out[f"{case}/loss"] = a(jit(DL.bce_loss, static_argnums=4)(
        p, dense, jnp.asarray(inp[f"{case}/sparse"]), jnp.asarray(inp[f"{case}/labels"]), cfg))
    out[f"{case}/interact"] = a(DL._interact(jnp.asarray(inp[f"{case}/bot"]),
                                            jnp.asarray(inp[f"{case}/emb"])))
    v, i = jit(DL.retrieval_score, static_argnums=(4, 5))(
        p, dense[0], jnp.asarray(inp[f"{case}/sparse"])[0], jnp.asarray(inp[f"{case}/cand"]), cfg, 10)
    out[f"{case}/retrieval/vals"], out[f"{case}/retrieval/ids"] = a(v), a(i)


# every call jitted (one compile a function and shape), cases compiled
# side by side: each writes its own keys
from concurrent.futures import ThreadPoolExecutor
with ThreadPoolExecutor(3) as pool:
    jobs = [pool.submit(seq_case, k, c) for k, c in spec["seq"].items()]
    jobs += [pool.submit(dlrm_case, k, c) for k, c in spec["dlrm"].items()]
    for j in jobs:
        j.result()

rows = jnp.asarray(inp["topk/rows"])
for k in spec["topk_k"]:
    v, i = jax.lax.top_k(rows, k)
    out[f"topk/{k}/vals"], out[f"topk/{k}/ids"] = a(v), a(i)
np.savez(sys.argv[2], **out)
"""


def _jsonable(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("compute_dtype", None)
    d["table_dtype"] = "float32"
    return d


@pytest.fixture(scope="module")
def io(tmp_path_factory):
    """``(inputs, reference outputs)``, both dicts of numpy arrays."""
    import json

    tmp = tmp_path_factory.mktemp("recsys")
    x = _inputs()
    np.savez(tmp / "in.npz", **x)
    spec = dict(table=TABLE, one=ONE_FEATURE, topk_k=list(TOPK_K),
                seq={c: _seq_cfg_dict(c) for c in SEQ_CASES},
                dlrm={c: _jsonable(cfg) for c, cfg in DLRM_CASES.items()})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "in.npz"), str(tmp / "out.npz"),
         json.dumps(spec)],
        capture_output=True, text=True, env=env, timeout=540)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return x, dict(np.load(tmp / "out.npz"))


def _params(ref, prefix):
    tree = {}
    for key, v in ref.items():
        if key.startswith(prefix):
            node = tree
            *path, leaf = key[len(prefix):].split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = v
    return sr.params_from_reference(tree, CPU)


def _t(a):
    return torch.as_tensor(np.require(a, requirements="W"))


def _close(got, want, what, tol=TOL):
    """NaN and infinities in the same places; finite values within tol."""
    got = np.asarray(got.detach().float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want), err_msg=what)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want), err_msg=what)
    fin = np.isfinite(want)
    err = float(np.max(np.abs(got[fin] - want[fin]), initial=0.0))
    assert err <= tol, f"{what}: max abs difference {err:.3e} > {tol}"
    return err


def _same(got, want, what):
    """Bit for bit (NaN equal to NaN, -0.0 equal to 0.0)."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want, got.dtype), err_msg=what)


def _mega(spec):
    return embedding.MegaTableConfig(**spec)


def _seq_cfg(case):
    return sr.SeqRecConfig(**_seq_cfg_dict(case))


def _dlrm_cfg(case):
    return dlrm.DLRMConfig(**{k: v for k, v in _jsonable(DLRM_CASES[case]).items()
                              if k != "table_dtype"})


# ---------------------------------------------------------------------------
# layernorm, the mega-table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", (16, 50, 64))
def test_layernorm_matches_reference(io, d):
    x, ref = io
    got = layers.layernorm(*(_t(x[f"ln/{d}/{k}"]) for k in "xwb"))
    _close(got, ref[f"ln/{d}"], f"layernorm d={d}")


def test_layernorm_is_population_variance_with_eps_1e6():
    x = torch.tensor([[1.0, 2.0, 4.0]])
    got = layers.layernorm(x, torch.ones(3), torch.zeros(3))
    var = x.var(-1, unbiased=False, keepdim=True)
    want = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(var + 1e-6)
    assert torch.equal(got, want)


def test_global_ids_and_lookup_match_reference(io):
    x, ref = io
    cfg = _mega(TABLE)
    ids = _t(x["emb/ids"])
    g = embedding.global_ids(ids, cfg)
    assert g.dtype == torch.int32 and cfg.total_rows == 16
    _same(g, ref["emb/global_ids"], "global_ids")
    _same(embedding.lookup(_t(x["emb/table"]), ids, cfg), ref["emb/lookup"], "lookup")


@pytest.mark.parametrize("mode", ("sum", "mean"))
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_pooled_lookup_matches_reference(io, mode, dtype):
    """-1 padding, an empty bag, ids past their feature (the next
    feature's rows) and past the table (NaN)."""
    x, ref = io
    table = _t(x["emb/table"]).to(getattr(torch, dtype))
    got = embedding.pooled_lookup(table, _t(x["emb/multi"]), _mega(TABLE), mode)
    assert got.dtype == table.dtype
    _close(got, ref[f"emb/pooled/{mode}/{dtype}"], f"pooled {mode} {dtype}")


@pytest.mark.parametrize("fn", ("lookup", "pooled_lookup", "lookup_sharded"))
def test_jnp_take_id_table_for_lookups(io, fn):
    """ids -1, 0, n-1, n, n+90, -n, -n-1 on a 16-row single-feature table:
    rows 15, 0, 15, NaN, NaN, 0, NaN for the gathers; the sharded lookup
    wraps nothing, so -1, n, n+90, -n and -n-1 give zeros."""
    x, ref = io
    cfg = _mega(ONE_FEATURE)
    table, ids = _t(x["emb/one_table"]), _t(x["emb/hazard"])
    if fn == "lookup":
        got = embedding.lookup(table, ids, cfg)
        want = ref["emb/hazard/lookup"]
        assert np.isnan(want[[3, 4, 6]]).all() and not np.isnan(want[[0, 1, 2, 5]]).any()
    elif fn == "pooled_lookup":
        got = embedding.pooled_lookup(table, ids[:, :, None], cfg)
        want = ref["emb/hazard/pooled"]
    else:
        got = embedding.lookup_sharded(table, ids, cfg, LocalFabric(2, device=CPU))
        want = ref["emb/hazard/sharded"]
        assert (want[[0, 3, 4, 5, 6]] == 0).all()
    _same(got, want, fn)


@pytest.mark.parametrize("n_shards", (1, 2, 4))
def test_lookup_sharded_equals_lookup_and_reference(io, n_shards):
    x, ref = io
    cfg = _mega(TABLE)
    fabric = LocalFabric(n_shards, device=CPU)
    table, ids = _t(x["emb/table"]), _t(x["emb/ids"])
    got = embedding.lookup_sharded(table, ids, cfg, fabric)
    assert torch.equal(got, embedding.lookup(table, ids, cfg))
    _same(got, ref["emb/sharded_multi"], "lookup_sharded")
    one, hz = _t(x["emb/one_table"]), _t(x["emb/hazard"])
    _same(embedding.lookup_sharded(one, hz, _mega(ONE_FEATURE), fabric),
          ref["emb/hazard/sharded"], f"lookup_sharded hazard, {n_shards} shards")


def test_lookup_sharded_refuses_uneven_shards():
    cfg = _mega(TABLE)
    table = torch.zeros((16, 4))
    ids = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="do not split"):
        embedding.lookup_sharded(table, ids, cfg, LocalFabric(3, device=CPU))
    with pytest.raises(ValueError, match="local shards"):
        embedding.lookup_sharded(table[:8], ids, cfg, LocalFabric(2, device=CPU))


def test_init_table_shape_scale_and_dtype():
    cfg = embedding.MegaTableConfig((1000, 24), 16)
    gen = torch.Generator().manual_seed(0)
    t = embedding.init_table(gen, cfg, dtype=torch.bfloat16)
    assert t.shape == (1024, 16) and t.dtype == torch.bfloat16
    assert abs(float(t.float().std()) - 0.25) < 0.01


# ---------------------------------------------------------------------------
# SASRec and BST
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", SASREC_CASES)
def test_sasrec_user_state_matches_reference(io, case):
    x, ref = io
    p, cfg = _params(ref, f"{case}/params/"), _seq_cfg(case)
    got = sr.sasrec_user_state(p, _t(x[f"{case}/seq"]), cfg)
    _close(got, ref[f"{case}/state"], f"{case} user state")


@pytest.mark.parametrize("cand", ("cand", "cand_hazard"))
@pytest.mark.parametrize("case", SASREC_CASES)
def test_score_candidates_matches_reference(io, case, cand):
    """Top-10 ids exact; with the id table among the candidates, the NaN
    rows lead the top-k (``lax.top_k``'s order) and a wrapped id scores
    its row."""
    x, ref = io
    p, cfg = _params(ref, f"{case}/params/"), _seq_cfg(case)
    st = _t(ref[f"{case}/state"])
    vals, ids = sr.score_candidates(p, st, _t(x[f"{case}/{cand}"]), cfg, top_k=10)
    np.testing.assert_array_equal(ids.numpy(), ref[f"{case}/{cand}/ids"])
    _close(vals, ref[f"{case}/{cand}/vals"], f"{case} {cand} scores")
    if cand == "cand_hazard":
        assert np.isnan(ref[f"{case}/{cand}/vals"][:, :3]).all()


@pytest.mark.parametrize("neg", ("negatives", "negatives_hazard"))
@pytest.mark.parametrize("case", SASREC_CASES)
def test_sasrec_loss_matches_reference(io, case, neg):
    x, ref = io
    p, cfg = _params(ref, f"{case}/params/"), _seq_cfg(case)
    got = sr.sasrec_loss(p, _t(x[f"{case}/seq"]), _t(x[f"{case}/targets"]),
                         _t(x[f"{case}/{neg}"]), cfg)
    _close(got, ref[f"{case}/loss/{neg}"], f"{case} sasrec_loss {neg}")
    assert np.isnan(ref[f"{case}/loss/{neg}"]) == (neg == "negatives_hazard")


@pytest.mark.parametrize("case", BST_CASES)
def test_bst_forward_and_loss_match_reference(io, case):
    x, ref = io
    p, cfg = _params(ref, f"{case}/params/"), _seq_cfg(case)
    seq, cand = _t(x[f"{case}/seq"]), _t(x[f"{case}/candidate"])
    _close(sr.bst_forward(p, seq, cand, cfg), ref[f"{case}/logits"], f"{case} logits")
    _close(sr.bst_loss(p, seq, cand, _t(x[f"{case}/labels"]), cfg),
           ref[f"{case}/loss"], f"{case} bst_loss")


@pytest.mark.parametrize("case", BST_CASES)
def test_bst_candidate_id_table_matches_reference(io, case):
    x, ref = io
    p, cfg = _params(ref, f"{case}/params/"), _seq_cfg(case)
    hz = _t(x[f"{case}/candidate_hazard"])
    got = sr.bst_forward(p, _t(x[f"{case}/seq"])[:hz.shape[0]], hz, cfg)
    want = ref[f"{case}/logits_hazard"]
    assert np.isnan(want[[3, 4, 6]]).all() and np.isfinite(want[[0, 1, 2, 5]]).all()
    _close(got, want, f"{case} hazard logits")


def test_padded_history_rows_are_zero_but_attended():
    """A -1 id embeds as zeros plus its position, and the last position's
    state still depends on it (no key mask)."""
    cfg = sasrec.SMOKE
    p = sr.init_params(torch.Generator().manual_seed(0), cfg)
    full = torch.arange(1, cfg.seq_len + 1, dtype=torch.int32)[None]
    padded = full.clone()
    padded[0, :4] = -1
    zeroed = dict(p, items=p["items"].clone())
    zeroed["items"][0] = 0.0
    a = sr.sasrec_user_state(p, padded, cfg)
    b = sr.sasrec_user_state(zeroed, torch.where(padded < 0, 0, padded), cfg)
    assert torch.equal(a, b)
    assert not torch.equal(a, sr.sasrec_user_state(p, full, cfg))


# ---------------------------------------------------------------------------
# DLRM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sp", ("sparse", "sparse_hazard"))
@pytest.mark.parametrize("case", list(DLRM_CASES))
def test_dlrm_forward_matches_reference(io, case, sp):
    x, ref = io
    p, cfg = _params(ref, f"{case}/params/"), _dlrm_cfg(case)
    got = dlrm.forward(p, _t(x[f"{case}/dense"]), _t(x[f"{case}/{sp}"]), cfg)
    _close(got, ref[f"{case}/logits/{sp}"], f"{case} forward {sp}")
    if sp == "sparse_hazard":   # ids n, n+90 and -n-1 in feature 0: NaN
        assert np.isnan(ref[f"{case}/logits/{sp}"][[3, 4, 6]]).all()


@pytest.mark.parametrize("case", list(DLRM_CASES))
def test_dlrm_bce_loss_matches_reference(io, case):
    x, ref = io
    p, cfg = _params(ref, f"{case}/params/"), _dlrm_cfg(case)
    got = dlrm.bce_loss(p, _t(x[f"{case}/dense"]), _t(x[f"{case}/sparse"]),
                        _t(x[f"{case}/labels"]), cfg)
    _close(got, ref[f"{case}/loss"], f"{case} bce_loss")


@pytest.mark.parametrize("case", list(DLRM_CASES))
def test_interact_matches_reference_in_index_order(io, case):
    x, ref = io
    f = len(DLRM_CASES[case].feature_rows) + 1
    ii, jj = torch.tril_indices(f, f, offset=-1)
    ni, nj = np.tril_indices(f, k=-1)
    np.testing.assert_array_equal(ii.numpy(), ni)
    np.testing.assert_array_equal(jj.numpy(), nj)
    got = dlrm._interact(_t(x[f"{case}/bot"]), _t(x[f"{case}/emb"]))
    assert got.shape == (5, f * (f - 1) // 2)
    _close(got, ref[f"{case}/interact"], f"{case} _interact")


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", list(DLRM_CASES))
def test_retrieval_score_chunked_matches_reference(io, case, chunk, monkeypatch):
    """The candidate axis in chunks equals one chunk and the reference:
    ids exact (NaN candidates first), scores within TOL."""
    x, ref = io
    p, cfg = _params(ref, f"{case}/params/"), _dlrm_cfg(case)
    args = (p, _t(x[f"{case}/dense"])[0], _t(x[f"{case}/sparse"])[0],
            _t(x[f"{case}/cand"]), cfg)
    if chunk is not None:
        monkeypatch.setattr(dlrm, "RETRIEVAL_CHUNK", chunk)
    vals, ids = dlrm.retrieval_score(*args, top_k=10)
    np.testing.assert_array_equal(ids.numpy(), ref[f"{case}/retrieval/ids"])
    _close(vals, ref[f"{case}/retrieval/vals"], f"{case} retrieval chunk={chunk}")
    monkeypatch.setattr(dlrm, "RETRIEVAL_CHUNK", args[3].shape[0])
    one_v, one_i = dlrm.retrieval_score(*args, top_k=10)
    assert torch.equal(ids, one_i)
    _close(vals, one_v.numpy(), f"{case} chunk {chunk} against one chunk")
    assert np.isnan(ref[f"{case}/retrieval/vals"][:3]).all()


# ---------------------------------------------------------------------------
# top-k with NaN; configs; initialisers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", TOPK_K)
def test_topk_total_orders_nan_as_lax_top_k(io, k):
    """NaN first (lowest index first), +inf, ties by index, +0.0 above
    -0.0, and a NaN with its sign bit set last, as ``lax.top_k``."""
    x, ref = io
    rows = _t(x["topk/rows"])
    vals, ids = counter.topk_total(rows, k)
    np.testing.assert_array_equal(ids.numpy(), ref[f"topk/{k}/ids"])
    np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                  ref[f"topk/{k}/vals"].view(np.uint32))


def _ref_fields(cfg):
    d = dataclasses.asdict(cfg)
    for k in ("compute_dtype", "table_dtype"):
        if k in d:
            d[k] = np.dtype(d[k]).name
    return d


def _port_fields(cfg):
    d = dataclasses.asdict(cfg)
    for k in ("compute_dtype", "table_dtype"):
        if k in d:
            d[k] = str(d[k]).replace("torch.", "")
    return d


@pytest.mark.parametrize("name,port,ref", [
    ("sasrec", sasrec, jsasrec), ("bst", bst, jbst),
    ("dlrm_rm2", dlrm_rm2, jrm2), ("dlrm_mlperf", dlrm_mlperf, jmlperf),
])
def test_configs_match_reference_field_for_field(name, port, ref):
    for which in ("FULL", "SMOKE"):
        assert _port_fields(getattr(port, which)) == _ref_fields(getattr(ref, which)), which
    assert port.SOURCE == ref.spec().source
    assert port.FULL.param_count() == ref.FULL.param_count()
    if name.startswith("dlrm"):
        assert port.FULL.table.total_rows == ref.FULL.table.total_rows
        assert port.FULL.n_interactions == ref.FULL.n_interactions
    assert registry.CRITEO_ROWS == jregistry.CRITEO_ROWS


@pytest.mark.parametrize("case", [*SEQ_CASES, *DLRM_CASES])
def test_init_params_tree_matches_reference(io, case):
    """The port's own draws: the reference's names, shapes and dtypes, with
    its standard deviations (the numbers are torch's)."""
    _, ref = io
    want = {k[len(case) + 8:]: v for k, v in ref.items()
            if k.startswith(f"{case}/params/")}
    gen = torch.Generator().manual_seed(0)
    p = (sr.init_params(gen, _seq_cfg(case)) if case in SEQ_CASES
         else dlrm.init_params(gen, _dlrm_cfg(case)))
    got = {}

    def walk(prefix, node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(prefix + k + "/", v)
            else:
                got[prefix + k] = v

    walk("", p)
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k
        assert str(v.dtype).replace("torch.", "") == want[k].dtype.name, k
        sd_ref = float(np.std(want[k].astype(np.float64)))
        if sd_ref == 0:                      # norms and biases: constants
            assert torch.equal(v, _t(want[k])), k
        elif v.numel() >= 256:
            assert abs(float(v.double().std()) - sd_ref) < 0.15 * sd_ref, k
