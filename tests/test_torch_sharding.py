"""The port's logical-axis sharding against the JAX package.

  * the five rule tables and ``with_overrides``, name for name;
  * ``RuleSet.spec``, ``param_shardings`` and ``train_loop.state_shardings``
    (ZeRO-1, with and without ``params_abs``) for every LM, recsys and GNN
    arch of the reference registry under its ``train_rule_overrides`` and
    ``serve_rule_overrides`` (passed to both packages as plain dicts), and
    the KV cache's serve specs, on the single-pod (16, 16), the multi-pod
    (2, 16, 16) and a (2, 2) mesh: equal leaf by leaf;
  * every logical tree (``transformer.param_logical`` / ``kv_cache_logical``,
    ``moe.moe_param_specs``, ``sequential_rec`` / ``dlrm`` / ``gnn``
    ``param_logical``, ``embedding.table_logical``, ``optim.state_logical``)
    equal to the reference's and shaped like the port's own ``init_params``
    at SMOKE (the same keys, each tuple as long as its leaf's ndim);
  * DTensor placements of specs, and the refusal of an uneven split.

The reference's specs need a mesh of that many devices, which JAX fixes
when it starts: they are resolved once per module in a subprocess with
512 fake CPU devices (``test_distributed._run``) and come back as JSON;
nothing is compiled.  The port resolves them on abstract meshes
(``launch.mesh.Mesh(kind="abstract")``), with the reference's parameter
shapes as meta tensors (the port's dry-run ``abstract_params`` is a later
slice; the SMOKE check ties the shapes to the port's own trees).
"""

import json
import math
import re

import pytest
import torch

from repro.configs import registry as jregistry
from repro.distribution import sharding as jsh
from repro.models import dlrm as jdlrm
from repro.models import embedding as jemb
from repro.models import gnn as jgnn
from repro.models import moe as jmoe
from repro.models import sequential_rec as jseq
from repro.models import transformer as jtf
from repro.training import optim as joptim
from repro_torch.configs import (bst, deepseek_moe_16b, dlrm_mlperf, dlrm_rm2, gin_tu,
                                 granite_moe_3b_a800m, minitron_4b, qwen2_5_3b, sasrec,
                                 smollm_360m)
from repro_torch.distribution import sharding as tsh
from repro_torch.launch import mesh as tmesh
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import embedding as temb
from repro_torch.models import gnn as tgnn
from repro_torch.models import moe as tmoe
from repro_torch.models import sequential_rec as tseq
from repro_torch.models import transformer as ttf
from repro_torch.training import optim as toptim
from repro_torch.training import train_loop as tloop
from repro_torch.training import tree
from test_distributed import _run

# the port's config module of each reference arch (pixie has no model tree)
PORT_CONFIGS = {
    "bst": bst, "deepseek-moe-16b": deepseek_moe_16b, "dlrm-mlperf": dlrm_mlperf,
    "dlrm-rm2": dlrm_rm2, "gin-tu": gin_tu, "granite-moe-3b-a800m": granite_moe_3b_a800m,
    "minitron-4b": minitron_4b, "qwen2.5-3b": qwen2_5_3b, "sasrec": sasrec,
    "smollm-360m": smollm_360m,
}
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
}
TABLES = ("LM_TRAIN_RULES", "LM_SERVE_RULES", "GNN_RULES", "RECSYS_RULES", "PIXIE_RULES")
FAMILY_RULES = {"recsys": "RECSYS_RULES", "gnn": "GNN_RULES"}

_REFERENCE_BODY = """
    import math
    from jax.sharding import Mesh
    from repro.configs import registry
    from repro.distribution import sharding as S
    from repro.models import dlrm, gnn, sequential_rec, transformer as tf
    from repro.training import train_loop
    from repro.training.checkpoint import _flatten_with_names

    MESHES = json.loads('''%s''')
    FAMILY_RULES = json.loads('''%s''')
    devs = np.array(jax.devices())
    enc = lambda s: [list(p) if isinstance(p, tuple) else p for p in s]

    def specs(tree):
        names, leaves, _ = _flatten_with_names(tree)
        return {n: enc(l.spec) for n, l in zip(names, leaves)}

    MODS = {"repro.models.transformer": tf, "repro.models.sequential_rec": sequential_rec,
            "repro.models.dlrm": dlrm, "repro.models.gnn": gnn}
    out = {}
    for arch in registry.all_archs():
        spec = registry.get_arch(arch)
        if spec.family == "pixie":
            continue
        cfg = spec.config
        mod = MODS[type(cfg).__module__]
        logical, abs_ = mod.param_logical(cfg), mod.abstract_params(cfg)
        names, leaves, _ = _flatten_with_names(abs_)
        res = {"shapes": {n: list(l.shape) for n, l in zip(names, leaves)}}
        if spec.family == "lm":
            train, serve = S.LM_TRAIN_RULES, S.LM_SERVE_RULES
        else:
            train = serve = getattr(S, FAMILY_RULES[spec.family])
        train = train.with_overrides(**spec.train_rule_overrides)
        serve = serve.with_overrides(**spec.serve_rule_overrides)
        for mname, (shape, axes) in MESHES.items():
            mesh = Mesh(devs[:math.prod(shape)].reshape(shape), tuple(axes))
            ps, os_ = train_loop.state_shardings(logical, train, mesh, zero1=True,
                                                 params_abs=abs_)
            _, os_plain = train_loop.state_shardings(logical, train, mesh, zero1=True)
            _, os_off = train_loop.state_shardings(logical, train, mesh)
            r = {"param": specs(ps), "opt": specs(os_), "opt_noshape": specs(os_plain),
                 "opt_off": specs(os_off),
                 "serve": specs(S.param_shardings(logical, serve, mesh)),
                 "tree_specs": {n: enc(s) for n, s in zip(
                     *_flatten_with_names(train.tree_specs(logical, mesh))[:2])}}
            if spec.family == "lm":
                r["kv"] = {k: enc(serve.spec(v, mesh))
                           for k, v in tf.kv_cache_logical().items()}
                r["batch"] = specs(train_loop.batch_shardings(
                    {"tokens": ("batch", "seq"), "mask": ("batch", "seq")}, train, mesh))
            res[mname] = r
        out[arch] = res
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref():
    return _run(512, _REFERENCE_BODY % (json.dumps(MESHES), json.dumps(FAMILY_RULES)))


def _enc(spec):
    return [list(p) if isinstance(p, tuple) else p for p in spec]


def _specs(tree_):
    names, leaves = tree.flatten_with_names(tree_)
    return {n: _enc(leaf.spec) for n, leaf in zip(names, leaves)}


def _nest(flat: dict, fn):
    """``{"['a']/['b']": v}`` -> ``{"a": {"b": fn(v)}}``."""
    out = {}
    for name, v in flat.items():
        keys = re.findall(r"\['(.*?)'\]", name)
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = fn(v)
    return out


def _port_logical(cfg):
    mod = {ttf.LMConfig: ttf, tseq.SeqRecConfig: tseq, tdlrm.DLRMConfig: tdlrm,
           tgnn.GINConfig: tgnn}[type(cfg)]
    return mod.param_logical(cfg)


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", TABLES)
def test_rule_tables_equal_reference(table):
    assert getattr(tsh, table).rules == getattr(jsh, table).rules


def test_with_overrides_equals_reference():
    for kv in ({"heads": None, "embed": None}, {"batch": "data", "kv_seq": ("pod", "model")},
               {"new_name": "model"}):
        for table in TABLES:
            got = getattr(tsh, table).with_overrides(**kv)
            want = getattr(jsh, table).with_overrides(**kv)
            assert got.rules == want.rules
            assert getattr(tsh, table).rules == getattr(jsh, table).rules  # unchanged


def test_axes_for_drops_missing_axes():
    single = tmesh.make_production_mesh()
    multi = tmesh.make_production_mesh(multi_pod=True)
    r = tsh.LM_TRAIN_RULES
    assert r.axes_for("batch", single) == "data"
    assert r.axes_for("batch", multi) == ("pod", "data")
    assert r.axes_for("seq", multi) is None and r.axes_for(None, multi) is None
    assert r.axes_for("unknown", multi) is None
    assert tsh.GNN_RULES.axes_for("edges", single) == ("data", "model")
    assert r.spec(("layers", "embed", "heads", "head_dim"), single) == \
        (None, "data", "model", None)
    assert tsh.RuleSet({"x": ("pod",)}).axes_for("x", single) is None


# ---------------------------------------------------------------------------
# specs of every arch on the three meshes
# ---------------------------------------------------------------------------


ARCHS = sorted(PORT_CONFIGS)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_reference(ref, arch, mesh_name):
    spec = jregistry.get_arch(arch)
    want = ref[arch][mesh_name]
    cfg = PORT_CONFIGS[arch].FULL
    shape, axes = MESHES[mesh_name]
    mesh = tmesh.Mesh(shape, axes, kind="abstract")
    logical = _port_logical(cfg)
    abs_ = _nest(ref[arch]["shapes"], lambda s: torch.empty(s, device="meta"))
    if spec.family == "lm":
        train, serve = tsh.LM_TRAIN_RULES, tsh.LM_SERVE_RULES
    else:
        train = serve = getattr(tsh, FAMILY_RULES[spec.family])
    # the overrides cross as plain dicts
    train = train.with_overrides(**dict(spec.train_rule_overrides))
    serve = serve.with_overrides(**dict(spec.serve_rule_overrides))
    ps, os_ = tloop.state_shardings(logical, train, mesh, zero1=True, params_abs=abs_)
    assert _specs(ps) == want["param"]
    assert _specs(os_) == want["opt"]
    assert _specs(tloop.state_shardings(logical, train, mesh, zero1=True)[1]) == \
        want["opt_noshape"]
    assert _specs(tloop.state_shardings(logical, train, mesh)[1]) == want["opt_off"]
    assert _specs(tsh.param_shardings(logical, serve, mesh)) == want["serve"]
    # (a spec is a tuple: boxed so that the tree walk stops at it)
    boxed = tsh.map_logical(lambda names, s: tsh.NamedSharding(mesh, s), logical,
                            train.tree_specs(logical, mesh))
    assert _specs(boxed) == want["tree_specs"]
    if spec.family == "lm":
        assert {k: _enc(serve.spec(v, mesh)) for k, v in ttf.kv_cache_logical().items()} \
            == want["kv"]
        bsh = tloop.batch_shardings({"tokens": ("batch", "seq"), "mask": ("batch", "seq")},
                                    train, mesh)
        assert _specs(bsh) == want["batch"]
    # every placement resolves, and every leaf divides its shards
    for sh_tree in (ps, os_.m):
        for (name, sh), leaf in zip(zip(*tree.flatten_with_names(sh_tree)),
                                    tree.leaves(abs_)):
            assert len(sh.placements) == len(axes)
            sh.check(leaf.shape, name)


# ---------------------------------------------------------------------------
# logical trees
# ---------------------------------------------------------------------------


def _same_structure(logical, params, where=""):
    """The same keys, and each tuple as long as its leaf's ndim."""
    if isinstance(logical, dict):
        assert isinstance(params, dict) and set(logical) == set(params), where
        for k in logical:
            _same_structure(logical[k], params[k], f"{where}/{k}")
        return
    assert tsh.is_logical(logical), where
    assert len(logical) == params.ndim, (where, logical, tuple(params.shape))


LM_MODULES = {"qwen2.5-3b": qwen2_5_3b, "smollm-360m": smollm_360m, "minitron-4b": minitron_4b,
              "granite-moe-3b-a800m": granite_moe_3b_a800m,
              "deepseek-moe-16b": deepseek_moe_16b}


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_tree_equals_reference_and_port_params(arch):
    spec = jregistry.get_arch(arch)
    jmod = {jtf.LMConfig: jtf, jseq.SeqRecConfig: jseq, jdlrm.DLRMConfig: jdlrm,
            jgnn.GINConfig: jgnn}[type(spec.config)]
    for jcfg, tcfg in ((spec.config, PORT_CONFIGS[arch].FULL),
                       (spec.smoke_config, PORT_CONFIGS[arch].SMOKE)):
        assert _port_logical(tcfg) == jmod.param_logical(jcfg)
    tcfg = PORT_CONFIGS[arch].SMOKE
    mod = {ttf.LMConfig: ttf, tseq.SeqRecConfig: tseq, tdlrm.DLRMConfig: tdlrm,
           tgnn.GINConfig: tgnn}[type(tcfg)]
    params = mod.init_params(torch.Generator().manual_seed(0), tcfg)
    logical = _port_logical(tcfg)
    _same_structure(logical, params)
    if arch == "deepseek-moe-16b":      # dense0: one unstacked block
        assert "layers" not in logical["dense0"]["wq"]
        assert logical["dense0"]["wq"] == ("embed", "heads", "head_dim")
        assert params["dense0"]["wq"].ndim == 3


def test_kv_cache_moe_table_and_state_logical_equal_reference():
    assert ttf.kv_cache_logical() == jtf.kv_cache_logical()
    cache = ttf.init_kv_cache(qwen2_5_3b.SMOKE, 2, 8, device="cpu")
    _same_structure(ttf.kv_cache_logical(), cache)
    for shared in (0, 2):
        jm = jmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, n_shared=shared)
        tm = tmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16, n_shared=shared)
        assert tmoe.moe_param_specs(tm) == jmoe.moe_param_specs(jm)
        _same_structure(tmoe.moe_param_specs(tm),
                        tmoe.init_moe_params(torch.Generator().manual_seed(0), 32, tm))
    assert temb.table_logical() == jemb.table_logical()
    logical = ttf.param_logical(qwen2_5_3b.SMOKE)
    got, want = toptim.state_logical(logical), joptim.state_logical(logical)
    assert got.m == want.m and got.v == want.v and got.step == want.step == ((),)
    assert type(got).__name__ == "OptState" and got._fields == want._fields


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------


def test_placements_follow_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    multi = tmesh.make_production_mesh(multi_pod=True)
    sh = tsh.NamedSharding(multi, tsh.P(("pod", "data"), None, "model"))
    assert sh.placements == (Shard(0), Shard(0), Shard(2))
    assert tsh.NamedSharding(multi, tsh.P()).placements == (Replicate(),) * 3
    single = tmesh.make_production_mesh()
    sh = tsh.LM_TRAIN_RULES.sharding(("layers", "embed", "heads", "head_dim"), single)
    assert sh.placements == (Shard(1), Shard(2))
    # the block of one mesh point: dim 0 split major to minor over (pod, data)
    assert sh.block((4, 32, 16, 8), {"data": 3, "model": 5}) == (
        slice(0, 4), slice(6, 8), slice(5, 6), slice(0, 8))
    sh = tsh.NamedSharding(multi, tsh.P(("pod", "data")))
    assert sh.block((64,), {"pod": 1, "data": 2, "model": 0}) == (slice(36, 38),)
    # ZeRO-1 over a spec that splits a dim over (pod, data) already
    rules = tsh.RuleSet({"batch": ("pod", "data"), "x": None})
    ps, os_ = tloop.state_shardings({"w": ("batch", "x")}, rules, multi, zero1=True,
                                    params_abs={"w": torch.empty(64, 32, device="meta")})
    assert ps["w"].spec == os_.m["w"].spec == (("pod", "data"), None)
    rules = tsh.RuleSet({"x": "pod"})
    _, os_ = tloop.state_shardings({"w": ("x", None, None)}, rules, multi, zero1=True,
                                   params_abs={"w": torch.empty(4, 32, 48, device="meta")})
    assert os_.m["w"].spec == ("pod", None, "data")
    with pytest.raises(ValueError, match="mesh order"):
        _ = tsh.NamedSharding(multi, tsh.P(("data", "pod"))).placements
    with pytest.raises(ValueError, match="shards two dims"):
        _ = tsh.NamedSharding(multi, tsh.P("model", "model")).placements


def test_uneven_split_is_refused_with_the_leaf_name():
    mesh = tmesh.Mesh((2, 2), ("data", "model"), kind="abstract")
    sh = tsh.NamedSharding(mesh, tsh.P(None, "data", "model"))
    sh.check((3, 4, 2), "blocks/wq")
    with pytest.raises(ValueError, match=r"blocks/wq.*dim 2"):
        sh.check((3, 4, 3), "blocks/wq")
    with pytest.raises(ValueError, match="more dims"):
        sh.check((4, 4), "embed")


def test_production_meshes_are_abstract():
    single, multi = tmesh.make_production_mesh(), tmesh.make_production_mesh(multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and tmesh.n_chips(single) == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.devices.size == 512
    assert tmesh.data_axes(single) == ("data",)
    assert tmesh.data_axes(multi) == ("pod", "data")
    with pytest.raises(ValueError, match="abstract"):
        multi.fabric("model")
    host = tmesh.make_host_mesh(device="cpu")
    assert host.kind == "local" and host.shape == {"data": 1, "model": 1}
    local = tmesh.make_host_mesh((2, 4), device="cpu")
    assert local.fabric("model").n_shards == 4 and local.fabric(("data", "model")).n_shards == 8
    assert math.prod(local.devices.shape) == 8
    with pytest.raises(ValueError, match="mesh order"):
        local.fabric(("model", "data"))
