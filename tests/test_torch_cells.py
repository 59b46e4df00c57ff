"""The port's dry-run cells (``launch/cells.py``) against the JAX package.

  * for every (arch, shape) on the single-pod (16, 16) and multi-pod (2,
    16, 16) meshes: each argument's global shape and dtype leaf by leaf,
    each in / out ``PartitionSpec`` and ``donate`` equal to the reference's
    ``build_cell``.  The reference's PRNG-key arguments are typed keys
    (shape ``()``, ``key<fry>``); the port's are ``(2,)`` int64 word pairs
    (``core/prng.py``), the one mapped difference.  The reference side is
    built once in a subprocess with 512 fake CPU devices
    (``test_distributed._run``'s prelude, started when the module starts)
    and never lowered;
  * one SMOKE cell a family run on both packages on the same inputs: the
    reference's jitted on a one-device (1, 1) mesh, the port's
    ``Cell.fn`` over a one-rank gloo group (a subprocess importing only the
    port, a ``file://`` store in the test's temporary directory): qwen
    decode and train, deepseek prefill (tensor-parallel products and
    expert parallelism on one rank), granite decode through expert
    parallelism, GIN on
    molecules, dlrm serve, SASRec retrieval and Pixie's replicated cell on
    ``small_test_graph``.  Floats within 2e-6 times max(1, the reference
    leaf's largest magnitude) (the LM, MoE, recsys and GIN families' rule;
    the decode configs keep a float32 cache, as ``test_torch_lm.py``
    does), ids and integers exact, Pixie's scores bit for bit;
  * ``roofline_report.model_flops`` equal to the reference's for every
    cell;
  * ``ShardedWalkConfig(unroll=True)``: the same bits as ``unroll=False``
    and as the reference's loop-free ``unroll=True`` on a 4-shard mesh.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.graphs.synthetic import small_test_graph, top_degree_pins
from repro.launch import cells as jcells
from repro.launch import roofline_report as jroof
from repro.launch.mesh import make_mesh_compat, set_mesh_compat
from repro.models import dlrm as jdlrm
from repro.models import gnn as jgnn
from repro.models import sequential_rec as jseq
from repro.models import transformer as jtf
from repro.training import optim as joptim
from repro_torch.configs import registry as treg
from repro_torch.core import distributed as tdist
from repro_torch.core import prng
from repro_torch.graphs import synthetic as tsyn
from repro_torch.launch import cells as tcells
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline_report as troof
from repro_torch.models import dlrm as tdlrm
from repro_torch.models import gnn as tgnn
from repro_torch.models import sequential_rec as tseq
from repro_torch.models import transformer as ttf
from repro_torch.training import tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-6
CPU = torch.device("cpu")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
CELLS = [(a, c.name) for a in jreg.all_archs() for c in jreg.get_arch(a).shapes]
UNROLL_CFG = dict(n_supersteps=16, walkers_per_shard=64, top_k=20, slack=8.0)
UNROLL_QUERY = ([0, 5, 17, -1], [1.0, 2.0, 0.5, 0.0])

_REFERENCE_BODY = """
    import functools, math
    from jax.sharding import Mesh
    from repro.configs import registry
    from repro.core import distributed as D
    from repro.graphs.synthetic import small_test_graph
    from repro.launch import cells as C
    from repro.models import dlrm, gnn, sequential_rec, transformer
    from repro.training.checkpoint import _flatten_with_names

    # the builds share each config's abstract tree (eval_shape of an init)
    for m in (dlrm, gnn, sequential_rec, transformer):
        m.abstract_params = functools.lru_cache(None)(m.abstract_params)
    MESHES = json.loads('''%s''')
    devs = np.array(jax.devices())
    enc = lambda s: [list(p) if isinstance(p, tuple) else p for p in s]

    def leaves(tree):
        names, ls, _ = _flatten_with_names(tree)
        return [[n, list(l.shape), str(l.dtype)] for n, l in zip(names, ls)]

    def specs(tree):
        names, ls, _ = _flatten_with_names(tree)
        return [[n, enc(l.spec)] for n, l in zip(names, ls)]

    out = {}
    for mname, (shape, axes) in MESHES.items():
        mesh = Mesh(devs[:math.prod(shape)].reshape(shape), tuple(axes))
        for arch in registry.all_archs():
            spec = registry.get_arch(arch)
            for cell in spec.shapes:
                c = C.build_cell(spec, cell, mesh)
                out[f"{arch}/{cell.name}/{mname}"] = {
                    "args": [leaves(a) for a in c.args],
                    "in": [specs(s) for s in c.in_shardings],
                    "out": specs(c.out_shardings), "donate": list(c.donate)}

    # the sharded walk with and without unroll on a 4-shard mesh
    sg = small_test_graph(0)
    shg = D.shard_graph(sg.graph, 4)
    mesh4 = Mesh(devs[:4], ("model",))
    qp = jnp.asarray(%s, jnp.int32)
    qw = jnp.asarray(%s, jnp.float32)
    walks = {}
    for unroll in (False, True):
        cfg = D.ShardedWalkConfig(unroll=unroll, **json.loads('''%s'''))
        r = jax.jit(lambda q, w, k: D.pixie_walk_sharded(shg, q, w, k, cfg, mesh4))(
            qp, qw, jax.random.key(3))
        walks[str(unroll)] = {"scores": np.asarray(r.top_scores).view(np.int32).tolist(),
                              "pins": np.asarray(r.top_pins).tolist(),
                              "dropped": int(r.dropped)}
    out["_unroll"] = walks
    print(json.dumps(out))
"""


_PRELUDE = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import json
    import jax
    import jax.numpy as jnp
    import numpy as np
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_proc():
    """The reference's 512-device subprocess (``test_distributed._run``'s
    prelude), started first so that it runs while the SMOKE cells do."""
    body = _REFERENCE_BODY % (json.dumps(MESHES), UNROLL_QUERY[0], UNROLL_QUERY[1],
                              json.dumps(UNROLL_CFG))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(_PRELUDE)
                             + textwrap.dedent(body)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    yield proc
    proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def ref(_reference_proc):
    out, err = _reference_proc.communicate(timeout=540)
    assert _reference_proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def cached_abstracts():
    """The port's builds share each config's abstract tree too (the cells
    read them through the model modules)."""
    mods = (tdlrm, tgnn, tseq, ttf)
    orig = {m: m.abstract_params for m in mods}
    for m in mods:
        m.abstract_params = functools.lru_cache(None)(m.abstract_params)
    yield
    for m, f in orig.items():
        m.abstract_params = f


def _dtype(x) -> str:
    return str(x).replace("torch.", "")


def _port_leaves(tree_):
    names, ls = tree.flatten_with_names(tree_)
    for x in ls:
        assert x.device.type == "meta", f"{x.device}: an argument allocated"
    return [[n, list(x.shape), _dtype(x.dtype)] for n, x in zip(names, ls)]


def _port_specs(tree_):
    names, ls = tree.flatten_with_names(tree_)
    return [[n, [list(p) if isinstance(p, tuple) else p for p in x.spec]]
            for n, x in zip(names, ls)]


def _as_port_key(leaves):
    """The reference's typed keys as the port's (2,) int64 word pairs."""
    return [[n, [2], "int64"] if dt.startswith("key<") and shape == [] else [n, shape, dt]
            for n, shape, dt in leaves]


# ---------------------------------------------------------------------------
# SMOKE cells on both packages
# ---------------------------------------------------------------------------

# name -> (arch, shape, shape params, config overrides, n_micro)
SMOKE_CASES = {
    "qwen_decode": ("qwen2.5-3b", "decode_32k", {"seq_len": 16, "global_batch": 2},
                    {"cache_dtype": "float32"}, None),
    "deepseek_prefill": ("deepseek-moe-16b", "prefill_32k", {"seq_len": 16, "global_batch": 2},
                         {"cache_dtype": "float32", "moe.ep_shard_map": True}, None),
    "qwen_train": ("qwen2.5-3b", "train_4k", {"seq_len": 16, "global_batch": 4}, {}, 2),
    "granite_ep_decode": ("granite-moe-3b-a800m", "decode_32k",
                          {"seq_len": 16, "global_batch": 2},
                          {"cache_dtype": "float32", "moe.ep_shard_map": True}, None),
    "gin_molecule": ("gin-tu", "molecule", {"batch": 4}, {}, None),
    "dlrm_serve": ("dlrm-rm2", "serve_p99", {"batch": 8}, {}, None),
    "sasrec_retrieval": ("sasrec", "retrieval_cand", {"n_candidates": 300}, {}, None),
    "pixie_replicated": ("pixie", "serve_200m_replicated", {}, {}, None),
}
PIXIE_SLOTS = 8


def _override(cfg, over: dict, dtypes):
    """``cfg`` with ``over`` applied (``"moe.x"`` reaches a nested config;
    dtype names through ``dtypes``)."""
    for key, val in over.items():
        if "." in key:
            outer, inner = key.split(".")
            cfg = dataclasses.replace(cfg, **{outer: dataclasses.replace(
                getattr(cfg, outer), **{inner: val})})
        else:
            cfg = dataclasses.replace(cfg, **{key: dtypes(val) if key.endswith("dtype") else val})
    return cfg


def _pixie_params(sg):
    g = sg.graph
    return {"n_pins": g.n_pins, "n_boards": g.n_boards, "n_edges": int(g.p2b.targets.shape[0]),
            "n_slots": PIXIE_SLOTS}


def _ref_case(name, sg):
    arch, shape, params, over, n_micro = SMOKE_CASES[name]
    spec = jreg.get_arch(arch)
    cfg = _override(spec.smoke_config, over, lambda v: getattr(jnp, v))
    spec = dataclasses.replace(spec, config=cfg)
    if name == "pixie_replicated":
        params = _pixie_params(sg)
    cell = next(c for c in spec.shapes if c.name == shape)
    cell = dataclasses.replace(cell, params={**cell.params, **params})
    return spec, cell, n_micro


def _inputs(name, spec, cell, c, sg):
    """Seeded inputs of the reference's cell ``c``, as the reference's
    argument trees."""
    rng = np.random.default_rng(sum(map(ord, name)))
    key = jax.random.key(len(name))
    cfg = spec.config
    if name in ("qwen_decode", "granite_ep_decode"):
        params_abs, cache_abs, tok_abs, _ = c.args
        params = jtf.init_params(key, cfg)
        cache = {k: jnp.asarray(rng.normal(size=v.shape), v.dtype) for k, v in cache_abs.items()}
        tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, tok_abs.shape), jnp.int32)
        return (params, cache, tokens, jnp.asarray(9, jnp.int32))
    if name == "deepseek_prefill":
        params = jtf.init_params(key, cfg)
        b, s = c.args[1].shape
        return (params, jnp.asarray(rng.integers(0, cfg.vocab_size, (b, s)), jnp.int32))
    if name == "qwen_train":
        params = jtf.init_params(key, cfg)
        b, s = c.args[1]["tokens"].shape
        batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (b, s)), jnp.int32),
                 "labels": jnp.asarray(rng.integers(0, cfg.vocab_size, (b, s)), jnp.int32),
                 "mask": jnp.asarray(rng.random((b, s)) > 0.2, jnp.float32)}
        return ((params, joptim.init(params)), batch)
    if name == "gin_molecule":
        p = cell.params
        gcfg = dataclasses.replace(cfg, d_in=p["d_feat"], n_classes=p["n_classes"],
                                   readout="sum")
        params = jgnn.init_params(key, gcfg)
        n, e, g = p["n_nodes"], p["n_edges"], p["batch"]
        base = np.repeat(np.arange(g) * n, e)
        batch = {"feats": jnp.asarray(rng.normal(size=(n * g, p["d_feat"])), jnp.float32),
                 "edge_src": jnp.asarray(base + rng.integers(0, n, e * g), jnp.int32),
                 "edge_dst": jnp.asarray(base + rng.integers(0, n, e * g), jnp.int32),
                 "graph_ids": jnp.asarray(np.repeat(np.arange(g), n), jnp.int32),
                 "labels": jnp.asarray(rng.integers(0, p["n_classes"], g), jnp.int32)}
        return ((params, joptim.init(params)), batch)
    if name == "dlrm_serve":
        b = cell.params["batch"]
        rows = np.asarray(cfg.feature_rows)
        return (jdlrm.init_params(key, cfg),
                jnp.asarray(rng.normal(size=(b, cfg.n_dense)), jnp.float32),
                jnp.asarray(rng.integers(0, rows, (b, cfg.n_sparse)), jnp.int32))
    if name == "sasrec_retrieval":
        seq = rng.integers(0, cfg.n_items, (1, cfg.seq_len))
        seq[0, :3] = -1
        cand = rng.permutation(cfg.n_items)[:cell.params["n_candidates"]]
        return (jseq.init_params(key, cfg), jnp.asarray(seq, jnp.int32),
                jnp.asarray(cand, jnp.int32))
    if name == "pixie_replicated":
        g = sg.graph
        pins = np.asarray(top_degree_pins(sg, 3))
        qp = np.full((1, PIXIE_SLOTS), -1, np.int32)
        qw = np.zeros((1, PIXIE_SLOTS), np.float32)
        qp[0, :3], qw[0, :3] = pins, (1.0, 2.0, 0.5)
        arr = lambda a: jnp.asarray(np.asarray(a), jnp.int32)
        return (arr(g.p2b.offsets), arr(g.p2b.targets), arr(g.b2p.offsets),
                arr(g.b2p.targets), jnp.asarray(qp), jnp.asarray(qw),
                jnp.zeros((1,), jnp.int32), jax.random.key(5))
    raise KeyError(name)


def _flat(tree_):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree_)
    return ["/".join(str(k) for k in p) for p, _ in flat], [x for _, x in flat]


def _host(x) -> np.ndarray:
    if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
        return np.asarray(jax.random.key_data(x)).astype(np.int64)
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


_PORT_SCRIPT = """
import dataclasses, json, sys
import numpy as np, torch
import torch.distributed as dist
from repro_torch.configs import get_arch
from repro_torch.distribution import sharding
from repro_torch.launch import cells as C
from repro_torch.launch import mesh as M
from repro_torch.training import tree

job = json.loads(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + job["store"], world_size=1, rank=0)
mesh = M.process_group_mesh((1, 1), ("data", "model"), device="cpu")
for case in job["cases"]:
    spec = get_arch(case["arch"])
    cfg = spec.smoke_config
    for key, val in case["over"].items():
        if "." in key:
            outer, inner = key.split(".")
            cfg = dataclasses.replace(cfg, **{outer: dataclasses.replace(
                getattr(cfg, outer), **{inner: val})})
        else:
            cfg = dataclasses.replace(cfg, **{key: getattr(torch, val)})
    spec = dataclasses.replace(spec, config=cfg)
    cell = next(c for c in spec.shapes if c.name == case["shape"])
    cell = dataclasses.replace(cell, params={**cell.params, **case["params"]})
    kw = {"n_micro": case["n_micro"]} if case["n_micro"] else {}
    c = C.build_cell(spec, cell, mesh, **kw)
    data = np.load(case["inputs"])
    whole, names = [], []
    for i, a in enumerate(c.args):
        ns, metas = tree.flatten_with_names(a)
        names.append(ns)
        whole.append(tree.unflatten(a, [
            torch.from_numpy(data[f"a{i}_{j}"]).to(m.dtype) for j, m in enumerate(metas)]))
    out = sharding.gather_state(c.fn(*C.place(c, tuple(whole))))
    onames, leaves = tree.flatten_with_names(out)
    host = lambda x: (x.float() if x.dtype == torch.bfloat16 else x).detach().numpy()
    np.savez(case["outputs"], **{f"o{j}": host(x) for j, x in enumerate(leaves)})
    with open(case["outputs"] + ".json", "w") as f:
        json.dump({"args": names, "out": onames}, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    """Every SMOKE case on both packages: ``{name: (reference out names,
    reference leaves, port names, port leaves, reference arg names)}``."""
    tmp = tmp_path_factory.mktemp("cells")
    sg = small_test_graph(0)
    ref_out, job = {}, {"store": str(tmp / "store"), "cases": []}
    for name in SMOKE_CASES:
        spec, cell, n_micro = _ref_case(name, sg)
        mesh = make_mesh_compat((1, 1), ("data", "model"))
        with set_mesh_compat(mesh):
            kw = {"n_micro": n_micro} if n_micro else {}
            c = jcells.build_cell(spec, cell, mesh, **kw)
            args = _inputs(name, spec, cell, c, sg)
            arg_names = [_flat(a)[0] for a in args]
            np.savez(tmp / f"{name}_in.npz", **{
                f"a{i}_{j}": _host(x) for i, a in enumerate(args)
                for j, x in enumerate(_flat(a)[1])})
            fn = jax.jit(c.fn, in_shardings=c.in_shardings, out_shardings=c.out_shardings,
                         donate_argnums=c.donate)
            names, leaves = _flat(fn(*args))
        ref_out[name] = (names, [_host(x) for x in leaves], arg_names)
        arch, shape, params, over, _ = SMOKE_CASES[name]
        job["cases"].append(dict(
            arch=arch, shape=shape, over=over, n_micro=n_micro,
            params=dict(cell.params) if name == "pixie_replicated" else params,
            inputs=str(tmp / f"{name}_in.npz"), outputs=str(tmp / f"{name}_out.npz")))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(_PORT_SCRIPT), json.dumps(job)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    out = {}
    for case, name in zip(job["cases"], SMOKE_CASES):
        data = np.load(case["outputs"])
        with open(case["outputs"] + ".json") as f:
            meta = json.load(f)
        got = [data[f"o{j}"] for j in range(len(meta["out"]))]
        out[name] = ref_out[name] + (meta["out"], got, meta["args"])
    return out


@pytest.mark.parametrize("name", list(SMOKE_CASES))
def test_smoke_cell_matches_reference(smoke, name):
    ref_names, ref_leaves, ref_args, names, leaves, args = smoke[name]
    assert args == ref_args
    assert names == ref_names
    for n, got, want in zip(names, leaves, ref_leaves):
        assert got.shape == want.shape and got.dtype == want.dtype, n
        if name == "pixie_replicated" and want.dtype == np.float32:
            np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32), err_msg=n)
        elif np.issubdtype(want.dtype, np.floating):
            scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
            err = float(np.abs(got.astype(np.float64) - want).max()) if want.size else 0.0
            assert err <= TOL * scale, f"{name} {n}: {err} > {TOL} x {scale}"
        else:
            np.testing.assert_array_equal(got, want, err_msg=n)


def test_smoke_cells_ran_the_paths_they_name(smoke):
    """The cases reach what they are for: the trained state moved, the
    retrieval is sorted and distinct, the walk scored its top pins."""
    _, ref_leaves, _, names, leaves, _ = smoke["qwen_train"]
    assert float(dict(zip(names, leaves))["[1]/['loss']"]) > 0
    _, _, _, names, leaves, _ = smoke["sasrec_retrieval"]
    vals, ids = leaves
    assert (np.diff(vals[0]) <= 0).all() and len(set(ids[0].tolist())) == 100
    _, _, _, names, leaves, _ = smoke["pixie_replicated"]
    assert (leaves[0][0, :5] > 0).all()


# ---------------------------------------------------------------------------
# Specs, model FLOPs and unroll against the reference's 512-device build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_cell_args_specs_and_donation_equal_reference(ref, cached_abstracts, arch, shape,
                                                      mesh_name):
    spec = treg.get_arch(arch)
    cell = next(c for c in spec.shapes if c.name == shape)
    mesh = tmesh.make_production_mesh(multi_pod=mesh_name == "multi")
    c = tcells.build_cell(spec, cell, mesh)
    want = ref[f"{arch}/{shape}/{mesh_name}"]
    assert [_port_leaves(a) for a in c.args] == [_as_port_key(a) for a in want["args"]]
    assert [_port_specs(s) for s in c.in_shardings] == want["in"]
    assert _port_specs(c.out_shardings) == want["out"]
    assert list(c.donate) == want["donate"]
    assert len(c.forms) == len(c.args) and set(c.forms) <= set(tcells.FORMS)


@pytest.mark.parametrize("arch,shape", CELLS, ids=[f"{a}-{s}" for a, s in CELLS])
def test_model_flops_equal_reference(arch, shape):
    kind = next(c.kind for c in jreg.get_arch(arch).shapes if c.name == shape)
    assert troof.model_flops(arch, shape, kind) == jroof.model_flops(arch, shape, kind)


def test_sharded_walk_unroll_changes_no_bit(ref):
    sg = tsyn.small_test_graph(0, device="cpu")
    shg = tdist.shard_graph(sg.graph, 4)
    qp = torch.tensor(UNROLL_QUERY[0], dtype=torch.int32)
    qw = torch.tensor(UNROLL_QUERY[1], dtype=torch.float32)
    for unroll in (False, True):
        cfg = tdist.ShardedWalkConfig(unroll=unroll, **UNROLL_CFG)
        r = tdist.pixie_walk_sharded(shg, qp, qw, prng.key(3, CPU), cfg,
                                     tdist.LocalFabric(4, device=CPU))
        got = {"scores": r.top_scores.view(torch.int32).tolist(),
               "pins": r.top_pins.tolist(), "dropped": int(r.dropped)}
        assert got == ref["_unroll"][str(unroll)]
    assert ref["_unroll"]["True"] == ref["_unroll"]["False"]
