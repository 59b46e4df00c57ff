"""Tensor-parallel LM serving (``sharding.TensorParallel``) against the JAX
package's GSPMD-sharded serving cells.

  * ``transformer.prefill`` and ``decode_step`` with ``tp=`` on a local
    (1, 4) mesh (in this process), and the port's prefill and decode cells
    (``launch/cells.py``) over 4 spawned gloo ranks on (1, 4) and (2, 2)
    meshes, against the reference's ``build_cell`` prefill and decode
    jitted with the cells' in / out shardings on a 4-device CPU mesh of the
    same shape (one module subprocess with four fake devices, every call
    jitted, compiled side by side in a thread pool; the gloo ranks run
    beside it): qwen2.5-3b SMOKE (GQA, random qkv biases), granite SMOKE
    with its heads padded 4 -> 8 (two of four shards hold only pad heads),
    its vocabulary 509 -> 512 and its experts 8 -> 12 with
    ``ep_shard_map``, and deepseek SMOKE (shared experts, ``dense0``) with
    ``ep_shard_map``, all in float32 with a float32 cache.  Prefill's
    logits and its ``kv_seq``-blocked cache; four decode steps on a seeded
    cache of 16 positions in blocks of 4: ``pos`` 0 (blocks 1-3 empty),
    ``pos`` 4 (a block's first position), 9 with the wrapping ids ``-1``,
    ``-V`` and ``-V_pad`` among the tokens, and 15 (the last);
  * routing over the global batch (``moe.moe_ffn_global`` in
    ``transformer._moe_tp``): granite SMOKE with its experts padded 8 ->
    12 and deepseek SMOKE, both without ``ep_shard_map``, on the (2, 2)
    gloo ranks against the reference's GSPMD cells (``moe_ffn`` on every
    data rank's tokens: one capacity, one expert order, the aux from the
    global means); their prompts are skewed (six token ids) so that the
    prefill's cut binds, which each test asserts (``moe.kept_assignments``:
    some expert past its global capacity, and the per-rank cuts keep
    another set); decode routes 4 tokens under a capacity of 8, so there
    the route keeps every assignment, as the reference's does;
  * the vocab-parallel lookup with the ids ``-1``, ``-V``, ``-V_pad``,
    ``V_pad``, ``V_pad + 3`` and ``-V_pad - 1`` against the reference's
    ``jnp.take`` of a table split over 'model': wrapped rows, NaN rows;
  * ``decode_attention_partial``'s twin over four blocks merged by
    ``merge_partials`` against the whole-cache ``decode_attention_plain``
    (empty blocks, a length on a block's edge, per-row lengths), and the
    kernel against its twin on the card (``cuda``).

Tolerance: floats within 2e-6 times max(1, the reference's largest
magnitude) (the LM family's rule: GSPMD and the port sum the partial
products over 'model' in their own orders); the padded vocabulary's
logits exactly -1e30; greedy tokens and NaN positions exact.  The file
imports no jax: the reference runs in its subprocess only.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.distribution import sharding
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from test_torch_moe_global import assert_global_cut_binds, routes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-6
CPU = torch.device("cpu")
BATCH, PROMPT, CACHE = 4, 16, 16
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# name -> (arch, config overrides (dtypes by name; "moe.x" a nested field))
CASES = {
    "qwen": ("qwen2.5-3b", {"cache_dtype": "float32"}),
    "granite": ("granite-moe-3b-a800m", {
        "cache_dtype": "float32", "pad_heads_to": 8, "vocab_size": 509,
        "pad_vocab_to": 512, "moe.pad_experts_to": 12, "moe.ep_shard_map": True}),
    "deepseek": ("deepseek-moe-16b", {"cache_dtype": "float32",
                                      "moe.ep_shard_map": True}),
}
# routing over the global batch: the (2, 2) mesh only (one data rank
# routes its tokens alone, as the cases above do)
GLOBAL_CASES = {
    "granite_global": ("granite-moe-3b-a800m", {"cache_dtype": "float32",
                                                "moe.pad_experts_to": 12,
                                                "moe.ep_shard_map": False}),
    "deepseek_global": ("deepseek-moe-16b", {"cache_dtype": "float32",
                                             "moe.ep_shard_map": False}),
}
ALL_CASES = {**CASES, **GLOBAL_CASES}
GLOBAL_PROMPT_IDS = 6          # the skewed prompts draw from this many ids
DECODE_POS = (0, 4, 9, 15)
WRAP_STEP = 2          # the step whose tokens hold -1, -V and -V_pad
MODES = ["local_1x4", "gloo_1x4", "gloo_2x2"]


def _port_config(name):
    """The case's SMOKE config with its overrides, as the port's."""
    import dataclasses

    arch, over = ALL_CASES[name]
    cfg = get_arch(arch).smoke_config
    for key, val in over.items():
        if "." in key:
            outer, inner = key.split(".")
            cfg = dataclasses.replace(cfg, **{outer: dataclasses.replace(
                getattr(cfg, outer), **{inner: val})})
        else:
            cfg = dataclasses.replace(cfg, **{key: getattr(torch, val)
                                              if key.endswith("dtype") else val})
    return cfg


def _ids(cfg):
    v, vp = cfg.vocab_size, cfg.vocab_padded
    return [-1, -v, -vp, vp, vp + 3, -vp - 1, 0, vp - 1]


def _write_inputs(path):
    """Seeded numpy parameters, prompts, caches and tokens for every case,
    flattened by name (``case/params/blocks/wq``)."""
    arrays = {}
    for ci, name in enumerate(ALL_CASES):
        cfg = _port_config(name)
        rng = np.random.default_rng(100 + ci)
        names, leaves = _flat(tf.abstract_params(cfg))
        for n, x in zip(names, leaves):
            shape = tuple(x.shape)
            if n.split("/")[-1] in ("ln1", "ln2", "final_norm"):
                a = 1.0 + 0.1 * rng.normal(size=shape)
            elif n.split("/")[-1] in ("bq", "bk", "bv"):
                a = 0.3 * rng.normal(size=shape)
            else:
                a = rng.normal(size=shape) / np.sqrt(cfg.d_model)
            arrays[f"{name}/params/{n}"] = a.astype(np.float32)
        ids = GLOBAL_PROMPT_IDS if name in GLOBAL_CASES else cfg.vocab_size
        arrays[f"{name}/prompt"] = rng.integers(0, ids, (BATCH, PROMPT), dtype=np.int32)
        shape = (cfg.n_layers, BATCH, CACHE, cfg.n_kv_heads, cfg.head_dim)
        arrays[f"{name}/cache_k"] = rng.normal(size=shape).astype(np.float32)
        arrays[f"{name}/cache_v"] = rng.normal(size=shape).astype(np.float32)
        toks = rng.integers(0, cfg.vocab_size, (len(DECODE_POS), BATCH)).astype(np.int32)
        toks[WRAP_STEP, :3] = (-1, -cfg.vocab_size, -cfg.vocab_padded)
        arrays[f"{name}/tokens"] = toks
        arrays[f"{name}/ids"] = np.asarray(_ids(cfg), np.int32)
    np.savez(path, **arrays)


def _flat(tree_, prefix=""):
    if isinstance(tree_, dict):
        names, leaves = [], []
        for k, v in tree_.items():
            n, l = _flat(v, f"{prefix}{k}/")
            names += n
            leaves += l
        return names, leaves
    return [prefix[:-1]], [tree_]


def _unflat(flat: dict, prefix: str) -> dict:
    out = {}
    for name, v in flat.items():
        if name.startswith(prefix):
            keys = name[len(prefix):].split("/")
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = v
    return out


# ---------------------------------------------------------------------------
# The reference: GSPMD cells on four fake CPU devices
# ---------------------------------------------------------------------------

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, sys
from concurrent.futures import ThreadPoolExecutor
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import registry
from repro.launch import cells as C
from repro.launch.mesh import set_mesh_compat

K = json.loads(sys.argv[1])
inp = dict(np.load(K["inp"]))
devs = np.array(jax.devices()[:4])


def config(arch, over):
    cfg = registry.get_arch(arch).smoke_config
    for key, val in over.items():
        if "." in key:
            outer, inner = key.split(".")
            cfg = dataclasses.replace(cfg, **{outer: dataclasses.replace(
                getattr(cfg, outer), **{inner: val})})
        else:
            cfg = dataclasses.replace(cfg, **{key: getattr(jnp, val)
                                              if key.endswith("dtype") else val})
    return cfg


def unflat(prefix):
    out = {}
    for name, v in inp.items():
        if name.startswith(prefix):
            keys = name[len(prefix):].split("/")
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = jnp.asarray(v)
    return out


def cell(spec, kind, params):
    base = next(c for c in spec.shapes if c.kind == kind and c.params["global_batch"] > 1)
    return dataclasses.replace(base, params={**base.params, **params})


def job(name, arch, over, mname, shape):
    cfg = config(arch, over)
    spec = dataclasses.replace(registry.get_arch(arch), config=cfg)
    mesh = Mesh(devs.reshape(shape), ("data", "model"))
    params = unflat(name + "/params/")
    res = {}
    with set_mesh_compat(mesh):
        c = C.build_cell(spec, cell(spec, "prefill", {"seq_len": K["prompt"],
                                                      "global_batch": K["batch"]}), mesh)
        fn = jax.jit(c.fn, in_shardings=c.in_shardings, out_shardings=c.out_shardings)
        logits, cache = fn(params, jnp.asarray(inp[name + "/prompt"]))
        res["prefill/logits"] = logits
        res["prefill/k"], res["prefill/v"] = cache["k"], cache["v"]
        c = C.build_cell(spec, cell(spec, "decode", {"seq_len": K["cache"],
                                                     "global_batch": K["batch"]}), mesh)
        fn = jax.jit(c.fn, in_shardings=c.in_shardings, out_shardings=c.out_shardings,
                     donate_argnums=c.donate)
        for i, pos in enumerate(K["pos"]):
            cache = {"k": jnp.asarray(inp[name + "/cache_k"]),
                     "v": jnp.asarray(inp[name + "/cache_v"])}
            logits, cache = fn(params, cache, jnp.asarray(inp[name + "/tokens"][i]),
                               jnp.asarray(pos, jnp.int32))
            res[f"decode{i}/logits"] = logits
            res[f"decode{i}/k"], res[f"decode{i}/v"] = cache["k"], cache["v"]
        # the vocab-parallel lookup alone: the table split over 'model'
        take = jax.jit(lambda e, t: jnp.take(e.astype(cfg.compute_dtype), t, axis=0),
                       in_shardings=(NamedSharding(mesh, P("model", None)),
                                     NamedSharding(mesh, P())))
        res["embed"] = take(params["embed"], jnp.asarray(inp[name + "/ids"]))
    return {f"{name}/{mname}/{k}": np.asarray(v) for k, v in res.items()}


jobs = [(n, a, o, m, s) for n, (a, o) in K["cases"].items() for m, s in K["meshes"].items()
        if m in K["case_meshes"][n]]
with ThreadPoolExecutor(len(jobs)) as pool:
    parts = list(pool.map(lambda j: job(*j), jobs))
out = {}
for p in parts:
    out.update(p)
np.savez(K["out"], **out)
print(json.dumps({"n": len(out)}))
"""


# ---------------------------------------------------------------------------
# The port over four gloo ranks: the cells on (1, 4) and (2, 2)
# ---------------------------------------------------------------------------

_GLOO = """
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_arch
from repro_torch.launch import cells as C
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as tf
from repro_torch.training import tree

rank, init, K = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
torch.set_num_threads(1)      # four ranks beside the reference's process
dist.init_process_group("gloo", init_method=init, world_size=4, rank=rank)
cpu = torch.device("cpu")
inp = dict(np.load(K["inp"]))


def config(arch, over):
    cfg = get_arch(arch).smoke_config
    for key, val in over.items():
        if "." in key:
            outer, inner = key.split(".")
            cfg = dataclasses.replace(cfg, **{outer: dataclasses.replace(
                getattr(cfg, outer), **{inner: val})})
        else:
            cfg = dataclasses.replace(cfg, **{key: getattr(torch, val)
                                              if key.endswith("dtype") else val})
    return cfg


def unflat(prefix):
    out = {}
    for name, v in inp.items():
        if name.startswith(prefix):
            keys = name[len(prefix):].split("/")
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = torch.from_numpy(v)
    return out


def cell(spec, kind, params):
    base = next(c for c in spec.shapes if c.kind == kind and c.params["global_batch"] > 1)
    return dataclasses.replace(base, params={**base.params, **params})


def whole(mesh, outs, shardings):
    leaves = [DTensor.from_local(x.contiguous(), mesh.device_mesh, s.placements,
                                 run_check=False).full_tensor()
              for x, s in zip(tree.leaves(outs), tree.leaves(shardings))]
    return tree.unflatten(outs, leaves)


out = {}
for mname, shape in K["meshes"].items():
    mesh = M.process_group_mesh(shape, ("data", "model"), device=cpu)
    for name, (arch, over) in K["cases"].items():
        if mname not in K["case_meshes"][name]:
            continue
        cfg = config(arch, over)
        spec = dataclasses.replace(get_arch(arch), config=cfg)
        params = unflat(name + "/params/")
        c = C.build_cell(spec, cell(spec, "prefill", {"seq_len": K["prompt"],
                                                      "global_batch": K["batch"]}), mesh)
        got = c.fn(*C.place(c, (params, torch.from_numpy(inp[name + "/prompt"]))))
        logits, cache = whole(mesh, got, c.out_shardings)
        out[f"{name}/{mname}/prefill/logits"] = logits.numpy()
        for k in "kv":
            out[f"{name}/{mname}/prefill/{k}"] = cache[k].numpy()
        c = C.build_cell(spec, cell(spec, "decode", {"seq_len": K["cache"],
                                                     "global_batch": K["batch"]}), mesh)
        for i, pos in enumerate(K["pos"]):
            cache = {k: torch.from_numpy(inp[f"{name}/cache_{k}"]) for k in "kv"}
            args = (params, cache, torch.from_numpy(inp[name + "/tokens"][i]),
                    torch.tensor(pos, dtype=torch.int32))
            got = c.fn(*C.place(c, args))
            logits, cache = whole(mesh, got, c.out_shardings)
            out[f"{name}/{mname}/decode{i}/logits"] = logits.numpy()
            for k in "kv":
                out[f"{name}/{mname}/decode{i}/{k}"] = cache[k].numpy()
if rank == 0:
    np.savez(K["out"], **out)
dist.destroy_process_group()
print(json.dumps({"rank": rank}))
"""


def _whole_cache(cache: dict) -> dict:
    """A local mesh's cache ``(L, n, b, s_loc, kh, dh)`` (the kv_seq blocks
    stacked after 'layers') as the whole ``(L, b, n * s_loc, kh, dh)``."""
    return {k: v.movedim(1, 2).flatten(2, 3) for k, v in cache.items()}


def _local_outputs(inp) -> dict:
    """The port's tensor-parallel prefill and decode on a local (1, 4) mesh,
    in this process."""
    out = {}
    mesh = tmesh.local_mesh((1, 4), device=CPU)
    pre = sharding.TensorParallel(mesh, sharding.LM_TRAIN_RULES, sharding.LM_SERVE_RULES)
    serve = sharding.LM_SERVE_RULES.with_overrides(heads=None, embed=None)
    dec = sharding.TensorParallel(mesh, serve)
    cache_logical = tf.kv_cache_logical()
    for name in CASES:
        cfg = _port_config(name)
        whole = _unflat({k: torch.from_numpy(v) for k, v in inp.items()}, name + "/params/")
        logical = tf.param_logical(cfg)
        with torch.no_grad():
            logits, cache = tf.prefill(pre.local_form(whole, logical),
                                       torch.from_numpy(inp[name + "/prompt"]), cfg,
                                       max_seq=PROMPT, tp=pre)
        cache = _whole_cache(cache)
        out[f"{name}/1x4/prefill/logits"] = logits.numpy()
        for k in "kv":
            out[f"{name}/1x4/prefill/{k}"] = cache[k].numpy()
        params = dec.local_form(whole, logical)
        for i, pos in enumerate(DECODE_POS):
            cache = dec.local_form({k: torch.from_numpy(inp[f"{name}/cache_{k}"])
                                    for k in "kv"}, cache_logical)
            cache = {k: v.contiguous() for k, v in cache.items()}   # the kernel's layout
            with torch.no_grad():
                logits, cache = tf.decode_step(params, cache,
                                               torch.from_numpy(inp[name + "/tokens"][i]),
                                               pos, cfg, tp=dec)
            cache = _whole_cache(cache)
            out[f"{name}/1x4/decode{i}/logits"] = logits.numpy()
            for k in "kv":
                out[f"{name}/1x4/decode{i}/{k}"] = cache[k].numpy()
        with torch.no_grad():
            out[f"{name}/1x4/embed"] = tf._embed_tp(
                params, torch.from_numpy(inp[name + "/ids"]), cfg, dec,
                tf.param_logical(cfg)).numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the four gloo ranks started side by
    side, the local mesh run here meanwhile: ``(reference, {mode:
    outputs})``, each a dict of arrays by ``case/mesh/output`` (and the
    inputs under ``"inputs"``)."""
    d = tmp_path_factory.mktemp("tp_serving")
    inp_path = str(d / "inp.npz")
    _write_inputs(inp_path)
    k = dict(inp=inp_path, cases=ALL_CASES, meshes=MESHES, prompt=PROMPT, cache=CACHE,
             batch=BATCH, pos=list(DECODE_POS),
             case_meshes={n: ["2x2"] if n in GLOBAL_CASES else list(MESHES)
                          for n in ALL_CASES})
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REFERENCE),
         json.dumps(dict(k, out=str(d / "ref.npz")))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    gk = json.dumps(dict(k, out=str(d / "gloo.npz")))
    gloo = [subprocess.Popen([sys.executable, "-c", _GLOO, str(r), f"file://{d / 'store'}", gk],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env) for r in range(4)]
    try:
        with np.load(inp_path) as f:
            inputs = dict(f)
        local = _local_outputs(inputs)
    finally:
        outs = [p.communicate(timeout=400) for p in [ref_proc] + gloo]
    for p, (_, err) in zip([ref_proc] + gloo, outs):
        assert p.returncode == 0, err[-3000:]
    ref = dict(np.load(d / "ref.npz"))
    gl = dict(np.load(d / "gloo.npz"))
    port = {"local_1x4": local, "gloo_1x4": gl, "gloo_2x2": gl, "inputs": inputs}
    return ref, port


def _mesh_of(mode: str) -> str:
    return mode.split("_")[1]


def _close(got, want, what: str, cfg=None, logits=False) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if logits and cfg.vocab_padded != cfg.vocab_size:
        assert (got[:, cfg.vocab_size:] == layers.NEG_INF).all(), what
        assert (want[:, cfg.vocab_size:] == layers.NEG_INF).all(), what
        got, want = got[:, :cfg.vocab_size], want[:, :cfg.vocab_size]
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = ~np.isnan(want)
    scale = max(1.0, float(np.abs(want[ok]).max())) if ok.any() else 1.0
    err = float(np.abs(got[ok].astype(np.float64) - want[ok]).max()) if ok.any() else 0.0
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"
    return err


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_tp_prefill_matches_reference(runs, mode, case):
    ref, port = runs
    cfg = _port_config(case)
    key = f"{case}/{_mesh_of(mode)}/prefill"
    got = port[mode]
    _close(got[key + "/logits"], ref[key + "/logits"], key, cfg, logits=True)
    for k in "kv":
        _close(got[f"{key}/{k}"], ref[f"{key}/{k}"], f"{key}/{k}")
    # the greedy next tokens, exactly
    assert np.array_equal(got[key + "/logits"].argmax(-1), ref[key + "/logits"].argmax(-1))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_tp_decode_matches_reference(runs, mode, case):
    ref, port = runs
    cfg = _port_config(case)
    got = port[mode]
    for i, pos in enumerate(DECODE_POS):
        key = f"{case}/{_mesh_of(mode)}/decode{i}"
        _close(got[key + "/logits"], ref[key + "/logits"], f"{key} pos {pos}", cfg,
               logits=True)
        assert np.array_equal(got[key + "/logits"].argmax(-1),
                              ref[key + "/logits"].argmax(-1)), key
        for k in "kv":
            _close(got[f"{key}/{k}"], ref[f"{key}/{k}"], f"{key}/{k}")


@pytest.mark.parametrize("case", list(GLOBAL_CASES))
def test_global_route_serving_matches_reference(runs, case):
    """Prefill and the four decode steps through routing over the global
    batch on the (2, 2) gloo ranks against the reference's GSPMD cells;
    the prompt makes the prefill's cut bind (the port's one-device routing
    of the whole batch, each MoE layer's selection)."""
    ref, port = runs
    cfg = _port_config(case)
    inp = port["inputs"]
    whole = _unflat({k: torch.from_numpy(v) for k, v in inp.items()}, case + "/params/")
    with torch.no_grad():
        sels = routes(lambda: tf.prefill(whole, torch.from_numpy(inp[case + "/prompt"]), cfg,
                                          max_seq=PROMPT))
    kept = assert_global_cut_binds(cfg, sels, MESHES["2x2"][0], case)
    got = port["gloo_2x2"]
    key = f"{case}/2x2/prefill"
    err = _close(got[key + "/logits"], ref[key + "/logits"], key, cfg, logits=True)
    for k in "kv":
        _close(got[f"{key}/{k}"], ref[f"{key}/{k}"], f"{key}/{k}")
    assert np.array_equal(got[key + "/logits"].argmax(-1), ref[key + "/logits"].argmax(-1))
    for i, pos in enumerate(DECODE_POS):
        key = f"{case}/2x2/decode{i}"
        _close(got[key + "/logits"], ref[key + "/logits"], f"{key} pos {pos}", cfg,
               logits=True)
        assert np.array_equal(got[key + "/logits"].argmax(-1),
                              ref[key + "/logits"].argmax(-1)), key
        for k in "kv":
            _close(got[f"{key}/{k}"], ref[f"{key}/{k}"], f"{key}/{k}")
    print(f"{case}: prefill logits {err:.3g} from the reference; kept (global, per rank, "
          f"of) by MoE layer {kept}")


@pytest.mark.parametrize("case", list(CASES))
def test_vocab_parallel_lookup_edge_ids_match_reference(runs, case):
    ref, port = runs
    for mname in MESHES:
        want = ref[f"{case}/{mname}/embed"]
        got = port["local_1x4"][f"{case}/1x4/embed"]
        assert np.array_equal(np.isnan(got).all(-1), np.isnan(want).all(-1)), mname
        assert np.isnan(got).any(-1).tolist() == [False, False, False, True, True, True,
                                                  False, False]
        np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


# ---------------------------------------------------------------------------
# The partial form and its merge
# ---------------------------------------------------------------------------

PARTIAL_CASES = [  # (b, h, kh, dh, block, lengths: an int or per-row list)
    (2, 8, 2, 16, 10, 1),            # blocks 1-3 empty
    (2, 8, 2, 16, 10, 10),           # block 0 full, the rest empty
    (2, 8, 2, 16, 10, 11),           # block 1 holds one position
    (3, 4, 4, 32, 16, 64),           # every block full
    (3, 6, 2, 8, 5, [1, 6, 20]),     # per-row: empty blocks in some rows
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", PARTIAL_CASES)
def test_partial_twin_merged_equals_whole_cache_twin(case, dtype):
    b, h, kh, dh, blk, lengths = case
    g = torch.Generator().manual_seed(sum(case[:5]))
    s = 4 * blk
    q = torch.randn(b, h, dh, generator=g).to(dtype)
    k = torch.randn(b, s, kh, dh, generator=g).to(dtype)
    v = torch.randn(b, s, kh, dh, generator=g).to(dtype)
    if isinstance(lengths, list):
        lengths = torch.tensor(lengths, dtype=torch.int32)
    parts = [ops.decode_attention_partial(q, k[:, i * blk:(i + 1) * blk].contiguous(),
                                          v[:, i * blk:(i + 1) * blk].contiguous(),
                                          i * blk, lengths, use_kernel=True)
             for i in range(4)]
    o, m, l = (torch.stack(t) for t in zip(*parts))
    assert torch.isfinite(o).all() and torch.isfinite(m).all() and torch.isfinite(l).all()
    n = lengths if isinstance(lengths, torch.Tensor) else torch.full((b,), lengths)
    for i in range(4):
        empty = n <= i * blk
        assert (m[i][empty] == da.NEG_INF).all() and (l[i][empty] == 0).all()
        assert (o[i][empty] == 0).all() and (l[i][~empty] >= 1).all()
    want = da.decode_attention_plain(q, k, v, lengths)
    err = (da.merge_partials(o, m, l) - want).abs().max().item()
    assert err <= TOL, err
    # one block of the whole cache: the merge gives its output bit for bit
    one = ops.decode_attention_partial(q, k, v, 0, lengths, use_kernel=False)
    assert torch.equal(da.merge_partials(*(t[None] for t in one)), one[0])
    assert (one[0] - want).abs().max().item() <= TOL
    assert _build.launches["decode_attention_partial"] == 0


def test_partial_form_refuses_what_the_kernel_cannot_take():
    q = torch.zeros((2, 4, 8))
    kv = torch.zeros((2, 5, 2, 8))
    for bad in (-1, torch.tensor([3, -2], dtype=torch.int32)):
        with pytest.raises(ValueError, match="every length"):
            ops.decode_attention_partial(q, kv, kv, 0, bad, use_kernel=False)
    with pytest.raises(ValueError, match="lo must be"):
        ops.decode_attention_partial(q, kv, kv, -5, 3, use_kernel=False)
    with pytest.raises(ValueError, match="runs on CUDA tensors"):
        da.decode_attention_partial(q, kv, kv, 0, 3)


def test_local_mesh_with_data_shards_is_refused():
    mesh = tmesh.local_mesh((2, 2), device=CPU)
    with pytest.raises(ValueError, match="local mesh serves tensor-parallel only"):
        sharding.TensorParallel(mesh, sharding.LM_SERVE_RULES)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [1, 8192, 8193, 32768, "rows"])
def test_decode_attention_partial_kernel_matches_twin_on_card(lengths):
    """The partial kernel against its twin at decode_32k's shape cut into
    4 blocks (bf16 cache, q bf16 and float32), and merged against the
    whole-cache kernel: o within 2e-6, m and l within 2e-6 times max(1,
    magnitude)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    dev = torch.device("cuda")
    b, h, kh, dh, s = 4, 16, 2, 128, 32768
    g = torch.Generator(device=dev).manual_seed(7)
    k = torch.randn(b, s, kh, dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(b, s, kh, dh, generator=g, device=dev).to(torch.bfloat16)
    if lengths == "rows":
        lengths = torch.tensor([1, 8192, 8193, 32768], dtype=torch.int32, device=dev)
    blk = s // 4
    for q_dtype in (torch.bfloat16, torch.float32):
        q = torch.randn(b, h, dh, generator=g, device=dev).to(q_dtype)
        parts = []
        for i in range(4):
            kb = k[:, i * blk:(i + 1) * blk].contiguous()
            vb = v[:, i * blk:(i + 1) * blk].contiguous()
            got = da.decode_attention_partial(q, kb, vb, i * blk, lengths)
            want = da.decode_attention_partial_plain(q, kb, vb, i * blk, lengths)
            assert (got[0] - want[0]).abs().max().item() <= TOL
            for x, y in zip(got[1:], want[1:]):
                assert ((x - y).abs() <= TOL * torch.clamp(y.abs(), min=1.0)).all()
            parts.append(got)
        o, m, l = (torch.stack(t) for t in zip(*parts))
        merged = da.merge_partials(o, m, l)
        assert (merged - da.decode_attention(q, k, v, lengths)).abs().max().item() <= TOL
