"""Tensor-parallel LM training (``transformer.loss_fn(tp=)`` under
``train_loop.jit_train_step(tp=)``) against the JAX package's GSPMD train
cell.

  * the reference's ``build_cell`` train cell jitted with the cells' in /
    out shardings on a 4-device CPU mesh, (1, 4) and (2, 2), in one module
    subprocess (four fake devices, the cells compiled side by side in a
    thread pool), against the port's train cell (``launch/cells.py``) over
    4 spawned gloo ranks on the same meshes and ``jit_train_step``'s local
    (1, 4) form in this process (the stacked-shard state of
    ``TensorParallel.local_form``, views of a whole tree, run under
    autograd): qwen2.5-3b SMOKE (GQA, random qkv biases, tied), granite
    SMOKE with its heads padded 4 -> 8, its vocabulary 509 -> 512 and its
    experts 8 -> 12 with ``ep_shard_map``, deepseek SMOKE (shared experts,
    ``dense0``) with ``ep_shard_map``, and minitron-4b SMOKE (untied
    ``lm_head``) with its heads padded 6 -> 8; float32, 2 steps of 2
    microbatches, batch 4, seq 16, a ragged mask and labels -1, V and V_pad
    among the real ones.  The loss, the grad norm and the whole state
    (parameters, ``m``, ``v``) after each step; each rank's leaves placed
    on no axis of a rank group equal bit for bit over that group; the
    ZeRO-1 blocks' shapes;
  * routing over the global batch (``moe.moe_ffn_global`` in
    ``transformer._moe_tp``): granite SMOKE with its experts padded 8 ->
    12 and deepseek SMOKE, both without ``ep_shard_map``, on the (2, 2)
    gloo ranks: the loss and every leaf's gradient of the whole batch
    (``loss_fn(tp=)`` on each rank's rows, summed over 'data' as the step
    sums them) against the reference's ``jax.value_and_grad`` of its
    ``loss_fn`` jitted with the train cell's shardings, and one train
    cell step's state against the reference's; the tokens are skewed (six
    ids) so that the cut binds in the gradient's batch and in the step's
    first microbatch, which the test asserts (``moe.kept_assignments``);
  * ``distributed.gather_from`` and ``fsdp_gather`` over gloo groups, each
    rank's gradient against the local mesh's (a ``LocalFabric``);
  * the vocab-parallel ``layers.chunked_softmax_xent`` (four vocabulary
    blocks, on a local mesh and over the gloo ranks' model group), value
    and gradients, against the reference's ``chunked_softmax_xent`` and its
    ``jax.grad``: labels on a block's first and last column, in the padded
    columns, -1, V and V_pad, chunks that pad the sequence.

Tolerance: within 2e-6 times max(1, the reference's largest magnitude)
(the LM family's rule: GSPMD and the port sum the partial products over
'model' in their own orders).  The file imports no jax: the reference
runs in its subprocess only.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.distributed import LocalFabric, fsdp_gather, gather_from
from repro_torch.distribution import sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.training import optim, train_loop
from repro_torch.training import tree
from test_torch_moe_global import assert_global_cut_binds, routes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-6
CPU = torch.device("cpu")
BATCH, SEQ, N_MICRO, STEPS = 4, 16, 2, 2
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
# name -> (arch, config overrides (dtypes by name; "moe.x" a nested field))
CASES = {
    "qwen": ("qwen2.5-3b", {}),
    "granite": ("granite-moe-3b-a800m", {
        "pad_heads_to": 8, "vocab_size": 509, "pad_vocab_to": 512,
        "moe.pad_experts_to": 12, "moe.ep_shard_map": True}),
    "deepseek": ("deepseek-moe-16b", {"moe.ep_shard_map": True}),
    "minitron": ("minitron-4b", {"pad_heads_to": 8}),
}
# routing over the global batch: the (2, 2) mesh only, one step
GLOBAL_CASES = {
    "granite_global": ("granite-moe-3b-a800m", {"moe.pad_experts_to": 12,
                                                "moe.ep_shard_map": False}),
    "deepseek_global": ("deepseek-moe-16b", {"moe.ep_shard_map": False}),
}
ALL_CASES = {**CASES, **GLOBAL_CASES}
GLOBAL_TOKEN_IDS = 6           # the skewed batches draw their tokens from this many ids
MODES = ["local_1x4", "gloo_1x4", "gloo_2x2"]
# the vocab-parallel CE alone: (b, s, d), V, V_pad, chunk
XENT = dict(b=2, s=12, d=24, v=509, vp=512, chunk=5)


def _port_config(name):
    arch, over = ALL_CASES[name]
    cfg = get_arch(arch).smoke_config
    for key, val in over.items():
        if "." in key:
            outer, inner = key.split(".")
            cfg = dataclasses.replace(cfg, **{outer: dataclasses.replace(
                getattr(cfg, outer), **{inner: val})})
        else:
            cfg = dataclasses.replace(cfg, **{key: val})
    return cfg


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


def _xent_labels():
    """Labels at a vocabulary block's edges (blocks of 128), in the padded
    columns, and outside ``[0, V_pad)``."""
    v, vp = XENT["v"], XENT["vp"]
    return [0, 127, 128, 255, 256, 383, 384, v - 1, v, vp - 1, -1, vp]


def _write_inputs(path):
    """Seeded numpy parameters and batches for every case, and the CE's
    inputs, flattened by name (``case/params/blocks/wq``)."""
    arrays = {}
    for ci, name in enumerate(ALL_CASES):
        cfg = _port_config(name)
        rng = np.random.default_rng(300 + ci)
        names, leaves = _flat(tf.abstract_params(cfg))
        for n, x in zip(names, leaves):
            shape = tuple(x.shape)
            if n.split("/")[-1] in ("ln1", "ln2", "final_norm"):
                a = 1.0 + 0.1 * rng.normal(size=shape)
            elif n.split("/")[-1] in ("bq", "bk", "bv"):
                a = 0.3 * rng.normal(size=shape)
            elif n == "embed":
                a = 0.5 * rng.normal(size=shape)
            else:
                a = rng.normal(size=shape) / np.sqrt(cfg.d_model)
            arrays[f"{name}/params/{n}"] = a.astype(np.float32)
        for i in range(STEPS):
            ids = GLOBAL_TOKEN_IDS if name in GLOBAL_CASES else cfg.vocab_size
            arrays[f"{name}/tokens{i}"] = rng.integers(0, ids, (BATCH, SEQ), dtype=np.int32)
            lab = rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
            lab[0, :3] = (-1, cfg.vocab_size, cfg.vocab_padded)
            arrays[f"{name}/labels{i}"] = lab
            mask = (rng.random((BATCH, SEQ)) > 0.25).astype(np.float32)
            mask[1, SEQ // 2:] = 0.0           # a ragged row
            mask[0, 1] = 0.0                   # label V: where padded, a -1e30 pick
            arrays[f"{name}/mask{i}"] = mask
    rng = np.random.default_rng(399)
    b, s, d = XENT["b"], XENT["s"], XENT["d"]
    arrays["xent/hidden"] = rng.normal(size=(b, s, d)).astype(np.float32)
    arrays["xent/head"] = (rng.normal(size=(d, XENT["vp"])) / np.sqrt(d)).astype(np.float32)
    lab = rng.integers(0, XENT["v"], (b, s)).astype(np.int32)
    edges = _xent_labels()
    lab.reshape(-1)[:len(edges)] = edges
    arrays["xent/labels"] = lab
    mask = (rng.random((b, s)) > 0.2).astype(np.float32)
    mask.reshape(-1)[:len(edges)] = 1.0
    mask.reshape(-1)[edges.index(XENT["v"])] = 0.0   # a -1e30 pick, masked
    arrays["xent/mask"] = mask
    np.savez(path, **arrays)


# ---------------------------------------------------------------------------
# The reference: GSPMD train cells on four fake CPU devices
# ---------------------------------------------------------------------------

_REFERENCE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json, sys
from concurrent.futures import ThreadPoolExecutor
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh
from repro.configs import registry
from repro.launch import cells as C
from repro.launch.mesh import set_mesh_compat
from repro.models import layers as L
from repro.training import optim

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
            cfg = dataclasses.replace(cfg, **{key: val})
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


def flat(tree_, prefix):
    out = {}
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree_)
    for path, x in leaves:
        out[prefix + "/".join(getattr(k, "key", getattr(k, "name", str(k)))
                              for k in path)] = np.asarray(x)
    return out


def job(name, arch, over, mname, shape):
    from repro.models import transformer as T

    cfg = config(arch, over)
    spec = dataclasses.replace(registry.get_arch(arch), config=cfg)
    mesh = Mesh(devs.reshape(shape), ("data", "model"))
    base = next(c for c in spec.shapes if c.kind == "train")
    cell = dataclasses.replace(base, params={**base.params, "seq_len": K["seq"],
                                             "global_batch": K["batch"]})
    params = unflat(name + "/params/")
    res = {}
    with set_mesh_compat(mesh):
        c = C.build_cell(spec, cell, mesh, n_micro=K["n_micro"])
        fn = jax.jit(c.fn, in_shardings=c.in_shardings, out_shardings=c.out_shardings,
                     donate_argnums=c.donate)
        if name in K["grads"]:
            # the whole first batch as one microbatch, the cell's shardings
            b0 = {k: jnp.asarray(inp[f"{name}/{k}0"]) for k in ("tokens", "labels", "mask")}
            vg = jax.jit(jax.value_and_grad(lambda p, b: T.loss_fn(
                p, b["tokens"], b["labels"], b["mask"], cfg, mesh=mesh)),
                in_shardings=(c.in_shardings[0][0], c.in_shardings[1]))
            loss, g = vg(params, b0)
            res["grad/loss"] = np.asarray(loss)
            res.update(flat({"params": g}, "grad/"))
        state = jax.device_put((params, optim.init(params)), c.in_shardings[0])
        for i in range(K["case_steps"][name]):
            batch = {k: jnp.asarray(inp[f"{name}/{k}{i}"]) for k in ("tokens", "labels", "mask")}
            state, m = fn(state, batch)
            for k in ("loss", "grad_norm"):
                res[f"step{i}/{k}"] = np.asarray(m[k])
            p, o = state
            res.update(flat({"params": p, "m": o.m, "v": o.v}, f"step{i}/"))
    return {f"{name}/{mname}/{k}": v for k, v in res.items()}


def xent():
    h, w = jnp.asarray(inp["xent/hidden"]), jnp.asarray(inp["xent/head"])
    lab, mask = jnp.asarray(inp["xent/labels"]), jnp.asarray(inp["xent/mask"])
    f = jax.jit(lambda h, w: L.chunked_softmax_xent(h, w, lab, mask, chunk=K["chunk"],
                                                    n_valid_vocab=K["v"]))
    val, (gh, gw) = jax.jit(jax.value_and_grad(
        lambda h, w: L.chunked_softmax_xent(h, w, lab, mask, chunk=K["chunk"],
                                            n_valid_vocab=K["v"]), argnums=(0, 1)))(h, w)
    return {"xent/loss": np.asarray(f(h, w)), "xent/value": np.asarray(val),
            "xent/grad_hidden": np.asarray(gh), "xent/grad_head": np.asarray(gw)}


jobs = [(n, a, o, m, s) for n, (a, o) in K["cases"].items() for m, s in K["meshes"].items()
        if m in K["case_meshes"][n]]
with ThreadPoolExecutor(len(jobs) + 1) as pool:
    xent_part = pool.submit(xent)
    parts = list(pool.map(lambda j: job(*j), jobs)) + [xent_part.result()]
out = {}
for p in parts:
    out.update(p)
np.savez(K["out"], **out)
print(json.dumps({"n": len(out)}))
"""


# ---------------------------------------------------------------------------
# The port over four gloo ranks: the train cells on (1, 4) and (2, 2), the
# collectives' gradients and the vocab-parallel CE
# ---------------------------------------------------------------------------

_GLOO = """
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_arch
from repro_torch.core.distributed import fsdp_gather, gather_from
from repro_torch.distribution import sharding
from repro_torch.launch import cells as C
from repro_torch.launch import mesh as M
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.training import optim, tree

rank, init, K = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
BATCH = K["batch"]
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
            cfg = dataclasses.replace(cfg, **{key: val})
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


def gathered(mesh, tree_, shardings):
    return [DTensor.from_local(x.contiguous(), mesh.device_mesh, s.placements,
                               run_check=False).full_tensor()
            for x, s in zip(tree.leaves(tree_), tree.leaves(shardings))]


def replicated_equal(mesh, local, shardings):
    # each leaf's block against every other rank's that holds the same block
    coords = [None] * 4
    dist.all_gather_object(coords, {a: mesh.coordinate(a) for a in mesh.axis_names})
    bad = []
    for n, x, s in zip(tree.flatten_with_names(local)[0], tree.leaves(local),
                       tree.leaves(shardings)):
        parts = [torch.empty_like(x) for _ in range(4)]
        dist.all_gather(parts, x.contiguous())
        whole = [n * s.shards(d) for d, n in enumerate(x.shape)]
        blocks = [s.block(whole, c) for c in coords]
        for r in range(4):
            for q in range(r):
                if blocks[r] == blocks[q] and not torch.equal(parts[r], parts[q]):
                    bad.append(f"{n} ranks {q} {r}")
    return bad


def whole_grads(mesh, cfg, spec, params, shardings, batch):
    # loss_fn(tp=) on this rank's rows of the whole batch (one microbatch),
    # each gradient summed over 'data' unless it is split on it (then it came
    # back reduce-scattered), as the step reduces it; gathered whole
    tp = sharding.TensorParallel(mesh, C._lm_train_rules(spec))
    leaves = [x[s.block(x.shape)].clone().requires_grad_(True)
              for x, s in zip(tree.leaves(params), tree.leaves(shardings))]
    n, d = mesh.shape["data"], mesh.coordinate("data")
    rows = slice(d * BATCH // n, (d + 1) * BATCH // n)
    loss = tf.loss_fn(tree.unflatten(params, leaves), batch["tokens"][rows],
                      batch["labels"][rows], batch["mask"][rows], cfg, tp=tp)
    fab = mesh.fabric("data")
    on_data = lambda spec: any(p == "data" or (isinstance(p, tuple) and "data" in p)
                               for p in spec)
    grads = [g if on_data(s.spec) else fab.psum(g.contiguous()[None])
             for g, s in zip(torch.autograd.grad(loss, leaves), tree.leaves(shardings))]
    return fab.psum(loss.detach()[None]), gathered(mesh, grads, shardings)


out, info = {}, {"replicated_unequal": [], "shapes": {}}
for mname, shape in K["meshes"].items():
    mesh = M.process_group_mesh(shape, ("data", "model"), device=cpu)
    for name, (arch, over) in K["cases"].items():
        if mname not in K["case_meshes"][name]:
            continue
        cfg = config(arch, over)
        spec = dataclasses.replace(get_arch(arch), config=cfg)
        base = next(c for c in spec.shapes if c.kind == "train")
        cell = dataclasses.replace(base, params={**base.params, "seq_len": K["seq"],
                                                 "global_batch": K["batch"]})
        c = C.build_cell(spec, cell, mesh, n_micro=K["n_micro"])
        params = unflat(name + "/params/")
        first = {k: torch.from_numpy(inp[f"{name}/{k}0"]) for k in ("tokens", "labels", "mask")}
        if name in K["grads"]:
            loss, g = whole_grads(mesh, cfg, spec, params, c.in_shardings[0][0], first)
            out[f"{name}/{mname}/grad/loss"] = loss.numpy()
            for n, x in zip(tree.flatten_with_names((params,))[0], g):
                out[f"{name}/{mname}/grad/{n}"] = x.numpy().copy()
        state, _ = C.place(c, ((params, optim.init(params)), first))
        if name == "qwen":
            info["shapes"][mname] = {n: list(x.shape) for n, x in
                                     zip(*tree.flatten_with_names(state))}
        for i in range(K["case_steps"][name]):
            batch = {k: torch.from_numpy(inp[f"{name}/{k}{i}"])
                     for k in ("tokens", "labels", "mask")}
            state, m = c.fn(state, batch)
            for k in ("loss", "grad_norm"):
                out[f"{name}/{mname}/step{i}/{k}"] = m[k].numpy()
            names = tree.flatten_with_names(state)[0]
            for n, x in zip(names, gathered(mesh, state, c.in_shardings[0])):
                out[f"{name}/{mname}/step{i}/{n}"] = x.numpy().copy()   # the state moves on
            info["replicated_unequal"] += [f"{name}/{mname}/step{i}: {b}" for b in
                                           replicated_equal(mesh, state, c.in_shardings[0])]

# gather_from over the (1, 4) mesh's model group: every rank uses the whole
mesh = M.process_group_mesh((1, 4), ("data", "model"), device=cpu)
fab = mesh.fabric("model")
x = torch.from_numpy(inp["coll/x"])[rank:rank + 1].clone().requires_grad_(True)
y = gather_from(fab, x)
loss = (torch.sin(y) * torch.from_numpy(inp["coll/w"])).sum()
out[f"coll/gather_from/rank{rank}"] = torch.autograd.grad(loss, x)[0].numpy()
# the FSDP gather over the (2, 2) mesh's data group: each rank its own rows
mesh = M.process_group_mesh((2, 2), ("data", "model"), device=cpu)
fab, d = mesh.fabric("data"), mesh.coordinate("data")
x = torch.from_numpy(inp["coll/p"])[d:d + 1].clone().requires_grad_(True)
whole = fsdp_gather(fab, x).flatten(0, 1)
loss = (torch.from_numpy(inp["coll/rows"])[d] @ whole).square().sum()
out[f"coll/fsdp/rank{rank}"] = torch.autograd.grad(loss, x)[0].numpy()
# the vocab-parallel CE over the (1, 4) model group: this rank's columns
mesh = M.process_group_mesh((1, 4), ("data", "model"), device=cpu)
fab = mesh.fabric("model")
h = torch.from_numpy(inp["xent/hidden"]).clone().requires_grad_(True)
cols = inp["xent/head"].shape[1] // 4
w = torch.from_numpy(inp["xent/head"][:, rank * cols:(rank + 1) * cols]).clone()
w.requires_grad_(True)
val = layers.chunked_softmax_xent(
    h, w[None], torch.from_numpy(inp["xent/labels"]), torch.from_numpy(inp["xent/mask"]),
    chunk=K["chunk"], n_valid_vocab=K["v"], vocab_blocks=([rank], fab))
gh, gw = torch.autograd.grad(val, (h, w))
out[f"xent/rank{rank}/value"] = val.detach().numpy()
out[f"xent/rank{rank}/grad_hidden"] = gh.numpy()
out[f"xent/rank{rank}/grad_head"] = gw.numpy()

parts = [None] * 4
dist.gather_object(out, parts if rank == 0 else None, dst=0)
infos = [None] * 4
dist.gather_object(info, infos if rank == 0 else None, dst=0)
if rank == 0:
    merged = {}
    for p in parts:
        merged.update(p)
    np.savez(K["out"], **merged)
    with open(K["out"] + ".json", "w") as f:
        json.dump({"replicated_unequal": sum((i["replicated_unequal"] for i in infos), []),
                   "shapes": infos[0]["shapes"]}, f)
dist.destroy_process_group()
print(json.dumps({"rank": rank}))
"""


def _collective_inputs(path_inp):
    """Inputs of the two collectives' gradient cases, added to the file."""
    rng = np.random.default_rng(398)
    with np.load(path_inp) as f:
        arrays = dict(f)
    arrays["coll/x"] = rng.normal(size=(4, 3, 5)).astype(np.float32)
    arrays["coll/w"] = rng.normal(size=(4, 3, 5)).astype(np.float32)
    arrays["coll/p"] = rng.normal(size=(2, 3, 4)).astype(np.float32)
    arrays["coll/rows"] = rng.normal(size=(2, 5, 6)).astype(np.float32)
    np.savez(path_inp, **arrays)


def _state_names(cfg) -> list:
    """The state's leaf names as the gloo ranks and the local run write
    them (``tree.flatten_with_names`` of ``(params, OptState)``)."""
    params = tf.abstract_params(cfg)
    return tree.flatten_with_names((params, optim.abstract_state(params)))[0]


def _local_outputs(inp) -> dict:
    """``jit_train_step`` with ``tp`` on a local (1, 4) mesh in this process:
    the state in its stacked-shard form, views of a whole tree."""
    out = {}
    mesh = tmesh.local_mesh((1, 4), device=CPU)
    tp = sharding.TensorParallel(mesh, sharding.LM_TRAIN_RULES)
    for name in CASES:
        cfg = _port_config(name)
        whole = _unflat({k: torch.from_numpy(v).clone() for k, v in inp.items()},
                        name + "/params/")
        logical = tf.param_logical(cfg)
        opt = optim.init(whole)
        state = (tp.local_form(whole, logical),
                 optim.OptState(tp.local_form(opt.m, logical),
                                tp.local_form(opt.v, logical), opt.step))
        psh, osh = train_loop.state_shardings(logical, sharding.LM_TRAIN_RULES, mesh,
                                              zero1=True, params_abs=whole)
        bsh = train_loop.batch_shardings({k: ("batch", "seq") for k in
                                          ("tokens", "labels", "mask")},
                                         sharding.LM_TRAIN_RULES, mesh)
        step = train_loop.jit_train_step(train_loop.make_train_step(
            lambda p, b: tf.loss_fn(p, b["tokens"], b["labels"], b["mask"], cfg, tp=tp),
            train_loop.TrainStepConfig(n_micro=N_MICRO)), psh, osh, bsh, tp=tp)
        names = _state_names(cfg)
        for i in range(STEPS):
            batch = {k: torch.from_numpy(inp[f"{name}/{k}{i}"])
                     for k in ("tokens", "labels", "mask")}
            state, m = step(state, batch)
            for k in ("loss", "grad_norm"):
                out[f"{name}/1x4/step{i}/{k}"] = m[k].numpy()
            p, o = state
            back = (tp.whole_form(p, logical),
                    optim.OptState(tp.whole_form(o.m, logical), tp.whole_form(o.v, logical),
                                   o.step))
            for n, x in zip(names, tree.leaves(back)):
                out[f"{name}/1x4/step{i}/{n}"] = x.numpy().copy()
    # the collectives on LocalFabrics: the whole in one process
    x = torch.from_numpy(inp["coll/x"]).clone().requires_grad_(True)
    loss = (torch.sin(gather_from(LocalFabric(4, CPU), x)) * torch.from_numpy(inp["coll/w"])).sum()
    out["coll/gather_from"] = torch.autograd.grad(loss, x)[0].numpy()
    p = torch.from_numpy(inp["coll/p"]).clone().requires_grad_(True)
    whole = fsdp_gather(LocalFabric(2, CPU), p).flatten(0, 1)
    rows = torch.from_numpy(inp["coll/rows"])
    loss = sum((rows[d] @ whole).square().sum() for d in range(2))
    out["coll/fsdp"] = torch.autograd.grad(loss, p)[0].numpy()
    # the vocab-parallel CE over four local blocks
    h = torch.from_numpy(inp["xent/hidden"]).clone().requires_grad_(True)
    w = torch.from_numpy(inp["xent/head"]).clone().requires_grad_(True)
    blocks = w.unflatten(1, (4, -1)).movedim(1, 0)
    val = layers.chunked_softmax_xent(
        h, blocks, torch.from_numpy(inp["xent/labels"]), torch.from_numpy(inp["xent/mask"]),
        chunk=XENT["chunk"], n_valid_vocab=XENT["v"],
        vocab_blocks=([0, 1, 2, 3], LocalFabric(4, CPU)))
    gh, gw = torch.autograd.grad(val, (h, w))
    out["xent/local/value"] = val.detach().numpy()
    out["xent/local/grad_hidden"], out["xent/local/grad_head"] = gh.numpy(), gw.numpy()
    one = layers.chunked_softmax_xent(
        h, w, torch.from_numpy(inp["xent/labels"]), torch.from_numpy(inp["xent/mask"]),
        chunk=XENT["chunk"], n_valid_vocab=XENT["v"])
    gh, gw = torch.autograd.grad(one, (h, w))
    out["xent/one/value"] = one.detach().numpy()
    out["xent/one/grad_hidden"], out["xent/one/grad_head"] = gh.numpy(), gw.numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the four gloo ranks started side by
    side, the local mesh run here meanwhile: ``(reference, {mode:
    outputs}, gloo info)``."""
    d = tmp_path_factory.mktemp("tp_training")
    inp_path = str(d / "inp.npz")
    _write_inputs(inp_path)
    _collective_inputs(inp_path)
    k = dict(inp=inp_path, cases=ALL_CASES, meshes=MESHES, seq=SEQ, batch=BATCH,
             n_micro=N_MICRO, chunk=XENT["chunk"], v=XENT["v"], grads=list(GLOBAL_CASES),
             case_meshes={n: ["2x2"] if n in GLOBAL_CASES else list(MESHES)
                          for n in ALL_CASES},
             case_steps={n: 1 if n in GLOBAL_CASES else STEPS for n in ALL_CASES})
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
    with open(str(d / "gloo.npz") + ".json") as f:
        info = json.load(f)
    port = {"local_1x4": local, "gloo_1x4": gl, "gloo_2x2": gl, "inputs": inputs}
    return ref, port, info


def _close(got, want, what: str) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    assert np.array_equal(np.isnan(got), np.isnan(want)), what
    ok = ~np.isnan(want)
    scale = max(1.0, float(np.abs(want[ok]).max())) if ok.any() else 1.0
    err = float(np.abs(got[ok].astype(np.float64) - want[ok]).max()) if ok.any() else 0.0
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"
    return err


def _ref_name(n: str) -> str:
    """A port state name (``[0]/['blocks']/['wq']``, ``[1]/.m/['embed']``)
    as the reference subprocess writes it (``params/blocks/wq``, ``m/embed``)."""
    parts = n.split("/")
    head = {"[0]": "params", "[1]": None}[parts[0]]
    rest = [p[2:-2] if p.startswith("['") else p for p in parts[1:]]
    if head is None:
        head, rest = rest[0].lstrip("."), rest[1:]
    return "/".join([head] + rest)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_tp_train_steps_match_reference(runs, mode, case):
    ref, port, _ = runs
    mname = mode.split("_")[1]
    got = port[mode]
    worst = 0.0
    for i in range(STEPS):
        key = f"{case}/{mname}/step{i}"
        for k in ("loss", "grad_norm"):
            _close(got[f"{key}/{k}"], ref[f"{key}/{k}"], f"{key}/{k}")
        for n in _state_names(_port_config(case)):
            if n.endswith(".step"):
                continue
            worst = max(worst, _close(got[f"{key}/{n}"], ref[f"{key}/{_ref_name(n)}"],
                                      f"{key}/{n}"))
    print(f"{mode} {case}: largest |state - reference| {worst:.3g}")


def _kept(cfg, params, tokens, n_data: int, what: str) -> list:
    """The witness on the port's one-device routing of ``tokens``."""
    with torch.no_grad():
        sels = routes(lambda: tf.forward(params, torch.from_numpy(tokens), cfg))
    return assert_global_cut_binds(cfg, sels, n_data, what)


@pytest.mark.parametrize("case", list(GLOBAL_CASES))
def test_global_route_train_matches_reference(runs, case):
    """Routing over the global batch on the (2, 2) gloo ranks: the whole
    batch's loss and every leaf's gradient, then one train cell step's
    state, against the reference's GSPMD ``value_and_grad`` and train
    cell.  The batch's cut and its first microbatch's bind."""
    ref, port, _ = runs
    cfg = _port_config(case)
    got = port["gloo_2x2"]
    inp = port["inputs"]
    params = _unflat({k: torch.from_numpy(v) for k, v in inp.items()}, case + "/params/")
    n_data = MESHES["2x2"][0]
    tokens = inp[f"{case}/tokens0"]
    kept = {"batch": _kept(cfg, params, tokens, n_data, case + " batch"),
            "micro0": _kept(cfg, params, tokens[:BATCH // N_MICRO], n_data,
                            case + " microbatch 0")}
    key = f"{case}/2x2"
    _close(got[f"{key}/grad/loss"], ref[f"{key}/grad/loss"], f"{key} loss")
    names = _state_names(cfg)
    worst = {}
    for n in names:
        if n.startswith("[0]/"):
            worst[n] = _close(got[f"{key}/grad/{n}"], ref[f"{key}/grad/{_ref_name(n)}"],
                              f"{key} grad {n}")
    for k in ("loss", "grad_norm"):
        _close(got[f"{key}/step0/{k}"], ref[f"{key}/step0/{k}"], f"{key}/step0/{k}")
    for n in names:
        if not n.endswith(".step"):
            _close(got[f"{key}/step0/{n}"], ref[f"{key}/step0/{_ref_name(n)}"],
                   f"{key}/step0/{n}")
    print(f"{case}: loss {float(got[key + '/grad/loss'])!r} vs "
          f"{float(ref[key + '/grad/loss'])!r}; largest gradient difference "
          f"{max(worst.values()):.3g}; kept (global, per rank, of) {kept}")


def test_replicated_leaves_equal_bit_for_bit_on_every_rank(runs):
    _, _, info = runs
    assert info["replicated_unequal"] == []


@pytest.mark.parametrize("mname", list(MESHES))
def test_zero1_blocks_are_the_gathered_steps(runs, mname):
    """The ZeRO-1 blocks of ``test_torch_distribution``'s gathered step,
    now beside each rank's parameter blocks (qwen SMOKE: d 64, 4 heads of
    16, vocabulary 512)."""
    _, _, info = runs
    shapes = info["shapes"][mname]
    n_data, n_model = MESHES[mname]
    assert shapes["[1]/.m/['embed']"] == [512 // n_model, 64 // n_data]
    assert shapes["[0]/['embed']"] == [512 // n_model, 64]
    assert shapes["[1]/.m/['blocks']/['wq']"] == [2, 64 // n_data, 4 // n_model, 16]
    assert shapes["[0]/['blocks']/['wq']"] == [2, 64 // n_data, 4 // n_model, 16]
    assert shapes["[0]/['blocks']/['wk']"] == [2, 64, 2, 16]
    assert shapes["[1]/.step"] == []


def test_gather_from_and_fsdp_gather_grads_over_gloo_equal_local(runs):
    _, port, _ = runs
    gl, local = port["gloo_1x4"], port["local_1x4"]
    for r in range(4):
        np.testing.assert_array_equal(gl[f"coll/gather_from/rank{r}"],
                                      local["coll/gather_from"][r:r + 1])
        d = r // 2                       # the rank's data coordinate on (2, 2)
        _close(gl[f"coll/fsdp/rank{r}"], local["coll/fsdp"][d:d + 1], f"fsdp rank {r}")


@pytest.mark.parametrize("mode", ["one", "local", "rank"])
def test_vocab_parallel_xent_matches_reference(runs, mode):
    ref, port, _ = runs
    local = port["local_1x4"]
    if mode == "rank":
        gl = port["gloo_1x4"]
        cols = XENT["vp"] // 4
        for r in range(4):
            _close(gl[f"xent/rank{r}/value"], ref["xent/value"], f"rank {r} value")
            _close(gl[f"xent/rank{r}/grad_hidden"], ref["xent/grad_hidden"],
                   f"rank {r} grad hidden")
            _close(gl[f"xent/rank{r}/grad_head"],
                   ref["xent/grad_head"][:, r * cols:(r + 1) * cols], f"rank {r} grad head")
        return
    _close(local[f"xent/{mode}/value"], ref["xent/value"], f"{mode} value")
    _close(local[f"xent/{mode}/value"], ref["xent/loss"], f"{mode} loss")
    _close(local[f"xent/{mode}/grad_hidden"], ref["xent/grad_hidden"], f"{mode} grad hidden")
    _close(local[f"xent/{mode}/grad_head"], ref["xent/grad_head"], f"{mode} grad head")
    # the padded columns take no gradient; the masked -1e30 pick none either
    assert (local[f"xent/{mode}/grad_head"][:, XENT["v"]:] == 0).all()

