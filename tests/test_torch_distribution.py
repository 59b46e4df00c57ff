"""The port's distribution layer against the JAX package.

  * ``moe.moe_ffn_sharded`` on local meshes (1, 4) and (2, 2) against the
    reference's ``shard_map`` on meshes of those shapes, at SMOKE width
    with padded experts, top 3 (a token's contributions span shards) and a
    dropping capacity;
  * the LM ``forward`` with ``mesh=`` (the expert-parallel route of
    ``transformer._ffn``) on granite's and deepseek's SMOKE configs with
    ``ep_shard_map``, and a token count that does not divide the data axes
    (``moe_ffn``, as the reference falls back); greedy ``generate`` with a
    (1, 4) mesh equal to the unsharded tokens;
  * ``compression.compressed_psum`` over 4 local shards: reduced values
    and residuals bit for bit, and the reference test's per-shard 0..3
    case;
  * ``train_loop.jit_train_step`` over 2 and 4 spawned gloo processes
    (meshes (2, 1) and (2, 2), ``LM_TRAIN_RULES``, ZeRO-1, two
    microbatches) on qwen2.5-3b SMOKE with a ragged loss mask, against the
    reference's one-device ``make_train_step``; the ZeRO-1 blocks' shapes
    and ``moe_ffn_sharded`` over the (2, 2) process group against the
    local form;
  * a checkpoint saved from 4 gloo ranks (and one from the reference's 4
    devices) restored onto 2 ranks with ``shardings=``, as
    ``tests/test_distributed.py`` restores onto another mesh; and
    ``resilience.run_resilient(state_shardings=)`` over 2 gloo ranks with
    failures at step 0 and at a checkpoint step, each rank restoring the
    same steps and ending with the bits of the run without failures;
  * routing over the global batch (``moe.moe_ffn_global``, the reference's
    GSPMD ``moe_ffn`` without ``ep_shard_map``) in the gathered body:
    granite SMOKE with its experts padded 8 -> 12 and deepseek SMOKE on
    the (2, 2) gloo ranks: each rank's rows of ``forward(mesh=)`` against
    the port's one device (the test that pinned the route's old refusal),
    and one ``jit_train_step`` (two microbatches), its loss, every leaf's
    gradient (``loss_fn(mesh=)`` summed over 'data') and the state after
    it, against the reference on one device (``make_train_step``'s body
    jitted, its gradient returned beside the state: the global batch's
    values, which its GSPMD cell computes); the tokens are skewed (six
    ids) so that the cut binds in the whole batch and in the step's first
    microbatch, which the tests assert;
  * the refusal of a ``jit_train_step`` given a step that
    ``make_train_step`` did not make.

The reference's calls need several devices, which JAX fixes when it
starts: they run once per module in a subprocess with four fake CPU
devices (as ``test_distributed._run`` starts one), every call jitted and
compiled side by side in a thread pool, while the gloo processes run
beside it; arrays cross in ``.npz`` files.

Tolerances, measured here and stated: the MoE outputs, the LM hidden
states and the aux losses within 2e-6 times max(1, the reference's largest
magnitude) (XLA and torch sum the expert and router products in different
orders); the compressed all-reduce bit for bit; the training state and
metrics after two steps within 2e-6 times max(1, magnitude), the rule the
one-device step is held to (measured: 1.7e-7 at most).
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

from repro.configs import deepseek_moe_16b as jdeep
from repro.configs import granite_moe_3b_a800m as jgran
from repro.configs import qwen2_5_3b as jqwen
from repro_torch.core.distributed import LocalFabric
from repro_torch.data import pipeline
from repro_torch.launch import mesh as tmesh
from repro_torch.models import layers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serving import decode as tdecode
from repro_torch.training import compression
from test_torch_moe import port_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-6
CPU = torch.device("cpu")
MESHES = [(1, 4), (2, 2)]
D_MODEL, D_FF = 64, 32
# name -> (n_experts, pad_experts_to, top_k, capacity_factor, tokens, seed)
MOE_CASES = {
    "top2_padded": (10, 12, 2, 1.25, 32, 1),
    "top3": (8, None, 3, 1.25, 40, 2),
    "dropping_padded": (6, 8, 2, 0.5, 64, 3),
}
# name -> (base config, MoE overrides, tokens shape)
LM_CASES = {
    "granite_ep": ("granite", {"ep_shard_map": True, "pad_experts_to": 12}, (2, 8)),
    "deepseek_ep": ("deepseek", {"ep_shard_map": True}, (2, 6)),
    "granite_ep_odd": ("granite", {"ep_shard_map": True, "pad_experts_to": 12}, (3, 1)),
}
# routing over the global batch on (2, 2): name -> (base config, MoE overrides)
GLOBAL_CASES = {
    "granite_global": ("granite", {"pad_experts_to": 12}),
    "deepseek_global": ("deepseek", {}),
}
GLOBAL_TOKEN_IDS = 6           # the skewed batches draw their tokens from this many ids
PSUM_SHAPES = {"a": (33,), "b": (8, 16), "c": (1000,)}
TRAIN = dict(batch=4, seq=16, n_micro=2, steps=2)


def lm_config(name):
    """The reference's LM config of a case (float32 compute and cache)."""
    base, moe_kw, _ = LM_CASES[name]
    cfg = {"granite": jgran.SMOKE, "deepseek": jdeep.SMOKE}[base]
    import jax.numpy as jnp

    return dataclasses.replace(cfg, compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                               moe=dataclasses.replace(cfg.moe, **moe_kw))


def global_config(name):
    """The reference's config of a global-route case (float32 compute and
    cache, no ``ep_shard_map``)."""
    base, moe_kw = GLOBAL_CASES[name]
    cfg = {"granite": jgran.SMOKE, "deepseek": jdeep.SMOKE}[base]
    import jax.numpy as jnp

    return dataclasses.replace(cfg, compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                               moe=dataclasses.replace(cfg.moe, **moe_kw))


def _moe_cfg(module, case):
    n_exp, pad, top_k, cf, _, _ = MOE_CASES[case]
    return module.MoEConfig(n_experts=n_exp, top_k=top_k, d_ff_expert=D_FF,
                            capacity_factor=cf, pad_experts_to=pad, ep_shard_map=True)


def _train_batches():
    """Two TokenPipeline batches with a ragged mask: each microbatch's rows
    hold different token counts, so the normaliser must be the global
    count."""
    pipe = pipeline.TokenPipeline(jqwen.SMOKE.vocab_size, TRAIN["batch"], TRAIN["seq"], seed=1)
    out = []
    for i in range(TRAIN["steps"]):
        b = pipe(i)
        keep = np.random.default_rng(10 + i).random(b["mask"].shape) < 0.6
        keep[1] = False                         # one row with no token at all
        b["mask"] = (b["mask"] * keep).astype(np.float32)
        out.append(b)
    return out


_REFERENCE_BODY = """
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor
    from jax.experimental.shard_map import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import deepseek_moe_16b as jdeep, granite_moe_3b_a800m as jgran
    from repro.configs import qwen2_5_3b as jqwen
    from repro.models import moe as M, transformer as tf
    from repro.training import checkpoint, compression, train_loop
    from repro.training.checkpoint import _flatten_with_names

    K = json.loads('''%s''')
    inp = dict(np.load(K["inp"]))
    out = {}
    jobs = []          # (output key, jitted fn, args, mesh)

    def flat(prefix, tree):
        names, leaves, _ = _flatten_with_names(tree)
        for n, l in zip(names, leaves):
            out[prefix + n] = np.asarray(l)

    def unflat(prefix):
        tree = {}
        for name, v in inp.items():
            if name.startswith(prefix):
                keys = name[len(prefix):].split("/")
                node = tree
                for key in keys[:-1]:
                    node = node.setdefault(key, {})
                node[keys[-1]] = jnp.asarray(v)
        return tree

    for name, (n_exp, pad, top_k, cf, tokens, seed) in K["moe_cases"].items():
        cfg = M.MoEConfig(n_experts=n_exp, top_k=top_k, d_ff_expert=K["d_ff"],
                          capacity_factor=cf, pad_experts_to=pad, ep_shard_map=True)
        p = {k: jnp.asarray(inp[f"moe/{name}/{k}"])
             for k in ("router", "w_gate", "w_up", "w_down")}
        x = jnp.asarray(inp[f"moe/{name}/x"])
        for shape in K["meshes"]:
            mesh = make_mesh_compat(tuple(shape), ("data", "model"))
            fn = jax.jit(lambda x, p, cfg=cfg, mesh=mesh: M.moe_ffn_sharded(x, p, cfg, mesh))
            jobs.append((f"moe/{name}/{shape[0]}x{shape[1]}", fn, (x, p), mesh))

    def lm_cfg(name):
        base, moe_kw, _ = K["lm_cases"][name]
        cfg = {"granite": jgran.SMOKE, "deepseek": jdeep.SMOKE}[base]
        return dataclasses.replace(cfg, compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                                   moe=dataclasses.replace(cfg.moe, **moe_kw))

    for name, (base, _, tshape) in K["lm_cases"].items():
        cfg = lm_cfg(name)
        params = jax.jit(lambda k, cfg=cfg: tf.init_params(k, cfg))(jax.random.key(5))
        flat(f"lm/{name}/params/", params)
        toks = jnp.asarray(inp[f"lm/{name}/tokens"])
        for shape in K["meshes"]:
            mesh = make_mesh_compat(tuple(shape), ("data", "model"))
            fn = jax.jit(lambda p, t, cfg=cfg, mesh=mesh: tf.forward(p, t, cfg, mesh=mesh))
            jobs.append((f"lm/{name}/{shape[0]}x{shape[1]}", fn, (params, toks), mesh))

    # compressed_psum over 4 data shards
    pmesh = make_mesh_compat((4,), ("data",))
    g = {k: jnp.asarray(inp[f"psum/g/{k}"]) for k in K["psum_shapes"]}
    r = {k: jnp.asarray(inp[f"psum/r/{k}"]) for k in K["psum_shapes"]}

    def cps(gg, rr):
        red, nr = compression.compressed_psum(
            jax.tree.map(lambda a: a[0], gg), jax.tree.map(lambda a: a[0], rr), "data")
        return jax.tree.map(lambda a: a[None], red), jax.tree.map(lambda a: a[None], nr)

    spec = jax.tree.map(lambda a: P("data"), g)
    fn = jax.jit(shard_map(cps, mesh=pmesh, in_specs=(spec, spec), out_specs=(spec, spec),
                           check_rep=False))
    jobs.append(("psum", fn, (g, r), pmesh))

    # the one-device train step: qwen smoke, two microbatches, two steps
    qcfg = dataclasses.replace(jqwen.SMOKE, compute_dtype=jnp.float32,
                               cache_dtype=jnp.float32)
    qparams = unflat("train/init/")
    loss = lambda p, b: tf.loss_fn(p, b["tokens"], b["labels"], b["mask"], qcfg)
    tstep = jax.jit(train_loop.make_train_step(
        loss, train_loop.TrainStepConfig(n_micro=K["train"]["n_micro"])))
    from repro.training import optim
    state = (qparams, optim.init(qparams))
    batches = [{k: jnp.asarray(inp[f"train/batch{i}/{k}"]) for k in ("tokens", "labels", "mask")}
               for i in range(K["train"]["steps"])]

    # routing over the global batch: one device, the global batch's values;
    # make_train_step's body, its gradient returned beside the state
    from repro.training import microbatch as jmicro
    from repro.training import optim as joptim

    def step_and_grads(loss, n_micro):
        def fn(state, b):
            params, opt = state
            val, grads = jmicro.accumulated_grads(loss, params, b, n_micro)
            new_p, new_o, metrics = joptim.apply_updates(params, grads, opt,
                                                         train_loop.TrainStepConfig().adamw)
            metrics["loss"] = val
            return (new_p, new_o), metrics, grads
        return fn

    gjobs = []          # (output key, jitted fn, args)
    for name, (base, moe_kw) in K["global_cases"].items():
        cfg = {"granite": jgran.SMOKE, "deepseek": jdeep.SMOKE}[base]
        cfg = dataclasses.replace(cfg, compute_dtype=jnp.float32, cache_dtype=jnp.float32,
                                  moe=dataclasses.replace(cfg.moe, **moe_kw))
        gp = unflat(f"global/{name}/params/")
        gb = {k: jnp.asarray(inp[f"global/{name}/{k}"]) for k in ("tokens", "labels", "mask")}
        gloss = lambda p, b, cfg=cfg: tf.loss_fn(p, b["tokens"], b["labels"], b["mask"], cfg)
        gjobs.append((f"global/{name}", jax.jit(step_and_grads(gloss, K["train"]["n_micro"])),
                      ((gp, joptim.init(gp)), gb)))

    def compile_job(job):
        key, fn, args, mesh = job
        with set_mesh_compat(mesh):
            return fn.lower(*args).compile()

    with ThreadPoolExecutor(8) as pool:
        gcomp = [pool.submit(lambda j=j: j[1].lower(*j[2]).compile()) for j in gjobs]
        compiled = list(pool.map(compile_job, jobs))
        gcomp = [c.result() for c in gcomp]
        tcomp = pool.submit(lambda: tstep.lower(state, batches[0]).compile())
        tcomp = tcomp.result()
    for (key, fn, args, mesh), c in zip(jobs, compiled):
        with set_mesh_compat(mesh):
            res = c(*args)
        if key == "psum":
            red, nr = res
            for k in K["psum_shapes"]:
                out[f"psum/reduced/{k}"] = np.asarray(red[k])
                out[f"psum/residual/{k}"] = np.asarray(nr[k])
        else:
            y, aux = res
            out[key + "/y"] = np.asarray(y)
            out[key + "/aux"] = np.asarray(aux)
    for (key, fn, args), c in zip(gjobs, gcomp):
        state_, m, g = c(*args)
        flat(key + "/state/", state_)
        flat(key + "/grad/", g)
        for k, v in m.items():
            out[f"{key}/metrics/{k}"] = np.asarray(v)
    metrics = []
    for b in batches:
        state, m = tcomp(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    flat("train/final/", state)

    # the reference test's per-shard gradients 0..3 (mean 1.5), eager as
    # that test runs it, and jitted
    gg = jnp.repeat(jnp.arange(4.0)[:, None], 8, axis=1)
    def f(a, b):
        o, n = compression.compressed_psum({"w": a[0]}, {"w": b[0]}, "data")
        return o["w"][None], n["w"][None]
    sm = shard_map(f, mesh=pmesh, in_specs=(P("data", None), P("data", None)),
                   out_specs=(P("data", None), P("data", None)), check_rep=False)
    with set_mesh_compat(pmesh):
        for mode, fn in (("eager", sm), ("jit", jax.jit(sm))):
            o, n = fn(gg, jnp.zeros_like(gg))
            out[f"psum0123/{mode}/reduced"] = np.asarray(o)
            out[f"psum0123/{mode}/residual"] = np.asarray(n)

    # a checkpoint saved from 4 devices, sharded on 'model'
    cmesh = make_mesh_compat((4,), ("model",))
    x = jax.device_put(jnp.arange(32.0).reshape(8, 4), NamedSharding(cmesh, P("model", None)))
    checkpoint.save(K["ckpt"], 3, {"x": x})
    np.savez(K["out"], **out)
    print(json.dumps({"metrics": metrics}))
"""


def _start_reference(n_devices: int, body: str) -> subprocess.Popen:
    """``test_distributed._run``'s subprocess, started without waiting."""
    prog = textwrap.dedent(f"""
        import os
        os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count={n_devices}"
        import json
        import jax
        import jax.numpy as jnp
        import numpy as np
        from repro.launch.mesh import make_mesh_compat, set_mesh_compat
    """) + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.Popen([sys.executable, "-c", prog], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)


def _flat_params(tree_, prefix):
    if isinstance(tree_, dict):
        out = {}
        for k, v in tree_.items():
            out.update(_flat_params(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree_.numpy()}


def _write_inputs(path):
    """Every input both packages share; the training run starts from the
    port's seeded qwen2.5-3b SMOKE parameters."""
    from repro_torch.configs import qwen2_5_3b

    rng = np.random.default_rng(0)
    inp = _flat_params(ttf.init_params(torch.Generator().manual_seed(7), qwen2_5_3b.SMOKE),
                       "train/init")
    for name, (n_exp, pad, top_k, cf, tokens, seed) in MOE_CASES.items():
        r = np.random.default_rng(seed)
        e = pad or n_exp
        inp[f"moe/{name}/x"] = r.standard_normal((tokens, D_MODEL), dtype=np.float32)
        inp[f"moe/{name}/router"] = r.standard_normal((D_MODEL, e), dtype=np.float32) * 0.3
        for k, shape in (("w_gate", (e, D_MODEL, D_FF)), ("w_up", (e, D_MODEL, D_FF)),
                         ("w_down", (e, D_FF, D_MODEL))):
            inp[f"moe/{name}/{k}"] = r.standard_normal(shape, dtype=np.float32) * 0.1
    for name, (_, _, tshape) in LM_CASES.items():
        inp[f"lm/{name}/tokens"] = rng.integers(0, 512, tshape).astype(np.int32)
    for k, shape in PSUM_SHAPES.items():
        inp[f"psum/g/{k}"] = rng.standard_normal((4,) + shape, dtype=np.float32) * 3
        inp[f"psum/r/{k}"] = rng.standard_normal((4,) + shape, dtype=np.float32) * 0.01
    for i, b in enumerate(_train_batches()):
        for k, v in b.items():
            inp[f"train/batch{i}/{k}"] = v
    for ci, name in enumerate(GLOBAL_CASES):
        cfg = port_config(global_config(name))
        r = np.random.default_rng(60 + ci)
        for n, shape in _abstract_shapes(ttf.abstract_params(cfg)):
            if n.split("/")[-1] in ("ln1", "ln2", "final_norm"):
                a = 1.0 + 0.1 * r.normal(size=shape)
            elif n == "embed":
                a = 0.5 * r.normal(size=shape)
            else:
                a = r.normal(size=shape) / np.sqrt(cfg.d_model)
            inp[f"global/{name}/params/{n}"] = a.astype(np.float32)
        b, s = TRAIN["batch"], TRAIN["seq"]
        inp[f"global/{name}/tokens"] = r.integers(0, GLOBAL_TOKEN_IDS, (b, s), dtype=np.int32)
        inp[f"global/{name}/labels"] = r.integers(0, cfg.vocab_size, (b, s), dtype=np.int32)
        inp[f"global/{name}/mask"] = (r.random((b, s)) > 0.25).astype(np.float32)
    np.savez(path, **inp)
    return inp


def _abstract_shapes(tree_, prefix=""):
    """``(name, shape)`` of every leaf of a tree of meta tensors, names
    ``a/b/c``."""
    if isinstance(tree_, dict):
        return [x for k, v in tree_.items() for x in _abstract_shapes(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tuple(tree_.shape))]


def _sub(flat: dict, prefix: str) -> dict:
    """``{"prefix['a']/['b']": v}`` -> ``{"a": {"b": v}}``."""
    import re

    tree_ = {}
    for name, v in flat.items():
        if not name.startswith(prefix):
            continue
        keys = re.findall(r"\['(.*?)'\]|\.(\w+)|\[(\d+)\]", name[len(prefix):])
        keys = [a or b or int(c) for a, b, c in keys]
        node = tree_
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        node[keys[-1]] = v
    return tree_


def _close(got, want, what, extra=0.0):
    want = np.asarray(want)
    got = got.detach().cpu().double().numpy() if isinstance(got, torch.Tensor) else got
    bound = TOL * max(1.0, float(np.abs(want).max())) + extra
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: {err} > {bound}"
    return err


# ---------------------------------------------------------------------------
# moe_ffn_sharded and the LM forward with a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ffn_sharded_matches_reference(ref, case, shape):
    inp, out = ref["inp"], ref["out"]
    cfg = _moe_cfg(tmoe, case)
    params = {k: torch.from_numpy(inp[f"moe/{case}/{k}"])
              for k in ("router", "w_gate", "w_up", "w_down")}
    x = torch.from_numpy(inp[f"moe/{case}/x"])
    mesh = tmesh.local_mesh(shape, device=CPU)
    y, aux = tmoe.moe_ffn_sharded(x, params, cfg, mesh)
    key = f"moe/{case}/{shape[0]}x{shape[1]}"
    err = _close(y, out[key + "/y"], key)
    _close(aux, out[key + "/aux"], key + " aux")
    print(f"{key}: largest |y - ref| {err:.3g} of max |y| "
          f"{np.abs(out[key + '/y']).max():.3g}, bit-equal "
          f"{int((y.numpy() == out[key + '/y']).sum())} of {y.numel()}; aux "
          f"{float(aux)!r} vs {float(out[key + '/aux'])!r}")
    # the local form against moe_ffn: equal with one data shard (the same
    # routing and aux) where a token's contributions add in moe_ffn's order
    # (top 2: at most one add a shard)
    if shape[0] == 1 and cfg.top_k <= 2:
        y0, aux0 = tmoe.moe_ffn(x, params, cfg)
        assert torch.equal(y, y0) and torch.equal(aux, aux0)


def test_moe_ffn_sharded_refusals():
    cfg = _moe_cfg(tmoe, "top3")
    p = {k: torch.zeros(s) for k, s in (("router", (D_MODEL, 8)), ("w_gate", (8, D_MODEL, D_FF)),
                                        ("w_up", (8, D_MODEL, D_FF)),
                                        ("w_down", (8, D_FF, D_MODEL)))}
    with pytest.raises(ValueError, match="do not divide"):
        tmoe.moe_ffn_sharded(torch.zeros(4, D_MODEL), p, cfg, tmesh.local_mesh((1, 3), device=CPU))
    with pytest.raises(ValueError, match="do not split"):
        tmoe.moe_ffn_sharded(torch.zeros(5, D_MODEL), p, cfg, tmesh.local_mesh((2, 2), device=CPU))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("case", list(LM_CASES))
def test_lm_forward_with_mesh_matches_reference(ref, case, shape):
    out = ref["out"]
    cfg = port_config(lm_config(case))
    params = layers.params_from_reference(_sub(out, f"lm/{case}/params/"), CPU)
    tokens = torch.from_numpy(ref["inp"][f"lm/{case}/tokens"])
    mesh = tmesh.local_mesh(shape, device=CPU)
    key = f"lm/{case}/{shape[0]}x{shape[1]}"
    with torch.no_grad():
        hidden, aux = ttf.forward(params, tokens, cfg, mesh=mesh)
    err = _close(hidden, out[key + "/y"], key)
    _close(aux, out[key + "/aux"], key + " aux")
    print(f"{key}: largest |hidden - ref| {err:.3g}; aux {float(aux)!r} vs "
          f"{float(out[key + '/aux'])!r}")
    if case == "granite_ep_odd" or shape[0] == 1:
        # moe_ffn taken (3 tokens over 2 data shards), or one data shard:
        # the unsharded forward's bits
        h0, aux0 = ttf.forward(params, tokens, cfg)
        assert torch.equal(hidden, h0) and torch.equal(aux, aux0)


@pytest.mark.parametrize("case", ["granite_ep", "deepseek_ep"])
def test_generate_with_mesh_equals_unsharded(ref, case):
    """Greedy decode through the expert-parallel route on (1, 4): prefill
    and every decode step with ``mesh=``.  One data shard routes, counts
    capacity and drops as the unsharded layer does, so the tokens are the
    unsharded ones (over several data shards each has its own capacity,
    as in the reference, and the tokens may part)."""
    cfg = port_config(lm_config(case))
    params = layers.params_from_reference(_sub(ref["out"], f"lm/{case}/params/"), CPU)
    prompt = torch.from_numpy(ref["inp"][f"lm/{case}/tokens"])
    want = tdecode.generate(params, prompt, cfg, max_new_tokens=5)
    got = tdecode.generate(params, prompt, cfg, max_new_tokens=5,
                           mesh=tmesh.local_mesh((1, 4), device=CPU))
    assert torch.equal(got, want)


def _global_params(inp, case):
    return layers.params_from_reference(_sub_slash(inp, f"global/{case}/params/"), CPU)


def _sub_slash(flat: dict, prefix: str) -> dict:
    """``{"prefix/a/b": v}`` -> ``{"a": {"b": torch(v)}}``."""
    tree_ = {}
    for name, v in flat.items():
        if name.startswith(prefix):
            keys = name[len(prefix):].split("/")
            node = tree_
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = v
    return tree_


def test_moe_without_ep_over_process_group_is_refused(ref, gloo):
    """A MoE block off the expert-parallel route over a process group with
    several data ranks was refused (PR 27: a rank's rows alone would be
    routed, capped and averaged).  It now routes over the global batch
    (``moe.moe_ffn_global``): each of the (2, 2) gloo ranks' hidden states
    and the aux equal the port's one-device ``forward`` of the whole batch
    within 2e-6 (the route's probability sums run in another order), the
    cut binding.  With one data rank the rank holds the global batch, and
    the forward is the unsharded one bit for bit."""
    from test_torch_moe_global import assert_global_cut_binds, routes

    inp = ref["inp"]
    cfg = port_config(global_config("granite_global"))
    params = _global_params(inp, "granite_global")
    tokens = torch.from_numpy(inp["global/granite_global/tokens"])
    with torch.no_grad():
        sels = routes(lambda: ttf.forward(params, tokens, cfg))
        h0, aux0 = ttf.forward(params, tokens, cfg)
    assert_global_cut_binds(cfg, sels, 2, "granite_global")
    _, arrays = gloo[(2, 2)]
    rows = tokens.shape[0] // 2
    for rank, a in enumerate(arrays):
        i = rank // 2
        _close(a["global/granite_global/hidden"], h0[i * rows:(i + 1) * rows].numpy(),
               f"rank {rank} hidden")
        _close(a["global/granite_global/aux"], aux0.numpy(), f"rank {rank} aux")
    with torch.no_grad():
        h1, aux1 = ttf.forward(params, tokens, cfg,
                               mesh=tmesh.Mesh((1, 2), ("data", "model"),
                                               kind="process_group", device=CPU))
    assert torch.equal(h1, h0) and torch.equal(aux1, aux0)


@pytest.mark.parametrize("case", list(GLOBAL_CASES))
def test_global_route_gathered_step_matches_reference(ref, gloo, case):
    """Routing over the global batch through the gathered body on the (2, 2)
    gloo ranks: one ``jit_train_step`` (two microbatches, each routed over
    its global rows), its loss and every leaf's gradient
    (``accumulated_grads`` of ``loss_fn(mesh=)`` on each rank's rows,
    summed over 'data', as the step sums them), its metrics and the whole
    state after it, against the reference's one-device step on the global
    batch (``make_train_step``'s body, its gradient returned beside the
    state).  Each rank's rows of ``forward(mesh=)`` are held to the port's
    one device by the test above.  The first microbatch's cut binds."""
    from test_torch_moe_global import assert_global_cut_binds, routes

    inp, out = ref["inp"], ref["out"]
    cfg = port_config(global_config(case))
    params = _global_params(inp, case)
    tokens = torch.from_numpy(inp[f"global/{case}/tokens"])
    micro = tokens.shape[0] // TRAIN["n_micro"]
    with torch.no_grad():
        sels = routes(lambda: ttf.forward(params, tokens[:micro], cfg))
    kept = assert_global_cut_binds(cfg, sels, 2, f"{case} microbatch 0")
    _, arrays = gloo[(2, 2)]
    key = f"global/{case}"
    worst = 0.0
    for rank, a in enumerate(arrays):
        _close(np.float64(a[key + "/loss"]), out[key + "/metrics/loss"], f"rank {rank} loss")
        for name, want in out.items():
            if name.startswith(key + "/grad/"):
                n = name[len(key + "/grad/"):]
                worst = max(worst, _close(a[f"{key}/grad/{n}"], want, f"rank {rank} grad {n}"))
            elif name.startswith((key + "/state/", key + "/metrics/")):
                n = name[len(key) + 1:]
                _close(np.asarray(a[f"{key}/{n}"], np.float64), want, f"rank {rank} {n}")
    print(f"{case}: loss {float(arrays[0][key + '/loss'])!r} vs "
          f"{float(out[key + '/metrics/loss'])!r}; largest gradient difference {worst:.3g}; "
          f"kept (global, per rank, of) in microbatch 0 by layer {kept}")


def test_jit_train_step_takes_a_make_train_step_step():
    from repro_torch.training import train_loop

    with pytest.raises(TypeError, match="make_train_step"):
        train_loop.jit_train_step(lambda state, batch: (state, {}), {}, None, {})


# ---------------------------------------------------------------------------
# compressed_psum
# ---------------------------------------------------------------------------


def test_compressed_psum_bit_equal_reference(ref):
    inp, out = ref["inp"], ref["out"]
    g = {k: torch.from_numpy(inp[f"psum/g/{k}"]) for k in PSUM_SHAPES}
    r = {k: torch.from_numpy(inp[f"psum/r/{k}"]) for k in PSUM_SHAPES}
    red, res = compression.compressed_psum(g, r, LocalFabric(4, device=CPU))
    for k in PSUM_SHAPES:
        want = out[f"psum/reduced/{k}"]
        assert all(np.array_equal(want[i], want[0]) for i in range(4))
        np.testing.assert_array_equal(red[k].numpy(), want[0], err_msg=k)
        np.testing.assert_array_equal(res[k].numpy(), out[f"psum/residual/{k}"], err_msg=k)
        # within one quantisation step of the float64 mean of g + r
        exact = (inp[f"psum/g/{k}"].astype(np.float64) + inp[f"psum/r/{k}"]).mean(0)
        step = np.abs(inp[f"psum/g/{k}"] + inp[f"psum/r/{k}"]).max() / 127
        assert np.abs(red[k].numpy() - exact).max() <= step


def test_compressed_psum_per_shard_means(ref):
    """The reference test's case: bit for bit the jitted reference.  Run
    eagerly, the reference rounds ``q * scale`` before the subtraction
    (XLA fuses the two under jit): its residuals then differ from the
    port's by that product's rounding, within one float32 ulp of the
    gradient; its reduced values are the same."""
    out = ref["out"]
    g = torch.arange(4.0)[:, None].repeat(1, 8)
    red, res = compression.compressed_psum({"w": g}, {"w": torch.zeros_like(g)},
                                           LocalFabric(4, device=CPU))
    for mode in ("jit", "eager"):
        np.testing.assert_array_equal(red["w"].numpy(), out[f"psum0123/{mode}/reduced"][0])
    np.testing.assert_array_equal(res["w"].numpy(), out["psum0123/jit/residual"])
    eager = out["psum0123/eager/residual"]
    assert (np.abs(res["w"].numpy() - eager) <= np.spacing(g.numpy())).all()
    np.testing.assert_allclose(red["w"].numpy(), 1.5, atol=0.05)


# ---------------------------------------------------------------------------
# gloo: jit_train_step, moe_ffn_sharded over a process group, checkpoints
# ---------------------------------------------------------------------------

_GLOO_WORKER = """
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.configs import qwen2_5_3b
from repro_torch.distribution import sharding
from repro_torch.launch import mesh as M
from repro_torch.models import layers, moe, transformer as tf
from repro_torch.training import checkpoint, microbatch, optim, train_loop, tree

rank, world, init = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
K = json.loads(sys.argv[4])
dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
cpu = torch.device("cpu")
out = {}


def unflat(flat, prefix):
    tree_ = {}
    for name, v in flat.items():
        if name.startswith(prefix):
            keys = name[len(prefix):].split("/")
            node = tree_
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = v
    return tree_


if K["task"] == "train":
    mesh = M.process_group_mesh(K["shape"], ("data", "model"), device=cpu)
    with np.load(K["inp"]) as f:
        inp = dict(f)
    cfg = qwen2_5_3b.SMOKE
    params = layers.params_from_reference(unflat(inp, "train/init/"), cpu)
    psh, osh = train_loop.state_shardings(
        tf.param_logical(cfg), sharding.LM_TRAIN_RULES, mesh, zero1=True,
        params_abs=params)
    bsh = train_loop.batch_shardings(
        {n: ("batch", "seq") for n in ("tokens", "labels", "mask")},
        sharding.LM_TRAIN_RULES, mesh)
    step = train_loop.jit_train_step(train_loop.make_train_step(
        lambda p, b: tf.loss_fn(p, b["tokens"], b["labels"], b["mask"], cfg, mesh=mesh),
        train_loop.TrainStepConfig(n_micro=K["n_micro"])), psh, osh, bsh)
    state = sharding.place((params, optim.init(params)), (psh, osh))
    out["local_shapes"] = {n: list(x.to_local().shape)
                           for n, x in zip(*tree.flatten_with_names(state))}
    metrics = []
    for i in range(K["steps"]):
        batch = {n: torch.from_numpy(inp[f"train/batch{i}/{n}"])
                 for n in ("tokens", "labels", "mask")}
        state, m = step(state, batch)
        metrics.append({n: float(v) for n, v in m.items()})
    out["metrics"] = metrics
    names, leaves = tree.flatten_with_names(sharding.gather_state(state))
    arrays = {n: x.numpy() for n, x in zip(names, leaves)}
    # expert parallelism over the process group (serving: no autograd)
    n_exp, pad, top_k, cf = K["moe_case"]
    cfg_m = moe.MoEConfig(n_experts=n_exp, top_k=top_k, d_ff_expert=K["d_ff"],
                          capacity_factor=cf, pad_experts_to=pad, ep_shard_map=True)
    p = {n: torch.from_numpy(inp[f"moe/top3/{n}"]) for n in ("router", "w_gate", "w_up",
                                                             "w_down")}
    x = torch.from_numpy(inp["moe/top3/x"])
    t_loc = x.shape[0] // K["shape"][0]
    i = mesh.coordinate("data")
    with torch.no_grad():
        y, aux = moe.moe_ffn_sharded(x[i * t_loc:(i + 1) * t_loc], p, cfg_m, mesh)
    arrays["moe/y"], arrays["moe/aux"] = y.numpy(), aux.numpy()
    # routing over the global batch (no ep_shard_map): this rank's rows
    from repro_torch.configs import deepseek_moe_16b, granite_moe_3b_a800m
    data = mesh.fabric("data")
    for name, (base, moe_kw) in K.get("global_cases", {}).items():
        c0 = {"granite": granite_moe_3b_a800m.SMOKE, "deepseek": deepseek_moe_16b.SMOKE}[base]
        gcfg = dataclasses.replace(c0, compute_dtype=torch.float32,
                                   cache_dtype=torch.float32,
                                   moe=dataclasses.replace(c0.moe, **moe_kw))
        gp = layers.params_from_reference(unflat(inp, f"global/{name}/params/"), cpu)
        gb = {n: torch.from_numpy(inp[f"global/{name}/{n}"]) for n in ("tokens", "labels",
                                                                       "mask")}
        rows = gb["tokens"].shape[0] // K["shape"][0]
        with torch.no_grad():
            h, aux = tf.forward(gp, gb["tokens"][i * rows:(i + 1) * rows], gcfg, mesh=mesh)
        arrays[f"global/{name}/hidden"], arrays[f"global/{name}/aux"] = h.numpy(), aux.numpy()
        # the step's gradient: its microbatches' rows of this rank, summed over 'data'
        gloss = lambda pp, b: tf.loss_fn(pp, b["tokens"], b["labels"], b["mask"], gcfg,
                                         mesh=mesh)
        loss, grads = microbatch.accumulated_grads(
            gloss, gp, train_loop._local_batch(gb, bsh, K["n_micro"]), K["n_micro"])
        arrays[f"global/{name}/loss"] = data.psum(loss.detach()[None]).numpy()
        for n, g in zip(*tree.flatten_with_names(grads)):
            arrays[f"global/{name}/grad/{n}"] = data.psum(g[None]).numpy()
        gpsh, gosh = train_loop.state_shardings(
            tf.param_logical(gcfg), sharding.LM_TRAIN_RULES, mesh, zero1=True, params_abs=gp)
        gstep = train_loop.jit_train_step(train_loop.make_train_step(
            gloss, train_loop.TrainStepConfig(n_micro=K["n_micro"])), gpsh, gosh, bsh)
        gstate, m = gstep(sharding.place((gp, optim.init(gp)), (gpsh, gosh)), gb)
        for k, v in m.items():
            arrays[f"global/{name}/metrics/{k}"] = v.numpy()
        for n, x in zip(*tree.flatten_with_names(sharding.gather_state(gstate))):
            arrays[f"global/{name}/state/{n}"] = x.numpy()
    np.savez(os.path.join(K["dir"], f"rank{rank}.npz"), **arrays)
elif K["task"] == "resilient":
    import time
    from repro_torch.training import resilience

    mesh = M.process_group_mesh((world, 1), ("data", "model"), device=cpu)
    rules, n_rows, n_steps = sharding.LM_TRAIN_RULES, 8, 4
    # w: ZeRO-1 splits its moments over 'data'; b: placed on 'model' only
    psh, osh = train_loop.state_shardings(
        {"w": ("embed_kv", "mlp"), "b": ("mlp",)}, rules, mesh, zero1=True,
        params_abs={"w": torch.empty(8, 4), "b": torch.empty(4)})
    bsh = train_loop.batch_shardings({"x": ("batch", "embed_kv"),
                                      "y": ("batch", "embed_kv")}, rules, mesh)
    g = torch.Generator().manual_seed(0)
    w0, b0 = torch.randn(8, 4, generator=g), torch.randn(4, generator=g)
    xs, ys = torch.randn(n_steps, n_rows, 8, generator=g), torch.randn(n_steps, n_rows, 4,
                                                                       generator=g)

    def loss(p, b):      # this rank's share of the global mean squared error
        return ((b["x"] @ p["w"] + p["b"] - b["y"]) ** 2).sum() / (n_rows * 4)

    step = train_loop.jit_train_step(train_loop.make_train_step(
        loss, train_loop.TrainStepConfig(adamw=optim.AdamWConfig(lr=1e-2, warmup_steps=0))),
        psh, osh, bsh)

    def run(ckpt_dir, fail_at):
        params = {"w": w0.clone(), "b": b0.clone()}
        state = sharding.place((params, optim.init(params)), (psh, osh))
        state, report = resilience.run_resilient(
            step, lambda i: {"x": xs[i], "y": ys[i]}, state, n_steps,
            resilience.ResilienceConfig(ckpt_dir=ckpt_dir, ckpt_every=2),
            failure_hook=resilience.make_scheduled_failures(fail_at),
            state_shardings=(psh, osh))
        names, leaves = tree.flatten_with_names(sharding.gather_state(state))
        return report, {n: x.numpy().tobytes().hex() for n, x in zip(names, leaves)}

    _, out["clean"] = run(os.path.join(K["dir"], "clean"), {})
    # rank 0 writes slowly: a rank that read LATEST before the write was
    # in place would fail at step 0 or restore an older step at step 2
    restored, restore, savez = [], checkpoint.restore, np.savez

    def recording_restore(*a, **kw):
        got = restore(*a, **kw)
        restored.append(got[1])
        return got

    def slow_savez(*a, **kw):
        time.sleep(0.5)
        return savez(*a, **kw)

    checkpoint.restore = recording_restore
    if rank == 0:
        np.savez = slow_savez
    report, out["failed"] = run(os.path.join(K["dir"], "failed"), {0: 1, 2: 1})
    checkpoint.restore, np.savez = restore, savez
    out["restored"], out["restores"] = restored, report.restores
elif K["task"] == "ckpt_save":
    mesh = M.process_group_mesh((world,), ("model",), device=cpu)
    sh = sharding.NamedSharding(mesh, sharding.P("model", None))
    x = sh.distribute(torch.arange(32.0).reshape(8, 4))
    out["local"] = x.to_local().tolist()
    checkpoint.save(K["ckpt"], 3, {"x": x})
elif K["task"] == "ckpt_restore":
    mesh = M.process_group_mesh((world,), ("model",), device=cpu)
    sh = {"x": sharding.NamedSharding(mesh, sharding.P("model", None))}
    for name in ("port", "ref"):
        restored, step = checkpoint.restore(K[name], {"x": torch.zeros(8, 4)}, shardings=sh)
        x = restored["x"]
        out[name] = dict(step=step, local=x.to_local().tolist(),
                         full=x.full_tensor().tolist(), placements=str(x.placements))
dist.barrier()
dist.destroy_process_group()
print(json.dumps(out))
"""


def _spawn(world: int, k: dict, tmp):
    init = f"file://{tmp / ('store_' + k['task'] + str(world) + str(k.get('shape', '')))}"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return [subprocess.Popen(
        [sys.executable, "-c", _GLOO_WORKER, str(r), str(world), init, json.dumps(k)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(world)]


def _collect(procs):
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawned run, side by side: the reference's subprocess, the two
    gloo training meshes and the 4-rank checkpoint save; then the 2-rank
    restore of both checkpoints."""
    d = tmp_path_factory.mktemp("dist")
    inp = _write_inputs(str(d / "inp.npz"))
    k = dict(inp=str(d / "inp.npz"), out=str(d / "out.npz"), ckpt=str(d / "ckpt_ref"),
             moe_cases=MOE_CASES, lm_cases=LM_CASES, meshes=MESHES, d_ff=D_FF,
             psum_shapes=PSUM_SHAPES, train=TRAIN, global_cases=GLOBAL_CASES)
    reference = _start_reference(4, _REFERENCE_BODY % json.dumps(k))
    common = dict(inp=str(d / "inp.npz"), n_micro=TRAIN["n_micro"], steps=TRAIN["steps"],
                  d_ff=D_FF, moe_case=MOE_CASES["top3"][:4])
    jobs = {}
    for shape in ((2, 1), (2, 2)):
        sub = d / f"train{shape[0]}x{shape[1]}"
        sub.mkdir()
        extra = {"global_cases": GLOBAL_CASES} if shape == (2, 2) else {}
        jobs[shape] = (sub, _spawn(shape[0] * shape[1],
                                   dict(common, task="train", shape=shape, dir=str(sub),
                                        **extra), d))
    save = _spawn(4, dict(task="ckpt_save", ckpt=str(d / "ckpt_port")), d)
    (d / "resilient").mkdir()
    resilient = _spawn(2, dict(task="resilient", dir=str(d / "resilient")), d)
    res = {"save": _collect(save), "resilient": _collect(resilient)}
    ref_out, err = reference.communicate(timeout=540)
    assert reference.returncode == 0, err[-3000:]
    restore = _spawn(2, dict(task="ckpt_restore", port=str(d / "ckpt_port"),
                             ref=str(d / "ckpt_ref")), d)
    for shape, (sub, procs) in jobs.items():
        outs = _collect(procs)
        arrays = []
        for r in range(len(procs)):
            with np.load(sub / f"rank{r}.npz") as f:
                arrays.append(dict(f))
        res[shape] = (outs, arrays)
    res["restore"] = _collect(restore)
    with np.load(d / "out.npz") as f:
        out = dict(f)
    res["ref"] = dict(inp=inp, out=out,
                      metrics=json.loads(ref_out.strip().splitlines()[-1])["metrics"])
    return res


@pytest.fixture(scope="module")
def ref(runs):
    return runs["ref"]


@pytest.fixture(scope="module")
def gloo(runs):
    return runs


@pytest.mark.parametrize("shape", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
def test_jit_train_step_over_gloo_matches_reference(ref, gloo, shape):
    outs, arrays = gloo[shape]
    out = ref["out"]
    for rank_out in outs:
        for got, want in zip(rank_out["metrics"], ref["metrics"]):
            for n in want:
                _close(np.float64(got[n]), want[n], f"metric {n}")
    worst = 0.0
    for name, got in arrays[0].items():
        if name.startswith(("moe/", "global/")):
            continue
        want = out["train/final/" + name]
        assert got.shape == want.shape and got.dtype == want.dtype, name
        for other in arrays[1:]:          # every rank holds the same state
            np.testing.assert_array_equal(other[name], got, err_msg=name)
        err = _close(got.astype(np.float64), want, name)
        worst = max(worst, err)
    print(f"{shape}: largest |state - reference| after {TRAIN['steps']} steps: {worst:.3g}")
    # ZeRO-1 blocks: the moments of a leaf placed on no data axis are split
    # over 'data' on their largest divisible dim
    shapes = outs[0]["local_shapes"]
    n_data, n_model = shape
    assert shapes["[1]/.m/['embed']"] == [512 // n_model, 64 // n_data]
    assert shapes["[0]/['embed']"] == [512 // n_model, 64]
    assert shapes["[1]/.m/['blocks']/['wq']"] == [2, 64 // n_data, 4 // n_model, 16]
    assert shapes["[1]/.step"] == []


def test_moe_ffn_sharded_over_gloo_equals_local(ref, gloo):
    outs, arrays = gloo[(2, 2)]
    inp = ref["inp"]
    cfg = _moe_cfg(tmoe, "top3")
    params = {k: torch.from_numpy(inp[f"moe/top3/{k}"])
              for k in ("router", "w_gate", "w_up", "w_down")}
    y, aux = tmoe.moe_ffn_sharded(torch.from_numpy(inp["moe/top3/x"]), params, cfg,
                                  tmesh.local_mesh((2, 2), device=CPU))
    t_loc = y.shape[0] // 2
    for rank, a in enumerate(arrays):
        i = rank // 2                                     # the rank's data coordinate
        np.testing.assert_array_equal(a["moe/y"], y[i * t_loc:(i + 1) * t_loc].numpy())
        np.testing.assert_array_equal(a["moe/aux"], aux.numpy())


def test_checkpoint_from_four_ranks_restores_onto_two(gloo):
    saved = gloo["save"]
    want = np.arange(32.0).reshape(8, 4)
    for rank, o in enumerate(saved):
        np.testing.assert_array_equal(o["local"], want[2 * rank:2 * rank + 2])
    for rank, o in enumerate(gloo["restore"]):
        for name in ("port", "ref"):
            r = o[name]
            assert r["step"] == 3 and r["placements"] == "(Shard(dim=0),)"
            np.testing.assert_array_equal(r["local"], want[4 * rank:4 * rank + 4])
            np.testing.assert_array_equal(r["full"], want)


def test_run_resilient_over_gloo_restores_one_step_on_every_rank(gloo):
    """run_resilient(state_shardings=) over 2 gloo ranks (a ZeRO-1
    jit_train_step), failures at step 0 and at checkpoint step 2, rank 0
    writing slowly: every rank restores steps 0 and 2 and ends with the
    bits of the run without failures."""
    outs = gloo["resilient"]
    for o in outs:
        assert o["restores"] == 2 and o["restored"] == [0, 2]
        assert o["failed"] == outs[0]["failed"]
        assert o["failed"] == o["clean"]


def test_checkpoint_restore_shardings_needs_a_process_group(tmp_path):
    from repro_torch.distribution import sharding
    from repro_torch.training import checkpoint

    checkpoint.save(str(tmp_path), 1, {"x": torch.zeros(6, 4)})
    mesh = tmesh.Mesh((4,), ("model",), kind="abstract")
    with pytest.raises(ValueError, match="process-group"):
        checkpoint.restore(str(tmp_path), {"x": torch.zeros(6, 4)},
                           shardings={"x": sharding.NamedSharding(mesh, sharding.P("model"))})
