"""The port's MoE FFN and MoE decoder against the JAX package.

``moe_ffn`` on one reference layer's weights (``init_moe_params`` carried
across by ``layers.params_from_reference``): no shared experts and two,
padded experts, and a capacity factor that drops tokens.  Expert
selections and the kept assignments must be exact; the smallest gap
between a token's k-th and (k+1)-th router probability is printed (a gap
near float32 rounding would make the selection a coin toss).

The MoE decoder on both MoE SMOKE configs (granite: routed experts only;
deepseek: two shared experts and a dense layer 0) and on a padded config
shaped like granite's FULL (heads, vocabulary and experts all padded):
``forward`` (hidden states and the summed aux loss), ``prefill``, four
``decode_step`` calls and greedy ``generate``, in float32 compute and
cache, on the reference's own weights.

Tolerance: 2e-6 absolute where the reference's values are O(1); where
they are larger (the expert outputs here reach ~45: an ``(E, d, ff)``
expert tensor has fan-in ``E``, so its weights have std ``E**-0.5``), 2e-6
times the tensor's largest magnitude, as the ranked scores are held
(ROADMAP "Ranked scores").  XLA and torch sum the products in different
orders.  Tokens, expert ids and kept assignments must be equal.

Every reference call runs once, jitted, in the module fixtures (the
routing capture runs the reference's ``moe_ffn`` eagerly, with
``jax.lax.top_k`` wrapped to keep its output).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_moe_16b as jdeep
from repro.configs import granite_moe_3b_a800m as jgran
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving import decode as jdecode
from repro_torch.configs import deepseek_moe_16b as tdeep
from repro_torch.configs import granite_moe_3b_a800m as tgran
from repro_torch.models import layers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serving import decode as tdecode

ATOL = 2e-6
CPU = torch.device("cpu")
PROMPT = (2, 6)        # batch, prompt length
DECODE_STEPS = 4
NEW_TOKENS = 5
D_MODEL = 64
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

# (n_shared, pad_experts_to, capacity_factor, tokens)
FFN_CASES = {
    "routed": (0, None, 1.25, 24),
    "shared2_padded": (2, 12, 1.25, 40),
    "dropping_padded": (0, 10, 0.5, 64),
    "shared2_dropping": (2, None, 0.3, 30),
}

_PADDED = jtf.LMConfig(
    name="moe-padded", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    head_dim=16, d_ff=64, vocab_size=500, pad_heads_to=8, pad_vocab_to=512,
    tie_embeddings=True, remat=False,
    moe=jmoe.MoEConfig(n_experts=6, top_k=3, d_ff_expert=32, pad_experts_to=8))


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype=jnp.float32,
                               cache_dtype=jnp.float32)


LM_CASES = {
    "granite_smoke": _f32(jgran.SMOKE),
    "deepseek_smoke": _f32(jdeep.SMOKE),
    "padded": _f32(_PADDED),
}


def port_moe(jm):
    return tmoe.MoEConfig(**{f.name: getattr(jm, f.name)
                             for f in dataclasses.fields(jm)})


def port_config(jcfg):
    """The reference's config as the port's (dtypes and MoE config mapped)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["compute_dtype"] = DTYPES[jnp.dtype(jcfg.compute_dtype).type]
    fields["cache_dtype"] = DTYPES[jnp.dtype(jcfg.cache_dtype).type]
    if jcfg.moe is not None:
        fields["moe"] = port_moe(jcfg.moe)
    return ttf.LMConfig(**fields)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, what):
    """Within 2e-6, or 2e-6 of the reference's largest magnitude."""
    want = np.asarray(want)
    bound = ATOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().cpu().float().numpy(), want,
                               rtol=0, atol=bound, err_msg=what)


def _keep_order(sel, cap):
    """The reference's dispatch rule in numpy: assignments sorted stably
    by expert, kept while their place in the expert is below ``cap``."""
    flat = sel.reshape(-1)
    order = np.argsort(flat, kind="stable")
    se = flat[order]
    start = np.searchsorted(se, se, side="left")
    return order, (np.arange(se.size) - start) < cap


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------


def _ffn_config(case):
    n_shared, pad, cf, _ = FFN_CASES[case]
    return jmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=48,
                          n_shared=n_shared, pad_experts_to=pad,
                          capacity_factor=cf)


@pytest.fixture(scope="module")
def ffn_reference():
    out = {}
    real_top_k = jax.lax.top_k
    for seed, case in enumerate(FFN_CASES):
        cfg = _ffn_config(case)
        t = FFN_CASES[case][3]
        params = _np_tree(jmoe.init_moe_params(jax.random.key(seed), D_MODEL, cfg))
        x = np.random.default_rng(50 + seed).normal(size=(t, D_MODEL)).astype(np.float32)
        y, aux = jax.jit(lambda p, x: jmoe.moe_ffn(x, p, cfg))(params, x)
        seen = []

        def spy(operand, k):
            res = real_top_k(operand, k)
            seen.append((np.asarray(operand), *map(np.asarray, res)))
            return res

        jax.lax.top_k = spy
        try:
            jmoe.moe_ffn(jnp.asarray(x), params, cfg)
        finally:
            jax.lax.top_k = real_top_k
        probs, gate, sel = seen[0]
        out[case] = dict(cfg=cfg, params=params, x=x, y=np.asarray(y),
                         aux=float(aux), probs=probs, gate=gate, sel=sel)
    return out


@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_reference(ffn_reference, case):
    r = ffn_reference[case]
    cfg = port_moe(r["cfg"])
    params = layers.params_from_reference(r["params"], CPU)
    x = torch.from_numpy(r["x"])
    y, aux = tmoe.moe_ffn(x, params, cfg)
    assert y.shape == r["y"].shape and y.dtype == torch.float32
    _close(y, r["y"], "moe_ffn output")
    _close(aux, r["aux"], "aux loss")

    probs, gate, sel = tmoe.route(x, params["router"], cfg)
    np.testing.assert_array_equal(sel.numpy(), r["sel"])
    _close(probs, r["probs"], "router probabilities")
    _close(gate, r["gate"] / np.maximum(r["gate"].sum(-1, keepdims=True), 1e-9),
           "gates")
    t, k = x.shape[0], cfg.top_k
    order, dest, keep, cap = tmoe.dispatch(sel, t, cfg)
    want_order, want_keep = _keep_order(r["sel"], cfg.capacity(t))
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert cap == r["cfg"].capacity(t)
    srt = np.sort(r["probs"], axis=-1)[:, ::-1]
    gap = float((srt[:, k - 1] - srt[:, k]).min())
    print(f"{case}: smallest k-th/(k+1)-th probability gap {gap:.3e}, "
          f"{int((~want_keep).sum())} of {t * k} assignments dropped")
    assert gap > 1e-6
    if "dropping" in case:
        assert (~want_keep).any(), "the dropping case drops nothing"


def test_moe_config_matches_reference():
    jm = jgran.FULL.moe
    tm = port_moe(jm)
    assert tm == tgran.FULL.moe
    for t in (1, 4, 8, 2048, 12_345):
        assert tm.capacity(t) == jm.capacity(t)
    assert tm.n_experts_padded == jm.n_experts_padded == 48
    want = {f.name: f.default for f in dataclasses.fields(jmoe.MoEConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tmoe.MoEConfig)}
    assert got == want


@pytest.mark.parametrize("n_shared,pad", [(0, None), (2, 12)])
def test_init_moe_params_layout_matches_reference(n_shared, pad):
    jcfg = jmoe.MoEConfig(n_experts=8, top_k=2, d_ff_expert=48,
                          n_shared=n_shared, pad_experts_to=pad)
    want = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)),
                                  jmoe.init_moe_params(jax.random.key(0), D_MODEL, jcfg))
    got = tmoe.init_moe_params(torch.Generator().manual_seed(0), D_MODEL,
                               port_moe(jcfg))
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got) == want
    # the reference's fan-in rule: std (E_pad)**-0.5 for the (E, d, ff) tensors
    e = jcfg.n_experts_padded
    big = tmoe.init_moe_params(torch.Generator().manual_seed(1), 256,
                               dataclasses.replace(port_moe(jcfg), d_ff_expert=256))
    assert abs(float(big["w_gate"].std()) - e ** -0.5) < 0.01
    assert abs(float(big["router"].std()) - 256 ** -0.5) < 0.01


# ---------------------------------------------------------------------------
# configs and parameter counts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jmod,tmod", [(jgran, tgran), (jdeep, tdeep)],
                         ids=["granite-moe-3b-a800m", "deepseek-moe-16b"])
def test_moe_configs_match_reference(jmod, tmod):
    for which in ("FULL", "SMOKE"):
        jcfg, tcfg = getattr(jmod, which), getattr(tmod, which)
        assert tcfg == port_config(jcfg), which
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.physical_param_count() == jcfg.physical_param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()
    assert tmod.SOURCE == jmod.spec().source


def test_dense_param_counts_match_reference():
    from repro.configs import qwen2_5_3b as jqwen
    from repro_torch.configs import qwen2_5_3b as tqwen

    for which in ("FULL", "SMOKE"):
        jcfg, tcfg = getattr(jqwen, which), getattr(tqwen, which)
        assert tcfg.physical_param_count() == jcfg.physical_param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()


# ---------------------------------------------------------------------------
# the MoE decoder
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference():
    out = {}
    for seed, (case, cfg) in enumerate(LM_CASES.items()):
        params = _np_tree(jtf.init_params(jax.random.key(seed), cfg))
        toks = np.random.default_rng(100 + seed).integers(
            0, cfg.vocab_size, PROMPT).astype(np.int32)
        max_seq = PROMPT[1] + DECODE_STEPS
        prefill = jax.jit(lambda p, t: jtf.prefill(p, t, cfg, max_seq=max_seq))
        step = jax.jit(lambda p, c, t, pos: jtf.decode_step(p, c, t, pos, cfg))
        forward = jax.jit(lambda p, t: jtf.forward(p, t, cfg))
        hidden, aux = forward(params, toks)
        logits, cache = prefill(params, toks)
        r = dict(params=params, toks=toks, hidden=np.asarray(hidden),
                 aux=float(aux), prefill_logits=np.asarray(logits),
                 prefill_cache=_np_tree(cache))
        cur = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        steps = []
        for i in range(DECODE_STEPS):
            logits, cache = step(params, cache, cur,
                                 jnp.asarray(PROMPT[1] + i, jnp.int32))
            steps.append((cur, np.asarray(logits), _np_tree(cache)))
            cur = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        r["steps"] = steps
        generate = jax.jit(lambda p, t: jdecode.generate(
            p, t, cfg, max_new_tokens=NEW_TOKENS))
        r["generated"] = np.asarray(generate(params, toks))
        out[case] = r
    return out


def _port(reference, case):
    r = reference[case]
    return r, port_config(LM_CASES[case]), ttf.params_from_reference(r["params"], CPU)


@pytest.mark.parametrize("case", list(LM_CASES))
def test_init_params_layout_matches_reference(reference, case):
    """The port's seeded init has the reference's tree, shapes and dtypes:
    the nested ``moe`` dict stacked on axis 0, and ``dense0`` unstacked."""
    want = jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)), reference[case]["params"])
    cfg = port_config(LM_CASES[case])
    got = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got)
    assert got == want
    e = cfg.moe.n_experts_padded
    assert want["blocks"]["moe"]["w_gate"][0] == (
        cfg.n_scan, e, cfg.d_model, cfg.moe.d_ff_expert)
    assert ("dense0" in want) == bool(cfg.first_dense_ff)


@pytest.mark.parametrize("case", list(LM_CASES))
def test_init_params_cast_as_drawn_equals_cast_for_serving(case):
    """``init_params(dtype=bf16)`` gives ``cast_for_serving`` of the float32
    tree bit for bit: the router, norms and nothing else stay float32."""
    f32 = port_config(LM_CASES[case])
    bf16 = dataclasses.replace(f32, compute_dtype=torch.bfloat16)
    want = ttf.cast_for_serving(ttf.init_params(torch.Generator().manual_seed(5), f32), bf16)
    got = ttf.init_params(torch.Generator().manual_seed(5), f32, dtype=torch.bfloat16)
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g)
    for path, w in flat_w:
        g = flat_g[path]
        assert g.dtype == w.dtype and torch.equal(g, w), path
    assert got["blocks"]["moe"]["router"].dtype == torch.float32
    assert got["blocks"]["moe"]["w_up"].dtype == torch.bfloat16
    if f32.moe.n_shared:
        assert got["blocks"]["moe"]["shared_down"].dtype == torch.bfloat16
        assert got["dense0"]["w_gate"].dtype == torch.bfloat16
        assert got["dense0"]["ln1"].dtype == torch.float32


@pytest.mark.parametrize("case", list(LM_CASES))
def test_forward_matches_reference(reference, case):
    r, cfg, params = _port(reference, case)
    hidden, aux = ttf.forward(params, torch.from_numpy(r["toks"]), cfg)
    _close(hidden, r["hidden"], "hidden")
    assert aux.dtype == torch.float32 and aux.shape == ()
    _close(aux, r["aux"], "aux")
    assert float(aux) > 0


@pytest.mark.parametrize("case", list(LM_CASES))
def test_prefill_matches_reference(reference, case):
    r, cfg, params = _port(reference, case)
    logits, cache = ttf.prefill(params, torch.from_numpy(r["toks"]), cfg,
                                max_seq=PROMPT[1] + DECODE_STEPS)
    _close(logits, r["prefill_logits"], "logits")
    for name in ("k", "v"):
        assert cache[name].shape[0] == cfg.n_layers
        _close(cache[name], r["prefill_cache"][name], name)
    if cfg.vocab_padded != cfg.vocab_size:
        assert (logits[:, cfg.vocab_size:] == -1e30).all()


@pytest.mark.parametrize("case", list(LM_CASES))
def test_decode_steps_match_reference(reference, case):
    r, cfg, params = _port(reference, case)
    _, cache = ttf.prefill(params, torch.from_numpy(r["toks"]), cfg,
                           max_seq=PROMPT[1] + DECODE_STEPS)
    for i, (cur, want_logits, want_cache) in enumerate(r["steps"]):
        logits, cache = ttf.decode_step(params, cache, torch.from_numpy(cur),
                                        PROMPT[1] + i, cfg)
        _close(logits, want_logits, f"step {i} logits")
        assert torch.equal(torch.argmax(logits, -1),
                           torch.from_numpy(np.argmax(want_logits, -1)))
        for name in ("k", "v"):
            _close(cache[name], want_cache[name], f"step {i} cache {name}")


@pytest.mark.parametrize("case", list(LM_CASES))
def test_generate_matches_reference(reference, case):
    r, cfg, params = _port(reference, case)
    got = tdecode.generate(params, torch.from_numpy(r["toks"]), cfg,
                           max_new_tokens=NEW_TOKENS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), r["generated"])


# ---------------------------------------------------------------------------
# NaN router rows and out-of-vocabulary ids: served as the reference serves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["routed", "shared2_padded"])
def test_moe_ffn_serves_a_nan_token_as_reference(ffn_reference, case):
    """One token's row all NaN: the reference's lax.top_k orders NaN first
    and serves it; the port's router (counter.topk_total) does too.  The
    NaN stays in that token's output row, the aux loss is NaN, and the
    finite rows equal the reference's and keep the bits the port gives
    them with the NaN row zeroed (no capacity binds here)."""
    r = ffn_reference[case]
    jcfg, cfg = r["cfg"], port_moe(r["cfg"])
    x = r["x"].copy()
    x[3] = np.nan
    y_ref, aux_ref = jax.jit(lambda p, x: jmoe.moe_ffn(x, p, jcfg))(r["params"], x)
    y_ref = np.asarray(y_ref)
    params = layers.params_from_reference(r["params"], CPU)
    y, aux = tmoe.moe_ffn(torch.from_numpy(x), params, cfg)
    assert np.isnan(y_ref[3]).all() and np.isnan(float(aux_ref))
    assert torch.isnan(y[3]).all() and torch.isnan(aux)
    finite = np.ones(x.shape[0], bool)
    finite[3] = False
    assert np.isfinite(y_ref[finite]).all()
    _close(y[finite], y_ref[finite], "finite rows")
    x0 = x.copy()
    x0[3] = 0.0
    y0, _ = tmoe.moe_ffn(torch.from_numpy(x0), params, cfg)
    assert torch.equal(y[finite], y0[finite])


def test_moe_out_of_vocabulary_ids_match_reference(reference):
    """Ids -1, 0, V-1, V, V+3, -V, -V-1 in the MoE decoder's forward,
    prefill, decode_step and generate (granite SMOKE): NaN where the
    reference's jnp.take fills, the NaN tokens routed and served."""
    from test_torch_lm import check_oob, oob_reference

    case = "granite_smoke"
    r, cfg, params = _port(reference, case)
    want = oob_reference(LM_CASES[case], r["params"], seed=8)
    check_oob(ttf, tdecode, params, cfg, want, _close)
