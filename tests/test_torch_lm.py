"""The port's dense LM (prefill, decode, forward, greedy generate) against
the JAX package.

Both sides run the same weights: the reference's ``init_params`` arrays
carried across by ``transformer.params_from_reference``, with random
nonzero ``bq``/``bk``/``bv`` where the config has QKV biases (the
reference initialises them to zero, which would hide the bias path).
Three configurations, all in float32 compute and cache:

  * ``qwen_smoke``: ``qwen2_5_3b.SMOKE`` (GQA 4/2, QKV bias, tied
    embeddings, rope theta 1e6);
  * ``padded_heads``: shaped like minitron (6 heads over 2 kv heads,
    padded to 8), untied head;
  * ``padded_vocab``: 500 tokens padded to 512 (pad logits -1e30).

Tolerance: 2e-6 absolute on every float (hidden states, logits, KV
caches): XLA and torch sum the matrix products in different orders, which
moves values of a few units (the caches, the normalised hidden states) by
a few float32 ulps.  Tokens must be equal.

Every reference call runs once, jitted, in the module-scoped
``reference`` fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import minitron_4b as jminitron
from repro.configs import qwen2_5_3b as jqwen
from repro.configs import smollm_360m as jsmollm
from repro.models import transformer as jtf
from repro.serving import decode as jdecode
from repro_torch.configs import minitron_4b as tminitron
from repro_torch.configs import qwen2_5_3b as tqwen
from repro_torch.configs import smollm_360m as tsmollm
from repro_torch.kernels import _build
from repro_torch.models import transformer as ttf
from repro_torch.serving import decode as tdecode

ATOL = 2e-6
CPU = torch.device("cpu")
PROMPT = (2, 6)        # batch, prompt length
DECODE_STEPS = 4
NEW_TOKENS = 5
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}

_PADDED_HEADS = dict(
    name="padded-heads", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    head_dim=16, d_ff=192, vocab_size=512, pad_heads_to=8, remat=False)
_PADDED_VOCAB = dict(
    name="padded-vocab", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab_size=500, pad_vocab_to=512, qkv_bias=True,
    tie_embeddings=True, remat=False)


def _f32(cfg):
    return dataclasses.replace(cfg, compute_dtype=jnp.float32,
                               cache_dtype=jnp.float32)


CASES = {
    "qwen_smoke": _f32(jqwen.SMOKE),
    "padded_heads": _f32(jtf.LMConfig(**_PADDED_HEADS)),
    "padded_vocab": _f32(jtf.LMConfig(**_PADDED_VOCAB)),
}


def port_config(jcfg):
    """The reference's config as the port's (dtypes mapped)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["compute_dtype"] = DTYPES[jnp.dtype(jcfg.compute_dtype).type]
    fields["cache_dtype"] = DTYPES[jnp.dtype(jcfg.cache_dtype).type]
    return ttf.LMConfig(**fields)


def _reference_params(cfg, seed):
    params = jtf.init_params(jax.random.key(seed), cfg)
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed)
        blocks = dict(params["blocks"])
        for name in ("bq", "bk", "bv"):
            blocks[name] = jnp.asarray(
                rng.normal(0.0, 0.5, blocks[name].shape).astype(np.float32))
        params = dict(params, blocks=blocks)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def reference():
    out = {}
    for seed, (case, cfg) in enumerate(CASES.items()):
        params = _reference_params(cfg, seed)
        rng = np.random.default_rng(100 + seed)
        toks = rng.integers(0, cfg.vocab_size, PROMPT).astype(np.int32)
        max_seq = PROMPT[1] + DECODE_STEPS
        prefill = jax.jit(lambda p, t: jtf.prefill(p, t, cfg, max_seq=max_seq))
        step = jax.jit(lambda p, c, t, pos: jtf.decode_step(p, c, t, pos, cfg))
        forward = jax.jit(lambda p, t: jtf.forward(p, t, cfg)[0])
        logits, cache = prefill(params, toks)
        r = dict(params=params, toks=toks,
                 cache0=jax.tree_util.tree_map(
                     np.asarray, jtf.init_kv_cache(cfg, PROMPT[0], max_seq)),
                 hidden=np.asarray(forward(params, toks)),
                 prefill_logits=np.asarray(logits),
                 prefill_cache=jax.tree_util.tree_map(np.asarray, cache))
        cur = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        steps = []
        for i in range(DECODE_STEPS):
            logits, cache = step(params, cache, cur,
                                 jnp.asarray(PROMPT[1] + i, jnp.int32))
            steps.append((cur, np.asarray(logits),
                          jax.tree_util.tree_map(np.asarray, cache)))
            cur = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        r["steps"] = steps
        generate = jax.jit(lambda p, t: jdecode.generate(
            p, t, cfg, max_new_tokens=NEW_TOKENS))
        r["generated"] = np.asarray(generate(params, toks))
        out[case] = r
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().cpu().float().numpy(), want,
                               rtol=0, atol=ATOL, err_msg=what)


def _port(reference, case):
    r = reference[case]
    return r, port_config(CASES[case]), ttf.params_from_reference(r["params"], CPU)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jmod,tmod", [(jqwen, tqwen), (jsmollm, tsmollm),
                                       (jminitron, tminitron)],
                         ids=["qwen2.5-3b", "smollm-360m", "minitron-4b"])
def test_configs_match_reference(jmod, tmod):
    for which in ("FULL", "SMOKE"):
        jcfg, tcfg = getattr(jmod, which), getattr(tmod, which)
        assert tcfg == port_config(jcfg), which
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.n_heads_padded == jcfg.n_heads_padded
        assert tcfg.vocab_padded == jcfg.vocab_padded
    assert tmod.SOURCE == jmod.spec().source


def test_lm_config_defaults_match_reference():
    want = {f.name: f.default for f in dataclasses.fields(jtf.LMConfig)}
    got = {f.name: f.default for f in dataclasses.fields(ttf.LMConfig)}
    assert got.keys() == want.keys()
    for name, value in want.items():
        if name in ("compute_dtype", "cache_dtype"):
            assert got[name] == DTYPES[jnp.dtype(value).type]
        else:
            assert got[name] == value, name


# ---------------------------------------------------------------------------
# parameters and the cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_init_params_layout_matches_reference(reference, case):
    """The port's seeded init has the reference's tree, shapes and dtypes
    (its numbers come from a torch.Generator)."""
    want = jax.tree_util.tree_map(
        lambda a: (a.shape, str(a.dtype)), reference[case]["params"])
    got = ttf.init_params(torch.Generator().manual_seed(0),
                          port_config(CASES[case]))
    got = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got)
    assert got == want
    hp, dh, d = (CASES[case].n_heads_padded, CASES[case].head_dim,
                 CASES[case].d_model)
    assert want["blocks"]["wq"][0] == (CASES[case].n_layers, d, hp, dh)
    assert want["blocks"]["wo"][0] == (CASES[case].n_layers, hp, dh, d)


@pytest.mark.parametrize("case", list(CASES))
def test_init_kv_cache_matches_reference(reference, case):
    r, cfg, _ = _port(reference, case)
    got = ttf.init_kv_cache(cfg, PROMPT[0], PROMPT[1] + DECODE_STEPS,
                            device=CPU)
    for name in ("k", "v"):
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), r["cache0"][name])


# ---------------------------------------------------------------------------
# forward, prefill, decode, generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_reference(reference, case):
    r, cfg, params = _port(reference, case)
    hidden, aux = ttf.forward(params, torch.from_numpy(r["toks"]), cfg)
    _close(hidden, r["hidden"], "hidden")
    assert float(aux) == 0.0


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_matches_reference(reference, case):
    r, cfg, params = _port(reference, case)
    logits, cache = ttf.prefill(params, torch.from_numpy(r["toks"]), cfg,
                                max_seq=PROMPT[1] + DECODE_STEPS)
    _close(logits, r["prefill_logits"], "logits")
    for name in ("k", "v"):
        _close(cache[name], r["prefill_cache"][name], name)
    if cfg.vocab_padded != cfg.vocab_size:
        assert (logits[:, cfg.vocab_size:] == -1e30).all()


@pytest.mark.parametrize("case", list(CASES))
def test_decode_steps_match_reference(reference, case):
    r, cfg, params = _port(reference, case)
    _, cache = ttf.prefill(params, torch.from_numpy(r["toks"]), cfg,
                           max_seq=PROMPT[1] + DECODE_STEPS)
    for i, (cur, want_logits, want_cache) in enumerate(r["steps"]):
        logits, cache = ttf.decode_step(params, cache, torch.from_numpy(cur),
                                        PROMPT[1] + i, cfg)
        _close(logits, want_logits, f"step {i} logits")
        for name in ("k", "v"):
            _close(cache[name], want_cache[name], f"step {i} cache {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_generate_matches_reference(reference, case):
    r, cfg, params = _port(reference, case)
    got = tdecode.generate(params, torch.from_numpy(r["toks"]), cfg,
                           max_new_tokens=NEW_TOKENS)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), r["generated"])


def test_decode_backends_agree_on_the_cpu(reference):
    """On CPU tensors both backends take the twin: equal bits, no launch."""
    r, cfg, params = _port(reference, "padded_heads")
    _build.reset_launches()
    out = {}
    for backend in ("pallas", "xla"):
        out[backend] = tdecode.generate(params, torch.from_numpy(r["toks"]),
                                        cfg, max_new_tokens=NEW_TOKENS,
                                        backend=backend)
    assert torch.equal(out["pallas"], out["xla"])
    assert _build.launches["decode_attention"] == 0


# ---------------------------------------------------------------------------
# the port alone: prefill + decode == forward, bf16 against f32
# ---------------------------------------------------------------------------


def _consistency_config(**kw):
    return ttf.LMConfig(
        name="t", n_layers=2, d_model=48, n_heads=4, n_kv_heads=2,
        head_dim=12, d_ff=96, vocab_size=160, qkv_bias=True, remat=False,
        **kw)


def test_prefill_plus_decode_matches_forward():
    """The reference's own check (tests/test_models_extra.py, dense case,
    its 2e-4) on the port alone."""
    cfg = _consistency_config(compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(
        np.random.default_rng(1).integers(0, 160, (2, 10)).astype(np.int32))
    h, _ = ttf.forward(params, toks, cfg)
    full = h @ ttf.lm_head_weight(params, cfg)
    logits_p, cache = ttf.prefill(params, toks[:, :6], cfg, max_seq=10)
    np.testing.assert_allclose(logits_p.numpy(), full[:, 5].numpy(),
                               rtol=2e-4, atol=2e-4)
    for i in range(6, 10):
        logits_d, cache = ttf.decode_step(params, cache, toks[:, i], i, cfg)
        np.testing.assert_allclose(logits_d.numpy(), full[:, i].numpy(),
                                   rtol=2e-4, atol=2e-4,
                                   err_msg=f"decode step {i}")


def test_bf16_decode_tracks_the_f32_path():
    """The serving dtypes (bf16 compute and cache, weights cast once by
    ``cast_for_serving``) against the port's own float32 path on the same
    weights: logits within 0.05 absolute (bf16 keeps 8 bits; the f32
    logits here are below ~1 in size), and the cast keeps the norm
    weights float32."""
    f32 = _consistency_config(compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    bf16 = _consistency_config()
    assert bf16.compute_dtype == bf16.cache_dtype == torch.bfloat16
    params = ttf.init_params(torch.Generator().manual_seed(3), f32)
    served = ttf.cast_for_serving(params, bf16)
    assert served["blocks"]["wq"].dtype == torch.bfloat16
    assert served["blocks"]["ln1"].dtype == torch.float32
    assert served["final_norm"].dtype == torch.float32
    toks = torch.from_numpy(
        np.random.default_rng(4).integers(0, 160, (2, 8)).astype(np.int32))
    want, wc = ttf.prefill(params, toks[:, :5], f32, max_seq=8)
    got, gc = ttf.prefill(served, toks[:, :5], bf16, max_seq=8)
    assert gc["k"].dtype == torch.bfloat16 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0.05, rtol=0)
    for i in range(5, 8):
        want, wc = ttf.decode_step(params, wc, toks[:, i], i, f32)
        got, gc = ttf.decode_step(served, gc, toks[:, i], i, bf16)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=0.05,
                                   rtol=0, err_msg=f"step {i}")


# ---------------------------------------------------------------------------
# the cache bound and the greedy rule
# ---------------------------------------------------------------------------


def test_decode_step_refuses_a_position_past_the_cache():
    cfg = tqwen.SMOKE
    params = ttf.init_params(torch.Generator().manual_seed(0), cfg)
    cache = ttf.init_kv_cache(cfg, 1, 4, device=CPU)
    with pytest.raises(ValueError, match="outside the cache"):
        ttf.decode_step(params, cache, torch.zeros(1, dtype=torch.int32), 4,
                        cfg)
    with pytest.raises(ValueError, match="backend"):
        ttf.decode_step(params, cache, torch.zeros(1, dtype=torch.int32), 0,
                        cfg, backend="triton")


def test_greedy_takes_the_first_maximal_logit():
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0]])
    got = tdecode._sample(logits, 0.0, None, 0)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(
        jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)).tolist() == [1, 0]


# ---------------------------------------------------------------------------
# token ids outside the vocabulary: read as jnp.take reads them
# ---------------------------------------------------------------------------


def oob_ids(v):
    """The edge ids of a padded vocabulary of ``v`` rows: ``-1`` and
    ``-v`` wrap once, ``v``, ``v + 3`` and ``-v - 1`` are past the table."""
    return np.array([-1, 0, v - 1, v, v + 3, -v, -v - 1], np.int32)


def oob_reference(jcfg, params, seed):
    """The reference's forward hidden states, prefill logits, one decode
    step's logits and greedy tokens, with one edge id in each row: the
    last prompt position of row ``i`` holds ``oob_ids[i]``, which is also
    row ``i``'s decode token."""
    ids = oob_ids(jcfg.vocab_padded)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab_size, (ids.size, 4)).astype(np.int32)
    toks[:, -1] = ids
    max_seq = toks.shape[1] + 1
    logits, cache = jax.jit(lambda p, t: jtf.prefill(p, t, jcfg, max_seq=max_seq))(
        params, toks)
    step_logits, _ = jax.jit(lambda p, c, t: jtf.decode_step(
        p, c, t, jnp.asarray(toks.shape[1], jnp.int32), jcfg))(params, cache, ids)
    return dict(
        toks=toks, ids=ids,
        hidden=np.asarray(jax.jit(lambda p, t: jtf.forward(p, t, jcfg)[0])(params, toks)),
        prefill=np.asarray(logits), step=np.asarray(step_logits),
        generated=np.asarray(jax.jit(lambda p, t: jdecode.generate(
            p, t, jcfg, max_new_tokens=3))(params, toks)))


def check_oob(ttf_mod, tdecode_mod, params, cfg, want, close):
    """The port against ``oob_reference``: NaN exactly where the
    reference's, finite values within ``close``, tokens equal."""
    def same(got, ref, what):
        got = got.detach().float().numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=what)
        ok = ~np.isnan(ref)
        close(torch.from_numpy(np.where(ok, got, 0)), np.where(ok, ref, 0), what)

    toks = torch.from_numpy(want["toks"])
    nan_rows = np.isnan(want["prefill"]).any(-1)
    assert nan_rows.tolist() == [False, False, False, True, True, False, True]
    same(ttf_mod.forward(params, toks, cfg)[0], want["hidden"], "forward")
    logits, cache = ttf_mod.prefill(params, toks, cfg, max_seq=toks.shape[1] + 1)
    same(logits, want["prefill"], "prefill")
    step, _ = ttf_mod.decode_step(params, cache, torch.from_numpy(want["ids"]),
                                  toks.shape[1], cfg)
    same(step, want["step"], "decode_step")
    got = tdecode_mod.generate(params, toks, cfg, max_new_tokens=3)
    np.testing.assert_array_equal(got.numpy(), want["generated"])


def test_out_of_vocabulary_ids_match_reference(reference):
    """Ids -1, 0, V-1, V, V+3, -V, -V-1 (V the padded vocabulary) in
    forward, prefill, decode_step and generate: -1 and -V wrap, the rest
    past the table give NaN logits, as jnp.take's fill gives them."""
    case = "padded_vocab"
    r, cfg, params = _port(reference, case)
    want = oob_reference(CASES[case], r["params"], seed=7)
    check_oob(ttf, tdecode, params, cfg, want, _close)
