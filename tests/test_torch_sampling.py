"""The port's random floats and temperature sampling against jax.random.

``prng.uniform`` and ``prng.gumbel`` must give ``jax.random.uniform`` and
``jax.random.gumbel`` (mode "low", jax's default) bit for bit, for several
keys, shapes and ranges (uniform's scale is a fused multiply-add in XLA:
ranges whose width is not 1 show it).  ``sampling.log_f32`` meets the
open interval (0, 1) and (0, 88] there, so it is held to ``jnp.log`` on
every float32 in [0.5, 2) and on 2**20 draws spread log-uniformly over
[2**-126, 88].  ``decode._sample`` with a temperature must pick the
reference's token on the reference's own logits, and ``generate`` with
temperature 0.7 and 1.0 must give the reference's tokens on a dense and
on an MoE SMOKE config, weights carried across.  The reference's
``generate`` runs as the reference runs it (its ``_sample`` eager: a
jitted ``logits / 0.7`` multiplies by the reciprocal and may move a bit).

Tolerance: none.  Every comparison here is of bits or tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_moe_16b as jdeep
from repro.configs import qwen2_5_3b as jqwen
from repro.models import transformer as jtf
from repro.serving import decode as jdecode
from repro_torch.core import prng, sampling
from repro_torch.models import transformer as ttf
from repro_torch.serving import decode as tdecode

from test_torch_moe import port_config

CPU = torch.device("cpu")
SEEDS = (0, 7, 123456, -5, 2**32 + 9)
SHAPES = ((1,), (7,), (3, 5, 7), (4, 49168))


def _bits(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32).view(np.int32)


def _jkey(seed):
    return jax.random.key(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_matches_reference_outside_int32_too(seed):
    want = np.asarray(jax.random.key_data(_jkey(seed)))
    assert prng.key(seed, CPU).tolist() == want.astype(np.int64).tolist()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-3.3, 7.1), (0.25, 0.3),
                                   (2.0**-126, 1.0)])
def test_uniform_bits_match_reference(seed, shape, lo, hi):
    want = jax.random.uniform(_jkey(seed), shape, minval=lo, maxval=hi)
    got = prng.uniform(prng.key(seed, CPU), shape, lo, hi)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_bits_match_reference(seed, shape):
    k = jax.random.fold_in(_jkey(seed), 3)
    want = jax.random.gumbel(k, shape)
    got = prng.gumbel(prng.fold_in(prng.key(seed, CPU), 3), shape)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_log_f32_on_every_float_in_half_to_two():
    lo, hi = np.float32(0.5).view(np.int32), np.float32(2.0).view(np.int32)
    xs = np.arange(lo, hi, dtype=np.int32).view(np.float32)
    jlog = jax.jit(jnp.log)
    bad = 0
    for c in range(0, xs.size, 1 << 22):
        x = xs[c:c + (1 << 22)]
        bad += int((_bits(jlog(x)) != _bits(sampling.log_f32(torch.from_numpy(x)).numpy())).sum())
    assert xs.size == 2**24 and bad == 0


def test_log_f32_over_gumbels_range():
    e = np.random.default_rng(0).uniform(-126.0, np.log2(88.0), 2**20)
    x = np.exp2(e).astype(np.float32)
    x[:3] = (2.0**-126, 88.0, np.nextafter(np.float32(1), np.float32(0)))
    np.testing.assert_array_equal(
        _bits(sampling.log_f32(torch.from_numpy(x)).numpy()),
        _bits(jax.jit(jnp.log)(x)))


@pytest.mark.parametrize("temperature", [0.7, 1.0, 0.3, 2.5])
def test_sample_matches_reference_on_its_logits(temperature):
    rng = np.random.default_rng(int(temperature * 10))
    logits = (rng.normal(size=(4, 512)) * 3).astype(np.float32)
    logits[1, ::7] = -1e30            # padded-vocabulary rows
    picks = []
    for seed in (0, 11):
        for i in range(6):
            want = np.asarray(jdecode._sample(jnp.asarray(logits), temperature,
                                              _jkey(seed), i))
            got = tdecode._sample(torch.from_numpy(logits), temperature,
                                  prng.key(seed, CPU), i)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
            picks.append(got)
    assert len({tuple(p.tolist()) for p in picks}) > 1
    assert all(int(p[1]) % 7 for p in picks)


def test_sample_without_a_key_or_temperature_is_greedy():
    logits = torch.tensor([[0.0, 1.0, 1.0]])
    assert tdecode._sample(logits, 0.7, None, 0).tolist() == [1]
    assert tdecode._sample(logits, 0.0, prng.key(0, CPU), 0).tolist() == [1]


CASES = {
    "qwen_smoke": dataclasses.replace(jqwen.SMOKE, cache_dtype=jnp.float32),
    "deepseek_smoke": dataclasses.replace(jdeep.SMOKE, cache_dtype=jnp.float32),
}


@pytest.fixture(scope="module")
def generated():
    out = {}
    for seed, (case, cfg) in enumerate(CASES.items()):
        params = jax.tree_util.tree_map(
            np.asarray, jtf.init_params(jax.random.key(seed), cfg))
        toks = np.random.default_rng(200 + seed).integers(
            0, cfg.vocab_size, (3, 5)).astype(np.int32)
        runs = {t: np.asarray(jdecode.generate(params, toks, cfg, max_new_tokens=6,
                                               temperature=t, key=_jkey(40 + seed)))
                for t in (0.7, 1.0)}
        greedy = np.asarray(jdecode.generate(params, toks, cfg, max_new_tokens=6))
        logits = np.asarray(jtf.prefill(params, toks, cfg)[0])
        out[case] = dict(params=params, toks=toks, runs=runs, greedy=greedy,
                         logits=logits)
    return out


@pytest.mark.parametrize("temperature", [0.7, 1.0])
@pytest.mark.parametrize("case", list(CASES))
def test_generate_with_temperature_matches_reference(generated, case, temperature):
    r = generated[case]
    cfg = port_config(CASES[case])
    params = ttf.params_from_reference(r["params"], CPU)
    seed = list(CASES).index(case)
    got = tdecode.generate(params, torch.from_numpy(r["toks"]), cfg,
                           max_new_tokens=6, temperature=temperature,
                           key=prng.key(40 + seed, CPU))
    np.testing.assert_array_equal(got.numpy(), r["runs"][temperature])
    assert not np.array_equal(r["runs"][temperature], r["greedy"])


@pytest.mark.parametrize("case", list(CASES))
def test_sample_matches_reference_on_its_model_logits(generated, case):
    """The reference's own prefill logits through both samplers."""
    logits = generated[case]["logits"]
    for temperature in (0.7, 1.0):
        for i in range(4):
            want = np.asarray(jdecode._sample(jnp.asarray(logits), temperature,
                                              _jkey(3), i))
            got = tdecode._sample(torch.from_numpy(logits), temperature,
                                  prng.key(3, CPU), i)
            np.testing.assert_array_equal(got.numpy(), want)
