"""The port's threefry key chain against jax.random, bit for bit.

The reference runs jax's default threefry2x32 in partitionable mode; the
port reproduces key, fold_in, split and bits in that mode, and the two
call sites the walk and the server build from them: ``_chunk_rbits``
(per-query and batch-native layouts) and ``fold_in(server_key, req_id)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import walk as jwalk
from repro_torch.core import prng
from repro_torch.core import walk as twalk


def _jkey(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_reference_mode_is_partitionable_threefry():
    assert jax.config.jax_threefry_partitionable is True
    assert str(jax.config.jax_default_prng_impl) == "threefry2x32"


@pytest.mark.parametrize("seed", [0, 1, 7, 11, 123456, 2**31 - 1, -1, -5])
def test_key(seed):
    np.testing.assert_array_equal(
        prng.key(seed, "cpu").numpy(), _jkey(jax.random.key(seed))
    )


@pytest.mark.parametrize("data", [0, 1, 7, 123456, 2**31 - 1])
def test_fold_in_and_bits(data):
    k = jax.random.key(7)
    tk = prng.key(7, "cpu")
    np.testing.assert_array_equal(
        prng.fold_in(tk, data).numpy(), _jkey(jax.random.fold_in(k, data))
    )
    want = np.asarray(jax.random.bits(jax.random.fold_in(k, data), (64, 4)))
    got = prng.bits(prng.fold_in(tk, data), (64, 4)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


def test_fold_in_broadcasts_over_keys_and_data():
    ks = jax.random.split(jax.random.key(3), 4)
    data = jnp.arange(5, dtype=jnp.int32)
    want = jax.vmap(lambda k: jax.vmap(lambda d: jax.random.fold_in(k, d))(data))(ks)
    got = prng.fold_in(prng.split(prng.key(3, "cpu"), 4)[:, None, :],
                       torch.arange(5)[None, :])
    np.testing.assert_array_equal(got.numpy(), _jkey(want))


@pytest.mark.parametrize("num", [1, 2, 5, 16])
def test_split(num):
    np.testing.assert_array_equal(
        prng.split(prng.key(11, "cpu"), num).numpy(),
        _jkey(jax.random.split(jax.random.key(11), num)),
    )


def test_bits_batched_over_keys():
    ks = jax.random.split(jax.random.key(9), 3)
    want = jax.vmap(lambda k: jax.random.bits(k, (5, 4)))(ks)
    got = prng.bits(prng.split(prng.key(9, "cpu"), 3), (5, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


@pytest.mark.parametrize("step_base", [0, 8, 123456])
def test_chunk_rbits_per_query(step_base):
    want = jwalk._chunk_rbits(jax.random.key(5), jnp.int32(step_base), 4, 32)
    got = twalk._chunk_rbits(prng.key(5, "cpu"), step_base, 4, 32)
    assert got.dtype == torch.int32 and got.shape == (4, 32, 4)
    np.testing.assert_array_equal(
        prng.from_int32_bits(got).numpy(), np.asarray(want).astype(np.int64)
    )


def test_chunk_rbits_batch_native_layout():
    """Walker q * w + i draws query q's per-query stream (walk.py:384)."""
    n_q, c, w = 3, 4, 16
    keys = jax.random.split(jax.random.key(2), n_q)
    rq = jax.vmap(lambda k: jwalk._chunk_rbits(k, jnp.int32(8), c, w))(keys)
    want = jnp.moveaxis(rq, 0, 1).reshape(c, n_q * w, 4)
    got = twalk._chunk_rbits(prng.split(prng.key(2, "cpu"), n_q), 8, c, w)
    np.testing.assert_array_equal(
        prng.from_int32_bits(got).numpy(), np.asarray(want).astype(np.int64)
    )


def test_server_request_and_padding_keys():
    """``fold_in(server_key, req_id)`` and the int32-max padding stream."""
    server = jax.random.key(0)
    tserver = prng.key(0, "cpu")
    for rid in (0, 1, 41, jnp.iinfo(jnp.int32).max):
        np.testing.assert_array_equal(
            prng.fold_in(tserver, int(rid)).numpy(),
            _jkey(jax.random.fold_in(server, rid)),
        )


def test_int32_bit_patterns_round_trip():
    x = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1], dtype=torch.int64)
    b = prng.to_int32_bits(x)
    assert b.dtype == torch.int32
    assert b.tolist() == [0, 1, 2**31 - 1, -(2**31), -1]
    assert prng.from_int32_bits(b).tolist() == x.tolist()
