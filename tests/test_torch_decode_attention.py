"""The decode-attention twin against the JAX package, on the CPU.

The port's ``decode_attention_plain`` (what the CPU and ``backend="xla"``
run, and what the CUDA kernel is held to on the card) against
``ref.decode_attention_ref`` and against the Pallas kernel
``decode_attention`` in interpret mode, at the reference test's shapes
(``tests/test_kernels.py``) and at length 1, within 2e-6 absolute: every
side computes in float32 on the same inputs (bf16 inputs are upcast
exactly), and only the order of the float32 sums differs.  Also pinned:
the refusal at length 0, and the decode step's pad-head handling (the real
heads through the op, zeros for the pad heads) against the reference's
``_decode_attention_ref`` with its ``hmask``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode_attention
from repro.models import transformer as jtf
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as tda

ATOL = 2e-6
SHAPES = [(2, 8, 2, 64, 512), (1, 16, 16, 128, 300), (4, 4, 1, 128, 1024)]


def _inputs(b, h, kh, dh, s, seed, dtype=np.float32, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, s + 1, b).astype(np.int32)
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    return jx, tx, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,kh,dh,s", SHAPES)
def test_twin_matches_reference_twin(dtype, b, h, kh, dh, s):
    jx, tx, lengths = _inputs(b, h, kh, dh, s, h * s + dh, dtype)
    want = jref.decode_attention_ref(*jx, jnp.asarray(lengths))
    got = tda.decode_attention_plain(*tx, torch.from_numpy(lengths))
    assert got.dtype == torch.float32 and got.shape == (b, h, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("b,h,kh,dh,s", SHAPES)
def test_twin_matches_pallas_kernel_in_interpret_mode(b, h, kh, dh, s):
    jx, tx, lengths = _inputs(b, h, kh, dh, s, 7 * s + h)
    want = jdecode_attention(*jx, jnp.asarray(lengths), block_s=256,
                             interpret=True)
    got = tda.decode_attention_plain(*tx, torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("lengths_as", ["tensor", "int"])
def test_length_one_is_the_first_value_row(lengths_as):
    b, h, kh, dh, s = 2, 4, 2, 64, 256
    jx, tx, lengths = _inputs(b, h, kh, dh, s, 0, lengths=[1, 1])
    arg = torch.from_numpy(lengths) if lengths_as == "tensor" else 1
    got = tda.decode_attention_plain(*tx, arg)
    want_ref = jref.decode_attention_ref(*jx, jnp.asarray(lengths))
    want_kernel = jdecode_attention(*jx, jnp.asarray(lengths), interpret=True)
    v0 = np.repeat(tx[2][:, 0].numpy(), h // kh, axis=1)      # (b, h, dh)
    np.testing.assert_array_equal(got.numpy(), v0)
    np.testing.assert_allclose(np.asarray(want_ref), v0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.asarray(want_kernel), v0, rtol=0, atol=ATOL)


def test_uniform_int_length_equals_a_tensor_of_it():
    _, tx, _ = _inputs(3, 6, 2, 32, 100, 5)
    a = tda.decode_attention_plain(*tx, 37)
    b = tda.decode_attention_plain(*tx, torch.full((3,), 37, dtype=torch.int32))
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", [0, -1, 101])
def test_lengths_outside_the_cache_are_refused(bad):
    _, tx, _ = _inputs(2, 4, 2, 16, 100, 1)
    with pytest.raises(ValueError, match=r"\[1, 100\]"):
        tda.decode_attention_plain(*tx, bad)
    with pytest.raises(ValueError, match=r"\[1, 100\]"):
        ops.decode_attention(*tx, torch.tensor([5, bad], dtype=torch.int32),
                             use_kernel=True)


def test_bad_shapes_and_types_are_refused():
    _, (q, k, v), _ = _inputs(2, 6, 4, 16, 10, 2)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tda.decode_attention_plain(q, k, v, 3)
    _, (q, k, v), _ = _inputs(2, 4, 2, 16, 10, 2)
    with pytest.raises(ValueError, match=r"\(2,\) int32"):
        tda.decode_attention_plain(q, k, v, torch.ones(2, dtype=torch.int64))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tda.decode_attention_plain(q.half(), k, v, 3)
    with pytest.raises(TypeError, match="k is"):
        tda.decode_attention_plain(q, k, v.bfloat16(), 3)


def test_kernel_wrapper_refuses_cpu_tensors_and_dispatch_takes_the_twin():
    _, tx, lengths = _inputs(2, 4, 2, 16, 10, 3)
    with pytest.raises(ValueError, match="CUDA"):
        tda.decode_attention(*tx, torch.from_numpy(lengths))
    _build.reset_launches()
    got = ops.decode_attention(*tx, torch.from_numpy(lengths), use_kernel=True)
    plain = ops.decode_attention(*tx, torch.from_numpy(lengths), use_kernel=False)
    assert torch.equal(got, plain)
    assert _build.launches["decode_attention"] == 0


@pytest.mark.parametrize("n_heads,kh,hp", [(6, 2, 8), (15, 5, 16), (3, 1, 3)])
def test_pad_heads_match_the_reference_hmask(n_heads, kh, hp):
    """The decode step's attention: the reference attends with every padded
    head (kv head ``min(i // group, kh - 1)``) and zeroes the pad heads by
    ``hmask``; the port attends with the real heads only and pads zeros."""
    cfg = jtf.LMConfig(name="t", n_layers=1, d_model=8, n_heads=n_heads,
                       n_kv_heads=kh, head_dim=16, d_ff=8, vocab_size=8,
                       pad_heads_to=hp if hp != n_heads else None)
    b, dh, s, length = 2, 16, 40, 23
    rng = np.random.default_rng(hp)
    q = rng.normal(size=(b, hp, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    attn = jtf._decode_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), length, cfg)
    hmask = (jnp.arange(hp) < n_heads).astype(attn.dtype)
    want = np.asarray(attn * hmask[None, :, None])
    got = ops.decode_attention(torch.from_numpy(q)[:, :n_heads],
                               torch.from_numpy(k), torch.from_numpy(v),
                               length, use_kernel=True)
    got = torch.nn.functional.pad(got, (0, 0, 0, hp - n_heads))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert not got[:, n_heads:].any()
