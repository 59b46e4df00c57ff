"""The decode-attention kernel's split-and-merge arithmetic, on the CPU.

The CUDA kernel (``csrc/decode_attention.cu``) cuts the sequence into
splits of ``split_len`` positions, one CTA each.  Within a split each warp
keeps an online softmax over its positions of every tile (a running max
``m``, sum ``l`` and ``acc = sum p v``), the CTA merges its warps' partials
in warp order, and the last CTA of a row merges the splits in split order:

    M = max_i m_i,  w_i = exp(m_i - M),  out = sum_i w_i acc_i / sum_i w_i l_i

A split that starts at or past its row's length (ragged lengths) has no
position: its partial is ``m = -1e30, l = 0, acc = 0``, so its weight is
``exp(-1e30 - M) = 0``.  This file writes that arithmetic out in plain
torch, float32, with the kernel's tile of 64 positions and 8 positions a
warp, and holds it against the reference's ``ref.decode_attention_ref``
within 2e-6 absolute (the kernel's own tolerance against its twin) at the
lengths around a split's edges, with ragged rows that fill one split or
many.  The kernel itself runs only on the card (``test_torch_cuda.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref

ATOL = 2e-6
NEG = -1e30
TILE, ROWS_PER_WARP, WARPS = 64, 8, 8


def _warp_of(pos: torch.Tensor) -> torch.Tensor:
    """The warp that owns each position of a split (its offset there)."""
    return (pos % TILE) // ROWS_PER_WARP


def _merge(m, l, acc):
    """Merge partials along axis 0 in order: ``(m, l, acc)`` of the whole."""
    big_m = m.max(0).values
    w = torch.exp(m - big_m)
    return big_m, (w * l).sum(0), (w[..., None] * acc).sum(0)


def _split_partial(qg, k, v, lo, hi, scale):
    """One split's ``(m, l, acc)`` for one batch row: per warp an online
    softmax over its tiles, then the warps merged in order.  ``qg`` is
    ``(kh, group, dh)``, ``k``/``v`` ``(s, kh, dh)``; positions [lo, hi)."""
    kh, group, dh = qg.shape
    m = torch.full((WARPS, kh, group), NEG)
    l = torch.zeros((WARPS, kh, group))
    acc = torch.zeros((WARPS, kh, group, dh))
    for t0 in range(lo, hi, TILE):
        pos = torch.arange(t0, min(t0 + TILE, hi))
        for w in range(WARPS):
            mine = pos[_warp_of(pos - lo) == w]
            if mine.numel() == 0:
                continue
            sc = torch.einsum("kgd,pkd->kgp", qg, k[mine]) * scale
            m_new = torch.maximum(m[w], sc.max(-1).values)
            corr = torch.exp(m[w] - m_new)
            p = torch.exp(sc - m_new[..., None])
            l[w] = l[w] * corr + p.sum(-1)
            acc[w] = acc[w] * corr[..., None] + torch.einsum("kgp,pkd->kgd", p, v[mine])
            m[w] = m_new
    return _merge(m, l, acc)


def split_attention(q, k, v, lengths, split_len):
    """The kernel's arithmetic: ``(b, h, dh)`` float32."""
    b, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    group = h // kh
    scale = dh ** -0.5
    n_splits = -(-(s if isinstance(lengths, torch.Tensor) else int(lengths)) // split_len)
    lens = (lengths.tolist() if isinstance(lengths, torch.Tensor)
            else [int(lengths)] * b)
    out = torch.empty((b, h, dh))
    for r in range(b):
        qg = q[r].float().reshape(kh, group, dh)
        parts = [_split_partial(qg, k[r].float(), v[r].float(), i * split_len,
                                min((i + 1) * split_len, lens[r]), scale)
                 for i in range(n_splits)]
        m, l, acc = (torch.stack(x) for x in zip(*parts))
        _, big_l, big_acc = _merge(m, l, acc)
        out[r] = (big_acc / big_l[..., None]).reshape(h, dh)
    return out


def _inputs(b, h, kh, dh, s, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, dh)).astype(np.float32)
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    return jx, [torch.from_numpy(a).to(tdt) for a in (q, k, v)]


SPLIT = 128
S = 3 * SPLIT + 40     # four splits, the last one short


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("length", [1, SPLIT - 1, SPLIT, SPLIT + 1, S])
def test_split_merge_matches_reference_at_split_edges(length, dtype):
    b, h, kh, dh = 2, 8, 2, 32
    jx, tx = _inputs(b, h, kh, dh, S, length, dtype)
    want = jref.decode_attention_ref(*jx, jnp.full((b,), length, jnp.int32))
    got = split_attention(*tx, length, SPLIT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("lengths", [
    [S, 1, SPLIT, 70],             # rows that fill four splits, one, or part of one
    [SPLIT + 1, 2 * SPLIT, 5, S],
])
def test_ragged_rows_with_empty_splits_match_reference(lengths):
    b, h, kh, dh = 4, 6, 2, 16
    jx, tx = _inputs(b, h, kh, dh, S, sum(lengths))
    lens = torch.tensor(lengths, dtype=torch.int32)
    want = jref.decode_attention_ref(*jx, jnp.asarray(lengths, jnp.int32))
    got = split_attention(*tx, lens, SPLIT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_one_split_is_the_warp_merge_alone():
    b, h, kh, dh, s = 3, 8, 1, 64, 200
    jx, tx = _inputs(b, h, kh, dh, s, 9)
    lengths = [200, 63, 129]
    want = jref.decode_attention_ref(*jx, jnp.asarray(lengths, jnp.int32))
    got = split_attention(*tx, torch.tensor(lengths, dtype=torch.int32), s)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_empty_partials_weigh_zero_where_minus_inf_would_give_nan():
    m = torch.tensor([[0.5], [NEG], [NEG]])
    l = torch.tensor([[2.0], [0.0], [0.0]])
    acc = torch.tensor([[[1.0, 3.0]], [[0.0, 0.0]], [[0.0, 0.0]]])
    big_m, big_l, big_acc = _merge(m, l, acc)
    assert torch.equal(big_m, m[0]) and torch.equal(big_l, l[0])
    assert torch.equal(big_acc, acc[0])
    # an empty split's own merge of its empty warps stays empty, not NaN
    e_m, e_l, e_acc = _merge(m[1:], l[1:], acc[1:])
    assert torch.equal(e_m, m[1]) and float(e_l) == 0 and not e_acc.any()
    # -inf instead of -1e30 would make the empty-warp merge NaN
    inf_m = torch.tensor([[-float("inf")], [-float("inf")]])
    assert torch.isnan(torch.exp(inf_m - inf_m.max(0).values)).all()
