"""The ranked request's two bags pooled by one call, on the CPU.

``embedding_bag_pair`` pools the neighbor bags and the query bag of a
ranked batch over one table in ONE kernel launch on the card; its plain
route is two ``embedding_bag_batched_plain`` calls.  No CUDA kernel runs
here (tests/test_torch_cuda.py holds the launch to these routes on the
card), so this file holds the routes the kernel is compared with:

  * ``ops.embedding_bag_pair`` on the CPU (either ``use_kernel``) equals
    two ``embedding_bag_batched_plain`` calls, bit for bit;
  * both equal the reference's chain twin ``ref.embedding_bag_batched_ref``
    bit for bit, and the reference's Pallas kernel run as its own tests run
    it on the CPU (interpret mode): bit for bit with a bf16 table; with a
    float32 table within the reference's own kernel-vs-oracle bound (rtol
    and atol 2e-6, ``tests/test_kernels.py``), because XLA on the CPU
    contracts the interpret-mode kernel's multiply and add into an FMA,
    which the port's twin (and the CUDA kernel, with ``_rn`` intrinsics)
    never does (measured: up to 3.8e-6 apart on a 64-element sum);
  * bag lengths 1, 33, 64 and 65 (one warp a bag, two, and eight, 32
    rows staged a warp), with an all-padding bag, in sum and mean mode,
    with weights and without.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag_batched as jbag_batched
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels import ops

V, D = 300, 32


def _bags(rng, shape):
    ids = rng.integers(-1, V, shape).astype(np.int32)
    ids.reshape(-1, shape[-1])[0] = -1                  # an all-padding bag
    w = rng.uniform(0.0, 2.0, shape).astype(np.float32)
    return ids, w


def _case(dtype, l_a, l_b, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    a = _bags(rng, (2, 5, l_a))          # neighbor-like: (b, k, l)
    b = _bags(rng, (2, 1, l_b))          # query-like: (b, 1, k)
    jt = jnp.asarray(table, dtype=jnp.dtype(dtype))
    tt = torch.as_tensor(table).to(getattr(torch, dtype))
    return jt, tt, a, b


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x.astype(jnp.float32))


@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l_a,l_b", [(1, 64), (33, 65), (64, 1), (65, 33)])
def test_pair_plain_route_equals_two_twin_calls_and_the_reference(
        l_a, l_b, dtype, mode):
    jt, tt, (ia, wa), (ib, wb) = _case(dtype, l_a, l_b, seed=l_a * 100 + l_b)
    for weighted in (True, False):
        twa = torch.as_tensor(wa) if weighted else None
        twb = torch.as_tensor(wb) if weighted else None
        pairs = [ops.embedding_bag_pair(
            tt, torch.as_tensor(ia), twa, torch.as_tensor(ib), twb,
            mode=mode, use_kernel=use_kernel) for use_kernel in (True, False)]
        pairs.append(eb.embedding_bag_pair_plain(
            tt, torch.as_tensor(ia), twa, torch.as_tensor(ib), twb, mode=mode))
        twins = [eb.embedding_bag_batched_plain(tt, torch.as_tensor(i), w,
                                                mode=mode)
                 for i, w in ((ia, twa), (ib, twb))]
        for ids, w, twin, k in ((ia, wa, twins[0], 0), (ib, wb, twins[1], 1)):
            jw = jnp.asarray(w) if weighted else None
            chain = jref.embedding_bag_batched_ref(jt, jnp.asarray(ids), jw,
                                                   mode=mode)
            kernel = jbag_batched(jt, jnp.asarray(ids), jw, mode=mode,
                                  interpret=True)
            for pair in pairs:
                got = pair[k]
                assert got.dtype == tt.dtype and got.shape == twin.shape
                assert torch.equal(got, twin)
            np.testing.assert_array_equal(_np(twin), _np(chain))
            if dtype == "bfloat16":
                np.testing.assert_array_equal(_np(twin), _np(kernel))
            else:
                np.testing.assert_allclose(_np(twin), _np(kernel),
                                           rtol=2e-6, atol=2e-6)
            assert not _np(twin).reshape(-1, D)[0].any()   # all padding


def test_pair_refuses_what_the_batched_bag_refuses():
    jt, tt, (ia, wa), (ib, wb) = _case("float32", 8, 16, seed=0)
    ids_a, ids_b = torch.as_tensor(ia), torch.as_tensor(ib)
    with pytest.raises(ValueError, match="3 dims"):
        ops.embedding_bag_pair(tt, ids_a[0], None, ids_b, None)
    with pytest.raises(ValueError, match="mode"):
        ops.embedding_bag_pair(tt, ids_a, None, ids_b, None, mode="max")
    with pytest.raises(ValueError, match="weights shape"):
        ops.embedding_bag_pair(tt, ids_a, None, ids_b,
                               torch.as_tensor(wa))
    with pytest.raises(ValueError, match="no kernel and no plain path"):
        ops.embedding_bag_pair(tt.to("meta"), ids_a, None, ids_b, None)
