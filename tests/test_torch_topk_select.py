"""The top-k's selection kernel (``kernels/topk_select.py``) and its twin
(``counter.topk_select_plain``).

On any host: the wrapper refuses a key type the kernel does not take and a
tensor that is not contiguous and 2-D, before it looks at the device; a dry
run (fake tensors under ``abstract.reckon_card``) of ``topk_dense`` and
``topk_total`` gives ``(rows, k)`` shapes, charges the kernel's bytes and
launches nothing; and on a CPU tensor the top-k takes the twin, its
``nonzero`` counted as the batch record's ``topk.nonzero`` wait.

Marked ``cuda`` (skipped without a card; run there with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_topk_select.py``):
the kernel equals the twin bit for bit, its indices on the card and the
whole ``topk_dense`` / ``topk_total`` (indices, values, order) on the card
against the CPU, at the walk's shape with ~10^5 ties at the k-th key, one
row, the MoE router's (4096, 64) with k = 6, k = 1 and k = n, all-equal
rows, a unique k-th key (the one tie taken is itself), rows whose chosen
indices are all ties, row lengths off the unit and off the 16-byte load,
and every key type; on a CUDA tensor ``topk_dense`` makes no host wait
and launches one ``topk_select`` set.  The file imports no jax.
"""

import pytest
import torch

from repro_torch import abstract
from repro_torch.core import counter
from repro_torch.kernels import _build, ops
from repro_torch.kernels import topk_select as ts
from repro_torch.launch import fake
from repro_torch.serving import batch_trace

UNIT = 4096          # keys a unit of csrc/topk_select.cu
KEY_TYPES = [torch.float32, torch.float64, torch.float16, torch.bfloat16,
             torch.int16, torch.int32, torch.int64]


def _kth(keys, k):
    return torch.topk(keys, k, dim=-1, sorted=True).values[:, -1:]


# ---------------------------------------------------------------------------
# Any host
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.bool,
                                   torch.complex64])
def test_the_wrapper_refuses_a_key_type_it_does_not_take(dtype):
    keys = torch.zeros((2, 8), dtype=dtype)
    with pytest.raises(TypeError, match="topk_select takes keys"):
        ts.topk_select(keys, keys[:, :1], 3)


@pytest.mark.parametrize("shape", ["1d", "3d", "strided", "transposed"])
def test_the_wrapper_refuses_keys_not_contiguous_and_2d(shape):
    base = torch.arange(48, dtype=torch.float32)
    keys = {"1d": base, "3d": base.reshape(2, 4, 6),
            "strided": base.reshape(4, 12)[:, ::2],
            "transposed": base.reshape(6, 8).t()}[shape]
    kth = torch.zeros((keys.shape[0], 1))
    with pytest.raises(ValueError, match="contiguous 2-D"):
        ts.topk_select(keys, kth, 2)


@pytest.mark.parametrize("bad", ["k0", "k_past_n", "kth_shape", "kth_dtype",
                                 "cpu_keys"])
def test_the_wrapper_refuses_a_bad_k_kth_or_device(bad):
    keys = torch.arange(24, dtype=torch.float32).reshape(3, 8)
    k, kth = 3, _kth(keys, 3)
    if bad == "k0":
        k = 0
    elif bad == "k_past_n":
        k = 9
    elif bad == "kth_shape":
        kth = kth[:2]
    elif bad == "kth_dtype":
        kth = kth.double()
    match = {"k0": "k=0", "k_past_n": "k=9", "cpu_keys": "CUDA tensors"}.get(bad, "kth must")
    with pytest.raises(ValueError, match=match):
        ts.topk_select(keys, kth, k)


@pytest.mark.parametrize("total", [False, True])
@pytest.mark.parametrize("dtype,rows,n,k", [
    (torch.float32, 8, 2 * UNIT + 5, 1000),
    (torch.bfloat16, 4096, 64, 6),
    (torch.float64, 1, 33, 33),
])
def test_the_dry_run_charges_the_kernel_and_launches_nothing(total, dtype, rows, n, k):
    x = torch.randn((rows, n), generator=torch.Generator().manual_seed(0)).to(dtype)
    fn = counter.topk_total if total else counter.topk_dense
    want_v, want_i = fn(x, k)
    before = dict(_build.launches)
    mode = abstract.fake_tensor_mode()
    with mode, abstract.reckon_card(), fake.Tally() as t:
        v, i = fn(mode.from_tensor(x), k)
    assert _build.launches == before, "a fake form launched"
    assert abstract.is_fake(v) and abstract.is_fake(i)
    assert (tuple(v.shape), v.dtype) == (tuple(want_v.shape), want_v.dtype) == ((rows, k), dtype)
    assert (tuple(i.shape), i.dtype) == (tuple(want_i.shape), want_i.dtype)
    size = x.element_size()       # order_keys' keys are as wide as the scores
    assert t.kernels["topk_select"] == 1
    assert t.bytes_by_op["topk_select"] == rows * n * size + rows * size + rows * k * 8


@pytest.mark.parametrize("rows,n,k", [(3, 50, 7), (1, 9, 9), (5, 40, 1)])
def test_on_a_cpu_tensor_the_top_k_takes_the_twin_and_counts_its_wait(rows, n, k):
    keys = torch.randint(0, 4, (rows, n), generator=torch.Generator().manual_seed(n)).float()
    kth = _kth(keys, k)
    before = dict(_build.launches)
    with batch_trace.BatchTrace(torch.device("cpu")) as rec:
        got = counter.topk_select_plain(keys, kth, k)
        vals, idx = counter.topk_dense(keys, k)
    assert _build.launches == before
    assert rec.host_syncs == {"topk.nonzero": 2}
    assert torch.equal(idx.long().sort(-1).values, got)
    assert torch.equal(vals, torch.gather(keys, 1, idx.long()))
    with pytest.raises(ValueError, match="CUDA tensors"):   # the card's route only
        ops.topk_select(keys, kth, k)
    # the twin's rule, row by row: the keys above, then the first ties
    for r in range(rows):
        above = (keys[r] > kth[r]).nonzero()[:, 0]
        ties = (keys[r] == kth[r]).nonzero()[:, 0][: k - above.numel()]
        assert got[r].tolist() == sorted(above.tolist() + ties.tolist())


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _placed(rows, n, n_above, n_ties, gen, dev, tie=5.0):
    """float32 zeros with ``n_above`` keys in (tie, tie + 100] and
    ``n_ties`` keys at ``tie`` a row, at random places."""
    keys = torch.zeros((rows, n), device=dev)
    for r in range(rows):
        at = torch.randperm(n, generator=gen, device=dev)[: n_above + n_ties]
        keys[r, at[:n_above]] = tie + torch.randint(
            1, 101, (n_above,), generator=gen, device=dev).float()
        keys[r, at[n_above:]] = tie
    return keys


def _case(name, gen, dev):
    """``(keys, k)`` of a named case, float32 unless the name says."""
    if name == "walk_shape_1e5_ties":
        return _placed(8, 2**24 + 5, 500, 100_000, gen, dev), 1000
    if name == "one_row":
        return torch.randint(0, 50, (1, 1_000_003), generator=gen, device=dev).float(), 1000
    if name == "moe_router":
        p = torch.rand((4096, 64), generator=gen, device=dev)
        return (p * 16).round() / 16, 6
    if name == "k_is_1":
        return torch.randint(0, 3, (3, 10_001), generator=gen, device=dev).float(), 1
    if name == "k_is_n":
        keys = torch.randint(0, 9, (3, 5_003), generator=gen, device=dev).float()
        return keys, 5_003
    if name == "all_equal":
        return torch.ones((2, 3 * UNIT + 1), device=dev), 17
    if name == "unique_kth":
        keys = torch.stack([torch.randperm(2 * UNIT + 8, generator=gen, device=dev)
                            for _ in range(3)]).float()
        return keys, 300
    if name == "every_chosen_a_tie":
        return _placed(4, 5 * UNIT, 0, 3_000, gen, dev, tie=7.0), 1000
    if name == "odd_length":
        return torch.randint(0, 20, (5, 3 * UNIT + 7), generator=gen, device=dev).float(), 300
    if name == "length_off_the_unit":
        return torch.randint(0, 20, (5, 2 * UNIT + 8), generator=gen, device=dev).float(), 300
    if name == "misaligned_start":
        keys = torch.randint(0, 20, (5 * (UNIT + 4) + 1,), generator=gen, device=dev).float()
        return keys[1:].view(5, UNIT + 4), 64
    raise KeyError(name)


CASES = ["walk_shape_1e5_ties", "one_row", "moe_router", "k_is_1", "k_is_n",
         "all_equal", "unique_kth", "every_chosen_a_tie", "odd_length",
         "length_off_the_unit", "misaligned_start"]


def _bits(v):
    return v.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[v.element_size()])


def _same_topk(fn, x, k, monkeypatch):
    """``fn(x, k)`` on the card equals the twin's route on the card bit for
    bit (indices, values, order), and the CPU run's indices and values (a
    NaN as a NaN: the CPU's bf16 ``gather`` rewrites a NaN's bits)."""
    gv, gi = fn(x, k)
    with monkeypatch.context() as m:
        m.setattr(ops, "topk_select", counter.topk_select_plain)
        wv, wi = fn(x, k)
    assert gi.dtype == wi.dtype and torch.equal(gi, wi)
    assert gv.dtype == wv.dtype and torch.equal(_bits(gv), _bits(wv))
    cv, ci = fn(x.cpu(), k)
    assert torch.equal(gi.cpu(), ci)
    gv = gv.cpu()
    if gv.is_floating_point():
        nan = torch.isnan(cv)
        assert torch.equal(torch.isnan(gv), nan)
        gv, cv = gv[~nan], cv[~nan]
    assert torch.equal(_bits(gv), _bits(cv))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_the_kernel_selects_as_the_twin(cuda_device, name, monkeypatch):
    gen = torch.Generator(device=cuda_device).manual_seed(CASES.index(name))
    keys, k = _case(name, gen, cuda_device)
    kth = _kth(keys, k)
    got = ts.topk_select(keys, kth, k)
    want = counter.topk_select_plain(keys, kth, k)
    assert torch.equal(got, want)
    if name == "unique_kth":
        assert ((keys == kth).sum(-1) == 1).all()
    if name == "every_chosen_a_tie":
        assert (torch.gather(keys, 1, got) == kth).all()
    _same_topk(counter.topk_dense, keys, k, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", KEY_TYPES)
def test_every_key_type_dense(cuda_device, dtype, monkeypatch):
    gen = torch.Generator(device=cuda_device).manual_seed(100 + KEY_TYPES.index(dtype))
    x = torch.randint(-20, 21, (6, 50_008), generator=gen, device=cuda_device).to(dtype)
    if dtype.is_floating_point:     # -0.0 ties +0.0
        flip = torch.rand(x.shape, generator=gen, device=cuda_device) < 0.5
        x = torch.where((x == 0) & flip, torch.tensor(-0.0, dtype=dtype, device=cuda_device), x)
    for k in (1, 777, 50_008):
        _same_topk(counter.topk_dense, x, k, monkeypatch)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", KEY_TYPES)
def test_every_key_type_total(cuda_device, dtype, monkeypatch):
    """``topk_total``: the float types through ``order_keys``' int16 /
    int32 / int64 keys (NaN first, +0.0 above -0.0), the integer types as
    their own keys."""
    gen = torch.Generator(device=cuda_device).manual_seed(200 + KEY_TYPES.index(dtype))
    x = torch.randint(-20, 21, (4, 3 * UNIT + 3), generator=gen, device=cuda_device).to(dtype)
    if dtype.is_floating_point:
        u = torch.rand(x.shape, generator=gen, device=cuda_device)
        special = torch.tensor([float("nan"), -float("nan"), float("inf"),
                                -float("inf"), -0.0, 0.0], dtype=dtype, device=cuda_device)
        pick = torch.randint(0, 6, x.shape, generator=gen, device=cuda_device)
        x = torch.where(u < 0.05, special[pick], x)
    for k in (1, 500, x.shape[1]):
        _same_topk(counter.topk_total, x, k, monkeypatch)


@pytest.mark.cuda
def test_topk_dense_on_the_card_makes_no_host_wait_and_one_launch_set(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    keys = _placed(8, 300_001, 200, 5_000, gen, cuda_device)
    counter.topk_dense(keys, 1000)              # builds and loads the library
    torch.cuda.synchronize()
    _build.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with batch_trace.BatchTrace(cuda_device) as rec:
            counter.topk_dense(keys, 1000)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _build.launches["topk_select"] == 1
    assert "topk.nonzero" not in rec.host_syncs
