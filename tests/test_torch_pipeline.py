"""The port's data pipelines against the JAX package's.

``repro_torch.data.pipeline`` is the port's own copy of the reference's
host-numpy pipelines (the port never imports the reference).  Every batch
must equal the reference's bit for bit, key for key, dtype for dtype, for
several ``(step, seed)``; each batch is a pure function of them (the
reference's ``test_pipelines_deterministic_per_step`` contract).  Exact.
"""

import dataclasses

import numpy as np
import pytest

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe

PIPES = {
    "tokens": ("TokenPipeline", dict(vocab_size=512, batch=4, seq_len=33)),
    "tokens_smollm": ("TokenPipeline", dict(vocab_size=49152, batch=2, seq_len=256,
                                            zipf_a=1.2)),
    "clicks": ("ClickLogPipeline", dict(n_dense=13, feature_rows=(64,) * 26, batch=32)),
    "clicks_skewed": ("ClickLogPipeline", dict(n_dense=4, feature_rows=(3, 1000, 7),
                                               batch=9)),
    "sasrec": ("SeqRecPipeline", dict(n_items=500, batch=6, seq_len=12, n_negatives=8)),
    "sasrec_no_neg": ("SeqRecPipeline", dict(n_items=50, batch=3, seq_len=5)),
    "bst": ("SeqRecPipeline", dict(n_items=500, batch=6, seq_len=8, with_candidate=True)),
}
STEP_SEEDS = [(0, 0), (1, 0), (17, 3), (123_456, 2**31 - 1)]


def _pair(name, seed):
    cls, kw = PIPES[name]
    return getattr(jpipe, cls)(seed=seed, **kw), getattr(tpipe, cls)(seed=seed, **kw)


@pytest.mark.parametrize("step,seed", STEP_SEEDS)
@pytest.mark.parametrize("name", list(PIPES))
def test_batches_equal_reference_bits(name, step, seed):
    ref, port = _pair(name, seed)
    want, got = ref(step), port(step)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k].view(np.uint8), want[k].view(np.uint8),
                                      err_msg=k)


@pytest.mark.parametrize("name", list(PIPES))
def test_batches_are_a_function_of_step_and_seed(name):
    _, pipe = _pair(name, 5)
    a, b, c = pipe(17), pipe(17), pipe(18)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert any(not np.array_equal(a[k], c[k]) for k in a)
    _, other = _pair(name, 6)
    assert any(not np.array_equal(a[k], other(17)[k]) for k in a)


@pytest.mark.parametrize("cls", ["TokenPipeline", "ClickLogPipeline", "SeqRecPipeline"])
def test_pipeline_fields_match_reference(cls):
    want = [(f.name, f.default) for f in dataclasses.fields(getattr(jpipe, cls))]
    got = [(f.name, f.default) for f in dataclasses.fields(getattr(tpipe, cls))]
    assert got == want
