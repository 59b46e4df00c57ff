"""The traffic mixes repeat from a seed."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from pixiebench import traffic

MIXES = sorted((Path(traffic.__file__).parent / "traffic").glob("*.json"))


def mix_of(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_payloads_repeat_from_a_seed(path):
    mix = mix_of(path)
    traffic.validate(mix)
    has_edge = torch.ones(5000, dtype=torch.bool)
    has_edge[::3] = False
    seed = 2**31 + 12345
    a = traffic.payloads(mix, 40, has_edge, 4, seed)
    b = traffic.payloads(mix, 40, has_edge, 4, seed)
    c = traffic.payloads(mix, 40, has_edge, 4, seed + 1)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.pins, c.pins)
    k = mix["pins_per_query"]
    assert a.pins.shape == (40, k) and a.pins.dtype == np.int32
    assert all(len(set(row)) == k for row in a.pins.tolist())
    assert has_edge[torch.from_numpy(a.pins).long()].all()
    lo, hi = mix["weights"]
    assert a.weights.dtype == np.float32 and (a.weights >= lo).all() and (a.weights < hi).all()
    assert ((a.feats >= 0) & (a.feats < 4)).all()


@pytest.mark.parametrize("path", [p for p in MIXES if mix_of(p)["loop"] == "open"],
                         ids=lambda p: p.stem)
def test_open_loop_arrivals_repeat_and_keep_their_gaps(path):
    mix = mix_of(path)
    seconds = 30.0
    a = traffic.arrivals(mix, seconds, 987654321987)
    b = traffic.arrivals(mix, seconds, 987654321987)
    c = traffic.arrivals(mix, seconds, 5)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    n = round(mix["rate_qps"] * seconds)
    assert len(a) == len(c) == n
    assert a[0] == 0.0 and (np.diff(a) > 0).all() and a[-1] < seconds
    # every seed offers the same cycle of gaps, rotated: the same multiset
    ga = np.sort(np.diff(np.append(a, seconds)))
    gc = np.sort(np.diff(np.append(c, seconds)))
    assert np.allclose(ga, gc, rtol=1e-9, atol=1e-12)
