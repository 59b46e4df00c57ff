"""The port's two legacy kernel entry points against the JAX package.

``ops.visit_counts`` (the flat histogram ``visit_counter``) and
``ops.walk_step`` (the unbiased one-superstep walk) are the reference's
public entry points to its last two TPU kernels.  On the CPU the port's
wrappers take their plain twins, held here against ``ref.visit_counter_ref``
and ``ref.walk_step_ref`` and once each against the interpret-mode Pallas
kernels, on the same numpy inputs, exactly: out-of-range and negative ids,
no events, bin counts off the 32-multiple, dead-end pins and empty boards
on the last row of each CSR, random words with the high bit set, and
``alpha_u32`` at 0 and 2**32 - 1.  The CUDA kernels are held against these
twins on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs.synthetic import small_test_graph, top_degree_pins
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.visit_counter import visit_counter as pallas_visit_counter
from repro.kernels.walk_step import walk_step as pallas_walk_step
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import visit_counter as tvc
from repro_torch.kernels import walk_step as tws

_ref_counter = jax.jit(ref.visit_counter_ref, static_argnums=1)
_ref_step = jax.jit(ref.walk_step_ref, static_argnames=("n_pins", "alpha_u32"))


# ---------------------------------------------------------------------------
# visit_counter
# ---------------------------------------------------------------------------


def _events(seed, m, n_bins):
    rng = np.random.default_rng(seed)
    ev = rng.integers(-5, n_bins + 20, m).astype(np.int32)
    if m >= 4:
        ev[:4] = [-(2**31), 2**31 - 1, n_bins, -1]
    return ev


@pytest.mark.parametrize("m,n_bins", [
    (0, 64), (1, 1), (128, 64), (2048, 512), (5000, 1300), (777, 33),
    (4096, 1), (300, 0),
])
def test_visit_counter_twin_matches_reference(m, n_bins):
    ev = _events(m * 7 + n_bins, m, n_bins)
    want = np.asarray(_ref_counter(jnp.asarray(ev), n_bins))
    got = tvc.visit_counter_plain(torch.as_tensor(ev), n_bins)
    assert got.dtype == torch.int32 and got.shape == (n_bins,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int(((ev >= 0) & (ev < n_bins)).sum())


def test_visit_counter_twin_matches_pallas_kernel_in_interpret_mode():
    ev = _events(3, 5000, 1300)
    want = np.asarray(pallas_visit_counter(jnp.asarray(ev), 1300, interpret=True))
    np.testing.assert_array_equal(
        tvc.visit_counter_plain(torch.as_tensor(ev), 1300).numpy(), want)


def test_visit_counts_dispatch_on_cpu_takes_the_twin():
    """No kernel launches on a CPU tensor, whatever ``use_kernel`` says,
    and the three settings agree with the reference's entry point."""
    ev = _events(11, 512, 100)
    want = np.asarray(jops.visit_counts(jnp.asarray(ev), 100, use_kernel=False))
    _build.reset_launches()
    for use_kernel in (None, True, False):
        got = tops.visit_counts(torch.as_tensor(ev), 100, use_kernel=use_kernel)
        np.testing.assert_array_equal(got.numpy(), want)
    assert _build.launches["visit_counter"] == 0


# ---------------------------------------------------------------------------
# walk_step
# ---------------------------------------------------------------------------


def _dead_end_csr():
    """6 pins, 4 boards (global ids 6..9).  Pins 0 and 5 (the last row)
    have no boards; boards 2 and 3 (the last row) have no pins, yet pins
    3 and 1 point at them, so a walker there reaches an empty board.  A
    read at either last row would start at len(targets)."""
    p2b = {0: [], 1: [0, 3], 2: [1], 3: [2], 4: [0, 1], 5: []}
    b2p = {0: [1, 4], 1: [2, 4], 2: [], 3: []}

    def csr(rows, shift):
        off = np.zeros(len(rows) + 1, np.int32)
        off[1:] = np.cumsum([len(rows[r]) for r in range(len(rows))])
        tgt = np.array([t + shift for r in range(len(rows)) for t in rows[r]],
                       np.int32)
        return off, tgt

    p2b_off, p2b_tgt = csr(p2b, 6)
    b2p_off, b2p_tgt = csr(b2p, 0)
    return p2b_off, p2b_tgt, b2p_off, b2p_tgt, 6


def _graph_csr():
    sg = small_test_graph(0)
    g = sg.graph
    arrays = tuple(np.asarray(a).astype(np.int32) for a in (
        g.p2b.offsets, g.p2b.targets, g.b2p.offsets, g.b2p.targets))
    return sg, arrays + (g.n_pins,)


def _walkers(seed, w, n_pins, high_bit=False):
    rng = np.random.default_rng(seed)
    curr = rng.integers(0, n_pins, w).astype(np.int32)
    query = rng.integers(0, n_pins, w).astype(np.int32)
    lo = 2**31 if high_bit else 0
    rbits = rng.integers(lo, 2**32, (w, 3), dtype=np.uint64).astype(np.uint32)
    return curr, query, rbits


def _ref_walk(curr, query, rbits, csr, alpha_u32):
    *arrays, n_pins = csr
    out = _ref_step(jnp.asarray(curr), jnp.asarray(query), jnp.asarray(rbits),
                    *(jnp.asarray(a) for a in arrays), n_pins=n_pins,
                    alpha_u32=alpha_u32)
    return [np.asarray(x) for x in out]


def _twin_walk(curr, query, rbits, csr, alpha_u32):
    *arrays, n_pins = csr
    return tws.walk_step_plain(
        torch.as_tensor(curr), torch.as_tensor(query),
        torch.as_tensor(rbits.view(np.int32)),
        *(torch.as_tensor(a) for a in arrays), n_pins=n_pins,
        alpha_u32=alpha_u32)


def _assert_step_equal(got, want):
    for name, a, b in zip(("next", "visited", "ok"), got, want):
        assert a.dtype == (torch.bool if name == "ok" else torch.int32), name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("alpha_u32", [0, 2**31, 2**32 - 1])
@pytest.mark.parametrize("high_bit", [False, True])
@pytest.mark.parametrize("which", ["small_test_graph", "dead_ends"])
def test_walk_step_twin_matches_reference(which, high_bit, alpha_u32):
    csr = _graph_csr()[1] if which == "small_test_graph" else _dead_end_csr()
    curr, query, rbits = _walkers(alpha_u32 % 97, 512, csr[-1], high_bit)
    if which == "dead_ends":
        curr[:6] = np.arange(6)
        query[:6] = 5   # the last pin: a dead end restart
    got = _twin_walk(curr, query, rbits, csr, alpha_u32)
    want = _ref_walk(curr, query, rbits, csr, alpha_u32)
    _assert_step_equal(got, want)
    if which == "dead_ends":
        assert not want[2].all() and want[2].any()
        assert (want[0][~want[2]] == query[~want[2]]).all()
        assert (want[1][~want[2]] == 0).all()


def test_walk_step_dead_ends_on_the_last_rows():
    """Walkers parked on the last pin (degree 0) never restart, and walkers
    whose board hop lands on the last board (no pins) come back to their
    query pin with no visit: the twin clamps those reads."""
    csr = _dead_end_csr()
    w = 64
    curr = np.full(w, 5, np.int32)
    curr[32:] = 1                       # pin 1 -> boards 0 and 3
    query = np.full(w, 2, np.int32)
    rbits = np.zeros((w, 3), np.uint32)
    rbits[:, 0] = 2**32 - 1             # never below alpha: no restart
    rbits[:, 1] = np.arange(w) | 2**31  # both of pin 1's boards, high bit set
    got = _twin_walk(curr, query, rbits, csr, 2**31)
    _assert_step_equal(got, _ref_walk(curr, query, rbits, csr, 2**31))
    nxt, vis, ok = (x.numpy() for x in got)
    assert not ok[:32].any() and (nxt[:32] == 2).all() and (vis[:32] == 0).all()
    assert ok[32:].any() and not ok[32:].all()   # board 0 hops, board 3 does not


def test_walk_step_twin_matches_pallas_kernel_in_interpret_mode():
    _, csr = _graph_csr()
    curr, query, rbits = _walkers(4, 256, csr[-1], high_bit=False)
    rbits[::3] |= np.uint32(2**31)
    *arrays, n_pins = csr
    want = pallas_walk_step(
        jnp.asarray(curr), jnp.asarray(query), jnp.asarray(rbits),
        *(jnp.asarray(a) for a in arrays), n_pins=n_pins, alpha_u32=2**31,
        interpret=True)
    got = _twin_walk(curr, query, rbits, csr, 2**31)
    _assert_step_equal(got, [np.asarray(x) for x in want])


@pytest.mark.parametrize("w", [1, 100, 255, 300])
def test_walk_step_takes_any_walker_count(w):
    """The reference's kernel refuses w % 256 != 0 (its TPU block); the
    port's kernel is one thread per walker and its twin takes any w, equal
    to the reference's oracle (which has no such rule)."""
    _, csr = _graph_csr()
    curr, query, rbits = _walkers(w, w, csr[-1], high_bit=True)
    _assert_step_equal(_twin_walk(curr, query, rbits, csr, 2**31),
                       _ref_walk(curr, query, rbits, csr, 2**31))
    with pytest.raises(ValueError, match="multiple"):
        *arrays, n_pins = csr
        pallas_walk_step(jnp.asarray(curr), jnp.asarray(query),
                         jnp.asarray(rbits), *(jnp.asarray(a) for a in arrays),
                         n_pins=n_pins, alpha_u32=2**31, interpret=True)


def test_walk_step_chained_supersteps_stay_in_lockstep():
    """Five chained supersteps through ``ops.walk_step`` (as the reference's
    test_paper_features chains its kernel) stay equal to the oracle."""
    sg, csr = _graph_csr()
    *arrays, n_pins = csr
    w = 256
    query = np.resize(top_degree_pins(sg, 4), w).astype(np.int32)
    curr_t = torch.as_tensor(query)
    curr_r = jnp.asarray(query)
    _build.reset_launches()
    for step in range(5):
        rbits = np.array(jax.random.bits(jax.random.key(step), (w, 3),
                                         dtype=jnp.uint32))
        got = tops.walk_step(curr_t, torch.as_tensor(query),
                             torch.as_tensor(rbits.view(np.int32)),
                             *(torch.as_tensor(a) for a in arrays),
                             n_pins=n_pins, alpha_u32=2**31)
        want = _ref_step(curr_r, jnp.asarray(query), jnp.asarray(rbits),
                         *(jnp.asarray(a) for a in arrays), n_pins=n_pins,
                         alpha_u32=2**31)
        _assert_step_equal(got, [np.asarray(x) for x in want])
        curr_t, curr_r = got[0], want[0]
    assert _build.launches["walk_step"] == 0


def test_walk_step_random_words_in_every_representation():
    """int32 bit patterns, int64 values and torch.uint32 give one walk."""
    _, csr = _graph_csr()
    *arrays, n_pins = csr
    curr, query, rbits = _walkers(9, 96, n_pins, high_bit=True)
    args = [torch.as_tensor(a) for a in arrays]
    outs = [
        tops.walk_step(torch.as_tensor(curr), torch.as_tensor(query), r, *args,
                       n_pins=n_pins, alpha_u32=2**31, use_kernel=use_kernel)
        for r in (torch.as_tensor(rbits.view(np.int32)),
                  torch.as_tensor(rbits.astype(np.int64)),
                  torch.as_tensor(rbits))
        for use_kernel in (None, False)
    ]
    for out in outs[1:]:
        for a, b in zip(out, outs[0]):
            assert torch.equal(a, b)
